"""Cycle-accurate execution of mapped-kernel artifacts and end-to-end
verification.

Counterpart of the execution half of ``src/repro/cgra/simulator.py``:
artifact -> decoded bitstream -> preset state -> ``run_program`` on the
PE array -> per-node values, checked by ``verify`` against the serial
Python oracle with the same mismatch strings.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..kernels.ops import decode_fields, init_state, run_program
from ..kernels.ref import PEState
from .arch import Grid, neighbor_table
from .artifact import Artifact, AssembledCIL


@dataclass
class SimResult:
    asm: AssembledCIL
    node_values: Dict[int, np.ndarray]     # node -> (B,) last-iteration value
    final_mem: np.ndarray                  # (B, M)
    total_rows: int


def preset_arrays(asm: AssembledCIL, num_pes: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """The (P,) OUT and (P, 4) register presets of ``asm`` that seed
    loop-carried values for iteration 0, zeros elsewhere."""
    out0 = np.zeros(num_pes, np.int32)
    regs0 = np.zeros((num_pes, 4), np.int32)
    for pe, val in asm.presets_out.items():
        out0[pe] = val
    for (pe, reg), val in asm.presets_reg.items():
        regs0[pe, reg] = val
    return out0, regs0


def preset_state(asm: AssembledCIL, num_pes: int, mem: np.ndarray,
                 batch: int, device="cuda") -> PEState:
    """Initial PE-array state for ``asm``: zeros plus the register/output
    presets of :func:`preset_arrays` in every batch row."""
    out0, regs0 = preset_arrays(asm, num_pes)
    state = init_state(batch, num_pes, mem, device)
    dev = state.mem.device
    return state._replace(
        out=torch.as_tensor(np.repeat(out0[None], batch, 0), device=dev),
        regs=torch.as_tensor(np.repeat(regs0[None], batch, 0), device=dev))


def stacked_preset_state(asms: Sequence[AssembledCIL], num_pes: int,
                         mems: np.ndarray, device="cuda") -> PEState:
    """Initial state of K bitstreams of one grid over (K, B, M) memories:
    the :func:`preset_state` of each on a leading K axis."""
    states = [preset_state(asm, num_pes, mem, len(mem), device)
              for asm, mem in zip(asms, mems)]
    return PEState(*(torch.stack(ts) for ts in zip(*states)))


def execute_asm(asm: AssembledCIL, grid: Grid, mem: np.ndarray,
                batch: int = 1, device="cuda"
                ) -> Tuple[PEState, torch.Tensor, torch.Tensor]:
    """Run an assembled CIL over ``batch`` memories.  Returns
    ``(final_state, outs (T, B, P), out0 (B, P))`` as tensors on
    ``device``: the shared execution seam under :func:`simulate` and the
    fuzzing engine."""
    fields = decode_fields(asm.words(), device)
    state = preset_state(asm, grid.num_pes, mem, batch, device)
    final, outs = run_program(fields, state, neighbor_table(grid), device)
    return final, outs, state.out


def simulate(artifact: Artifact, mem: np.ndarray, batch: int = 1,
             device="cuda") -> SimResult:
    asm = artifact.asm
    final, outs, _ = execute_asm(asm, artifact.grid, mem, batch=batch,
                                 device=device)
    outs = outs.cpu().numpy()
    last_iter = artifact.program.trip - 1
    node_values = {n: outs[t, :, pe]
                   for (t, pe), (n, j) in asm.node_of_cell.items()
                   if j == last_iter}
    return SimResult(asm=asm, node_values=node_values,
                     final_mem=final.mem.cpu().numpy(),
                     total_rows=asm.total_rows)


def verify(artifact: Artifact, mem: np.ndarray, device="cuda") -> List[str]:
    """Returns a list of mismatch strings (empty == end-to-end correct)."""
    program = artifact.program
    errors: List[str] = []
    mem = np.asarray(mem, np.int32)
    sim = simulate(artifact, mem, batch=1, device=device)
    oracle_mem = [int(v) for v in mem]
    program.run_oracle(oracle_mem)
    oracle_vals = program.last_iteration_values([int(v) for v in mem])
    mask = (1 << 32) - 1
    for n, vals in sim.node_values.items():
        got = int(vals[0]) & mask
        exp = oracle_vals.get(n)
        if exp is None:
            continue
        if got != (exp & mask):
            errors.append(
                f"node {n} ({program.name}): sim {got:#x} != oracle "
                f"{exp & mask:#x}")
    sim_mem = sim.final_mem[0].astype(np.int64) & mask
    for i, v in enumerate(oracle_mem):
        if int(sim_mem[i]) != (v & mask):
            errors.append(f"mem[{i}]: sim {int(sim_mem[i]):#x} != oracle "
                          f"{v & mask:#x}")
    return errors
