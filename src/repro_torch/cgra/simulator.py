"""Cycle-accurate execution of mapped kernels and end-to-end verification.

Counterpart of ``src/repro/cgra/simulator.py``: program -> SAT mapping
(:func:`map_for_execution`) -> bitstream -> ``run_program`` on the PE
array -> per-node values, checked by ``verify`` against the serial Python
oracle with the same mismatch strings.  :func:`simulate` and
:func:`verify` take either an :class:`~repro_torch.cgra.artifact.Artifact`
or, as in the JAX package, ``(program, mapping, mem)``; a mapping is
assembled into its artifact first, so both run the same path.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.ops import (decode_fields, device_image, neighbor_tensor,
                           run_program)
from ..kernels.ref import InstrRow, PEState
from .arch import PEGrid, neighbor_table
from .artifact import Artifact
from .bitstream import AssembledCIL
from .programs import LoopBuilder


def map_for_execution(program: LoopBuilder, grid: PEGrid, config=None):
    """SAT-map with the bitstream assembler as a CEGAR oracle: prologue
    clobbers (codegen-level counterexamples the paper's encoding does not
    model) are fed back as blocking clauses.

    Compatibility shim, as in the JAX package — new code should use the
    session API instead::

        Toolchain(grid, config).map(program)   # repro_torch.toolchain
    """
    from ..core.mapper import map_dfg
    from ..toolchain.oracles import assembler_oracle

    return map_dfg(program.build_dfg(), grid, config,
                   assemble_check=assembler_oracle(program))


def _artifact(source: Union[Artifact, LoopBuilder], args: tuple
              ) -> Tuple[Artifact, np.ndarray]:
    """``(artifact, mem)`` from ``(artifact, mem)`` or ``(program,
    mapping, mem)`` positional arguments."""
    if isinstance(source, Artifact):
        (mem,) = args
        return source, mem
    mapping, mem = args
    return Artifact.from_mapping(source, mapping), mem


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


class DeviceProgram(NamedTuple):
    """What every launch of one bitstream reads besides its memories, on
    one device: built once by :func:`device_program`."""
    fields: InstrRow        # (T, P) int32 decoded words
    out0: torch.Tensor      # (P,) OUT presets
    regs0: torch.Tensor     # (P, 4) register presets
    source: tuple           # the words and presets it was built from


def device_program(asm: AssembledCIL, num_pes: int, device="cuda"
                   ) -> DeviceProgram:
    """The decoded words and the preset tables of ``asm`` on ``device``,
    built on the first call for each (device, ``num_pes``) and kept in
    ``asm.device_programs``; a bitstream or presets assigned to ``asm``
    since are built anew.  ``device_program.builds`` counts the builds."""
    dev = resolve_device(device)
    source = (asm.bitstream, asm.presets_out, asm.presets_reg)
    prog = asm.device_programs.get((dev, num_pes))
    if prog is None or any(a is not b for a, b in zip(prog.source, source)):
        out0, regs0 = preset_arrays(asm, num_pes)
        prog = DeviceProgram(decode_fields(asm.words(), dev),
                             torch.as_tensor(out0, device=dev),
                             torch.as_tensor(regs0, device=dev), source)
        asm.device_programs[(dev, num_pes)] = prog
        device_program.builds += 1
    return prog


device_program.builds = 0


@functools.lru_cache(maxsize=64)
def device_neighbors(grid: PEGrid, device="cuda") -> torch.Tensor:
    """``grid``'s checked (P, 4) neighbour table on ``device``, made once
    per (grid, device)."""
    return neighbor_tensor(neighbor_table(grid), grid.num_pes, device)


def preset_state(asm: AssembledCIL, num_pes: int, mem,
                 batch: int, device="cuda") -> PEState:
    """Initial PE-array state for ``asm`` over ``mem`` (a host array or a
    tensor, as :func:`~repro_torch.kernels.ops.device_image` takes it):
    zeros plus the register/output presets of :func:`preset_arrays` in
    every batch row, broadcast on the device from :func:`device_program`."""
    prog = device_program(asm, num_pes, device)
    image = device_image(mem, batch, device)
    flags = torch.zeros((2, batch, num_pes), dtype=torch.int32,
                        device=image.device)
    return PEState(regs=prog.regs0.expand(batch, num_pes, 4).contiguous(),
                   out=prog.out0.expand(batch, num_pes).contiguous(),
                   sf=flags[0], zf=flags[1], mem=image)


def stacked_preset_state(asms: Sequence[AssembledCIL], num_pes: int,
                         mems, device="cuda") -> PEState:
    """Initial state of K bitstreams of one grid over (K, B, M) memories:
    the :func:`preset_state` of each on a leading K axis."""
    progs = [device_program(asm, num_pes, device) for asm in asms]
    image = device_image(mems, mems.shape[-2], device).contiguous()
    K, B = image.shape[:2]
    flags = torch.zeros((2, K, B, num_pes), dtype=torch.int32,
                        device=image.device)
    return PEState(
        regs=torch.stack([p.regs0 for p in progs])[:, None].expand(
            K, B, num_pes, 4).contiguous(),
        out=torch.stack([p.out0 for p in progs])[:, None].expand(
            K, B, num_pes).contiguous(),
        sf=flags[0], zf=flags[1], mem=image)


def execute_asm(asm: AssembledCIL, grid: PEGrid, mem,
                batch: int = 1, device="cuda"
                ) -> Tuple[PEState, torch.Tensor, torch.Tensor]:
    """Run an assembled CIL over ``batch`` memories (``mem`` a host array or
    a tensor on ``device``, used as it is).  Returns ``(final_state, outs
    (T, B, P), out0 (B, P))`` as tensors on ``device``: the shared
    execution seam under :func:`simulate` and the fuzzing engine.  The
    words, presets and neighbour table come from the device, built once."""
    state = preset_state(asm, grid.num_pes, mem, batch, device)
    final, outs = run_program(device_program(asm, grid.num_pes,
                                             device).fields,
                              state, device_neighbors(grid, device), device)
    return final, outs, state.out


def simulate(source, *args, batch: int = 1, device="cuda") -> SimResult:
    """``simulate(artifact, mem)`` or ``simulate(program, mapping, mem)``
    over ``batch`` copies of ``mem``."""
    artifact, mem = _artifact(source, args)
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


def verify(source, *args, device="cuda") -> List[str]:
    """``verify(artifact, mem)`` or ``verify(program, mapping, mem)``:
    a list of mismatch strings (empty == end-to-end correct)."""
    artifact, mem = _artifact(source, args)
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
