"""Mismatch triage: shrink, replay, explain, reproduce.

A copy of ``src/repro/fuzz/triage.py`` that works on artifacts and runs
each probe on the port's PE array (the card by default):

* :func:`shrink`: batch-bisection to a single failing memory.  Each probe
  is one batched run over half the current candidate set, so a failure
  among N memories is isolated in O(log N) runs, and the survivor is
  re-validated solo (batch of one) to rule out batch coupling.
* :func:`first_divergence`: replays the one failing memory with the full
  out trace and walks the schedule in cycle order against the
  per-iteration oracle values, naming the first (cycle, PE, node,
  iteration) where simulation and oracle part ways.
* :func:`write_reproducer`: a self-contained JSON of kernel, arch, II,
  backend, the memory image, the divergence and the mismatch lines.
* :func:`inject_fault`: the detector's self-test: flip one opcode of a
  known-good bitstream so tests can prove the fuzzer fails, shrinks and
  explains.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from ..cgra.artifact import Artifact
from ..cgra.bitstream import AssembledCIL
from ..cgra.isa import encode_program
from ..cgra.simulator import execute_asm
from ..device import resolve_device
from .engine import (
    M32,
    FuzzReport,
    _backend,
    batched_oracle,
    batched_oracle_iterations,
    compare_batch,
    mismatch_strings,
    node_values_from_outs,
)


@dataclass
class Divergence:
    """First point where the simulated trace leaves the oracle."""

    cycle: int
    pe: int
    node: int
    iteration: int
    got: int
    expected: int

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return (f"cycle {self.cycle}, PE {self.pe}: node {self.node} "
                f"(iteration {self.iteration}) sim {self.got:#x} != "
                f"oracle {self.expected:#x}")


def shrink(
    mems: np.ndarray,
    check: Callable[[np.ndarray], np.ndarray],
    indices: Optional[Sequence[int]] = None,
) -> Tuple[np.ndarray, Optional[int], int]:
    """Bisect a batch with at least one failing memory down to one.

    ``check(mems) -> (B,) bool failing mask`` is the batched probe (one
    engine run).  Returns ``(memory, corpus_index, probes)``; the survivor
    is re-validated alone so the reproducer is guaranteed to fail at batch
    size 1.  Raises ``ValueError`` if the initial batch has no failure, or
    if the failure refuses to reproduce solo (a batch-coupling bug).
    """
    mems = np.asarray(mems)
    if mems.ndim == 1:
        mems = mems[None, :]
    idx = (np.arange(mems.shape[0]) if indices is None
           else np.asarray(list(indices)))
    probes = 0
    cur = mems
    if cur.shape[0] == 0:
        raise ValueError("shrink: empty batch")
    while cur.shape[0] > 1:
        half = cur.shape[0] // 2
        probes += 1
        mask = np.asarray(check(cur[:half]), bool)
        if mask.any():
            keep = np.nonzero(mask)[0]
            cur, idx = cur[:half][keep], idx[:half][keep]
        else:
            # the failure lives in the other half; re-probe it
            probes += 1
            mask = np.asarray(check(cur[half:]), bool)
            if not mask.any():
                raise ValueError(
                    "shrink: failure vanished when the batch was split — "
                    "batch-coupled divergence")
            keep = np.nonzero(mask)[0]
            cur, idx = cur[half:][keep], idx[half:][keep]
        # keep only the first survivor: minimality, not a smaller batch
        cur, idx = cur[:1], idx[:1]
    probes += 1
    solo = np.asarray(check(cur), bool)
    if not solo.any():
        raise ValueError(
            "shrink: survivor does not fail at batch size 1 — "
            "batch-coupled divergence")
    return cur[0], int(idx[0]), probes


def engine_check(artifact: Artifact, device="cuda"
                 ) -> Callable[[np.ndarray], np.ndarray]:
    """The standard batched probe for :func:`shrink`: execute + oracle +
    compare, returning the failing mask."""
    dev = resolve_device(device)
    asm, program = artifact.asm, artifact.program

    def check(mems: np.ndarray) -> np.ndarray:
        mems = np.asarray(mems, np.int32)
        if mems.ndim == 1:
            mems = mems[None, :]
        final, outs, _ = execute_asm(asm, artifact.grid, mems,
                                     batch=mems.shape[0], device=dev)
        sim_vals = node_values_from_outs(asm, outs, program.trip)
        oracle_vals, oracle_mem = batched_oracle(program, mems)
        return compare_batch(sim_vals, final.mem.cpu().numpy(),
                             oracle_vals, oracle_mem)

    return check


def first_divergence(artifact: Artifact, mem: np.ndarray, device="cuda"
                     ) -> Optional[Divergence]:
    """Replay one memory with the full trace and name the first cell whose
    simulated value differs from the oracle's value for that (node,
    iteration)."""
    asm = artifact.asm
    mem = np.asarray(mem, np.int32).reshape(1, -1)
    _, outs, _ = execute_asm(asm, artifact.grid, mem, batch=1,
                             device=device)
    outs = outs.cpu().numpy()
    history = batched_oracle_iterations(artifact.program, mem)
    for (t, pe) in sorted(asm.node_of_cell):
        n, j = asm.node_of_cell[(t, pe)]
        got = int(outs[t, 0, pe]) & M32
        exp = int(history[j][n][0]) & M32
        if got != exp:
            return Divergence(cycle=t, pe=pe, node=n, iteration=j,
                              got=got, expected=exp)
    return None


def write_reproducer(
    out_dir: str,
    kernel: str,
    arch: str,
    asm: AssembledCIL,
    backend: str,
    mem: np.ndarray,
    corpus_index: int,
    divergence: Optional[Divergence],
    mismatches: Sequence[str],
) -> str:
    """A self-contained failure record under ``out_dir``; returns the
    path.  Deterministic content (no timestamps) so records diff
    cleanly."""
    os.makedirs(out_dir, exist_ok=True)
    safe_arch = arch.replace("/", "_").replace(":", "_")
    path = os.path.join(out_dir,
                        f"{kernel}__{safe_arch}__mem{corpus_index}.json")
    doc = {
        "kernel": kernel,
        "arch": arch,
        "ii": asm.ii,
        "trip": asm.trip,
        "backend": backend,
        "corpus_index": corpus_index,
        "mem": [int(v) for v in np.asarray(mem).ravel()],
        "divergence": divergence.to_dict() if divergence else None,
        "mismatches": list(mismatches),
    }
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
    return path


def triage_failure(
    artifact: Artifact,
    mems: np.ndarray,
    rep: FuzzReport,
    device="cuda",
    out_dir: str = "results/fuzz_failures",
) -> None:
    """The full mismatch pipeline on a failing :class:`FuzzReport`: shrink
    to one memory, replay for the first divergence, write the reproducer,
    and annotate the report in place."""
    dev = resolve_device(device)
    asm, program = artifact.asm, artifact.program
    failing = np.asarray(rep.failing, int)
    mem, idx, _probes = shrink(np.asarray(mems)[failing],
                               engine_check(artifact, dev), indices=failing)
    div = first_divergence(artifact, mem, dev)
    solo = mem.reshape(1, -1)
    final, outs, _ = execute_asm(asm, artifact.grid, solo, batch=1,
                                 device=dev)
    sim_vals = node_values_from_outs(asm, outs, program.trip)
    oracle_vals, oracle_mem = batched_oracle(program, solo)
    lines = mismatch_strings(program, sim_vals, final.mem.cpu().numpy(),
                             oracle_vals, oracle_mem, 0, label=idx)
    rep.divergence = div.to_dict() if div else None
    rep.reproducer = write_reproducer(
        out_dir, rep.kernel, rep.arch, asm, _backend(dev), mem, idx, div,
        lines)


# ---------------------------------------------------------------------------
# fault injection — prove the detector can fail
# ---------------------------------------------------------------------------

_FAULT_SWAPS = {"SADD": "SSUB", "SSUB": "SADD", "LXOR": "LOR",
                "LAND": "LOR", "LOR": "LAND", "SMUL": "SADD"}


def inject_fault(asm: AssembledCIL
                 ) -> Tuple[AssembledCIL, Tuple[int, int], str]:
    """Return a copy of ``asm`` with one instruction's opcode flipped
    (e.g. SADD -> SSUB) inside its word, at the earliest schedule cell
    that computes a DFG node.  Returns (mutated asm, (cycle, pe), mutation
    label)."""
    for (t, pe) in sorted(asm.node_of_cell):
        ins = asm.rows[t][pe]
        if ins.op in _FAULT_SWAPS:
            new_op = _FAULT_SWAPS[ins.op]
            rows = [list(row) for row in asm.rows]
            rows[t][pe] = dataclasses.replace(ins, op=new_op)
            mutated = dataclasses.replace(asm,
                                          bitstream=encode_program(rows))
            return mutated, (t, pe), f"{ins.op}->{new_op}@t{t}pe{pe}"
    raise ValueError(f"no mutable instruction found in {asm.name}")
