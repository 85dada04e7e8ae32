"""The CGRA PE array on the card: wrappers of the hand-written CUDA kernels
in ``csrc/pe_array.cu``.

``cycle_step`` launches ``cycle_step_kernel``, one cycle, which replaces
``repro/kernels/pe_array.py``'s Pallas ``_cycle_kernel``.  ``run_cycles``
launches ``run_cycles_kernel``, every row of a program in one launch, which
replaces the ``lax.scan`` of that kernel in ``repro/kernels/ops.py``; given
a stack of K same-grid programs it runs them all in that one launch, which
replaces the ``jax.vmap`` of the scan in ``repro/fuzz/engine.py``.

Each wrapper launches its kernel for CUDA tensors and raises if it cannot.
CPU tensors go to the plain versions, ``ref.cycle_step_ref``,
``ref.run_cycles_ref`` and ``ref.run_stacked_ref``.  ``cycle_step.launches``
and ``run_cycles.launches`` count kernel launches and nothing else.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .ref import (InstrRow, PEState, cycle_step_ref, run_cycles_ref,
                  run_stacked_ref)

MAX_THREADS = 256                  # kThreads in csrc/pe_array.cu
RUN_CYCLES_THREADS = 64            # target block size of run_cycles_kernel
DEFAULT_SHARED_BYTES = 48 * 1024   # without cudaFuncSetAttribute
MAX_SHARED_BYTES = 232_448         # 227 KB a block on sm_90
MAX_PROGRAMS = 65_535              # gridDim.y: programs in one launch


def _check(state: PEState, fields: InstrRow, field_shape: Tuple[int, ...],
           neighbors: torch.Tensor, out: Optional[PEState] = None,
           lead: Tuple[int, ...] = ()) -> None:
    """Every tensor int32, contiguous, on the state's device and of its
    shape; ``lead`` is the stack axis (K,) that the state carries."""
    B, P = state.out.shape[-2:]
    M = state.mem.shape[-1]
    shapes = {k: lead + shape for k, shape in (
        ("regs", (B, P, 4)), ("out", (B, P)), ("sf", (B, P)),
        ("zf", (B, P)), ("mem", (B, M)))}
    device = state.out.device
    outs = [] if out is None else out._asdict().items()
    named = ([(f"state.{k}", t, shapes[k]) for k, t in state._asdict().items()]
             + [(f"out.{k}", t, shapes[k]) for k, t in outs]
             + [(f"instr.{k}", t, field_shape)
                for k, t in fields._asdict().items()]
             + [("neighbors", neighbors, (P, 4))])
    for name, t, shape in named:
        if t.device != device or t.dtype != torch.int32:
            raise ValueError(f"{name}: expected int32 on {device}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {shape}, got "
                             f"{tuple(t.shape)}")
    if out is not None:
        for src, dst in zip(state, out):
            if src.data_ptr() == dst.data_ptr():
                raise ValueError("output buffers must not alias the input "
                                 "state")
    if not 0 < P <= MAX_THREADS:
        raise ValueError(f"{P} PEs: the kernels take 1 to {MAX_THREADS}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def cycle_step(state: PEState, instr: InstrRow, neighbors: torch.Tensor,
               out: Optional[PEState] = None) -> PEState:
    """One CGRA cycle.  ``neighbors`` is the (P, 4) int32 N/E/S/W table on
    the state's device, every entry in ``[0, P)``.  The new state goes into
    ``out`` when given (buffers that must not alias ``state``), else into
    fresh tensors."""
    device = state.out.device
    if device.type == "cpu":
        new = cycle_step_ref(state, instr, neighbors)
        if out is None:
            return new
        for dst, src in zip(out, new):
            dst.copy_(src)
        return out
    if device.type != "cuda":
        raise ValueError(f"cycle_step runs on cuda or cpu, not {device}")
    if out is None:
        out = PEState(*(torch.empty_like(t) for t in state))
    B, P = state.out.shape
    _check(state, instr, (P,), neighbors, out)
    from .build import library

    M = state.mem.shape[1]
    ptrs = [t.data_ptr() for t in (*instr, neighbors, *state, *out)]
    status = library().pe_cycle_step(*ptrs, B, P, M, _stream(device))
    if status != 0:
        raise RuntimeError(f"pe_cycle_step launch failed: cudaError {status}")
    cycle_step.launches += 1
    return out


cycle_step.launches = 0


class Geometry(NamedTuple):
    rows_per_block: int   # R whole batch rows a block
    threads: int          # R * P rounded up to a warp
    blocks: int           # blocks of one program (gridDim.x)
    shared_bytes: int     # R * (M + 2P) int32 words: mem_s and out_s[2]
    programs: int         # K programs of a stack (gridDim.y)


def run_cycles_geometry(B: int, P: int, M: int, K: int = 1) -> Geometry:
    """Launch shape of ``run_cycles_kernel`` for K programs, each over B
    batch rows of P PEs and M memory words.  Blocks of about
    ``RUN_CYCLES_THREADS`` threads, so that B=1024 at P=16 gives 256 blocks
    a program for the 132 SMs; as many rows as fit in 48 KB of shared
    memory, and one row a block up to 227 KB.  The K programs take K times
    the blocks, side by side on the card's second grid axis."""
    if not 0 < P <= MAX_THREADS:
        raise ValueError(f"{P} PEs: run_cycles takes 1 to {MAX_THREADS}")
    if not 0 < K <= MAX_PROGRAMS:
        raise ValueError(f"{K} programs: one launch takes 1 to "
                         f"{MAX_PROGRAMS}")
    row_bytes = 4 * (M + 2 * P)
    if row_bytes > MAX_SHARED_BYTES:
        raise ValueError(
            f"M={M}, P={P}: a batch row needs {row_bytes} bytes of shared "
            f"memory, above the {MAX_SHARED_BYTES} (227 KB) a block may have")
    rows = max(1, min(RUN_CYCLES_THREADS // P,
                      DEFAULT_SHARED_BYTES // row_bytes))
    threads = -(-rows * P // 32) * 32
    return Geometry(rows, threads, -(-B // rows), rows * row_bytes, K)


def run_cycles(fields: InstrRow, state: PEState, neighbors: torch.Tensor,
               trace: bool = True) -> Tuple[PEState, Optional[torch.Tensor]]:
    """Every row of a program: ``fields`` holds (T, P) int32 tensors and
    ``state`` (B, ...) ones.  A stack of K programs on one grid, ``fields``
    (K, T, P) and ``state`` with a leading K axis, runs in the same one
    launch.  Returns (final state, out trace (T, B, P), or (K, T, B, P) for
    a stack, or None when ``trace`` is off) in fresh tensors; ``state`` is
    left unchanged."""
    device = state.out.device
    stacked = fields.op.dim() == 3
    if device.type == "cpu":
        plain = run_stacked_ref if stacked else run_cycles_ref
        return plain(fields, state, neighbors, trace)
    if device.type != "cuda":
        raise ValueError(f"run_cycles runs on cuda or cpu, not {device}")
    if fields.op.dim() not in (2, 3):
        raise ValueError(f"instr.op: expected a (T, P) program or a "
                         f"(K, T, P) stack, got {tuple(fields.op.shape)}")
    if stacked and state.out.dim() == 3 \
            and fields.op.shape[0] != state.out.shape[0]:
        raise ValueError(f"{fields.op.shape[0]} programs but "
                         f"{state.out.shape[0]} states in the stack")
    lead = tuple(fields.op.shape[:1]) if stacked else ()
    K = lead[0] if stacked else 1
    T = fields.op.shape[-2]
    B, P = state.out.shape[-2:]
    M = state.mem.shape[-1]
    _check(state, fields, lead + (T, P), neighbors, lead=lead)
    outs = (torch.empty(lead + (T, B, P), dtype=torch.int32, device=device)
            if trace else None)
    if T == 0:
        return PEState(*(t.clone() for t in state)), outs
    geom = run_cycles_geometry(B, P, M, K)
    out = PEState(*(torch.empty_like(t) for t in state))
    from .build import library

    ptrs = [t.data_ptr() for t in (*fields, neighbors, *state, *out)]
    status = library().pe_run_cycles(
        *ptrs, None if outs is None else outs.data_ptr(), T, B, P, M, *geom,
        _stream(device))
    if status != 0:
        raise RuntimeError(f"pe_run_cycles launch failed: cudaError {status}")
    run_cycles.launches += 1
    return out, outs


run_cycles.launches = 0
