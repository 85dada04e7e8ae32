"""The CGRA PE array on the card: wrappers of the hand-written CUDA kernels
in ``csrc/pe_array.cu``.

``run_cycles`` runs every row of a program in one launch, which replaces
the ``lax.scan`` of ``repro/kernels/pe_array.py``'s Pallas ``_cycle_kernel``
in ``repro/kernels/ops.py``; given a stack of K same-grid programs it runs
them all in that one launch, which replaces the ``jax.vmap`` of the scan in
``repro/fuzz/engine.py``.  ``cycle_step``, one cycle, which replaces
``_cycle_kernel`` itself, is a one-row launch of the same kernels without
a trace: the file holds one implementation of the ISA for the card.

A launch takes one of two layouts of the program, chosen from the shape by
:func:`run_cycles_geometry`: ``run_lanes_kernel`` (a lane a batch row and
PE) for launches small enough to be bound by the latency of a row, and
for one-row launches wherever it fits; ``run_cycles_kernel`` (a lane a
batch row, a warp a PE) for the rest.

Each wrapper launches its kernel for CUDA tensors and raises if it cannot.
CPU tensors go to the plain versions, ``ref.cycle_step_ref``,
``ref.run_cycles_ref`` and ``ref.run_stacked_ref``.  ``cycle_step.launches``
and ``run_cycles.launches`` count the launches each wrapper makes and
nothing else; of ``run_cycles``'s, ``run_cycles.lane_launches`` counts
those in the lane layout and ``run_cycles.ring_launches`` those whose
program runs from a ring of two chunks (``chunk_rows < T``);
``run_cycles.last_geometry`` is the :class:`Geometry` of its latest
launch.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import build
from .ref import (InstrRow, PEState, cycle_step_ref, run_cycles_ref,
                  run_stacked_ref)

MAX_PES = 256                      # PEs the kernels take (kMaxPes)
LANES = 32
TARGET_BLOCKS = 128                # blocks run_cycles spreads a launch over
MAX_SHARED_BYTES = 232_448         # 227 KB a block on sm_90
IMAGE_SHARED_BYTES = 96 * 1024     # R halves until the memory image fits
PROGRAM_SHARED_BYTES = 64 * 1024   # a program above it runs from a ring
MAX_PROGRAMS = 65_535              # gridDim.y: programs in one launch
UNIFORM_LAYOUT, LANE_LAYOUT = 0, 1  # the layouts of run_cycles
LANE_WARPS = 4                     # warps a block in the lane layout
LANES_MAX_WARPS = 1024             # above it, the uniform layout
LANE_SHARED_BYTES = 96 * 1024      # a lane block's memory image
FIELDS = 5                         # op, dst, sa, sb, imm
RECORD = 8                         # words of a staged instruction


def _check(state: PEState, fields: InstrRow, field_shape: Tuple[int, ...],
           neighbors: torch.Tensor, out: Optional[PEState] = None,
           lead: Tuple[int, ...] = ()) -> None:
    """Every tensor int32, contiguous, on the state's device and of its
    shape; ``lead`` is the stack axis (K,) that the state carries.  One
    pass; the names are built only for the error."""
    B, P = state.out.shape[-2:]
    M = state.mem.shape[-1]
    bp = lead + (B, P)
    shapes = (lead + (B, P, 4), bp, bp, bp, lead + (B, M))
    device = state.out.device
    named = [*zip(state, shapes), *zip(fields, (field_shape,) * FIELDS),
             (neighbors, (P, 4))]
    if out is not None:
        named += zip(out, shapes)
    for t, shape in named:
        if (t.dtype != torch.int32 or t.device != device
                or t.shape != shape or not t.is_contiguous()):
            _raise_check(state, fields, field_shape, neighbors, out, shapes)
    if out is not None:
        for src, dst in zip(state, out):
            if src.data_ptr() == dst.data_ptr():
                raise ValueError("output buffers must not alias the input "
                                 "state")
    if not 0 < P <= MAX_PES:
        raise ValueError(f"{P} PEs: the kernels take 1 to {MAX_PES}")


def _raise_check(state, fields, field_shape, neighbors, out, shapes):
    """The error of :func:`_check`, with the name of the first bad tensor."""
    device = state.out.device
    named = ([(f"state.{k}", t, s) for k, t, s in
              zip(PEState._fields, state, shapes)]
             + [(f"out.{k}", t, s) for k, t, s in
                zip(PEState._fields, out or (), shapes)]
             + [(f"instr.{k}", t, field_shape) for k, t in
                zip(InstrRow._fields, fields)]
             + [("neighbors", neighbors, (state.out.shape[-1], 4))])
    for name, t, shape in named:
        if t.device != device or t.dtype != torch.int32:
            raise ValueError(f"{name}: expected int32 on {device}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {tuple(shape)}, "
                             f"got {tuple(t.shape)}")


def _stream(device: torch.device) -> int:
    """The raw handle of the current stream on ``device``: what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without making
    a ``Stream`` object on every launch."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None or device.index is None:
        return torch.cuda.current_stream(device).cuda_stream
    return raw(device.index)


def _launch(fields: InstrRow, state: PEState, neighbors: torch.Tensor,
            out: PEState, outs: Optional[torch.Tensor], T: int, B: int,
            P: int, M: int, geom: Geometry, device: torch.device) -> None:
    """One ``pe_run_cycles`` launch of checked tensors on ``device``'s
    current stream: T rows from ``state`` into ``out``, the trace into
    ``outs`` (None for none).  Raises if the launch fails."""
    ptrs = [t.data_ptr() for t in (*fields, neighbors, *state, *out)]
    status = build.library().pe_run_cycles(
        *ptrs, None if outs is None else outs.data_ptr(), T, B, P, M, *geom,
        _stream(device))
    if status != 0:
        raise RuntimeError(f"pe_run_cycles launch failed: cudaError {status}")


def cycle_step(state: PEState, instr: InstrRow, neighbors: torch.Tensor,
               out: Optional[PEState] = None) -> PEState:
    """One CGRA cycle.  ``neighbors`` is the (P, 4) int32 N/E/S/W table on
    the state's device, every entry in ``[0, P)``.  The new state goes into
    ``out`` when given (buffers that must not alias ``state``), else into
    fresh tensors.  On the card it is one launch of ``run_cycles``'s
    kernels: the row as a one-row program, no trace, in the layout that
    ``run_cycles_geometry(B, P, M, 1, 1)`` gives."""
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
    M = state.mem.shape[1]
    _launch(instr, state, neighbors, out, None, 1, B, P, M,
            run_cycles_geometry(B, P, M, 1, 1), device)
    cycle_step.launches += 1
    return out


cycle_step.launches = 0


class Geometry(NamedTuple):
    """Launch shape of ``run_cycles``, in the order ``pe_run_cycles``
    takes it."""
    rows_per_block: int   # batch rows a block (uniform: R, a power of two
                          # up to 32; lanes: 32 // P a warp x its warps)
    threads: int          # 32 lanes x the block's warps
    blocks: int           # blocks of one program (gridDim.x)
    shared_bytes: int     # dynamic shared memory a block
    programs: int         # K programs of a stack (gridDim.y)
    chunk_rows: int       # C program rows a slot; C < T runs from a ring
    memory_in_shared: int  # 1: the image in shared memory, 0: in mem_o
    layout: int           # UNIFORM_LAYOUT or LANE_LAYOUT

    def warp_pes(self, P: int) -> int:
        """PEs of a batch row that one warp holds: every one in the lane
        layout, :func:`pes_per_warp` of them, run in turn, in the
        uniform one."""
        return P if self.layout == LANE_LAYOUT else pes_per_warp(P)


def pes_per_warp(P: int) -> int:
    """PEs one warp runs in turn: the fewest of 1, 2, 4, 8 that keep a
    block at 16 warps (512 threads) up to P = 128; 8 and up to 32 warps
    above."""
    return 1 if P <= 16 else 2 if P <= 32 else 4 if P <= 64 else 8


@functools.lru_cache(maxsize=256)
def run_cycles_geometry(B: int, P: int, M: int, K: int = 1, T: int = 1,
                        layout: Optional[int] = None) -> Geometry:
    """Launch shape of ``run_cycles`` for K programs of T rows, each over
    B batch rows of P PEs and M memory words, in ``layout`` (by default
    the one chosen below).

    ``LANE_LAYOUT`` (``run_lanes_kernel``) runs, where :func:`lanes_fit`,
    a launch of at most ``LANES_MAX_WARPS`` warps at one lane a (batch
    row, PE): such a launch is bound by the latency of one row, which this
    layout keeps shortest.  It also runs every one-row launch (T = 1,
    ``cycle_step``) at any B: with no row loop to amortise the uniform
    layout's staging and packing, its prologue costs more than the lane
    layout's at every B measured.  A block is ``LANE_WARPS`` warps of
    32 // P batch rows each, and holds their memory image; a one-row
    launch of one program stages none (shared bytes 0, the image in
    device memory) but keeps to the same fit: a larger image is copied by
    the uniform layout's blocks, not by one warp.  Every other launch
    runs ``UNIFORM_LAYOUT`` (``run_cycles_kernel``).

    ``UNIFORM_LAYOUT``: lanes are batch rows: R, the largest power of two
    up to 32 that still gives ``TARGET_BLOCKS`` blocks over the K programs (R = 8 at B = 1024,
    32 at B = 16384), halved while the transposed image, M x (R | 1) words,
    and the lanes' register files, (8P + 2) x (R | 1), are above
    ``IMAGE_SHARED_BYTES``; where even R = 1 leaves no room for two program
    rows, the image stays in device memory (``mem_o``), at any M.  A warp
    runs ``pes_per_warp(P)`` PEs in turn.  The program takes T rows of
    8P + 1 words (and a word) when they fit in ``PROGRAM_SHARED_BYTES``
    (and the 227 KB a block may have), else a ring of two chunks.  Raises
    where ``layout`` is the lane layout and P, M do not fit it, or where
    the block does not fit in 227 KB even without the image."""
    if not 0 < P <= MAX_PES:
        raise ValueError(f"{P} PEs: run_cycles takes 1 to {MAX_PES}")
    if not 0 < K <= MAX_PROGRAMS:
        raise ValueError(f"{K} programs: one launch takes 1 to "
                         f"{MAX_PROGRAMS}")
    T = max(1, T)
    if layout is None:
        small = lanes_fit(P, M) and (
            T == 1 or K * -(-B // (LANES // P)) <= LANES_MAX_WARPS)
        layout = LANE_LAYOUT if small else UNIFORM_LAYOUT
    if layout == LANE_LAYOUT:
        if not lanes_fit(P, M):
            raise ValueError(f"P={P}, M={M}: the lane layout takes up to "
                             f"{LANES} PEs and a block's image in "
                             f"{LANE_SHARED_BYTES} bytes")
        R = LANES // P * LANE_WARPS
        if K == 1 and T == 1:    # one row reads the image once: not staged
            return Geometry(R, LANES * LANE_WARPS, -(-B // R), 0, 1, 1, 0,
                            LANE_LAYOUT)
        return Geometry(R, LANES * LANE_WARPS, -(-B // R), _lane_shared(R, M),
                        K, T, 1, LANE_LAYOUT)
    per_block = (K * B) // TARGET_BLOCKS
    wanted = min(LANES, 1 << max(0, per_block.bit_length() - 1))
    program_row = 4 * (RECORD * P + 1)     # P records and a row's flags

    def fixed(R: int, image: bool) -> int:
        """Image, the lanes' register files, neighbour table, last row,
        the 32-entry ALU table."""
        S = R | 1
        return 4 * ((M * S if image else 0) + (8 * P + 2) * S + 4 * P + 33)

    def rows_fitting(image: bool) -> int:
        R = wanted
        while R > 1 and fixed(R, image) > IMAGE_SHARED_BYTES:
            R //= 2
        return R

    R = rows_fitting(True)
    image = fixed(R, True) + 2 * (program_row + 4) <= MAX_SHARED_BYTES
    if not image:
        R = rows_fitting(False)
    room = min(PROGRAM_SHARED_BYTES, MAX_SHARED_BYTES - fixed(R, image))
    if T * program_row + 4 <= room:      # a slot: C records and C + 1 flags
        C = T
    else:
        C = max(1, (room - 8) // (2 * program_row))
    slots = 1 if C == T else 2
    shared = fixed(R, image) + slots * (C * program_row + 4)
    if shared > MAX_SHARED_BYTES:
        raise ValueError(
            f"M={M}, P={P}: a block needs {shared} bytes of shared memory "
            f"even without the image, above the {MAX_SHARED_BYTES} (227 KB) "
            f"a block may have")
    warps = -(-P // pes_per_warp(P))
    return Geometry(R, LANES * warps, -(-B // R), shared, K, C, int(image),
                    UNIFORM_LAYOUT)


def _lane_shared(R: int, M: int) -> int:
    """Bytes of a lane block: the memory image of its R batch rows."""
    return 4 * R * M


def lanes_fit(P: int, M: int) -> bool:
    """Whether P PEs over M memory words can run in the lane layout: all
    P PEs of a batch row in one warp, and the image of a block's
    ``LANE_WARPS`` x 32 // P batch rows in ``LANE_SHARED_BYTES``."""
    return (0 < P <= LANES and _lane_shared(LANE_WARPS * (LANES // P), M)
            <= LANE_SHARED_BYTES)


def run_cycles(fields: InstrRow, state: PEState, neighbors: torch.Tensor,
               trace: bool = True, layout: Optional[int] = None
               ) -> Tuple[PEState, Optional[torch.Tensor]]:
    """Every row of a program: ``fields`` holds (T, P) int32 tensors and
    ``state`` (B, ...) ones.  A stack of K programs on one grid, ``fields``
    (K, T, P) and ``state`` with a leading K axis, runs in the same one
    launch.  Returns (final state, out trace (T, B, P), or (K, T, B, P) for
    a stack, or None when ``trace`` is off) in fresh tensors; ``state`` is
    left unchanged.  On the card the launch takes the layout that
    :func:`run_cycles_geometry` chooses, or ``layout`` where given."""
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
    lead = fields.op.shape[:1] if stacked else ()
    K = lead[0] if stacked else 1
    T = fields.op.shape[-2]
    B, P = state.out.shape[-2:]
    M = state.mem.shape[-1]
    _check(state, fields, (*lead, T, P), neighbors, lead=tuple(lead))
    outs = (torch.empty((*lead, T, B, P), dtype=torch.int32, device=device)
            if trace else None)
    if T == 0:
        return PEState(*(t.clone() for t in state)), outs
    geom = run_cycles_geometry(B, P, M, K, T, layout)
    out = PEState(*(torch.empty_like(t) for t in state))
    _launch(fields, state, neighbors, out, outs, T, B, P, M, geom, device)
    run_cycles.launches += 1
    run_cycles.last_geometry = geom
    if geom.layout == LANE_LAYOUT:
        run_cycles.lane_launches += 1
    if geom.chunk_rows < T:
        run_cycles.ring_launches += 1
    return out, outs


run_cycles.launches = 0
run_cycles.lane_launches = 0        # of them, in the lane layout
run_cycles.ring_launches = 0        # of them, the program from a ring
run_cycles.last_geometry = None     # the shape of the latest launch
