"""The switching-activity harvest on the card: one chunk's toggle counts in
one launch of the hand-written ``harvest_kernel`` (``csrc/activity.cu``).

:func:`pack_pairs` packs the replay's (value, previous value, bin) triples
(``fuzz.activity._replay_pairs``) into a :class:`HarvestTable`: one int32
array of three words a pair, in the replay's order, which crosses to a
device once.  :func:`harvest_update` adds, for every memory of a chunk's
out trace and every pair, the popcount of the value XOR the previous value
into the pair's bin of the caller's int64 bins, on the trace's device and
stream, without a wait.  The sums are integers, so they equal those of
``fuzz.activity.ActivityAccumulator.update_ref``, the plain version, which
is what the accumulator runs off the card.

The kernel replaces no TPU kernel: the JAX package replays the datapath in
numpy on the host (``repro/fuzz/activity.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from . import build
from .pe_array import _stream

#: flags of a pair's third word: its value / previous value is a constant
LHS_CONST, RHS_CONST = 1 << 8, 1 << 9
BIN_MASK = 0xFF
MAX_BINS = 64
#: fewest pairs a slice is cut to where the card is full without
MIN_SLICE = 96
MAX_THREADS = 256
#: a block's memories are as many as keep one row of their trace
#: (threads x P x 4 bytes) within this
ROW_BYTES = 32 * 1024
SMS = 132
#: warps the table's slices give an SM: a warp's load touches a sector a
#: memory, so a row is served from L1 only while few warps share it.  At
#: B = 16,384 the best count is near 12 at P = 16 and 4 to 6 at P = 64;
#: 8, summed over each configuration's programs, reads 14-19% above each
#: program's best, under 1% of a chunk (``chip_smoke.py --harvest`` sweeps
#: it)
SM_WARPS = 8
#: a block's bin sums are 32-bit: threads x pairs a slice x 32 stays within
SUM_LIMIT = (1 << 32) - 1


@dataclass
class HarvestTable:
    """The replay of one schedule of T rows on P PEs as the kernel reads
    it: ``packed`` (pairs, 3) int32, each pair's value word, previous
    value word (a cell ``t * P + q``, or a constant where its flag is set)
    and bin with the flags ``LHS_CONST`` and ``RHS_CONST``; ``bins`` the
    number of bins the pairs add into."""

    T: int
    P: int
    bins: int
    packed: np.ndarray
    #: :meth:`on_device`'s copies
    _on_device: Dict[torch.device, torch.Tensor] = field(
        default_factory=dict, repr=False, compare=False)

    @property
    def pairs(self) -> int:
        return self.packed.shape[0]

    def on_device(self, device: torch.device) -> torch.Tensor:
        """``packed`` on ``device``, copied there once (a CUDA device
        without an index is the current one, as a tensor placed there
        reports it)."""
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device not in self._on_device:
            self._on_device[device] = torch.as_tensor(self.packed,
                                                      device=device)
        return self._on_device[device]


def pack_pairs(lhs: Sequence[Tuple[int, int]],
               rhs: Sequence[Tuple[int, int]], bins: Sequence[int], T: int,
               P: int, n_bins: int) -> HarvestTable:
    """The table of pairs ``(lhs[i], rhs[i])`` into ``bins[i]`` over a
    trace of T rows on P PEs, each value a replayed source (its cell
    ``t * P + q``, or -1 for a constant; the constant).  A constant is
    kept as int32, wrapped as the plain version wraps it.  Raises
    ``ValueError`` for a cell outside the trace, a bin outside
    ``[0, n_bins)`` or more bins than the kernel holds."""
    if not len(lhs) == len(rhs) == len(bins):
        raise ValueError(f"{len(lhs)} values, {len(rhs)} previous values "
                         f"and {len(bins)} bins")
    if not 0 < n_bins <= MAX_BINS:
        raise ValueError(f"{n_bins} bins: the kernel holds 1 to {MAX_BINS}")
    cells = np.asarray([[c for c, _ in lhs], [c for c, _ in rhs]],
                       np.int64).reshape(2, -1)
    consts = np.asarray([[v for _, v in lhs], [v for _, v in rhs]],
                        np.int64).reshape(2, -1)
    bin_arr = np.asarray(bins, np.int64).reshape(-1)
    if ((cells >= T * P) | (cells < -1)).any():
        raise ValueError(f"a cell outside the trace's {T} x {P}")
    if ((bin_arr < 0) | (bin_arr >= n_bins)).any():
        raise ValueError(f"a bin outside [0, {n_bins})")
    is_const = cells < 0
    words = np.where(is_const, consts.astype(np.int32), cells)
    flags = is_const[0] * LHS_CONST | is_const[1] * RHS_CONST
    packed = np.stack([words[0], words[1], bin_arr | flags], axis=1)
    return HarvestTable(T=T, P=P, bins=n_bins,
                        packed=np.ascontiguousarray(packed, np.int32))


def harvest_geometry(B: int, P: int, pairs: int,
                     sm_warps: int = SM_WARPS) -> Tuple[int, int, int]:
    """(threads a block, slices, pairs a slice) of a launch over a trace of
    B memories on P PEs and a table of ``pairs`` pairs.

    A block holds one memory a thread, as many as keep a row of their
    trace within ``ROW_BYTES`` (256 at P = 16, 128 at P = 64) and no more
    than B needs.  The table is cut into slices of at least ``MIN_SLICE``
    pairs until the launch has ``sm_warps`` warps on every SM, and into as
    many as keep a block's sums within 32 bits; the slices are then as
    many as that slice length needs, so that none is empty."""
    if B <= 0 or P <= 0 or pairs <= 0 or sm_warps <= 0:
        raise ValueError(f"B = {B}, P = {P}, {pairs} pairs, {sm_warps} "
                         f"warps an SM: nothing to harvest")
    row_threads = max(32, min(MAX_THREADS, ROW_BYTES // (4 * P)) // 32 * 32)
    threads = min(row_threads, -(-B // 32) * 32)
    warps = -(-B // threads) * (threads // 32)
    longest = SUM_LIMIT // (threads * 32)
    slices = max(min(-(-SMS * sm_warps // warps), -(-pairs // MIN_SLICE)),
                 -(-pairs // longest), 1)
    slice_ = -(-pairs // slices)
    return threads, -(-pairs // slice_), slice_


def _check(what: str, x: torch.Tensor, dtype: torch.dtype,
           shape: Tuple[int, ...], device: torch.device) -> None:
    if x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous() or x.device != device:
        raise ValueError(f"{what}: expected a contiguous {shape} {dtype} "
                         f"tensor on {device}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def harvest_update(table: HarvestTable, outs: torch.Tensor,
                   bins: torch.Tensor) -> None:
    """Add one chunk's toggle counts into ``bins``, a contiguous
    (``table.bins``,) int64 tensor on the trace's device: for every memory
    of ``outs``, a contiguous (T, B, P) int32 trace on a CUDA device with
    the table's T and P, and every pair of ``table``, the popcount of the
    value XOR the previous value into the pair's bin.  One launch of
    ``harvest_kernel`` on the device's current stream, not waited for;
    nothing is allocated.  ``harvest_update.launches`` counts the
    launches.  There is no fallback: ``ActivityAccumulator.update_ref`` is
    the plain version."""
    device = outs.device
    if device.type != "cuda":
        raise ValueError(f"harvest_update runs on a CUDA device, not "
                         f"{device}; ActivityAccumulator.update_ref is its "
                         f"plain version")
    if outs.dim() != 3:
        raise ValueError(f"outs: expected a (T, B, P) trace, got "
                         f"{tuple(outs.shape)}")
    T, B, P = outs.shape
    _check("outs", outs, torch.int32, (table.T, B, table.P), device)
    _check("bins", bins, torch.int64, (table.bins,), device)
    if not B or not table.pairs:
        return
    if T * B >= 1 << 31:
        raise ValueError(f"{T} rows x {B} memories: the kernel's rows take "
                         f"2^31 or more")
    threads, slices, slice_ = harvest_geometry(B, P, table.pairs)
    status = build.activity_library().harvest_run(
        outs.data_ptr(), table.on_device(device).data_ptr(), bins.data_ptr(),
        table.pairs, table.bins, T, B, P, threads, slices, slice_,
        _stream(device))
    if status != 0:
        raise RuntimeError(f"harvest launch failed: cudaError {status}")
    harvest_update.launches += 1


harvest_update.launches = 0
