"""Run a whole instruction grid on the PE-array state.

Counterpart of ``src/repro/kernels/ops.py``: ``run_program`` takes the
place of its ``lax.scan``.  On the card the whole program, or a stack of K
programs on one grid, is one launch of the fused kernel
(``pe_array.run_cycles``); on the CPU it is the loop of the plain cycle
step.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..cgra.isa import OPS
from ..device import resolve_device
from .pe_array import run_cycles
from .ref import InstrRow, PEState


def decode_fields(words: np.ndarray, device="cuda") -> InstrRow:
    """(T, P) uint32 bitstream, or a (K, T, P) stack of them -> int32
    instruction fields of the same shape."""
    w = np.asarray(words, np.uint32).astype(np.int64)
    op = (w >> 27) & 0x1F
    if op.size and op.max() >= len(OPS):
        raise ValueError(f"opcode {int(op.max())} is not in the ISA")
    imm = w & 0xFFFF
    imm = np.where(imm >= 1 << 15, imm - (1 << 16), imm)
    dev = resolve_device(device)
    return InstrRow(*(torch.as_tensor(f.astype(np.int32), device=dev)
                      for f in (op, (w >> 24) & 0x7, (w >> 20) & 0xF,
                                (w >> 16) & 0xF, imm)))


def device_image(mem, batch: int, device="cuda") -> torch.Tensor:
    """The memory images of a run as an int32 tensor on ``device``: ``mem``
    is one (M,) image for every row, (batch, M), or a (K, batch, M)
    stack.  A host array crosses to the device in one copy; a tensor
    already there is used as it is (a one-image tensor is expanded, not
    copied)."""
    dev = resolve_device(device)
    if isinstance(mem, torch.Tensor):
        mem = mem.to(dev, torch.int32)
        return mem.expand(batch, -1) if mem.dim() == 1 else mem
    mem = np.asarray(mem, np.int32)
    if mem.ndim == 1:
        mem = np.broadcast_to(mem, (batch,) + mem.shape)
    return torch.tensor(mem, device=dev)


def init_state(batch: int, num_pes: int, mem, device="cuda") -> PEState:
    """Zeroed PE state over the images of :func:`device_image`."""
    image = device_image(mem, batch, device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=image.device)

    return PEState(regs=zeros(batch, num_pes, 4), out=zeros(batch, num_pes),
                   sf=zeros(batch, num_pes), zf=zeros(batch, num_pes),
                   mem=image)


def neighbor_tensor(neighbors: Sequence[Sequence[int]], num_pes: int,
                    device="cuda") -> torch.Tensor:
    """The (P, 4) N/E/S/W table as an int32 tensor on ``device``, checked:
    every entry a PE id below ``num_pes``."""
    nbr = np.asarray(neighbors, np.int32)
    if nbr.shape != (num_pes, 4) or nbr.min() < 0 or nbr.max() >= num_pes:
        raise ValueError(
            f"neighbors must be a (P, 4) table of PE ids < {num_pes}")
    return torch.as_tensor(nbr, device=resolve_device(device))


def run_program(fields: InstrRow, state: PEState, neighbors,
                device="cuda", trace: bool = True
                ) -> Tuple[PEState, Optional[torch.Tensor]]:
    """Run every instruction row: fields (T, P) over a (B, ...) state, or a
    stack of K programs, fields (K, T, P) over a (K, B, ...) state.
    ``neighbors`` is the (P, 4) table, or the tensor that
    :func:`neighbor_tensor` made of it, which is used as it is.  Returns
    (final state, out trace (T, B, P) or (K, T, B, P), or None when
    ``trace`` is off), both on ``device``; ``state`` is left unchanged."""
    dev = resolve_device(device)
    if not isinstance(neighbors, torch.Tensor):
        neighbors = neighbor_tensor(neighbors, state.out.shape[-1], dev)
    fields = InstrRow(*(f.to(dev, torch.int32).contiguous() for f in fields))
    state = PEState(*(t.to(dev, torch.int32).contiguous() for t in state))
    return run_cycles(fields, state, neighbors, trace=trace)
