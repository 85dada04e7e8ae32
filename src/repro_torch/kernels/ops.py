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


def init_state(batch: int, num_pes: int, mem: np.ndarray,
               device="cuda") -> PEState:
    """Zeroed PE state; ``mem`` is one (M,) image for every row or (batch, M)."""
    mem = np.asarray(mem, np.int32)
    if mem.ndim == 1:
        mem = np.broadcast_to(mem, (batch,) + mem.shape)
    dev = resolve_device(device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    return PEState(regs=zeros(batch, num_pes, 4), out=zeros(batch, num_pes),
                   sf=zeros(batch, num_pes), zf=zeros(batch, num_pes),
                   mem=torch.tensor(mem, device=dev))


def run_program(fields: InstrRow, state: PEState,
                neighbors: Sequence[Sequence[int]], device="cuda",
                trace: bool = True
                ) -> Tuple[PEState, Optional[torch.Tensor]]:
    """Run every instruction row: fields (T, P) over a (B, ...) state, or a
    stack of K programs, fields (K, T, P) over a (K, B, ...) state.  Returns
    (final state, out trace (T, B, P) or (K, T, B, P), or None when
    ``trace`` is off), both on ``device``; ``state`` is left unchanged."""
    dev = resolve_device(device)
    nbr = np.asarray(neighbors, np.int32)
    P = state.out.shape[-1]
    if nbr.shape != (P, 4) or nbr.min() < 0 or nbr.max() >= P:
        raise ValueError(f"neighbors must be a (P, 4) table of PE ids < {P}")
    nbr_t = torch.as_tensor(nbr, device=dev)
    fields = InstrRow(*(f.to(dev, torch.int32).contiguous() for f in fields))
    state = PEState(*(t.to(dev, torch.int32).contiguous() for t in state))
    return run_cycles(fields, state, nbr_t, trace=trace)
