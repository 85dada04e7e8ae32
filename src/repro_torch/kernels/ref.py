"""The plain PyTorch version of the CGRA PE-array cycle step.

Counterpart of ``src/repro/kernels/ref.py`` and the semantic contract of
the CUDA kernel (``csrc/pe_array.cu``): given one decoded instruction row
and the PE-array state, advance one CGRA cycle.  All ALU ops are int32
with wrap-around; every executed (non-NOP) op updates OUT and the sign/zero
flags; BSFA/BZFA select on the flags from *before* the cycle; neighbour
OUT reads and loads see the pre-cycle state; stores commit at the end of
the cycle.

Where the two JAX executors are the reference, this follows them:

* FXPMUL is the int32-wrapped product shifted right arithmetically by 16,
  which is what ``repro.kernels.ref`` computes with x64 off (its int64
  cast is a no-op), not the exact product of ``isa.alu_semantics``.
* Load/store addresses are ``a (+ imm for LWI/SWI)`` wrapped to int32 and
  clamped to ``[0, M-1]``, never dropped.
* Selectors 11-15 read ZERO and opcodes 27-31 yield 0, as the Pallas
  kernel does (the assembler emits neither).
* Two stores to one address in one cycle are undefined behaviour; which
  value lands is unspecified.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..cgra.isa import FXP_FRAC_BITS, OPCODE

_M32 = 0xFFFFFFFF
_SIGN = 0x80000000


class PEState(NamedTuple):
    regs: torch.Tensor   # (B, P, 4) int32
    out: torch.Tensor    # (B, P) int32
    sf: torch.Tensor     # (B, P) int32 (0/1) sign flag
    zf: torch.Tensor     # (B, P) int32 (0/1) zero flag
    mem: torch.Tensor    # (B, M) int32


class InstrRow(NamedTuple):
    op: torch.Tensor     # (P,) int32 opcode ids ((T, P) for a program)
    dst: torch.Tensor
    sa: torch.Tensor     # source selectors
    sb: torch.Tensor
    imm: torch.Tensor


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 keeping the low 32 bits (two's complement)."""
    return (((x & _M32) ^ _SIGN) - _SIGN).to(torch.int32)


def select_operand(sel, regs, out, out_nbr, imm):
    """sel: (P,); regs (B, P, 4), out (B, P), out_nbr (B, P, 4) as N/E/S/W,
    imm (P,).  Returns (B, P) int32."""
    B, P = out.shape
    zeros = torch.zeros((B, P, 6), dtype=torch.int32, device=out.device)
    cands = torch.cat([regs, out[:, :, None], out_nbr,
                       imm[None, :, None].expand(B, P, 1), zeros], dim=2)
    idx = sel.long()[None, :, None].expand(B, P, 1)   # 16 selectors: 10-15 ZERO
    return torch.gather(cands, 2, idx)[:, :, 0]


def alu(op, a, b, sf, zf):
    """All-op ALU with select-by-opcode. op: (P,), a/b/sf/zf: (B, P)."""
    a64, b64 = a.long(), b.long()
    shift = b & 31
    zero = torch.zeros_like(a)
    results = {
        "NOP": zero,
        "SADD": wrap32(a64 + b64),
        "SSUB": wrap32(a64 - b64),
        "SMUL": wrap32(a64 * b64),
        "FXPMUL": wrap32(a64 * b64) >> FXP_FRAC_BITS,
        "SLT": wrap32(a64 << shift.long()),
        "SRT": wrap32((a64 & _M32) >> shift.long()),
        "SRA": a >> shift,
        "LAND": a & b,
        "LOR": a | b,
        "LXOR": a ^ b,
        "LNAND": ~(a & b),
        "LNOR": ~(a | b),
        "LXNOR": ~(a ^ b),
        "BSFA": torch.where(sf > 0, a, b),
        "BZFA": torch.where(zf > 0, a, b),
        "LWD": a,            # placeholder: replaced by the memory path
        "LWI": a,
        "SWD": b,            # result of a store is the stored value
        "SWI": b,
        "BEQ": wrap32(a64 - b64),
        "BNE": wrap32(a64 - b64),
        "BLT": wrap32(a64 - b64),
        "BGE": wrap32(a64 - b64),
        "JUMP": zero,
        "EXIT": zero,
        "MOV": wrap32(a64 + b64),
    }
    stacked = torch.stack([results[name] for name in OPCODE]
                          + [zero] * (32 - len(OPCODE)), dim=2)
    idx = op.long()[None, :, None].expand(*a.shape, 1)
    return torch.gather(stacked, 2, idx)[:, :, 0]


def cycle_step_ref(state: PEState, instr: InstrRow,
                   neighbors: torch.Tensor) -> PEState:
    """One CGRA cycle.  ``neighbors`` is the (P, 4) N/E/S/W table on the
    state's device.  Returns a new state; the input is left unchanged."""
    regs, out, sf, zf, mem = state
    B, M = mem.shape
    op, imm = instr.op, instr.imm
    out_nbr = out[:, neighbors.long()]                    # (B, P, 4)
    a = select_operand(instr.sa, regs, out, out_nbr, imm)
    b = select_operand(instr.sb, regs, out, out_nbr, imm)
    res = alu(op, a, b, sf, zf)

    is_lwi = op == OPCODE["LWI"]
    is_load = (op == OPCODE["LWD"]) | is_lwi
    is_swi = op == OPCODE["SWI"]
    is_store = (op == OPCODE["SWD"]) | is_swi
    offset = torch.where(is_lwi | is_swi, imm, 0).long()
    addr = wrap32(a.long() + offset[None, :]).clamp(0, M - 1).long()
    res = torch.where(is_load[None, :], torch.gather(mem, 1, addr), res)

    # stores commit after every load has read; column M drops non-stores
    mem_ext = torch.cat([mem, mem.new_zeros((B, 1))], dim=1)
    mem_ext.scatter_(1, torch.where(is_store[None, :], addr, M), b)
    new_mem = mem_ext[:, :M].contiguous()

    executed = (op != OPCODE["NOP"])[None, :]
    new_out = torch.where(executed, res, out)
    new_sf = torch.where(executed, (res < 0).to(torch.int32), sf)
    new_zf = torch.where(executed, (res == 0).to(torch.int32), zf)
    slots = torch.arange(4, device=regs.device)
    hit = executed[:, :, None] & (instr.dst.long()[:, None] == slots)[None]
    new_regs = torch.where(hit, res[:, :, None], regs)
    return PEState(regs=new_regs, out=new_out, sf=new_sf, zf=new_zf,
                   mem=new_mem)


def run_cycles_ref(fields: InstrRow, state: PEState, neighbors: torch.Tensor,
                   trace: bool = True
                   ) -> Tuple[PEState, Optional[torch.Tensor]]:
    """Every row of a program (``fields`` holds (T, P) tensors): the loop of
    :func:`cycle_step_ref` that the JAX package's ``lax.scan`` runs.
    Returns (final state, out trace (T, B, P) or None); the input is left
    unchanged."""
    T = fields.op.shape[0]
    outs = state.out.new_empty((T, *state.out.shape)) if trace else None
    for t in range(T):
        state = cycle_step_ref(state, InstrRow(*(f[t] for f in fields)),
                               neighbors)
        if trace:
            outs[t] = state.out
    return state, outs


def run_stacked_ref(fields: InstrRow, state: PEState, neighbors: torch.Tensor,
                    trace: bool = True
                    ) -> Tuple[PEState, Optional[torch.Tensor]]:
    """K programs of one grid (``fields`` (K, T, P), ``state`` with a leading
    K axis): :func:`run_cycles_ref` on each, stacked, as the JAX package's
    ``jax.vmap`` of its scan runs them.  Returns (final state with the K
    axis, out trace (K, T, B, P) or None)."""
    runs = [run_cycles_ref(InstrRow(*(f[k] for f in fields)),
                           PEState(*(t[k] for t in state)), neighbors, trace)
            for k in range(fields.op.shape[0])]
    final = PEState(*(torch.stack(ts) for ts in zip(*(f for f, _ in runs))))
    outs = torch.stack([o for _, o in runs]) if trace else None
    return final, outs
