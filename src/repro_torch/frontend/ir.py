"""Front-end SSA IR: the traced form of a loop body, before legalization.

A copy of ``src/repro/frontend/ir.py``.  The tracer
(``repro_torch.frontend.tracer``) records a user-written Python loop body
into this graph; the legalizer (``repro_torch.frontend.legalize``) lowers it
onto the Table-5 ISA.  IR semantics are defined here once — 32-bit two's
complement, shift amounts masked to 5 bits, comparisons on the *wrapped*
difference (exactly what the BSFA/BZFA flag path of the hardware computes)
— and shared by the concrete reference interpreter, so the differential
co-simulation in ``repro_torch.frontend.verify`` is bit-exact by construction.

Node kinds:

* ``const``    — 32-bit literal (``value``), no args
* ``carry``    — loop-carried input (previous iteration's value), no args
* binops       — ``add sub mul fxpmul and or xor shl lshr ashr``
* compares     — ``lt ge eq ne`` (``gt``/``le`` are normalized by swapping
                 operands at trace time); results are *conditions*, only
                 consumable by ``select``
* ``select``   — ``(cond, a, b)`` data-dependent select
* ``load``     — ``(addr)`` word read from the shared data memory
* ``store``    — ``(addr, value)`` word write (side effect; kept in program
                 order in ``Trace.stores``)
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

M32 = (1 << 32) - 1

BIN_OPS = ("add", "sub", "mul", "fxpmul", "and", "or", "xor", "shl", "lshr", "ashr")
CMP_OPS = ("lt", "ge", "eq", "ne")

FXP_FRAC_BITS = 16  # fxpmul: (a*b) >> 16, matching repro_torch.cgra.isa.FXPMUL


def s32(x: int) -> int:
    """Wrap to signed 32-bit two's complement."""
    x &= M32
    return x - (1 << 32) if x >= (1 << 31) else x


def eval_binop(op: str, a: int, b: int) -> int:
    """Reference semantics of a binary IR op on int32 values."""
    if op == "add":
        return s32(a + b)
    if op == "sub":
        return s32(a - b)
    if op == "mul":
        return s32(a * b)
    if op == "fxpmul":
        # exact wide product, matching the Python oracle.  The PE array
        # (CUDA kernel and plain version alike) computes this in int32, so
        # traced kernels must keep |a*b| < 2**31 (see the fxpmul gap note
        # in repro_torch.frontend.__init__) or co-simulation will flag the
        # wrap.
        return s32((s32(a) * s32(b)) >> FXP_FRAC_BITS)
    if op == "and":
        return s32(a & b)
    if op == "or":
        return s32(a | b)
    if op == "xor":
        return s32(a ^ b)
    if op == "shl":
        return s32(a << (b & 31))
    if op == "lshr":
        return s32((a & M32) >> (b & 31))
    if op == "ashr":
        return s32(s32(a) >> (b & 31))
    raise ValueError(f"unknown binary IR op {op!r}")


def eval_cmp(op: str, a: int, b: int) -> bool:
    """Comparison on the wrapped 32-bit difference — the flag the hardware's
    SSUB/BSFA/BZFA path actually computes, *not* Python's unbounded ``<``."""
    d = s32(a - b)
    if op == "lt":
        return d < 0
    if op == "ge":
        return d >= 0
    if op == "eq":
        return d == 0
    if op == "ne":
        return d != 0
    raise ValueError(f"unknown compare IR op {op!r}")


@dataclass(frozen=True)
class TNode:
    """One SSA node.  ``args`` index producing nodes; ``value`` is set for
    ``const`` nodes only."""

    id: int
    op: str
    args: Tuple[int, ...] = ()
    value: Optional[int] = None


@dataclass
class CarryDef:
    """A loop-carried value: ``leaf`` is the node read at the body's start
    (previous iteration), ``update`` the node computing the next value."""

    name: str
    init: int
    leaf: int
    update: Optional[int] = None


@dataclass
class Trace:
    """A fully traced loop body, ready for legalization."""

    name: str
    trip: int
    nodes: List[TNode] = field(default_factory=list)
    carries: List[CarryDef] = field(default_factory=list)
    stores: List[int] = field(default_factory=list)
    results: Dict[str, int] = field(default_factory=dict)

    def node(self, nid: int) -> TNode:
        return self.nodes[nid]

    def op_histogram(self) -> Dict[str, int]:
        return dict(Counter(n.op for n in self.nodes))
