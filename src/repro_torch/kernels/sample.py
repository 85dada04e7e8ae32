"""Seeded random instruction rows and PE-array states for holding the
PE-array kernels against their plain versions (tests and ``chip_smoke.py``),
and hazard programs aimed at the row scheme of ``run_cycles_kernel``.

Programs are collision-free: two stores to one address in one cycle are
undefined behaviour, so a row holds either SWI stores to distinct
addresses or exactly one SWD store.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..cgra.isa import DST_NONE, OPCODE, OPS, SRC_ZERO

_STORE_FREE = [op for op in OPS if op != "SWD"]
_NO_MEMORY = [op for op in OPS if op not in ("LWD", "LWI", "SWD", "SWI")]

#: hazard programs of :func:`hazard_fields`
HAZARDS = ("nop_rows", "nop_tail", "store_then_load", "store_nop_load",
           "every_address")


def random_fields(rng: np.random.RandomState, T: int, P: int, M: int,
                  full_encoding: bool = False) -> Dict[str, np.ndarray]:
    """(T, P) int32 ``op``/``dst``/``sa``/``sb``/``imm`` arrays.

    By default only the encodings the assembler emits are drawn (the 27
    opcodes, selectors 0-10).  ``full_encoding`` also draws opcodes 27-31
    and selectors 11-15, which the port defines as 0 and ZERO; the JAX
    reference leaves them undefined.  Needs ``P < M`` for distinct SWI
    addresses.
    """
    ops = _STORE_FREE + (["<27+>"] if full_encoding else [])
    n_sel = 16 if full_encoding else 11
    f = {k: np.zeros((T, P), np.int32) for k in ("op", "dst", "sa", "sb",
                                                   "imm")}
    for t in range(T):
        swd_pe = int(rng.randint(P)) if rng.rand() < 0.25 else -1
        for p in range(P):
            name = "SWD" if p == swd_pe else str(rng.choice(ops))
            if name == "SWI" and swd_pe >= 0:
                name = "LWI"
            op = int(rng.randint(27, 32)) if name == "<27+>" else OPCODE[name]
            sa = int(rng.randint(n_sel))
            imm = int(rng.randint(-(1 << 15), 1 << 15))
            if name == "SWI":              # distinct address per row
                sa, imm = SRC_ZERO, (t * P + p) % M
            f["op"][t, p] = op
            f["dst"][t, p] = (int(rng.randint(4)) if rng.rand() < 0.7
                              else DST_NONE)
            f["sa"][t, p] = sa
            f["sb"][t, p] = int(rng.randint(n_sel))
            f["imm"][t, p] = imm
    return f


def random_state(rng: np.random.RandomState, B: int, P: int,
                 M: int) -> Dict[str, np.ndarray]:
    """``regs``/``out``/``sf``/``zf``/``mem`` int32 arrays: half the rows
    small values (in-range addresses), half full-range int32."""
    def draw(shape):
        small = rng.randint(-(1 << 8), 1 << 8, size=shape)
        wide = rng.randint(-(1 << 31), 1 << 31, size=shape, dtype=np.int64)
        pick = rng.rand(*shape) < 0.5
        return np.where(pick, small, wide).astype(np.int32)

    return {"regs": draw((B, P, 4)), "out": draw((B, P)),
            "sf": rng.randint(0, 2, (B, P)).astype(np.int32),
            "zf": rng.randint(0, 2, (B, P)).astype(np.int32),
            "mem": draw((B, M))}


def _nop_row(f: Dict[str, np.ndarray], t: int) -> None:
    """Row t all NOP; its other fields stay as drawn (non-zero, as in a
    padding word)."""
    f["op"][t] = OPCODE["NOP"]


def _memory_cell(f, t, p, op, addr, rng) -> None:
    """(t, p) an LWI or SWI at ``addr`` (a = ZERO, so the address is imm);
    a store's value comes from a random source, a load lands in a random
    register."""
    f["op"][t, p] = OPCODE[op]
    f["sa"][t, p] = SRC_ZERO
    f["imm"][t, p] = addr
    if op == "SWI":
        f["sb"][t, p] = int(rng.randint(SRC_ZERO + 1))
    else:
        f["dst"][t, p] = int(rng.randint(4))


def hazard_fields(rng: np.random.RandomState, kind: str, T: int, P: int,
                  M: int) -> Dict[str, np.ndarray]:
    """(T, P) int32 fields of one of :data:`HAZARDS`, programs aimed at
    the row scheme of ``run_cycles_kernel`` (barriers only where needed, no
    work for NOP rows, trailing NOP rows not run):

    * ``nop_rows``: random rows with all-NOP rows in the middle (every
      third row, and a run of two);
    * ``nop_tail``: random rows, the last third of them all NOP;
    * ``store_then_load``: row t stores (SWI) at distinct addresses from the
      even PEs, row t + 1 loads each address from the same PE and from the
      next one, the other PEs run random non-memory ops;
    * ``store_nop_load``: a store row, then an all-NOP row or a live row
      without memory ops, then a row that loads what was stored;
    * ``every_address``: each row stores from the even PEs and loads from
      the odd ones, walking over every address of M (when T * ceil(P/2)
      >= M): a load reads the address the previous row stored, or, on odd
      rows, the one this row stores (the old value).

    Needs ``P >= 2`` and ``P <= M``.  Stores in one row never share an
    address."""
    if kind not in HAZARDS:
        raise ValueError(f"unknown hazard program {kind!r}; one of {HAZARDS}")
    f = random_fields(rng, T, P, M)
    if kind == "nop_rows":
        for t in [*range(1, T, 3), T // 2, T // 2 + 1]:
            if t < T:
                _nop_row(f, t)
        return f
    if kind == "nop_tail":
        for t in range(T - T // 3, T):
            _nop_row(f, t)
        return f
    for t in range(T):             # the other PEs: no memory ops
        for p in range(P):
            f["op"][t, p] = OPCODE[str(rng.choice(_NO_MEMORY))]
    evens = list(range(0, P, 2))
    if kind == "store_then_load":
        for t in range(0, T - 1, 2):
            addrs = rng.choice(M, size=len(evens), replace=False)
            for q, addr in zip(evens, addrs):
                _memory_cell(f, t, q, "SWI", int(addr), rng)
                _memory_cell(f, t + 1, q, "LWI", int(addr), rng)
                if q + 1 < P:
                    _memory_cell(f, t + 1, q + 1, "LWI", int(addr), rng)
        return f
    if kind == "store_nop_load":
        for t in range(0, T - 2, 3):
            addrs = rng.choice(M, size=len(evens), replace=False)
            for q, addr in zip(evens, addrs):
                _memory_cell(f, t, q, "SWI", int(addr), rng)
                _memory_cell(f, t + 2, q + 1 if q + 1 < P else q, "LWI",
                             int(addr), rng)
            if (t // 3) % 2 == 0:
                _nop_row(f, t + 1)
        return f
    odds = list(range(1, P, 2))
    n = len(evens)
    for t in range(T):             # every_address
        for i, q in enumerate(evens):
            _memory_cell(f, t, q, "SWI", (t * n + i) % M, rng)
        for i, q in enumerate(odds):
            row = t if t % 2 else t - 1
            _memory_cell(f, t, q, "LWI", (row * n + i % n) % M, rng)
    return f
