"""Seeded random instruction rows and PE-array states for holding the
cycle-step kernel against its plain version (tests and ``chip_smoke.py``).

Programs are collision-free: two stores to one address in one cycle are
undefined behaviour, so a row holds either SWI stores to distinct
addresses or exactly one SWD store.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..cgra.isa import DST_NONE, OPCODE, OPS, SRC_ZERO

_STORE_FREE = [op for op in OPS if op != "SWD"]


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
