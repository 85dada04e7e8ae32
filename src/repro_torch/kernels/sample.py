"""Seeded random instruction rows and PE-array states for holding the
PE-array kernels against their plain versions (tests and ``chip_smoke.py``),
hazard programs aimed at the row scheme of ``run_cycles_kernel``, CIL
programs and memories for holding the oracle kernel to its plain version,
and simulator results with planted differences for its verdict.

Programs are collision-free: two stores to one address in one cycle are
undefined behaviour, so a row holds either SWI stores to distinct
addresses or exactly one SWD store.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

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


# ---------------------------------------------------------------------------
# programs for the oracle kernel (kernels/oracle.py)
# ---------------------------------------------------------------------------

#: programs of :func:`out_of_range_program`
OUT_OF_RANGE = ("lwd", "lwi", "swd", "swi", "negative")
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1


def oracle_edges(builder, trip: int = 5):
    """A CIL program that reaches what no shipped kernel may: every op
    class on data-dependent operands, FXPMUL of full-range words (products
    past 2^47), shifts by loaded amounts (past 31 and negative) and by
    constants 33 / -1 / 40, SRT of negative words, BSFA / BZFA on zero and
    negative producers, absent operands, integer constants, two carries on
    one update node, loads and stores by carry and by immediate.  Its
    addresses stay in [0, 32) for ``trip`` up to 8.  ``builder`` is a
    ``LoopBuilder`` class (of either package)."""
    p = builder("oracle_edges", trip)
    i = p.carry("i", 0)
    acc = p.carry("acc", -7)
    twin = p.carry("twin", 3)                 # shares acc's update node
    p.set_carry(i, p.op("SADD", i, 1))
    x = p.op("LWD", i)                        # mem[i]
    y = p.op("LWI", None, None, imm=8)        # mem[8]
    z = p.op("LWI", i, None, imm=9)           # mem[i + 9]
    vals = [p.op(op, x, y) for op in (
        "SADD", "SSUB", "SMUL", "FXPMUL", "SLT", "SRT", "SRA", "LAND", "LOR",
        "LXOR", "LNAND", "LNOR", "LXNOR", "BEQ", "BNE", "BLT", "BGE")]
    vals += [p.op("SLT", z, 33), p.op("SRT", z, -1), p.op("SRA", z, 40),
             p.op("FXPMUL", z, z), p.op("SRT", x, z), p.op("MOV", acc),
             p.op("SADD", None, None, imm=-5), p.op("SSUB", None, x, imm=11),
             p.op("JUMP"), p.op("EXIT"), p.op("NOP")]
    same = p.op("SSUB", x, x)                 # zero every time
    vals += [p.op("BZFA", x, y, flag=same), p.op("BSFA", x, y, flag=same),
             p.op("BSFA", y, z, flag=x),
             p.op("BZFA", None, z, imm=17, flag=z)]
    total = vals[0]
    for v in vals[1:]:
        total = p.op("LXOR", total, v)
    mixed = p.op("SADD", total, acc)
    p.set_carry(acc, mixed)
    p.set_carry(twin, mixed)
    p.op("SWD", i, mixed)                     # mem[i] = mixed
    p.op("SWI", None, twin, imm=20)           # mem[20] = twin
    p.op("SWI", i, vals[3], imm=24)           # mem[i + 24] = FXPMUL
    return p


def oracle_edge_mems(B: int = 64, M: int = 32, seed: int = 0) -> np.ndarray:
    """(B, M) int32 memories for :func:`oracle_edges`: full-range words,
    a third of them drawn from the edges (0, -1, INT32_MIN, INT32_MAX,
    shift amounts around 32, ...), and every fourth memory zero in its
    first 16 words."""
    rng = np.random.default_rng(seed)
    mems = rng.integers(_INT32_MIN, _INT32_MAX + 1, (B, M), dtype=np.int64)
    special = np.array([0, -1, 1, _INT32_MIN, _INT32_MAX, 1 << 16,
                        -(1 << 16), 31, 32, 33, -32, 65535], np.int64)
    pick = rng.random((B, M)) < 0.3
    mems[pick] = rng.choice(special, pick.sum())
    mems[::4, :16] = 0
    return mems.astype(np.int32)


def tiled_corpus(artifact, B: int) -> np.ndarray:
    """B memories of ``artifact``'s fuzz corpus (seed B): above 1024 the
    1024-memory corpus in tiles, each rolled by its index, so that no two
    rows 1024 apart agree."""
    from ..fuzz.corpus import make_corpus

    base = make_corpus(artifact, min(B, 1024), seed=B)
    if B <= 1024:
        return base
    return np.concatenate([np.roll(base, k, axis=0)
                           for k in range(-(-B // 1024))])[:B]


def out_of_range_program(builder, kind: str, M: int = 16):
    """A program with one kind of access (``OUT_OF_RANGE``) whose address
    leaves [0, M) where a memory's word says so: it loads word i at
    iteration i and uses that word as an address (``swi`` stores to M in
    every memory, ``negative`` loads from i - 2)."""
    p = builder(f"bad_{kind}", 4)
    i = p.carry("i", 0)
    p.set_carry(i, p.op("SADD", i, 1))
    addr = p.op("LWD", i)
    if kind == "lwd":
        p.op("LWD", addr)
    elif kind == "lwi":
        p.op("LWI", addr, None, imm=3)
    elif kind == "swd":
        p.op("SWD", addr, i)
    elif kind == "swi":
        p.op("SWI", None, i, imm=M)
    elif kind == "negative":
        p.op("LWI", i, None, imm=-2)
    else:
        raise ValueError(f"unknown out-of-range program {kind!r}; expected "
                         f"one of {OUT_OF_RANGE}")
    return p


def first_error_case(builder):
    """(program, memories, the numpy oracle's error text) where memory 4
    leaves [0, 8) at node 5 in iteration 1, before memory 1 does at node 4
    in iteration 2: the error names the first access over all memories."""
    p = builder("first_error", 3)
    i = p.carry("i", 0)
    p.set_carry(i, p.op("SADD", i, 1))        # node 1
    a = p.op("LWD", i)                        # node 2
    b = p.op("LWI", i, None, imm=4)           # node 3
    p.op("LWD", a)                            # node 4
    p.op("LWD", b)                            # node 5
    mems = np.zeros((6, 8), np.int32)
    mems[1, 2] = 99
    mems[4, 5] = -3
    return p, mems, "first_error: node 5 (LWD) address outside [0, 8)"


#: what :func:`verdict_case` plants
VERDICT_FAULTS = ("neither", "image", "nodes", "both")


def verdict_case(oracle_vals: Dict[int, np.ndarray], oracle_mem: np.ndarray,
                 fault: str, rows: Iterable[int]
                 ) -> Tuple[Dict[int, np.ndarray], np.ndarray]:
    """A simulator's result for holding a verdict to
    ``fuzz.engine.compare_batch``: the oracle's own (``oracle_vals`` {nid:
    (B,)} and ``oracle_mem`` (B, M), as ``batched_oracle`` returns them)
    as int32, every other node in reverse order, with one bit flipped
    where ``fault`` says: an image word in each of ``rows`` (``image``), a
    node value in each row five past one of them (``nodes``), both, or
    neither.  Returns (sim node values, sim images)."""
    if fault not in VERDICT_FAULTS:
        raise ValueError(f"unknown fault {fault!r}; expected one of "
                         f"{VERDICT_FAULTS}")
    B, M = oracle_mem.shape
    mem = np.array(oracle_mem, np.int64).astype(np.int32)
    nodes = list(oracle_vals)[::-2]
    vals = {n: np.broadcast_to(oracle_vals[n], (B,)).astype(np.int32)
            for n in nodes}
    for r in sorted({r for r in rows if 0 <= r < B}):
        if fault in ("image", "both"):
            mem[r, (r * 31) % M] ^= 1 << (r % 31)
        if fault in ("nodes", "both") and nodes:
            vals[nodes[r % len(nodes)]][(r + 5) % B] ^= 1 << (r % 31)
    return vals, mem
