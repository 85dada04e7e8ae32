"""CIL programs: a tiny SSA builder, the paper's benchmark loops, an oracle.

Each benchmark from paper Table 6 is written as a real integer loop against
the Table-5 ISA (the original RAMP-toolchain DFG dumps are not available
offline; node/edge counts approximate the paper's — see DESIGN.md §9).

Flag-based selects (BSFA/BZFA) consume the flags set by the *previous
instruction on the same PE* — modelled as ``flag`` edges that the SAT
encoder restricts to same-PE placements with no intervening op.

A copy of ``src/repro/cgra/programs.py``.  ``LoopBuilder`` is also the
program an artifact carries: :meth:`LoopBuilder.from_dict` rebuilds it from
the artifact's program part (and checks the stored node order against the
DFG's), :meth:`LoopBuilder.to_dict` writes that part back, and its
interpreter is the serial oracle that fuzzing and ``verify`` replay.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

from ..core.dfg import DFG, Edge, Node
from .isa import alu_semantics

FLAG = "flag"


@dataclass(frozen=True)
class Val:
    node: int


@dataclass
class Carry:
    name: str
    init: int
    update: Optional[int] = None   # producing node id (set by set_carry)


Operand = Union[Val, Carry, int, None]


class LoopBuilder:
    """Builds a CIL DFG plus enough metadata to assemble and execute it."""

    def __init__(self, name: str, trip_count: int):
        self.name = name
        self.trip = trip_count
        self._next = 1
        self.nodes: List[Node] = []
        self.node_srcs: Dict[int, Tuple[Operand, Operand]] = {}
        self.node_imm: Dict[int, int] = {}
        self.flag_deps: Dict[int, int] = {}   # consumer -> flag producer
        self.carries: List[Carry] = []
        self.result_nodes: Dict[str, int] = {}

    # -- builder API --------------------------------------------------------------

    def carry(self, name: str, init: int) -> Carry:
        c = Carry(name=name, init=init)
        self.carries.append(c)
        return c

    def op(self, op: str, a: Operand = None, b: Operand = None,
           imm: Optional[int] = None, flag: Optional[Val] = None) -> Val:
        nid = self._next
        self._next += 1
        self.nodes.append(Node(nid, op=op))
        self.node_srcs[nid] = (a, b)
        self.node_imm[nid] = imm if imm is not None else 0
        if flag is not None:
            self.flag_deps[nid] = flag.node
        return Val(nid)

    def set_carry(self, c: Carry, v: Val) -> None:
        c.update = v.node

    def result(self, name: str, v: Union[Val, Carry]) -> None:
        self.result_nodes[name] = v.node if isinstance(v, Val) else v.update

    # -- outputs -------------------------------------------------------------------

    def build_dfg(self) -> DFG:
        edges: List[Edge] = []
        seen = set()

        def add(src, dst, dist):
            key = (src, dst, dist)
            if key not in seen:
                seen.add(key)
                edges.append(Edge(src, dst, dist))

        for nid, (a, b) in self.node_srcs.items():
            for operand in (a, b):
                if isinstance(operand, Val):
                    add(operand.node, nid, 0)
                elif isinstance(operand, Carry):
                    if operand.update is None:
                        raise ValueError(f"carry {operand.name} never set")
                    add(operand.update, nid, 1)
        for dst, src in self.flag_deps.items():
            key = (src, dst, 0)
            if key in seen:
                edges = [e for e in edges
                         if not (e.src == src and e.dst == dst
                                 and e.distance == 0)]
            seen.add(key)
            edges.append(Edge(src, dst, 0, kind="flag"))
        return DFG(self.nodes, edges, name=self.name)

    def flag_edges(self) -> List[Tuple[int, int]]:
        return [(src, dst) for dst, src in self.flag_deps.items()]

    # -- the program part of an artifact -------------------------------------------

    def to_dict(self) -> Dict:
        """Nodes with tagged operands, carries, named results and the node
        order, as a mapped-kernel artifact stores them."""
        return {
            "name": self.name,
            "trip": self.trip,
            "nodes": [{"id": node.id, "op": node.op,
                       "a": _tag(self.node_srcs[node.id][0]),
                       "b": _tag(self.node_srcs[node.id][1]),
                       "imm": self.node_imm[node.id],
                       "flag_dep": self.flag_deps.get(node.id)}
                      for node in self.nodes],
            "carries": [{"name": c.name, "init": c.init, "update": c.update}
                        for c in self.carries],
            "result_nodes": dict(self.result_nodes),
            "topo_order": self.build_dfg().topo_order(),
        }

    @classmethod
    def from_dict(cls, doc: Dict) -> "LoopBuilder":
        """Inverse of :meth:`to_dict`.  The node order is not stored twice:
        the one the DFG gives must equal the stored one, because loads and
        stores that no edge orders make memory results depend on it."""
        p = cls(doc["name"], int(doc["trip"]))
        carries = {c["name"]: p.carry(c["name"], int(c["init"]))
                   for c in doc["carries"]}

        def operand(tagged) -> Operand:
            kind, value = tagged
            if kind == "none":
                return None
            if kind == "int":
                return int(value)
            if kind == "val":
                return Val(int(value))
            if kind == "carry":
                return carries[value]
            raise ValueError(f"unknown operand kind {kind!r}")

        for n in doc["nodes"]:
            if n["id"] != p._next:
                raise ValueError(f"{p.name}: node ids must run 1, 2, ...; "
                                 f"got {n['id']} where {p._next} was due")
            flag = None if n["flag_dep"] is None else Val(n["flag_dep"])
            p.op(n["op"], operand(n["a"]), operand(n["b"]), imm=n["imm"],
                 flag=flag)
        for c in doc["carries"]:
            carries[c["name"]].update = c["update"]
        p.result_nodes = dict(doc["result_nodes"])
        if p.build_dfg().topo_order() != list(doc["topo_order"]):
            raise ValueError(f"{p.name}: stored node order differs from "
                             f"the DFG's topological order")
        return p

    # -- oracle ---------------------------------------------------------------------

    def run_oracle(self, mem: List[int]) -> Dict[str, int]:
        """Executes the loop in plain Python (per-iteration topo order)."""
        vals = self._interpret(mem)
        return {name: vals[nid] for name, nid in self.result_nodes.items()}

    def last_iteration_values(self, mem: List[int]) -> Dict[int, int]:
        """Every node's value during the final iteration (for sim checks)."""
        return self._interpret(mem)

    def _interpret(self, mem: List[int]) -> Dict[int, int]:
        dfg = self.build_dfg()
        order = dfg.topo_order()
        carry_vals = {c.update: c.init for c in self.carries}
        flags: Dict[int, Tuple[bool, bool]] = {}
        vals: Dict[int, int] = {}
        for _ in range(self.trip):
            vals = {}
            flags = {}
            for nid in order:
                a, b = self.node_srcs[nid]
                imm = self.node_imm[nid]
                node = dfg.nodes[nid]

                def fetch(operand, use_imm):
                    if operand is None:
                        return imm if use_imm else 0
                    if isinstance(operand, int):
                        return operand
                    if isinstance(operand, Val):
                        return vals[operand.node]
                    return carry_vals[operand.update]

                # an absent first operand reads the immediate — except for
                # LWI/SWI, where the assembler wires the ZERO source so the
                # address is 0 + imm (the imm would otherwise count twice)
                av = fetch(a, a is None and node.op not in ("LWI", "SWI"))
                bv = fetch(b, b is None)
                if node.op in ("LWI", "LWD"):
                    addr = av + (imm if node.op == "LWI" else 0)
                    out = mem[addr]
                elif node.op in ("SWI", "SWD"):
                    addr = av + (imm if node.op == "SWI" else 0)
                    mem[addr] = bv
                    out = bv
                elif node.op in ("BSFA", "BZFA"):
                    sign, zero = flags[self.flag_deps[nid]]
                    out = av if (sign if node.op == "BSFA" else zero) else bv
                else:
                    out = alu_semantics(node.op, av, bv)
                vals[nid] = out
                flags[nid] = (out < 0, out == 0)
            for c in self.carries:
                carry_vals[c.update] = vals[c.update]
        return vals


def _tag(operand: Operand) -> list:
    """An operand as an artifact stores it: ``[kind, value]``."""
    if operand is None:
        return ["none", None]
    if isinstance(operand, Val):
        return ["val", operand.node]
    if isinstance(operand, Carry):
        return ["carry", operand.name]
    return ["int", int(operand)]


# ---------------------------------------------------------------------------
# paper Table 6 benchmarks
# ---------------------------------------------------------------------------


def bitcount(x_init: int = 0x5A5A5A5A, trip: int = 32) -> LoopBuilder:
    """count += x & 1; x >>= 1   (paper: 6 nodes / 7 edges)."""
    p = LoopBuilder("bitcount", trip)
    x = p.carry("x", x_init)
    cnt = p.carry("count", 0)
    i = p.carry("i", 0)
    b = p.op("LAND", x, None, imm=1)
    c2 = p.op("SADD", cnt, b)
    x2 = p.op("SRT", x, None, imm=1)
    i2 = p.op("SADD", i, None, imm=1)
    t = p.op("BNE", i2, None, imm=trip)
    p.op("JUMP", t)
    p.set_carry(x, x2)
    p.set_carry(cnt, c2)
    p.set_carry(i, i2)
    p.result("count", c2)
    return p


def reversebits(x_init: int = 0x13579BDF, trip: int = 32) -> LoopBuilder:
    """r = (r << 1) | (x & 1); x >>= 1; store r (paper: 9 nodes / 10 edges)."""
    p = LoopBuilder("reversebits", trip)
    x = p.carry("x", x_init)
    r = p.carry("r", 0)
    i = p.carry("i", 0)
    b = p.op("LAND", x, None, imm=1)
    r1 = p.op("SLT", r, None, imm=1)
    r2 = p.op("LOR", r1, b)
    x2 = p.op("SRT", x, None, imm=1)
    i2 = p.op("SADD", i, None, imm=1)
    p.op("SWI", i2, r2, imm=64)          # store intermediate at 64+i
    t = p.op("BNE", i2, None, imm=trip)
    p.op("JUMP", t)
    p.set_carry(x, x2)
    p.set_carry(r, r2)
    p.set_carry(i, i2)
    p.result("r", r2)
    return p


def isqrt(n_init: int = 1234567, trip: int = 16) -> LoopBuilder:
    """Bit-by-bit integer sqrt (paper: 8 nodes / 12 edges)."""
    p = LoopBuilder("sqrt", trip)
    n = p.carry("n", n_init)
    res = p.carry("res", 0)
    bit = p.carry("bit", 1 << 30)
    t = p.op("LOR", res, bit)
    c = p.op("SSUB", n, t)               # sign(c) <=> n < t
    n2 = p.op("BSFA", n, Val(c.node), flag=c)      # n if n<t else n-t
    rh = p.op("SRT", res, None, imm=1)
    ro = p.op("LOR", rh, bit)
    c2 = p.op("SSUB", n, t)              # duplicated compare for 2nd select
    r2 = p.op("BSFA", rh, ro, flag=c2)   # res>>1 if n<t else (res>>1)|bit
    b2 = p.op("SRT", bit, None, imm=2)
    p.set_carry(n, n2)
    p.set_carry(res, r2)
    p.set_carry(bit, b2)
    p.result("res", r2)
    return p


def stringsearch(trip: int = 16) -> LoopBuilder:
    """Two-pattern running character match (paper: 16 nodes / 18 edges)."""
    p = LoopBuilder("stringsearch", trip)
    i = p.carry("i", 0)
    m1 = p.carry("m1", 0)
    m2 = p.carry("m2", 0)
    a = p.op("LWI", i, None, imm=0)       # text[i]
    b = p.op("LWI", i, None, imm=32)      # pat1[i]
    c = p.op("LWI", i, None, imm=48)      # pat2[i]
    d1 = p.op("SSUB", a, b)
    e1 = p.op("BZFA", 1, 0, imm=1, flag=d1)
    n1 = p.op("SADD", m1, e1)
    d2 = p.op("SSUB", a, c)
    e2 = p.op("BZFA", 1, 0, imm=1, flag=d2)
    n2 = p.op("SADD", m2, e2)
    i2 = p.op("SADD", i, None, imm=1)
    p.op("SWI", i2, n1, imm=80)
    t = p.op("BNE", i2, None, imm=trip)
    p.op("JUMP", t)
    p.set_carry(i, i2)
    p.set_carry(m1, n1)
    p.set_carry(m2, n2)
    p.result("m1", n1)
    p.result("m2", n2)
    return p


def gsm(trip: int = 16) -> LoopBuilder:
    """Saturating fixed-point multiply-accumulate (paper: 14 nodes / 20 edges)."""
    MAX, MIN = 32767, -32768
    p = LoopBuilder("gsm", trip)
    i = p.carry("i", 0)
    acc = p.carry("acc", 0)
    x = p.op("LWI", i, None, imm=0)
    y = p.op("LWI", i, None, imm=32)
    prod = p.op("SMUL", x, y)
    sh = p.op("SRA", prod, None, imm=15)
    s = p.op("SADD", acc, sh)
    cmax = p.op("SSUB", s, None, imm=MAX)      # sign => s < MAX
    s1 = p.op("BSFA", s, None, imm=MAX, flag=cmax)
    cmin = p.op("SSUB", Val(s1.node), None, imm=MIN)  # sign => s1 < MIN
    s2 = p.op("BSFA", None, s1, imm=MIN, flag=cmin)
    i2 = p.op("SADD", i, None, imm=1)
    p.op("SWI", i2, s2, imm=64)
    t = p.op("BNE", i2, None, imm=trip)
    p.op("JUMP", t)
    p.set_carry(i, i2)
    p.set_carry(acc, s2)
    p.result("acc", s2)
    return p


def _rotl(p: LoopBuilder, v, amount: int) -> Val:
    lo = p.op("SLT", v, None, imm=amount)
    hi = p.op("SRT", v, None, imm=32 - amount)
    return p.op("LOR", lo, hi)


def sha(trip: int = 16) -> LoopBuilder:
    """SHA-1-style round mix with variable rotation (paper: 25 nodes / 29
    edges; ours: 22/29 — register renames become explicit MOVs)."""
    p = LoopBuilder("sha", trip)
    a = p.carry("a", 0x67452301)
    b = p.carry("b", -271733879)
    c = p.carry("c", -1732584194)
    d = p.carry("d", 0x10325476)
    e = p.carry("e", -1009589776)
    i = p.carry("i", 0)
    rot_a = _rotl(p, a, 5)                         # 3 nodes
    nb = p.op("LNAND", b, b)                       # ~b
    t1 = p.op("LAND", b, c)
    t2 = p.op("LAND", nb, d)
    f = p.op("LOR", t1, t2)
    w = p.op("LWI", i, None, imm=0)                # w[i]
    s1 = p.op("SADD", rot_a, f)
    s2 = p.op("SADD", s1, w)
    s3 = p.op("SADD", s2, e)
    temp = p.op("SADD", s3, None, imm=0x7999)      # + K (truncated imm)
    b_rot = _rotl(p, b, 30)                        # 3 nodes
    e_new = p.op("MOV", d)
    d_new = p.op("MOV", c)
    b_new = p.op("MOV", a)
    i2 = p.op("SADD", i, None, imm=1)
    p.op("SWI", i2, temp, imm=32)
    t = p.op("BNE", i2, None, imm=trip)
    p.op("JUMP", t)
    p.set_carry(a, temp)
    p.set_carry(b, b_new)
    p.set_carry(c, b_rot)
    p.set_carry(d, d_new)
    p.set_carry(e, e_new)
    p.set_carry(i, i2)
    p.result("a", temp)
    return p


def sha2(trip: int = 16) -> LoopBuilder:
    """SHA-256-style round core (paper: 25 nodes / 33 edges; ours: 23/30)."""
    p = LoopBuilder("sha2", trip)
    e = p.carry("e", 0x510E527F)
    f = p.carry("f", -1694144372)
    g = p.carry("g", 0x1F83D9AB)
    h = p.carry("h", 0x5BE0CD19)
    i = p.carry("i", 0)
    s1a = _rotl(p, e, 26)                          # 3 nodes (rotr 6)
    s1b = _rotl(p, e, 21)                          # 3 nodes (rotr 11)
    s1 = p.op("LXOR", s1a, s1b)
    ne = p.op("LNAND", e, e)                       # ~e
    c1 = p.op("LAND", e, f)
    c2 = p.op("LAND", ne, g)
    ch = p.op("LXOR", c1, c2)
    w = p.op("LWI", i, None, imm=0)
    t1 = p.op("SADD", h, s1)
    t2 = p.op("SADD", t1, ch)
    t3 = p.op("SADD", t2, w)
    temp = p.op("SADD", t3, None, imm=0x28DB)      # + K (truncated imm)
    h_new = p.op("MOV", g)
    g_new = p.op("MOV", f)
    f_new = p.op("MOV", e)
    i2 = p.op("SADD", i, None, imm=1)
    p.op("SWI", i2, temp, imm=32)
    t = p.op("BNE", i2, None, imm=trip)
    p.op("JUMP", t)
    p.set_carry(e, temp)
    p.set_carry(f, f_new)
    p.set_carry(g, g_new)
    p.set_carry(h, h_new)
    p.set_carry(i, i2)
    p.result("e", temp)
    return p


BENCHMARKS = {
    "reversebits": reversebits,
    "bitcount": bitcount,
    "sqrt": isqrt,
    "stringsearch": stringsearch,
    "gsm": gsm,
    "sha": sha,
    "sha2": sha2,
}


def benchmark_mem(name: str, seed: int = 0):
    """Randomized 128-word input image for a Table-6 benchmark.

    stringsearch draws from a small alphabet so pattern matches actually
    occur; gsm keeps operands within Q15 so saturation paths are exercised
    without constant overflow.
    """
    import numpy as np

    rng = np.random.RandomState(seed)
    mem = np.zeros(128, np.int32)
    if name == "stringsearch":
        mem[0:16] = rng.randint(0, 8, 16)
        mem[32:48] = rng.randint(0, 8, 16)
        mem[48:64] = rng.randint(0, 8, 16)
    elif name == "gsm":
        mem[0:16] = rng.randint(-(2**14), 2**14, 16)
        mem[32:48] = rng.randint(-(2**14), 2**14, 16)
    else:
        mem[0:32] = rng.randint(0, 2**30, 32)
    return mem


def _register_benchmarks() -> None:
    import functools

    from .registry import register_kernel

    for name, factory in BENCHMARKS.items():
        register_kernel(
            name, factory, origin="handwritten",
            make_mem=functools.partial(benchmark_mem, name),
            tags=("table6",))


_register_benchmarks()


# ---------------------------------------------------------------------------
# synthetic DFGs matched to paper Table 3 (solver-level benchmarks)
# ---------------------------------------------------------------------------

TABLE3 = {
    # name: (nodes, edges)
    "sha_t3": (30, 33), "sha2_t3": (26, 28), "gsm_t3": (20, 24),
    "patricia": (42, 46), "bitcount_t3": (26, 29), "basicmath": (19, 20),
    "stringsearch_t3": (16, 16), "backprop": (35, 39), "nw": (16, 16),
    "srand": (22, 22), "hotspot": (67, 76),
}


def synthetic_dfg(name: str, seed: int = 0) -> DFG:
    """Seeded random DFG with Table-3 node/edge counts: a connected forward
    DAG plus 1-3 loop-carried back-edges (every CIL has a recurrence)."""
    import random
    n, m = TABLE3[name]
    rng = random.Random(hash(name) % (2**31) + seed)
    n_back = min(3, max(1, m - (n - 1)))
    nodes = [Node(i) for i in range(1, n + 1)]
    edges = []
    seen = set()
    for dst in range(2, n + 1):            # spanning-tree forward skeleton
        src = rng.randint(max(1, dst - 6), dst - 1)
        seen.add((src, dst))
        edges.append(Edge(src, dst, 0))
    while len(edges) < m - n_back:
        dst = rng.randint(2, n)
        src = rng.randint(max(1, dst - 8), dst - 1)
        if (src, dst) not in seen:
            seen.add((src, dst))
            edges.append(Edge(src, dst, 0))
    added = 0
    while added < n_back:
        src = rng.randint(2, n)
        dst = rng.randint(1, src)
        if src != dst and (src, dst) not in seen:
            seen.add((src, dst))
            edges.append(Edge(src, dst, 1))
            added += 1
    return DFG(nodes, edges, name=name)
