"""Trace plain Python loop bodies into the front-end SSA IR.

A copy of ``src/repro/frontend/tracer.py``.  A kernel is a Python
function ``body(s, mem)`` over a state proxy ``s`` (one attribute per
declared loop-carried value) and a memory proxy ``mem`` (word-addressed
loads/stores).  Running the body under a :class:`GraphSession` records
every operation on the symbolic operands into a
:class:`~repro_torch.frontend.ir.Trace`; running it under a
:class:`ConcreteSession` executes the same body on plain int32 values —
the *reference* side of the differential co-simulation.

Python semantics are preserved where they are representable: reading a
carry before writing it yields the previous iteration's value, reading it
after a write yields the new value, and the final binding becomes the next
iteration's input.  Data-dependent control flow is **not** representable on
a CGRA kernel — ``bool(traced value)`` raises :class:`TraceError`; use
:func:`where` (lowered to the BSFA/BZFA flag-select path) instead.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .ir import FXP_FRAC_BITS, CarryDef, TNode, Trace, eval_binop, eval_cmp, s32


class TraceError(RuntimeError):
    """The loop body used a construct outside the traceable subset."""


@dataclass(frozen=True)
class MemRegion:
    """A randomized input region: ``length`` words at ``base`` drawn
    uniformly from ``[lo, hi)`` by :func:`make_mem`."""

    base: int
    length: int
    lo: int = 0
    hi: int = 1 << 30


@dataclass
class LoopSpec:
    """Declares everything about a traceable loop that the body function
    itself cannot express: carried values and their initial values, the trip
    count, which carries are observable results, and the randomized memory
    image for co-simulation."""

    name: str
    trip: int
    carries: Dict[str, int]
    results: Tuple[str, ...] = ()
    index: Optional[str] = None  # induction carry driving the exit branch
    loop_control: bool = False  # append BNE/JUMP loop-control ops
    mem_size: int = 128
    mem_regions: Tuple[MemRegion, ...] = ()

    def result_names(self) -> Tuple[str, ...]:
        if self.results:
            unknown = [r for r in self.results if r not in self.carries]
            if unknown:
                raise TraceError(f"results {unknown} are not declared carries")
            return tuple(self.results)
        return tuple(self.carries)


def make_mem(spec: LoopSpec, seed: int = 0) -> np.ndarray:
    """Deterministic randomized input memory image for one co-sim seed."""
    rng = np.random.RandomState(seed)
    mem = np.zeros(spec.mem_size, np.int64)
    for region in spec.mem_regions:
        mem[region.base : region.base + region.length] = rng.randint(
            region.lo, region.hi, region.length, dtype=np.int64
        )
    return mem.astype(np.int32)


# ---------------------------------------------------------------------------
# sessions: one graph-recording, one concrete (the reference interpreter)
# ---------------------------------------------------------------------------


class GraphSession:
    """Records operations into an SSA graph with hash-consing and constant
    folding (two-const ops fold; +0/*1/&0-style identities simplify)."""

    mode = "graph"

    def __init__(self) -> None:
        self.nodes: List[TNode] = []
        self.stores: List[int] = []
        self._cse: Dict[Tuple, int] = {}

    def _emit(self, op: str, args: Tuple[int, ...] = (),
              value: Optional[int] = None, cse: bool = True) -> int:
        key = (op, args, value)
        if cse and key in self._cse:
            return self._cse[key]
        nid = len(self.nodes)
        self.nodes.append(TNode(id=nid, op=op, args=args, value=value))
        if cse:
            self._cse[key] = nid
        return nid

    def const(self, v: int) -> int:
        return self._emit("const", value=s32(v))

    def carry(self, name: str) -> int:
        return self._emit("carry", cse=False)

    def _const_of(self, nid: int) -> Optional[int]:
        n = self.nodes[nid]
        return n.value if n.op == "const" else None

    def binop(self, op: str, a: int, b: int) -> int:
        ca, cb = self._const_of(a), self._const_of(b)
        if ca is not None and cb is not None:
            return self.const(eval_binop(op, ca, cb))
        if cb == 0 and op in ("add", "sub", "or", "xor", "shl", "lshr", "ashr"):
            return a
        if ca == 0 and op in ("add", "or", "xor"):
            return b
        if ca == 0 and op in ("shl", "lshr", "ashr", "mul", "and"):
            return self.const(0)
        if cb == 0 and op in ("mul", "and"):
            return self.const(0)
        if (cb == 1 and op == "mul") or (cb == -1 and op == "and"):
            return a
        if (ca == 1 and op == "mul") or (ca == -1 and op == "and"):
            return b
        return self._emit(op, (a, b))

    def cmp(self, op: str, a: int, b: int) -> int:
        ca, cb = self._const_of(a), self._const_of(b)
        if ca is not None and cb is not None:
            return self._emit("bconst", value=int(eval_cmp(op, ca, cb)))
        return self._emit(op, (a, b))

    def select(self, cond: int, a: int, b: int) -> int:
        c = self.nodes[cond]
        if c.op == "bconst":
            return a if c.value else b
        return self._emit("select", (cond, a, b))

    def load(self, addr: int) -> int:
        return self._emit("load", (addr,))

    def store(self, addr: int, val: int) -> None:
        self.stores.append(self._emit("store", (addr, val), cse=False))


class ConcreteSession:
    """Executes the same operations on plain int32 values against a real
    memory list — the plain-Python reference of the co-simulation."""

    mode = "concrete"

    def __init__(self, mem: List[int]):
        self.mem = mem

    def const(self, v: int) -> int:
        return s32(v)

    def binop(self, op: str, a: int, b: int) -> int:
        return eval_binop(op, a, b)

    def cmp(self, op: str, a: int, b: int) -> bool:
        return eval_cmp(op, a, b)

    def select(self, cond: bool, a: int, b: int) -> int:
        return a if cond else b

    def _check(self, addr: int) -> int:
        if not 0 <= addr < len(self.mem):
            raise TraceError(f"memory address {addr} outside [0, {len(self.mem)})")
        return addr

    def load(self, addr: int) -> int:
        return s32(self.mem[self._check(addr)])

    def store(self, addr: int, val: int) -> None:
        self.mem[self._check(addr)] = s32(val)


def _wrap32_arr(x) -> np.ndarray:
    """Vectorized :func:`~repro_torch.frontend.ir.s32` on int64 arrays."""
    x = np.asarray(x, np.int64) & ((1 << 32) - 1)
    return x - ((x >= (1 << 31)).astype(np.int64) << 32)


class BatchedSession:
    """Executes the body on batched int64 arrays against a (B, M) memory —
    the vectorized reference of the co-simulation.

    Operand refs are int64 scalars/arrays holding wrapped int32 values:
    constants and induction carries stay 0-d (one address computation per
    batch), data touched by loads becomes (B,).  Semantics mirror
    :class:`ConcreteSession` / ``repro_torch.frontend.ir.eval_binop`` bit for
    bit — the fxpmul product is exact-wide, comparisons test the wrapped
    32-bit difference.  Loads and stores accept 0-d addresses (the traced
    kernels compute every address from induction carries) and (B,) ones.
    """

    mode = "concrete"

    def __init__(self, mems: np.ndarray):
        mems = np.asarray(mems, np.int64)
        if mems.ndim == 1:
            mems = mems[None, :]
        self.mems = _wrap32_arr(mems)
        self.batch = self.mems.shape[0]

    def const(self, v: int):
        return s32(v)

    def binop(self, op: str, a, b):
        a = np.asarray(a, np.int64)
        b = np.asarray(b, np.int64)
        if op == "add":
            return _wrap32_arr(a + b)
        if op == "sub":
            return _wrap32_arr(a - b)
        if op == "mul":
            return _wrap32_arr(a * b)
        if op == "fxpmul":
            return _wrap32_arr((a * b) >> FXP_FRAC_BITS)
        if op == "and":
            return _wrap32_arr(a & b)
        if op == "or":
            return _wrap32_arr(a | b)
        if op == "xor":
            return _wrap32_arr(a ^ b)
        if op == "shl":
            return _wrap32_arr(a << (b & 31))
        if op == "lshr":
            return _wrap32_arr((a & ((1 << 32) - 1)) >> (b & 31))
        if op == "ashr":
            return _wrap32_arr(a >> (b & 31))
        raise ValueError(f"unknown binary IR op {op!r}")

    def cmp(self, op: str, a, b):
        d = _wrap32_arr(np.asarray(a, np.int64) - np.asarray(b, np.int64))
        if op == "lt":
            return d < 0
        if op == "ge":
            return d >= 0
        if op == "eq":
            return d == 0
        if op == "ne":
            return d != 0
        raise ValueError(f"unknown compare IR op {op!r}")

    def select(self, cond, a, b):
        return np.where(cond, np.asarray(a, np.int64),
                        np.asarray(b, np.int64))

    def _check(self, addr) -> np.ndarray:
        addr = np.asarray(addr, np.int64)
        size = self.mems.shape[1]
        if ((addr < 0) | (addr >= size)).any():
            off = int(np.asarray(addr).ravel()[0]) if addr.ndim == 0 \
                else int(addr[((addr < 0) | (addr >= size))][0])
            raise TraceError(f"memory address {off} outside [0, {size})")
        return addr

    def load(self, addr):
        addr = self._check(addr)
        if addr.ndim == 0:
            return self.mems[:, addr]
        return self.mems[np.arange(self.batch), addr]

    def store(self, addr, val) -> None:
        addr = self._check(addr)
        val = np.broadcast_to(_wrap32_arr(val), (self.batch,))
        if addr.ndim == 0:
            self.mems[:, addr] = val
        else:
            self.mems[np.arange(self.batch), addr] = val


Session = Union[GraphSession, ConcreteSession, BatchedSession]


# ---------------------------------------------------------------------------
# symbolic operands
# ---------------------------------------------------------------------------


class SymValue:
    """A traced operand.  ``kind`` is ``"data"`` for 32-bit values and
    ``"cond"`` for comparison results (consumable only by :func:`where`)."""

    __slots__ = ("sess", "ref", "kind")

    def __init__(self, sess: Session, ref, kind: str = "data"):
        self.sess = sess
        self.ref = ref
        self.kind = kind

    # -- lifting ----------------------------------------------------------------

    def _lift(self, other) -> "SymValue":
        return lift(self.sess, other)

    def _data_ref(self):
        if self.kind != "data":
            raise TraceError(
                "a comparison result is not a 32-bit value; use "
                "where(cond, a, b) to turn it into one"
            )
        return self.ref

    # -- arithmetic -------------------------------------------------------------

    def _bin(self, other, op: str, swap: bool = False) -> "SymValue":
        o = self._lift(other)
        a, b = o._data_ref(), self._data_ref()
        if not swap:
            a, b = b, a
        return SymValue(self.sess, self.sess.binop(op, a, b))

    def __add__(self, other):
        return self._bin(other, "add")

    def __radd__(self, other):
        return self._bin(other, "add", swap=True)

    def __sub__(self, other):
        return self._bin(other, "sub")

    def __rsub__(self, other):
        return self._bin(other, "sub", swap=True)

    def __mul__(self, other):
        return self._bin(other, "mul")

    def __rmul__(self, other):
        return self._bin(other, "mul", swap=True)

    def __and__(self, other):
        return self._bin(other, "and")

    def __rand__(self, other):
        return self._bin(other, "and", swap=True)

    def __or__(self, other):
        return self._bin(other, "or")

    def __ror__(self, other):
        return self._bin(other, "or", swap=True)

    def __xor__(self, other):
        return self._bin(other, "xor")

    def __rxor__(self, other):
        return self._bin(other, "xor", swap=True)

    def __lshift__(self, other):
        return self._bin(other, "shl")

    def __rlshift__(self, other):
        return self._bin(other, "shl", swap=True)

    def __rshift__(self, other):
        """Arithmetic shift, matching Python's ``>>`` on signed ints."""
        return self._bin(other, "ashr")

    def __rrshift__(self, other):
        return self._bin(other, "ashr", swap=True)

    def lshr(self, other) -> "SymValue":
        """Logical (zero-filling) right shift — no Python operator spells
        this, so it is a method."""
        return self._bin(other, "lshr")

    def __neg__(self):
        return SymValue(
            self.sess, self.sess.binop("sub", self.sess.const(0), self._data_ref())
        )

    def __invert__(self):
        return SymValue(
            self.sess, self.sess.binop("xor", self._data_ref(), self.sess.const(-1))
        )

    # -- comparisons ------------------------------------------------------------

    def _cmp(self, other, op: str, swap: bool = False) -> "SymValue":
        o = self._lift(other)
        a, b = self._data_ref(), o._data_ref()
        if swap:
            a, b = b, a
        return SymValue(self.sess, self.sess.cmp(op, a, b), kind="cond")

    def __lt__(self, other):
        return self._cmp(other, "lt")

    def __ge__(self, other):
        return self._cmp(other, "ge")

    def __gt__(self, other):  # a > b  ==  b < a
        return self._cmp(other, "lt", swap=True)

    def __le__(self, other):  # a <= b  ==  b >= a
        return self._cmp(other, "ge", swap=True)

    def __eq__(self, other):  # noqa: traced equality returns a condition
        return self._cmp(other, "eq")

    def __ne__(self, other):
        return self._cmp(other, "ne")

    __hash__ = None  # type: ignore[assignment]

    # -- untraceable constructs -------------------------------------------------

    def __bool__(self):
        raise TraceError(
            "data-dependent control flow (if/while on a traced value) is not "
            "traceable; use where(cond, a, b) instead"
        )

    def __index__(self):
        raise TraceError("a traced value cannot be used as a Python index")

    def _no_div(self, *_a, **_k):
        raise TraceError("the Table-5 ISA has no divider; division/modulo "
                         "are not traceable")

    __truediv__ = __rtruediv__ = __floordiv__ = __rfloordiv__ = _no_div
    __mod__ = __rmod__ = __pow__ = __rpow__ = _no_div


def lift(sess: Session, x) -> SymValue:
    """Wrap a Python int as a traced constant; pass traced values through."""
    if isinstance(x, SymValue):
        if x.sess is not sess:
            raise TraceError("operands from different trace sessions")
        return x
    if isinstance(x, bool) or not isinstance(x, (int, np.integer)):
        raise TraceError(
            f"only 32-bit integers are traceable, got {type(x).__name__} "
            "(floats and nested loops are known front-end gaps)"
        )
    return SymValue(sess, sess.const(int(x)))


def where(cond: SymValue, a, b) -> SymValue:
    """Data-dependent select: ``a`` where ``cond`` holds, else ``b``."""
    if not isinstance(cond, SymValue) or cond.kind != "cond":
        raise TraceError("where() needs a traced comparison as its condition")
    av = lift(cond.sess, a)
    bv = lift(cond.sess, b)
    return SymValue(
        cond.sess, cond.sess.select(cond.ref, av._data_ref(), bv._data_ref())
    )


def minimum(a, b) -> SymValue:
    x = a if isinstance(a, SymValue) else b
    return where(lift(x.sess, a) < b, a, b)


def maximum(a, b) -> SymValue:
    x = a if isinstance(a, SymValue) else b
    return where(lift(x.sess, a) < b, b, a)


def clamp(x: SymValue, lo: int, hi: int) -> SymValue:
    return minimum(maximum(x, lo), hi)


def absolute(x: SymValue) -> SymValue:
    return where(x < 0, -x, x)


def fxpmul(a, b) -> SymValue:
    """Q16.16 fixed-point multiply (lowered to the FXPMUL opcode)."""
    x = a if isinstance(a, SymValue) else b
    if not isinstance(x, SymValue):
        raise TraceError("fxpmul needs at least one traced operand")
    av, bv = lift(x.sess, a), lift(x.sess, b)
    return SymValue(x.sess, x.sess.binop("fxpmul", av._data_ref(), bv._data_ref()))


# ---------------------------------------------------------------------------
# state / memory proxies
# ---------------------------------------------------------------------------


class LoopState:
    """Attribute proxy over the declared carries.  Reads yield the current
    binding (the previous iteration's value until the first write); writes
    rebind, and the final binding becomes the carry update."""

    def __init__(self, sess: Session, bindings: Dict[str, SymValue]):
        object.__setattr__(self, "_sess", sess)
        object.__setattr__(self, "_bindings", bindings)

    def __getattr__(self, name: str) -> SymValue:
        bindings = object.__getattribute__(self, "_bindings")
        if name not in bindings:
            raise TraceError(f"read of undeclared carry {name!r}; declare it "
                             "in LoopSpec.carries")
        return bindings[name]

    def __setattr__(self, name: str, value) -> None:
        bindings = object.__getattribute__(self, "_bindings")
        if name not in bindings:
            raise TraceError(f"write to undeclared carry {name!r}; declare it "
                             "in LoopSpec.carries")
        sess = object.__getattribute__(self, "_sess")
        v = lift(sess, value)
        v._data_ref()  # conditions cannot be carried
        bindings[name] = v


class SymMem:
    """Word-addressed view of the shared data memory."""

    def __init__(self, sess: Session):
        self._sess = sess

    def _addr(self, addr):
        return lift(self._sess, addr)._data_ref()

    def __getitem__(self, addr) -> SymValue:
        return SymValue(self._sess, self._sess.load(self._addr(addr)))

    def __setitem__(self, addr, value) -> None:
        v = lift(self._sess, value)
        self._sess.store(self._addr(addr), v._data_ref())


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

Body = Callable[[LoopState, SymMem], None]


def trace_kernel(spec: LoopSpec, body: Body) -> Trace:
    """Run ``body`` once under symbolic operands and return the recorded
    SSA graph."""
    sess = GraphSession()
    carries: List[CarryDef] = []
    bindings: Dict[str, SymValue] = {}
    for name, init in spec.carries.items():
        leaf = sess.carry(name)
        carries.append(CarryDef(name=name, init=s32(init), leaf=leaf))
        bindings[name] = SymValue(sess, leaf)
    body(LoopState(sess, bindings), SymMem(sess))
    for cd in carries:
        cd.update = bindings[cd.name]._data_ref()
    results = {name: bindings[name].ref for name in spec.result_names()}
    return Trace(
        name=spec.name,
        trip=spec.trip,
        nodes=sess.nodes,
        carries=carries,
        stores=sess.stores,
        results=results,
    )


def python_reference(
    spec: LoopSpec, body: Body, mem: Sequence[int]
) -> Tuple[Dict[str, int], List[int]]:
    """Execute ``body`` for ``spec.trip`` iterations on concrete int32
    values.  Returns (result carry values, final memory image) — the
    reference side of the differential co-simulation."""
    mem_list = [s32(int(v)) for v in mem]
    sess = ConcreteSession(mem_list)
    vals: Dict[str, int] = {n: s32(i) for n, i in spec.carries.items()}
    for _ in range(spec.trip):
        bindings = {n: SymValue(sess, v) for n, v in vals.items()}
        body(LoopState(sess, bindings), SymMem(sess))
        vals = {n: bindings[n].ref for n in vals}
    return {n: vals[n] for n in spec.result_names()}, mem_list


def batched_reference(
    spec: LoopSpec, body: Body, mems: np.ndarray
) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Execute ``body`` for ``spec.trip`` iterations over a whole (B, M)
    batch of memories at once.  Returns (result carries as (B,) int64
    arrays of wrapped int32 values, final (B, M) memory images) — the
    vectorized reference that replaced the per-seed
    :func:`python_reference` loop in the co-simulation harness."""
    sess = BatchedSession(mems)
    vals: Dict[str, object] = {n: s32(i) for n, i in spec.carries.items()}
    for _ in range(spec.trip):
        bindings = {n: SymValue(sess, v) for n, v in vals.items()}
        body(LoopState(sess, bindings), SymMem(sess))
        vals = {n: bindings[n].ref for n in vals}
    results = {
        n: np.broadcast_to(np.asarray(vals[n], np.int64),
                           (sess.batch,)).copy()
        for n in spec.result_names()
    }
    return results, sess.mems
