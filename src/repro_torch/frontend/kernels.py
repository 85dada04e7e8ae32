"""Traced kernels: plain Python loop bodies compiled through the front-end.

A copy of ``src/repro/frontend/kernels.py``, with its 11 bodies in the same
registration order, each written over a suite's trip count and data layout
(``TRACED_SUITES``; the default suite's are ``TRACED_KERNELS``).  Each
kernel is a ``body(s, mem)`` function plus a
:class:`LoopSpec`; the ``@traced_kernel`` decorator traces it once,
legalizes it onto the Table-5 ISA on demand, and registers it in the
port's kernel registry (``repro_torch.cgra.registry``) — which is how
traced kernels show up in mapping, fuzzing and the co-simulation harness.

The suite roughly doubles the sweepable workload set and deliberately
covers every front-end lowering path: immediate folding (fir4, stencil3),
wide-constant materialization (popcount, ema_fxp, argmax's INT_MIN),
flag-select lowering with compare duplication (relu_clamp, argmax, sad),
pure recurrence chains (xorshift32), read-after-write carry rebinding
(xorshift32), loads at computed offsets and stores (most), and FXPMUL
(ema_fxp).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..cgra.registry import DEFAULT_SUITE, SUITES, Suite, register_kernel
from .ir import Trace
from .legalize import legalize
from .tracer import (Body, LoopSpec, MemRegion, absolute, fxpmul, make_mem,
                     python_reference, trace_kernel, where)


class TracedKernel:
    """A (spec, body) pair: trace lazily, legalize per call, co-sim ready."""

    def __init__(self, spec: LoopSpec, body: Body):
        self.spec = spec
        self.body = body
        self._trace: Optional[Trace] = None

    @property
    def name(self) -> str:
        return self.spec.name

    def trace(self) -> Trace:
        if self._trace is None:
            self._trace = trace_kernel(self.spec, self.body)
        return self._trace

    def build(self):
        """A fresh legalized LoopBuilder (the registry factory)."""
        return legalize(self.trace(), self.spec)

    def reference(self, mem) -> Tuple[Dict[str, int], List[int]]:
        """Plain-Python execution: (result carries, final memory)."""
        return python_reference(self.spec, self.body, mem)

    def make_mem(self, seed: int = 0) -> np.ndarray:
        return make_mem(self.spec, seed)


TRACED_KERNELS: Dict[str, TracedKernel] = {}


def traced_kernel(spec: LoopSpec) -> Callable[[Body], TracedKernel]:
    """Decorator: wrap a loop body and auto-register it as a kernel."""

    def deco(body: Body) -> TracedKernel:
        tk = TracedKernel(spec, body)
        TRACED_KERNELS[spec.name] = tk
        register_kernel(spec.name, tk.build, origin="traced",
                        make_mem=tk.make_mem, tags=("frontend",))
        return tk

    return deco


# ---------------------------------------------------------------------------
# the kernel suite
# ---------------------------------------------------------------------------
#
# Each loop is written once, over a suite (``repro_torch.cgra.registry.
# Suite``): its trip count N, the first input at word 0, a second input at
# ``L.second``, the outputs at ``L.out``, in an image of ``L.mem_words``
# words.  The default suite (N = 16, 0 / 32 / 64 in 128 words) gives the
# JAX package's kernels; the frame suite the same loops at 160 iterations.

#: the default suite's trip count; inputs live in [0, 64), outputs at
#: [64, ...)
N = DEFAULT_SUITE.trip

#: ``make(suite) -> (spec, body)`` of every loop, in registration order
_LOOPS: List[Callable[[Suite], Tuple[LoopSpec, Body]]] = []

#: the traced kernels of each suite by name; the default suite's dict is
#: ``TRACED_KERNELS``
TRACED_SUITES: Dict[str, Dict[str, TracedKernel]] = {
    DEFAULT_SUITE.name: TRACED_KERNELS}


def _loop(make: Callable[[Suite], Tuple[LoopSpec, Body]]):
    _LOOPS.append(make)
    return make


@_loop
def dotprod(L: Suite):
    def body(s, mem):
        """acc += x[i] * y[i]"""
        s.acc = s.acc + mem[s.i] * mem[s.i + L.second]
        s.i = s.i + 1

    return LoopSpec(
        name=L.kernel("dotprod"), trip=L.trip, carries={"i": 0, "acc": 0},
        results=("acc",), index="i", loop_control=True,
        mem_size=L.mem_words,
        mem_regions=(MemRegion(0, L.trip, -(2**15), 2**15),
                     MemRegion(L.second, L.trip, -(2**15), 2**15))), body


@_loop
def fir4(L: Suite):
    def body(s, mem):
        """4-tap FIR with immediate coefficients; y[i] at out+i."""
        y = (mem[s.i] * 5 - mem[s.i + 1] * 3 + mem[s.i + 2] * 7
             + mem[s.i + 3] * 2)
        mem[s.i + L.out] = y
        s.i = s.i + 1

    return LoopSpec(
        name=L.kernel("fir4"), trip=L.trip, carries={"i": 0}, results=(),
        mem_size=L.mem_words,
        mem_regions=(MemRegion(0, L.trip + 3, -(2**12), 2**12),)), body


@_loop
def saxpy(L: Suite):
    def body(s, mem):
        """y'[i] = 13*x[i] + y[i] (read at second+i, written to out+i)."""
        mem[s.i + L.out] = 13 * mem[s.i] + mem[s.i + L.second]
        s.i = s.i + 1

    return LoopSpec(
        name=L.kernel("saxpy"), trip=L.trip, carries={"i": 0},
        mem_size=L.mem_words,
        mem_regions=(MemRegion(0, L.trip, -(2**13), 2**13),
                     MemRegion(L.second, L.trip, -(2**13), 2**13))), body


@_loop
def prefix_sum(L: Suite):
    def body(s, mem):
        """Inclusive scan: out[i] = x[0] + ... + x[i]."""
        s.acc = s.acc + mem[s.i]
        mem[s.i + L.out] = s.acc
        s.i = s.i + 1

    return LoopSpec(
        name=L.kernel("prefix_sum"), trip=L.trip, carries={"i": 0, "acc": 0},
        results=("acc",), mem_size=L.mem_words,
        mem_regions=(MemRegion(0, L.trip, 0, 2**20),)), body


@_loop
def relu_clamp(L: Suite):
    def body(s, mem):
        """out[i] = clamp(x[i], 0, 255) — two chained flag-selects."""
        v = mem[s.i]
        v = where(v < 0, 0, v)
        v = where(v > 255, 255, v)
        mem[s.i + L.out] = v
        s.i = s.i + 1

    return LoopSpec(
        name=L.kernel("relu_clamp"), trip=L.trip, carries={"i": 0},
        mem_size=L.mem_words,
        mem_regions=(MemRegion(0, L.trip, -512, 512),)), body


@_loop
def popcount(L: Suite):
    def body(s, mem):
        """SWAR popcount per word — exercises wide-constant
        materialization."""
        v = mem[s.i]
        v = v - (v.lshr(1) & 0x55555555)
        v = (v & 0x33333333) + (v.lshr(2) & 0x33333333)
        v = (v + v.lshr(4)) & 0x0F0F0F0F
        v = (v * 0x01010101).lshr(24)
        s.acc = s.acc + v
        s.i = s.i + 1

    return LoopSpec(
        name=L.kernel("popcount"), trip=L.trip, carries={"i": 0, "acc": 0},
        results=("acc",), mem_size=L.mem_words,
        mem_regions=(MemRegion(0, L.trip, -(2**31), 2**31 - 1),)), body


@_loop
def stencil3(L: Suite):
    def body(s, mem):
        """out[i] = (x[i] + 2*x[i+1] + x[i+2] + 2) >> 2"""
        acc = mem[s.i] + (mem[s.i + 1] << 1) + mem[s.i + 2] + 2
        mem[s.i + L.out] = acc >> 2
        s.i = s.i + 1

    return LoopSpec(
        name=L.kernel("stencil3"), trip=L.trip, carries={"i": 0},
        mem_size=L.mem_words,
        mem_regions=(MemRegion(0, L.trip + 2, 0, 2**12),)), body


@_loop
def argmax(L: Suite):
    def body(s, mem):
        """Running maximum and its index; one compare feeds two selects.

        Written delta-style (``best += max(delta, 0)``) so the load has a
        single consumer: the naive two-``where`` form makes the load feed
        both duplicated flag compares while the best-select feeds one of
        them too — an adjacency *triangle*, and the torus interconnect is
        bipartite, so that shape is unmappable at any II.  ``best`` starts
        at ``-2**24`` (not INT_MIN): the flag compare sees the wrapped
        difference, and INT_MIN minus a positive sample would wrap
        positive.
        """
        delta = mem[s.i] - s.best
        is_new = delta > 0
        s.best = s.best + where(is_new, delta, 0)
        s.besti = where(is_new, s.i, s.besti)
        s.i = s.i + 1

    return LoopSpec(
        name=L.kernel("argmax"), trip=L.trip,
        carries={"i": 0, "best": -(2**24), "besti": 0},
        results=("best", "besti"), mem_size=L.mem_words,
        mem_regions=(MemRegion(0, L.trip, -(2**20), 2**20),)), body


@_loop
def sad(L: Suite):
    def body(s, mem):
        """Sum of absolute differences."""
        s.acc = s.acc + absolute(mem[s.i] - mem[s.i + L.second])
        s.i = s.i + 1

    return LoopSpec(
        name=L.kernel("sad"), trip=L.trip, carries={"i": 0, "acc": 0},
        results=("acc",), index="i", loop_control=True,
        mem_size=L.mem_words,
        mem_regions=(MemRegion(0, L.trip, -(2**14), 2**14),
                     MemRegion(L.second, L.trip, -(2**14), 2**14))), body


@_loop
def xorshift32(L: Suite):
    def body(s, mem):
        """Marsaglia xorshift PRNG — a pure recurrence chain (RecII-bound)
        with read-after-write carry rebinding inside the body."""
        s.x = s.x ^ (s.x << 13)
        s.x = s.x ^ s.x.lshr(17)
        s.x = s.x ^ (s.x << 5)
        mem[s.i + L.out] = s.x
        s.i = s.i + 1

    return LoopSpec(
        name=L.kernel("xorshift32"), trip=L.trip,
        carries={"i": 0, "x": 0x2545F491}, results=("x",),
        mem_size=L.mem_words, mem_regions=()), body


@_loop
def ema_fxp(L: Suite):
    def body(s, mem):
        """Q16.16 exponential moving average: ema = 0.75*ema + 0.25*x[i]."""
        s.ema = fxpmul(s.ema, 49152) + fxpmul(mem[s.i], 16384)
        mem[s.i + L.out] = s.ema
        s.i = s.i + 1

    return LoopSpec(
        name=L.kernel("ema_fxp"), trip=L.trip, carries={"i": 0, "ema": 0},
        results=("ema",), mem_size=L.mem_words,
        mem_regions=(MemRegion(0, L.trip, -(2**15), 2**15),)), body


def _register_suite(suite: Suite) -> None:
    """Trace every loop over ``suite`` (lazily) and register it; the
    default suite through :func:`traced_kernel`, as the JAX package."""
    for make in _LOOPS:
        spec, body = make(suite)
        if suite is DEFAULT_SUITE:
            traced_kernel(spec)(body)
            continue
        tk = TracedKernel(spec, body)
        TRACED_SUITES.setdefault(suite.name, {})[spec.name] = tk
        register_kernel(spec.name, tk.build, origin="traced",
                        make_mem=tk.make_mem, tags=("frontend",),
                        suite=suite.name)


for _suite in SUITES.values():
    _register_suite(_suite)
