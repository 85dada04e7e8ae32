"""Traced kernels: plain Python loop bodies compiled through the front-end.

A copy of ``src/repro/frontend/kernels.py``, with its 11 bodies in the same
registration order.  Each kernel is a ``body(s, mem)`` function plus a
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

from ..cgra.registry import register_kernel
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

N = 16  # common trip count; inputs live in [0, 64), outputs at [64, ...)


@traced_kernel(LoopSpec(
    name="dotprod", trip=N, carries={"i": 0, "acc": 0}, results=("acc",),
    index="i", loop_control=True,
    mem_regions=(MemRegion(0, N, -(2**15), 2**15),
                 MemRegion(32, N, -(2**15), 2**15))))
def dotprod(s, mem):
    """acc += x[i] * y[i]"""
    s.acc = s.acc + mem[s.i] * mem[s.i + 32]
    s.i = s.i + 1


@traced_kernel(LoopSpec(
    name="fir4", trip=N, carries={"i": 0}, results=(),
    mem_regions=(MemRegion(0, N + 3, -(2**12), 2**12),)))
def fir4(s, mem):
    """4-tap FIR with immediate coefficients; y[i] at 64+i."""
    y = mem[s.i] * 5 - mem[s.i + 1] * 3 + mem[s.i + 2] * 7 + mem[s.i + 3] * 2
    mem[s.i + 64] = y
    s.i = s.i + 1


@traced_kernel(LoopSpec(
    name="saxpy", trip=N, carries={"i": 0},
    mem_regions=(MemRegion(0, N, -(2**13), 2**13),
                 MemRegion(32, N, -(2**13), 2**13))))
def saxpy(s, mem):
    """y'[i] = 13*x[i] + y[i] (read at 32+i, written to 64+i)."""
    mem[s.i + 64] = 13 * mem[s.i] + mem[s.i + 32]
    s.i = s.i + 1


@traced_kernel(LoopSpec(
    name="prefix_sum", trip=N, carries={"i": 0, "acc": 0}, results=("acc",),
    mem_regions=(MemRegion(0, N, 0, 2**20),)))
def prefix_sum(s, mem):
    """Inclusive scan: out[i] = x[0] + ... + x[i]."""
    s.acc = s.acc + mem[s.i]
    mem[s.i + 64] = s.acc
    s.i = s.i + 1


@traced_kernel(LoopSpec(
    name="relu_clamp", trip=N, carries={"i": 0},
    mem_regions=(MemRegion(0, N, -512, 512),)))
def relu_clamp(s, mem):
    """out[i] = clamp(x[i], 0, 255) — two chained flag-selects."""
    v = mem[s.i]
    v = where(v < 0, 0, v)
    v = where(v > 255, 255, v)
    mem[s.i + 64] = v
    s.i = s.i + 1


@traced_kernel(LoopSpec(
    name="popcount", trip=N, carries={"i": 0, "acc": 0}, results=("acc",),
    mem_regions=(MemRegion(0, N, -(2**31), 2**31 - 1),)))
def popcount(s, mem):
    """SWAR popcount per word — exercises wide-constant materialization."""
    v = mem[s.i]
    v = v - (v.lshr(1) & 0x55555555)
    v = (v & 0x33333333) + (v.lshr(2) & 0x33333333)
    v = (v + v.lshr(4)) & 0x0F0F0F0F
    v = (v * 0x01010101).lshr(24)
    s.acc = s.acc + v
    s.i = s.i + 1


@traced_kernel(LoopSpec(
    name="stencil3", trip=N, carries={"i": 0},
    mem_regions=(MemRegion(0, N + 2, 0, 2**12),)))
def stencil3(s, mem):
    """out[i] = (x[i] + 2*x[i+1] + x[i+2] + 2) >> 2"""
    acc = mem[s.i] + (mem[s.i + 1] << 1) + mem[s.i + 2] + 2
    mem[s.i + 64] = acc >> 2
    s.i = s.i + 1


@traced_kernel(LoopSpec(
    name="argmax", trip=N,
    carries={"i": 0, "best": -(2**24), "besti": 0},
    results=("best", "besti"),
    mem_regions=(MemRegion(0, N, -(2**20), 2**20),)))
def argmax(s, mem):
    """Running maximum and its index; one compare feeds two selects.

    Written delta-style (``best += max(delta, 0)``) so the load has a
    single consumer: the naive two-``where`` form makes the load feed both
    duplicated flag compares while the best-select feeds one of them too —
    an adjacency *triangle*, and the torus interconnect is bipartite, so
    that shape is unmappable at any II.  ``best`` starts at ``-2**24`` (not
    INT_MIN): the flag compare sees the wrapped difference, and INT_MIN
    minus a positive sample would wrap positive.
    """
    delta = mem[s.i] - s.best
    is_new = delta > 0
    s.best = s.best + where(is_new, delta, 0)
    s.besti = where(is_new, s.i, s.besti)
    s.i = s.i + 1


@traced_kernel(LoopSpec(
    name="sad", trip=N, carries={"i": 0, "acc": 0}, results=("acc",),
    index="i", loop_control=True,
    mem_regions=(MemRegion(0, N, -(2**14), 2**14),
                 MemRegion(32, N, -(2**14), 2**14))))
def sad(s, mem):
    """Sum of absolute differences."""
    s.acc = s.acc + absolute(mem[s.i] - mem[s.i + 32])
    s.i = s.i + 1


@traced_kernel(LoopSpec(
    name="xorshift32", trip=N, carries={"i": 0, "x": 0x2545F491},
    results=("x",),
    mem_regions=()))
def xorshift32(s, mem):
    """Marsaglia xorshift PRNG — a pure recurrence chain (RecII-bound)
    with read-after-write carry rebinding inside the body."""
    s.x = s.x ^ (s.x << 13)
    s.x = s.x ^ s.x.lshr(17)
    s.x = s.x ^ (s.x << 5)
    mem[s.i + 64] = s.x
    s.i = s.i + 1


@traced_kernel(LoopSpec(
    name="ema_fxp", trip=N, carries={"i": 0, "ema": 0}, results=("ema",),
    mem_regions=(MemRegion(0, N, -(2**15), 2**15),)))
def ema_fxp(s, mem):
    """Q16.16 exponential moving average: ema = 0.75*ema + 0.25*x[i]."""
    s.ema = fxpmul(s.ema, 49152) + fxpmul(mem[s.i], 16384)
    mem[s.i + 64] = s.ema
    s.i = s.i + 1
