"""Traced loop front-end: Python loop bodies -> CIL DFGs.

A copy of ``src/repro/frontend/__init__.py``, with the same public names.
Write the loop body as a plain Python function, trace it under symbolic
operands, legalize the traced SSA graph onto the Table-5 ISA, and the
result is a :class:`~repro_torch.cgra.programs.LoopBuilder`
indistinguishable from the hand-written benchmarks — it SAT-maps,
assembles and simulates unchanged.  Every traced kernel is proven by
*differential co-simulation* (``repro_torch.frontend.verify``): the mapped
bitstream is executed on the PE-array simulator (the CUDA kernel on the
card) and compared bit-exactly against the same body run on int32 values.

Traceable subset
----------------
* 32-bit two's-complement integers only; ``+ - * & | ^ << >>`` (``>>`` is
  arithmetic, ``.lshr()`` is logical), ``~x``, ``-x``, and
  :func:`~repro_torch.frontend.tracer.fxpmul` (Q16.16)
* comparisons ``< <= > >= == !=`` produce *conditions*, consumable only by
  :func:`~repro_torch.frontend.tracer.where` (lowered to the BSFA/BZFA
  flag path); ``minimum``/``maximum``/``clamp``/``absolute`` are built on it
* loop-carried state: attributes of the state proxy declared in
  :class:`~repro_torch.frontend.tracer.LoopSpec`; reads before the first
  write see the previous iteration, the final binding becomes the next
  iteration's input
* word loads/stores on the shared data memory via the ``mem`` proxy;
  ``base + constant`` addressing folds into LWI/SWI immediates
* constants of any 32-bit width (wide ones are materialized as constant
  carries)

Known gaps
----------
* **floats** — the ISA is integer-only; ``fxpmul`` is the Q16.16 escape
  hatch
* **nested loops / data-dependent trip counts** — one innermost loop body
  per kernel; ``bool(traced value)`` raises :class:`TraceError`
* **division / modulo** — no divider in the ISA
* **fxpmul operand range** — the reference computes the exact wide
  product, but the PE array evaluates FXPMUL in int32: keep
  ``|a*b| < 2**31`` (bound your ``MemRegion`` ranges accordingly, as
  ``ema_fxp`` does) or the co-sim will report the wrap as a mismatch
* **memory aliasing** — the DFG carries no memory-ordering edges (same as
  the hand-written benchmarks): a load and a store to the same address in
  flight simultaneously is undefined; keep input and output regions
  disjoint
* comparisons use the *wrapped* 32-bit difference (what the hardware's
  SSUB flag path computes): ``a < b`` misorders operands more than
  ``2**31`` apart — bit-exactness with the reference is preserved because
  the reference uses the same rule
"""

from .ir import Trace, eval_binop, eval_cmp, s32
from .legalize import LegalizeError, legalize
from .tracer import (LoopSpec, MemRegion, TraceError, absolute, clamp,
                     fxpmul, make_mem, maximum, minimum, python_reference,
                     trace_kernel, where)
from .kernels import TRACED_KERNELS, TracedKernel, traced_kernel
from .verify import CoSimReport, cosimulate, run_all

__all__ = [
    "Trace", "eval_binop", "eval_cmp", "s32",
    "LegalizeError", "legalize",
    "LoopSpec", "MemRegion", "TraceError",
    "absolute", "clamp", "fxpmul", "make_mem", "maximum", "minimum",
    "python_reference", "trace_kernel", "where",
    "TRACED_KERNELS", "TracedKernel", "traced_kernel",
    "CoSimReport", "cosimulate", "run_all",
]
