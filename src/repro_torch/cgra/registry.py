"""One shared CIL-kernel registry for every consumer of the port.

A copy of ``src/repro/cgra/registry.py``.  Two modules register kernels
as an import side effect:

* :mod:`repro_torch.cgra.programs`, the hand-written Table-6 benchmarks;
* :mod:`repro_torch.frontend.kernels`, the traced kernels, legalized from
  their Python loop bodies by the port's own front-end.

:func:`ensure_registered` imports both, in that order, so the registry
names the same kernels in the same order as the JAX package's.  Each
entry carries the kernel *factory* (a fresh
:class:`~repro_torch.cgra.programs.LoopBuilder` per call) plus the
randomized input-memory generator.

Kernels come in suites (:class:`Suite`): the default one, whose names
and order are the JAX package's, and port-only suites of the same loops
at an application's length, whose kernels carry their suite's suffix
(``gsm_f160``).  :func:`kernel_names` lists one suite, the default one
unless asked; :func:`get_kernel` finds a kernel of any suite.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

# modules that register kernels as an import side effect
_PROVIDERS = (".programs", "..frontend.kernels")

ORIGINS = ("handwritten", "traced")


@dataclass(frozen=True)
class Suite:
    """Where a suite's loops keep their data: ``trip`` iterations, the
    first input at word 0, a second input at ``second``, the outputs at
    ``out``, in an image of ``mem_words`` words.  Its kernels are the
    default suite's names with ``suffix``."""

    name: str
    trip: int
    second: int
    out: int
    mem_words: int
    suffix: str

    def kernel(self, base: str) -> str:
        """The suite's name for the loop ``base``."""
        return base + self.suffix


#: the JAX package's suite: 16 iterations over a 128-word image
DEFAULT_SUITE = Suite("default", trip=16, second=32, out=64, mem_words=128,
                      suffix="")
#: one speech frame of GSM 06.10 a call (160 samples: 20 ms at 8 kHz),
#: over a 512-word image; port-only
FRAME160 = Suite("frame160", trip=160, second=168, out=336, mem_words=512,
                 suffix="_f160")
SUITES: Dict[str, Suite] = {s.name: s for s in (DEFAULT_SUITE, FRAME160)}


def _default_mem(seed: int = 0) -> np.ndarray:
    """Fallback input image: 32 random words in a 128-word memory."""
    rng = np.random.RandomState(seed)
    mem = np.zeros(128, np.int32)
    mem[0:32] = rng.randint(0, 2**30, 32)
    return mem


@dataclass(frozen=True)
class KernelSpec:
    """A registered CIL kernel: how to build it and how to feed it."""

    name: str
    factory: Callable  # () -> LoopBuilder
    origin: str  # "handwritten" | "traced"
    make_mem: Callable[[int], np.ndarray] = _default_mem  # seed -> (M,) int32
    tags: Tuple[str, ...] = field(default_factory=tuple)
    suite: str = DEFAULT_SUITE.name

    @property
    def mem_words(self) -> int:
        """Words of the kernel's memory image (its suite's)."""
        return SUITES[self.suite].mem_words


_REGISTRY: Dict[str, KernelSpec] = {}
_ensured = False


def register_kernel(
    name: str,
    factory: Callable,
    *,
    origin: str,
    make_mem: Optional[Callable[[int], np.ndarray]] = None,
    tags: Tuple[str, ...] = (),
    replace: bool = False,
    suite: str = DEFAULT_SUITE.name,
) -> KernelSpec:
    if origin not in ORIGINS:
        raise ValueError(f"unknown origin {origin!r}; expected one of {ORIGINS}")
    if suite not in SUITES:
        raise ValueError(f"unknown suite {suite!r}; expected one of "
                         f"{tuple(SUITES)}")
    if name in _REGISTRY and not replace:
        raise ValueError(f"kernel {name!r} already registered "
                         f"(origin={_REGISTRY[name].origin})")
    spec = KernelSpec(name=name, factory=factory, origin=origin,
                      make_mem=make_mem or _default_mem, tags=tuple(tags),
                      suite=suite)
    _REGISTRY[name] = spec
    return spec


def ensure_registered() -> None:
    """Import every provider module exactly once (idempotent).

    Only latches after *all* providers imported cleanly — a failing
    provider keeps raising on every call instead of leaving later callers
    with a silently shrunken registry."""
    global _ensured
    if _ensured:
        return
    for mod in _PROVIDERS:
        importlib.import_module(mod, __package__)
    _ensured = True


def get_kernel(name: str) -> KernelSpec:
    ensure_registered()
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown kernel {name!r}; registered: {kernel_names()}")
    return _REGISTRY[name]


def kernel_names(origin: Optional[str] = None,
                 suite: str = DEFAULT_SUITE.name) -> List[str]:
    """Registration-ordered kernel names of one suite, optionally filtered
    by origin."""
    ensure_registered()
    return [n for n, s in _REGISTRY.items()
            if s.suite == suite and (origin is None or s.origin == origin)]


def is_registered(name: str) -> bool:
    """Whether ``name`` is a kernel of any suite."""
    ensure_registered()
    return name in _REGISTRY


def kernel_factories(origin: Optional[str] = None) -> Dict[str, Callable]:
    """name -> LoopBuilder factory (the shape BENCHMARKS used to have)."""
    ensure_registered()
    return {n: _REGISTRY[n].factory for n in kernel_names(origin)}


def kernel_program(name: str):
    """Instantiate a fresh LoopBuilder for ``name``."""
    return get_kernel(name).factory()


def make_mem(name: str, seed: int = 0) -> np.ndarray:
    """The registered randomized input-memory image for one seed."""
    return get_kernel(name).make_mem(seed)
