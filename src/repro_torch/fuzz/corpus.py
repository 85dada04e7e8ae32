"""Deterministic seeded memory corpora, one generator family per kernel.

A copy of ``src/repro/fuzz/corpus.py``.  A kernel is named either by
its registry name, whose input regions, FXPMUL clip flag and image size
come from the registry as in the JAX package, or by an artifact, which
stores all three; the two give byte-identical images.  Memory ``i`` of a
corpus uses ``STRATEGIES[i % 5]`` with an RNG derived only from
``(kernel, base_seed, i)`` via crc32:

* ``uniform``  every region cell uniform in its declared ``[lo, hi)``
* ``boundary`` region bounds, +-1, 0 and the 16-bit immediate extremes
* ``sparse``   mostly zero, a few uniform cells
* ``fill``     all-zero / all-ones images alternating per index
* ``overflow`` int32 extremes and full-range values

Kernels containing FXPMUL get their extremes clipped into the declared
range, where the executors' int32 product agrees with the exact oracle.
"""
from __future__ import annotations

import functools
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..cgra.artifact import Artifact
from ..cgra.isa import IMM_MAX, IMM_MIN
from ..cgra.registry import DEFAULT_SUITE, FRAME160, Suite, get_kernel

INT32_MIN = -(1 << 31)
INT32_MAX = (1 << 31) - 1

STRATEGIES: Tuple[str, ...] = (
    "uniform", "boundary", "sparse", "fill", "overflow")

MEM_SIZE = DEFAULT_SUITE.mem_words


@dataclass(frozen=True)
class Region:
    """``length`` words at ``base``, values drawn from ``[lo, hi)``."""

    base: int
    length: int
    lo: int = 0
    hi: int = 1 << 30


def _gsm_regions(suite: Suite) -> Tuple[Region, ...]:
    return (Region(0, suite.trip, -(2 ** 14), 2 ** 14),
            Region(suite.second, suite.trip, -(2 ** 14), 2 ** 14))


#: input layouts of the hand-written Table-6 benchmarks, mirroring
#: ``repro_torch.cgra.programs.benchmark_mem`` (which only exposes a callable)
_HANDWRITTEN_REGIONS: Dict[str, Tuple[Region, ...]] = {
    "stringsearch": (Region(0, 16, 0, 8), Region(32, 16, 0, 8),
                     Region(48, 16, 0, 8)),
    "gsm": _gsm_regions(DEFAULT_SUITE),
    FRAME160.kernel("gsm"): _gsm_regions(FRAME160),
}
_DEFAULT_REGIONS: Tuple[Region, ...] = (Region(0, 32, 0, 2 ** 30),)


@functools.lru_cache(maxsize=None)
def kernel_regions(name: str) -> Tuple[Region, ...]:
    """The randomized input regions of one registry kernel."""
    spec = get_kernel(name)
    if spec.origin == "traced":
        from ..frontend.kernels import TRACED_SUITES

        mem_regions = TRACED_SUITES[spec.suite][name].spec.mem_regions
        return tuple(Region(r.base, r.length, r.lo, r.hi)
                     for r in mem_regions)
    return _HANDWRITTEN_REGIONS.get(name, _DEFAULT_REGIONS)


@functools.lru_cache(maxsize=None)
def uses_wide_product(name: str) -> bool:
    """Whether the kernel's program contains FXPMUL (the one op whose
    executors' int32 product diverges from the exact oracle outside the
    declared input range)."""
    from ..cgra.registry import kernel_program

    program = kernel_program(name)
    return any(n.op == "FXPMUL" for n in program.nodes)


Kernel = Union[str, Artifact]


def _layout(kernel: Kernel) -> Tuple[str, Tuple[Region, ...], bool]:
    """(name, input regions, clip flag) of a registry name or artifact."""
    if isinstance(kernel, Artifact):
        return (kernel.kernel, tuple(Region(*r) for r in kernel.regions),
                kernel.wide_product)
    return kernel, kernel_regions(kernel), uses_wide_product(kernel)


def kernel_mem_words(kernel: Kernel) -> int:
    """Words of the memory image of a registry name or an artifact."""
    if isinstance(kernel, Artifact):
        return kernel.mem_words
    return get_kernel(kernel).mem_words


def _rng(kernel: str, seed: int, index: int) -> np.random.RandomState:
    """Process-stable per-memory RNG (crc32 mix, never ``hash``)."""
    tag = zlib.crc32(f"{kernel}/{seed}/{index}".encode())
    return np.random.RandomState(tag & 0x7FFFFFFF)


def _pool(region: Region, clip: bool, extremes: Sequence[int]) -> np.ndarray:
    vals = [region.lo, region.hi - 1, 0, 1, -1, *extremes]
    if clip:
        vals = [min(max(v, region.lo), region.hi - 1) for v in vals]
    return np.array(sorted(set(vals)), dtype=np.int64)


def _fill_regions(mem: np.ndarray, regions: Sequence[Region], draw) -> None:
    for r in regions:
        mem[r.base:r.base + r.length] = draw(r)


def generate_memory(kernel: Kernel, index: int, seed: int = 0,
                    strategy: Optional[str] = None,
                    mem_size: Optional[int] = None) -> np.ndarray:
    """One deterministic (mem_size,) int32 image for corpus slot ``index``
    (``mem_size``: the kernel's own image by default)."""
    if mem_size is None:
        mem_size = kernel_mem_words(kernel)
    strategy = strategy or STRATEGIES[index % len(STRATEGIES)]
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown corpus strategy {strategy!r}; "
                         f"expected one of {STRATEGIES}")
    name, regions, clip = _layout(kernel)
    rng = _rng(name, seed, index)
    mem = np.zeros(mem_size, np.int64)

    if strategy == "uniform":
        _fill_regions(mem, regions,
                      lambda r: rng.randint(r.lo, r.hi, r.length,
                                            dtype=np.int64))
    elif strategy == "boundary":
        _fill_regions(
            mem, regions,
            lambda r: rng.choice(_pool(r, clip, (IMM_MIN, IMM_MAX)),
                                 r.length))
    elif strategy == "sparse":
        def sparse(r: Region) -> np.ndarray:
            vals = np.zeros(r.length, np.int64)
            hot = rng.rand(r.length) < 0.125
            vals[hot] = rng.randint(r.lo, r.hi, int(hot.sum()),
                                    dtype=np.int64)
            return vals
        _fill_regions(mem, regions, sparse)
    elif strategy == "fill":
        word = 0 if (index // len(STRATEGIES)) % 2 == 0 else -1
        _fill_regions(
            mem, regions,
            lambda r: np.full(r.length,
                              min(max(word, r.lo), r.hi - 1) if clip
                              else word, np.int64))
    else:  # overflow
        _fill_regions(
            mem, regions,
            lambda r: rng.choice(
                _pool(r, clip, (INT32_MIN, INT32_MAX, INT32_MIN + 1,
                                0x55555555, -0x55555556)), r.length)
            if clip or rng.rand() < 0.5
            else rng.randint(INT32_MIN, INT32_MAX, r.length,
                             dtype=np.int64))
    return mem.astype(np.int32)


def make_corpus(kernel: Kernel, n: int, seed: int = 0,
                strategies: Optional[Sequence[str]] = None,
                mem_size: Optional[int] = None) -> np.ndarray:
    """(n, mem_size) int32 corpus; row ``i`` uses strategy ``i % len``.
    ``mem_size`` defaults to the kernel's own image (``kernel_mem_words``:
    128 words but in a port-only suite)."""
    if mem_size is None:
        mem_size = kernel_mem_words(kernel)
    chosen = tuple(strategies) if strategies else STRATEGIES
    for s in chosen:
        if s not in STRATEGIES:
            raise ValueError(f"unknown corpus strategy {s!r}; "
                             f"expected one of {STRATEGIES}")
    rows: List[np.ndarray] = [
        generate_memory(kernel, i, seed=seed,
                        strategy=chosen[i % len(chosen)],
                        mem_size=mem_size)
        for i in range(n)]
    return (np.stack(rows) if rows
            else np.zeros((0, mem_size), np.int32))
