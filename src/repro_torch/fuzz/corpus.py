"""Deterministic seeded memory corpora, one generator family per kernel.

A copy of ``src/repro/fuzz/corpus.py`` that takes the input regions and
the FXPMUL clip flag from the artifact instead of the kernel registry, so
its images are byte-identical to the JAX package's.  Memory ``i`` of a
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

import zlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..cgra.artifact import Artifact
from ..cgra.isa import IMM_MAX, IMM_MIN

INT32_MIN = -(1 << 31)
INT32_MAX = (1 << 31) - 1

STRATEGIES: Tuple[str, ...] = (
    "uniform", "boundary", "sparse", "fill", "overflow")

MEM_SIZE = 128


@dataclass(frozen=True)
class Region:
    """``length`` words at ``base``, values drawn from ``[lo, hi)``."""

    base: int
    length: int
    lo: int = 0
    hi: int = 1 << 30


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


def generate_memory(artifact: Artifact, index: int, seed: int = 0,
                    strategy: Optional[str] = None,
                    mem_size: int = MEM_SIZE) -> np.ndarray:
    """One deterministic (mem_size,) int32 image for corpus slot ``index``."""
    strategy = strategy or STRATEGIES[index % len(STRATEGIES)]
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown corpus strategy {strategy!r}; "
                         f"expected one of {STRATEGIES}")
    regions = [Region(*r) for r in artifact.regions]
    clip = artifact.wide_product
    rng = _rng(artifact.kernel, seed, index)
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


def make_corpus(artifact: Artifact, n: int, seed: int = 0,
                strategies: Optional[Sequence[str]] = None,
                mem_size: int = MEM_SIZE) -> np.ndarray:
    """(n, mem_size) int32 corpus; row ``i`` uses strategy ``i % len``."""
    chosen = tuple(strategies) if strategies else STRATEGIES
    for s in chosen:
        if s not in STRATEGIES:
            raise ValueError(f"unknown corpus strategy {s!r}; "
                             f"expected one of {STRATEGIES}")
    rows: List[np.ndarray] = [
        generate_memory(artifact, i, seed=seed,
                        strategy=chosen[i % len(chosen)],
                        mem_size=mem_size)
        for i in range(n)]
    return (np.stack(rows) if rows
            else np.zeros((0, mem_size), np.int32))
