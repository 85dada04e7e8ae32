"""Seeded memory images, made in bulk.

A rewrite of the port's corpus strategies (``fuzz/corpus.py``) over a
kernel's frozen input regions, vectorised over the rows: row ``i`` of a
pool takes ``STRATEGIES[i % 5]``.

* ``uniform``  every region cell uniform in its ``[lo, hi)``
* ``boundary`` region bounds, +-1, 0 and the 16-bit immediate extremes
* ``sparse``   mostly zero, one cell in eight uniform
* ``fill``     all-zero and all-ones regions, alternating
* ``overflow`` int32 extremes and full-range values

A kernel with FXPMUL has every value clipped into its regions, where the
PE array's wrapped product and the CIL program's exact one agree.  The
bytes differ from the port's corpus; the value sets are the same.  The
same seed and kernel give the same pool on any machine.
"""
from __future__ import annotations

import zlib
from typing import Sequence, Tuple

import numpy as np

STRATEGIES: Tuple[str, ...] = (
    "uniform", "boundary", "sparse", "fill", "overflow")
MEM_WORDS = 128
IMM_MIN, IMM_MAX = -(1 << 15), (1 << 15) - 1
INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


def rng_for(seed: int, kernel: str, stream: str = "pool"
            ) -> np.random.Generator:
    """A generator of its own for (seed, kernel, stream); any whole seed."""
    words = [seed % (1 << 64), zlib.crc32(kernel.encode()),
             zlib.crc32(stream.encode())]
    return np.random.default_rng(np.random.SeedSequence(words))


def _pool(lo: int, hi: int, clip: bool, extremes: Sequence[int]) -> np.ndarray:
    vals = [lo, hi - 1, 0, 1, -1, *extremes]
    if clip:
        vals = [min(max(v, lo), hi - 1) for v in vals]
    return np.array(sorted(set(vals)), np.int64)


def memories(regions: Sequence[Sequence[int]], wide_product: bool, n: int,
             rng: np.random.Generator, words: int = MEM_WORDS) -> np.ndarray:
    """(n, words) int32 images over ``regions`` ((base, length, lo, hi)
    each); cells outside every region are zero."""
    mem = np.zeros((n, words), np.int64)
    index = np.arange(n)
    kind = index % len(STRATEGIES)
    for base, length, lo, hi in regions:
        cols = slice(base, base + length)
        for s, name in enumerate(STRATEGIES):
            rows = index[kind == s]
            k = len(rows)
            if k == 0:
                continue
            shape = (k, length)
            if name == "uniform":
                vals = rng.integers(lo, hi, shape, dtype=np.int64)
            elif name == "boundary":
                pool = _pool(lo, hi, wide_product, (IMM_MIN, IMM_MAX))
                vals = pool[rng.integers(0, len(pool), shape)]
            elif name == "sparse":
                hot = rng.random(shape) < 0.125
                vals = np.where(hot, rng.integers(lo, hi, shape,
                                                  dtype=np.int64), 0)
            elif name == "fill":
                word = np.where((rows // len(STRATEGIES)) % 2 == 0, 0, -1)
                if wide_product:
                    word = np.clip(word, lo, hi - 1)
                vals = np.repeat(word[:, None], length, axis=1)
            else:
                pool = _pool(lo, hi, wide_product,
                             (INT32_MIN, INT32_MAX, INT32_MIN + 1,
                              0x55555555, -0x55555556))
                vals = pool[rng.integers(0, len(pool), shape)]
                if not wide_product:
                    wide = rng.random(k) < 0.5
                    full = rng.integers(INT32_MIN, INT32_MAX, shape,
                                        dtype=np.int64)
                    vals = np.where(wide[:, None], full, vals)
            mem[rows, cols] = vals
    return mem.astype(np.int32)
