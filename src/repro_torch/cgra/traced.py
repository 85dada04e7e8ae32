"""The traced kernels of the registry, rebuilt from their shipped artifacts.

In the JAX package these kernels are plain Python loop bodies that
``src/repro/frontend/kernels.py`` traces and legalizes into LoopBuilder
programs.  Until the front-end is ported, this module registers the same
11 kernels, in that file's order, from the program part of each shipped
artifact (``artifacts/4x4/<kernel>.json``: nodes, carries, results, node
order and input regions); ``tests/test_torch_artifacts.py`` holds that
part equal to the JAX registry's program.  It gives way to the front-end
slice, which registers them from their loop bodies.

``make_mem`` is a copy of ``make_mem`` in ``src/repro/frontend/tracer.py``
over the artifact's regions.
"""
from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from .programs import LoopBuilder
from .registry import register_kernel

#: registration order of ``src/repro/frontend/kernels.py``
TRACED_KERNELS: Tuple[str, ...] = (
    "dotprod", "fir4", "saxpy", "prefix_sum", "relu_clamp", "popcount",
    "stencil3", "argmax", "sad", "xorshift32", "ema_fxp")

#: the arch whose shipped artifacts carry the traced programs
_ARTIFACT_DIR = Path(__file__).resolve().parents[1] / "artifacts" / "4x4"

MEM_SIZE = 128


@functools.lru_cache(maxsize=None)
def _program_part(name: str) -> Dict:
    doc = json.loads((_ARTIFACT_DIR / f"{name}.json").read_text())
    return {"program": doc["program"],
            "regions": tuple(tuple(r) for r in doc["regions"])}


def traced_regions(name: str) -> Tuple[Tuple[int, int, int, int], ...]:
    """``(base, length, lo, hi)`` of each randomized input region."""
    return _program_part(name)["regions"]


def build(name: str) -> LoopBuilder:
    """A fresh LoopBuilder of the traced kernel ``name``."""
    return LoopBuilder.from_dict(_program_part(name)["program"])


def make_mem(name: str, seed: int = 0) -> np.ndarray:
    """Deterministic randomized input memory image for one seed."""
    rng = np.random.RandomState(seed)
    mem = np.zeros(MEM_SIZE, np.int64)
    for base, length, lo, hi in traced_regions(name):
        mem[base:base + length] = rng.randint(lo, hi, length, dtype=np.int64)
    return mem.astype(np.int32)


def _register_traced() -> None:
    for name in TRACED_KERNELS:
        register_kernel(name, functools.partial(build, name),
                        origin="traced",
                        make_mem=functools.partial(make_mem, name),
                        tags=("frontend",))


_register_traced()
