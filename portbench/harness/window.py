"""One run of one cell: set-up, the measured window, and what it leaves
for the metric readers and the check.

The client is closed-loop and alone, as ``python -m repro_torch fuzz``
is: it goes round the configuration's kernels in their listed order, one
call at a time, and hands each call a frozen artifact and its kernel's
memories, made at set-up from the seed.  Every pass sends the same
memories again: the window measures the program's work on them, and a
cache of answers by input is not a gain a user would see.  The window
holds whole passes of the kernel list, at least one: a further pass
starts only where the passes so far say it ends within the asked
seconds.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from . import devtrace, memgen
from .spec import Cell


@dataclass
class Call:
    """One request of the window and what the program answered."""

    kernel: str
    index: int                   # position in the configuration's list
    doc: Dict                    # the artifact the answer is judged on
    memories: np.ndarray         # (n, M) the memories sent
    launches: List[int]          # batch rows of each chunk, in order
    report: Optional[object] = None   # the program's FuzzReport
    error: Optional[str] = None


@dataclass
class Window:
    cell: Cell
    seed: int
    setup_s: float = 0.0
    window_s: float = 0.0
    passes: int = 0
    pass_s: List[float] = field(default_factory=list)  # each pass's seconds
    calls: List[Call] = field(default_factory=list)
    trace: Optional[devtrace.DeviceTrace] = None


def chunks(n: int, batch: int) -> List[int]:
    return [min(batch, n - lo) for lo in range(0, n, batch)]


def make_pool(cell: Cell, seed: int) -> List[np.ndarray]:
    """Every kernel's memories, from the seed alone."""
    n = int(cell.traffic["memories_per_call"])
    words = int(cell.config["memory_words"])
    return [memgen.memories(d["regions"], d["wide_product"], n,
                            memgen.rng_for(seed, d["kernel"]), words)
            for d in cell.docs]


def _sync(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


class _Client:
    """The closed-loop client of one run."""

    def __init__(self, cell: Cell, pool: List[np.ndarray], device: str):
        from repro_torch.cgra.artifact import Artifact

        self.cell, self.pool, self.device = cell, pool, device
        self.batch = int(cell.traffic["batch"])
        self.artifacts = [Artifact.from_dict(d) for d in cell.docs]

    def fuzz(self, i: int, mems: np.ndarray):
        from repro_torch.fuzz.engine import fuzz_program

        return fuzz_program(self.artifacts[i], mems, batch=self.batch,
                            device=self.device)

    def call(self, i: int) -> Call:
        doc, mems = self.cell.docs[i], self.pool[i]
        call = Call(kernel=doc["kernel"], index=i, doc=doc, memories=mems,
                    launches=chunks(len(mems), self.batch))
        try:
            call.report = self.fuzz(i, mems)
        except Exception as e:          # a request that never answers
            call.error = f"{type(e).__name__}: {e}"
        return call

    def warm(self) -> None:
        """Every shape the window runs, once: each kernel over one chunk,
        and the ragged last chunk."""
        sizes = chunks(len(self.pool[0]), self.batch)
        for i, mems in enumerate(self.pool):
            self.fuzz(i, mems[:sizes[0]])
        if len(set(sizes)) > 1:
            self.fuzz(0, self.pool[0][:sizes[-1]])


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: Optional[float] = None,
        client=None) -> Window:
    """Set up, warm, and measure whole passes for about ``seconds``.
    ``client`` replaces the program's client (the check's control)."""
    t0 = time.perf_counter() if t_start is None else t_start
    win = Window(cell=cell, seed=seed)
    client = (client or _Client)(cell, make_pool(cell, seed), device)
    client.warm()
    _sync(device)
    win.setup_s = time.perf_counter() - t0

    profiled = trace and device == "cuda"
    with contextlib.ExitStack() as stack:
        prof = None
        if profiled:
            from torch.profiler import ProfilerActivity, profile

            prof = stack.enter_context(profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        w0 = time.perf_counter()
        while True:
            p0 = time.perf_counter()
            for i, doc in enumerate(cell.docs):
                with _label(profiled, doc):
                    win.calls.append(client.call(i))
            win.passes += 1
            win.pass_s.append(time.perf_counter() - p0)
            elapsed = time.perf_counter() - w0
            if elapsed + elapsed / win.passes > seconds:
                break
        _sync(device)
        win.window_s = time.perf_counter() - w0
    if prof is not None:
        win.trace = devtrace.read(prof, win.window_s)
    return win


def _label(on: bool, doc: Dict):
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(f"{devtrace.LABEL}fuzz {doc['kernel']}")
