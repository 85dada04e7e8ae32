"""In-process counter/histogram registry.

Deliberately small: counters are monotonic ints, histograms keep exact
count/sum/min/max plus a bounded reservoir of recent observations from
which percentiles (p50/p90/p99) are computed. The JAX package's
``repro.serve`` keeps one :class:`MetricsRegistry` per server and
surfaces ``snapshot()`` through the ``stats`` verb; anything else (benchmarks, tests) can instantiate
its own registry.

Thread-safety: ``inc``/``observe`` take a per-registry lock, so the
registry can be shared between the asyncio event loop and worker-pool
callback threads.

A copy of ``src/repro/obs/metrics.py``.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, List, Optional


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Histogram:
    """Streaming histogram with exact aggregates and reservoir percentiles.

    The reservoir keeps the most recent ``window`` observations (ring
    buffer), which is the right bias for serving metrics: percentiles
    reflect current behavior, while count/sum/min/max stay exact over
    the full lifetime.
    """

    __slots__ = ("name", "window", "count", "total", "vmin", "vmax", "_ring", "_idx")

    def __init__(self, name: str, window: int = 2048) -> None:
        self.name = name
        self.window = window
        self.count = 0
        self.total = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None
        self._ring: List[float] = []
        self._idx = 0

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.total += value
        if self.vmin is None or value < self.vmin:
            self.vmin = value
        if self.vmax is None or value > self.vmax:
            self.vmax = value
        if len(self._ring) < self.window:
            self._ring.append(value)
        else:
            self._ring[self._idx] = value
            self._idx = (self._idx + 1) % self.window

    def percentile(self, q: float) -> Optional[float]:
        """Nearest-rank percentile over the reservoir (``q`` in [0, 1])."""
        if not self._ring:
            return None
        ordered = sorted(self._ring)
        rank = max(1, min(len(ordered), math.ceil(q * len(ordered))))
        return ordered[rank - 1]

    def snapshot(self, digits: int = 6) -> Dict[str, Any]:
        doc: Dict[str, Any] = {"count": self.count}
        if self.count:
            doc["sum"] = round(self.total, digits)
            doc["min"] = round(self.vmin, digits)  # type: ignore[arg-type]
            doc["max"] = round(self.vmax, digits)  # type: ignore[arg-type]
            for label, q in (("p50", 0.50), ("p90", 0.90), ("p99", 0.99)):
                val = self.percentile(q)
                if val is not None:
                    doc[label] = round(val, digits)
        return doc


class MetricsRegistry:
    """Named counters and histograms, created on first use."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def histogram(self, name: str, window: int = 2048) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name, window=window)
            return h

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            c.inc(n)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name)
            h.observe(value)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "counters": {k: c.value for k, c in sorted(self._counters.items())},
                "histograms": {
                    k: h.snapshot() for k, h in sorted(self._histograms.items())
                },
            }
