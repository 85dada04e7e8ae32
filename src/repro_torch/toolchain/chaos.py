"""Deterministic chaos / fault-injection harness for the compile fleet.

The resilient ``compile_many`` path (:mod:`repro_torch.toolchain.resilience`)
is only trustworthy if its failure handling is *exercised*, and real
solver segfaults, hangs and torn cache writes are rare and
irreproducible.  This module injects them on demand, deterministically:

* the spec travels in the ``REPRO_CHAOS`` environment variable (JSON),
  so worker processes — forked or spawned — inherit it with zero
  plumbing;
* every injection decision is a pure hash of ``(seed, kernel, arch,
  attempt)``: the same seed afflicts the same points with the same
  faults on every run, on every machine, which is what lets the chaos
  CI lane assert that a 20%-fault-rate sweep converges to results
  byte-identical to a fault-free one;
* the *attempt* number is part of the key, so a point whose first
  attempt crashes gets a clean retry by default (``attempts=(0,)``) —
  or keeps failing (``attempts`` covering every retry) when a test
  wants to walk the whole degradation ladder.

Fault kinds (the worker entry point consults ``decide`` and calls
:func:`inject_worker_fault`; the parent's cache-write path handles
``cache-corrupt`` via :func:`corrupt_file`):

==================  ========================================================
``crash``           ``os._exit(139)`` — a segfaulting solver process
``hang``            sleep past every budget — a wedged CDCL solve the
                    parent-side deadline must kill
``solver-error``    raise :class:`ChaosError` inside the map stage
``cache-corrupt``   the parent truncates the just-written cache entry,
                    simulating a torn write a later sweep must quarantine
==================  ========================================================

A copy of ``src/repro/toolchain/chaos.py``: the same ``REPRO_CHAOS`` JSON
injects the same faults into the fleets of both packages.  The spec keeps
``abort_after_points`` (a killed *sweep*, which the JAX package's sweep
acts on) so one JSON parses in both; its hook, ``maybe_abort``, comes
with the port of the sweep.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import dataclass
from typing import Optional, Tuple

#: environment variable carrying the JSON :class:`ChaosSpec`
ENV_KEY = "REPRO_CHAOS"

#: injectable fault kinds (aligned with ``resilience.FailureKind``)
KINDS: Tuple[str, ...] = ("crash", "hang", "solver-error", "cache-corrupt")

#: exit code of a simulated worker segfault (``crash``)
CRASH_EXIT_CODE = 139


class ChaosError(RuntimeError):
    """The injected ``solver-error`` fault (also stands in for ``crash``
    and ``hang`` when the task runs inline and cannot be killed)."""


@dataclass(frozen=True)
class ChaosSpec:
    """One deterministic fault-injection campaign."""

    seed: int = 0
    #: probability that an eligible (point, attempt) is afflicted
    rate: float = 0.0
    #: fault kinds to draw from (uniformly, by hash)
    kinds: Tuple[str, ...] = KINDS
    #: attempt indices eligible for injection; ``(0,)`` afflicts only the
    #: first try so the retry ladder recovers deterministically
    attempts: Tuple[int, ...] = (0,)
    #: how long an injected hang sleeps (far past any per-point budget)
    hang_s: float = 3600.0
    #: hard-exit the sweep after this many completed points (``None`` off)
    abort_after_points: Optional[int] = None

    # -- env round-trip ----------------------------------------------------

    def to_json(self) -> str:
        d = {"seed": self.seed, "rate": self.rate,
             "kinds": list(self.kinds), "attempts": list(self.attempts),
             "hang_s": self.hang_s}
        if self.abort_after_points is not None:
            d["abort_after_points"] = self.abort_after_points
        return json.dumps(d, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ChaosSpec":
        d = json.loads(text)
        unknown = sorted(set(d) - {"seed", "rate", "kinds", "attempts",
                                   "hang_s", "abort_after_points"})
        if unknown:
            raise ValueError(f"unknown ChaosSpec fields: {unknown}")
        bad = sorted(set(d.get("kinds", [])) - set(KINDS))
        if bad:
            raise ValueError(f"unknown chaos kinds {bad}; valid: {KINDS}")
        return cls(
            seed=int(d.get("seed", 0)),
            rate=float(d.get("rate", 0.0)),
            kinds=tuple(d.get("kinds", KINDS)),
            attempts=tuple(int(a) for a in d.get("attempts", (0,))),
            hang_s=float(d.get("hang_s", 3600.0)),
            abort_after_points=(int(d["abort_after_points"])
                                if d.get("abort_after_points") is not None
                                else None),
        )

    # -- the one decision function ----------------------------------------

    def decide(self, kernel: str, arch: str, attempt: int) -> Optional[str]:
        """Fault kind afflicting ``(kernel, arch, attempt)``, or ``None``.

        Pure: hash-derived, no RNG state — every process (parent, any
        worker, any retry of the sweep itself) reaches the same verdict.
        """
        if self.rate <= 0.0 or not self.kinds:
            return None
        if attempt not in self.attempts:
            return None
        h = hashlib.sha256(
            f"{self.seed}|{kernel}|{arch}|{attempt}".encode()).digest()
        draw = int.from_bytes(h[:8], "big") / 2.0**64
        if draw >= self.rate:
            return None
        return self.kinds[int.from_bytes(h[8:12], "big") % len(self.kinds)]


def active() -> Optional[ChaosSpec]:
    """The spec from ``REPRO_CHAOS``, or ``None`` (the hot-path answer —
    one ``os.environ`` probe when chaos is off)."""
    text = os.environ.get(ENV_KEY)
    if not text:
        return None
    return ChaosSpec.from_json(text)


def inject_worker_fault(kind: str, spec: ChaosSpec,
                        inline: bool = False) -> None:
    """Execute one worker-side fault.  ``inline`` mode (no process to
    kill, no supervisor watching) degrades ``crash``/``hang`` to a raised
    :class:`ChaosError` so a ``jobs=1`` run stays debuggable."""
    if kind == "crash":
        if not inline:
            os._exit(CRASH_EXIT_CODE)
        raise ChaosError("chaos: injected worker crash (inline)")
    if kind == "hang":
        if not inline:
            time.sleep(spec.hang_s)
            # a supervisor should have killed us long ago; fall through to
            # an error so an unsupervised run still terminates
        raise ChaosError("chaos: injected hang was not killed")
    if kind == "solver-error":
        raise ChaosError("chaos: injected solver failure")
    raise ValueError(f"not a worker-side fault kind: {kind!r}")


def corrupt_file(path: str) -> None:
    """Simulate a torn write: truncate the entry mid-JSON.  The next
    reader must quarantine it (see ``repro_torch.dse.cache.MappingCache``)."""
    try:
        with open(path, "r+") as fh:
            data = fh.read()
            fh.seek(0)
            fh.truncate()
            fh.write(data[: max(1, len(data) // 2)])
    except OSError:
        pass

