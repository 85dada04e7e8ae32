"""Typed stage artifacts of the compilation session.

Every :class:`~repro_torch.toolchain.session.Toolchain` stage returns one of
these instead of a bare tuple, and a failed ``compile()`` records *which*
stage died (``CompileResult.stage``) so callers never have to guess
whether a kernel was unmappable, timed out in the solver, or crashed in
code generation.

Stage order (the paper's Fig. 4 flow, plus run-time metrics)::

    source -> Program -> MapResult -> AssembledCIL -> RuntimeMetrics
                                                   -> SimResult

A copy of ``StageError``, ``Program``, ``CompileResult`` and
``format_error`` from ``src/repro/toolchain/artifacts.py``.  The wire
views (``WireMapping``, ``WireMapResult``) and ``CompileResult.from_dict``,
which the compile server and the fleet need, are not ported yet
(``ROADMAP.md``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from ..cgra.bitstream import AssembledCIL
from ..cgra.energy import RuntimeMetrics
from ..core.dfg import DFG
from ..core.mapper import MapResult
from ..core.mapping import Mapping

# canonical stage names, in pipeline order
STAGES = ("source", "map", "assemble", "metrics", "simulate")


class StageError(RuntimeError):
    """A pipeline stage failed; ``.stage`` names the culprit."""

    def __init__(
        self,
        stage: str,
        message: str,
        cause: Optional[BaseException] = None,
    ):
        super().__init__(f"[{stage}] {message}")
        self.stage = stage
        self.message = message
        self.cause = cause

    def error_text(self) -> str:
        """The ``"TypeName: msg"`` (or bare-message) form every consumer
        stores in ``CompileResult.error`` — one shape on every path."""
        if self.cause is not None:
            return format_error(self.cause)
        return self.message


@dataclass
class Program:
    """Stage-1 artifact: a mappable kernel with its DFG already built.

    ``builder`` is the :class:`~repro_torch.cgra.programs.LoopBuilder` needed by
    the assemble/metrics/simulate stages; DFG-only sources (the synthetic
    Table-3 graphs) leave it ``None`` and stop the pipeline after ``map``.
    """

    name: str
    origin: str  # "handwritten" | "traced" | "inline" | "dfg"
    dfg: DFG
    builder: Optional[object] = None  # LoopBuilder
    make_mem: Optional[object] = None  # seed -> (M,) int32 input image
    #: set iff this Program was resolved *from* the kernel registry by
    #: name — the portfolio racer may then rebuild it (and its CEGAR
    #: oracle) inside worker processes.  A same-named traced/inline
    #: kernel leaves it None: its DFG is not the registry's.
    registry_name: Optional[str] = None

    @property
    def mappable_only(self) -> bool:
        return self.builder is None

    def __repr__(self) -> str:  # keep session logs readable
        return (
            f"Program({self.name!r}, origin={self.origin!r}, "
            f"nodes={self.dfg.num_nodes}, edges={self.dfg.num_edges})"
        )


@dataclass
class CompileResult:
    """End-to-end artifact bundle of one ``Toolchain.compile()`` call.

    ``status`` is ``"ok"`` when every stage ran; otherwise it carries the
    map-stage verdict (``"unsat-capped"`` / ``"timeout"``), ``"error"``
    for a single-shot exception, or ``"failed"`` when the resilient fleet
    exhausted its whole retry/degradation ladder — with ``stage`` naming
    where the pipeline stopped and ``error`` the formatted cause.

    The fleet additionally threads provenance through: ``failure`` is the
    structured record of the last failure encountered (``kind`` from
    :class:`~repro.toolchain.resilience.FailureKind`, plus stage,
    exception type and truncated traceback — set even when a retry
    recovered), ``retries`` counts attempts beyond the first, and
    ``degraded`` names the degradation rung that produced the result
    (``"backend-flip"`` / ``"oracle-off"`` / ``"ii-capped"``), ``None``
    for a first-class result.
    """

    kernel: str
    rows: int
    cols: int
    status: str
    #: non-default architecture label (archspec compact string / preset
    #: name); ``None`` on the homogeneous torus so legacy digests are
    #: byte-identical
    arch: Optional[str] = None
    stage: Optional[str] = None
    program: Optional[Program] = None
    map_result: Optional[MapResult] = None
    asm: Optional[AssembledCIL] = None
    metrics: Optional[RuntimeMetrics] = None
    error: Optional[str] = None
    cache_hit: bool = False
    timings: Dict[str, float] = field(default_factory=dict)
    #: structured record of the last failure (kind/stage/type/traceback);
    #: present even when a retry or degradation rung recovered the point
    failure: Optional[Dict] = None
    #: attempts beyond the first the fleet spent on this point
    retries: int = 0
    #: degradation rung that produced the result, ``None`` if first-class
    degraded: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    @property
    def failure_kind(self) -> Optional[str]:
        """Typed :class:`~repro.toolchain.resilience.FailureKind` of the
        last recorded failure, or ``None``."""
        return self.failure.get("kind") if self.failure else None

    @property
    def size(self) -> str:
        return f"{self.rows}x{self.cols}"

    @property
    def mapping(self) -> Optional[Mapping]:
        return self.map_result.mapping if self.map_result else None

    @property
    def ii(self) -> Optional[int]:
        return self.map_result.ii if self.map_result else None

    @property
    def mii(self) -> Optional[int]:
        return self.map_result.mii if self.map_result else None

    @property
    def map_time_s(self) -> float:
        return self.timings.get("map", 0.0)

    # -- serialization (process-pool transfer, CLI JSON) -------------------

    def to_dict(self) -> Dict:
        map_result = self.map_result.to_dict() if self.map_result else None
        metrics = self.metrics.to_dict() if self.metrics else None
        out = {
            "kernel": self.kernel,
            "rows": self.rows,
            "cols": self.cols,
            "status": self.status,
            "stage": self.stage,
            "error": self.error,
            "cache_hit": self.cache_hit,
            "timings": {k: round(v, 6) for k, v in self.timings.items()},
            "map_result": map_result,
            "metrics": metrics,
        }
        if self.arch is not None:
            out["arch"] = self.arch
        # resilience provenance: emitted only when set, so pre-fleet
        # digests (and the committed CI baselines) stay byte-identical
        if self.failure is not None:
            out["failure"] = dict(self.failure)
        if self.retries:
            out["retries"] = self.retries
        if self.degraded is not None:
            out["degraded"] = self.degraded
        return out

    def summary(self) -> Dict:
        """Flat JSON-ready digest (the ``repro map --json`` document)."""
        times = {k: round(v, 4) for k, v in self.timings.items()}
        out = {
            "kernel": self.kernel,
            "grid": self.size,
            "status": self.status,
            "stage": self.stage,
            "error": self.error,
            "cache_hit": self.cache_hit,
            "ii": self.ii,
            "mii": self.mii,
            "stage_times_s": times,
        }
        if self.arch is not None:
            out["arch"] = self.arch
        if self.failure is not None:
            out["failure"] = dict(self.failure)
        if self.retries:
            out["retries"] = self.retries
        if self.degraded is not None:
            out["degraded"] = self.degraded
        if self.map_result is not None:
            out["backend"] = self.map_result.backend
            out["map_status"] = self.map_result.status
            out["cegar_rounds"] = self.map_result.cegar_rounds
            out["attempts"] = len(self.map_result.attempts)
            # portfolio/fact telemetry rides along only when a race ran
            # (or facts seeded the solve), so sequential digests — and
            # every committed baseline built from them — stay
            # byte-identical
            mr = self.map_result
            if mr.strategies_raced:
                out["strategies_raced"] = mr.strategies_raced
                out["winner"] = mr.winner
                out["encodings_built"] = mr.encodings_built
                out["incremental_solves"] = mr.incremental_solves
                if mr.cancelled_after_s is not None:
                    out["cancelled_after_s"] = round(mr.cancelled_after_s, 4)
            if mr.facts_used:
                out["facts_used"] = mr.facts_used
        if self.mapping is not None:
            out["utilization"] = round(self.mapping.utilization, 4)
        if self.metrics is not None:
            out["metrics"] = self.metrics.to_dict()
        return out


def format_error(exc: BaseException) -> str:
    """The one error-string format every consumer (sweep rows, CLI JSON)
    shares: ``"TypeName: message"``."""
    return f"{type(exc).__name__}: {exc}"
