"""Typed stage artifacts of the compilation session.

Every :class:`~repro_torch.toolchain.session.Toolchain` stage returns one of
these instead of a bare tuple, and a failed ``compile()`` records *which*
stage died (``CompileResult.stage``) so callers never have to guess
whether a kernel was unmappable, timed out in the solver, or crashed in
code generation.

Stage order (the paper's Fig. 4 flow, plus run-time metrics)::

    source -> Program -> MapResult -> AssembledCIL -> RuntimeMetrics
                                                   -> SimResult

A copy of ``src/repro/toolchain/artifacts.py``, the wire views
(``WireMapping``, ``WireMapResult``) and ``CompileResult.from_dict``
included: a ``to_dict`` document of either package revives on this side.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..cgra.arch import PEGrid
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


class WireMapping:
    """Read-only view of a serialized :class:`~repro_torch.core.mapping.Mapping`
    — the wire side of a round trip, where no DFG/grid exists to revive
    live objects.  Exposes exactly what digests consume."""

    __slots__ = ("_d", "_num_pes")

    def __init__(self, d: Dict, num_pes: Optional[int] = None):
        self._d = d
        self._num_pes = num_pes

    @property
    def ii(self) -> int:
        return self._d["ii"]

    @property
    def num_folds(self) -> int:
        return self._d["num_folds"]

    @property
    def placements(self) -> List:
        return self._d["placements"]

    @property
    def routing_nodes(self) -> int:
        return self._d.get("routing_nodes", 0)

    @property
    def utilization(self) -> float:
        """Paper's U — recomputable from the serialized form alone."""
        if self._num_pes is None:
            raise ValueError("WireMapping needs num_pes for utilization")
        return len(self._d["placements"]) / float(self.ii * self._num_pes)

    def to_dict(self) -> Dict:
        return copy.deepcopy(self._d)


class WireMapResult:
    """Read-only view of :meth:`~repro_torch.core.mapper.MapResult.to_dict`
    output.  :meth:`CompileResult.from_dict` uses it when no ``dfg`` +
    ``grid`` are at hand (the wire/client side), so a serialized result —
    the fleet's failure provenance and the racer's telemetry included —
    round-trips losslessly: :meth:`to_dict` re-emits the stored dict
    unchanged, and every field :meth:`CompileResult.summary` reads is a
    property here.  :meth:`revive` upgrades to a full
    :class:`~repro_torch.core.mapper.MapResult` once the artifacts exist."""

    __slots__ = ("_d", "_num_pes")

    def __init__(self, d: Dict, num_pes: Optional[int] = None):
        self._d = d
        self._num_pes = num_pes

    @property
    def status(self) -> str:
        return self._d["status"]

    @property
    def mii(self) -> int:
        return self._d["mii"]

    @property
    def backend(self) -> str:
        return self._d.get("backend", "")

    @property
    def cegar_rounds(self) -> int:
        return self._d.get("cegar_rounds", 0)

    @property
    def encodings_built(self) -> int:
        return self._d.get("encodings_built", 0)

    @property
    def incremental_solves(self) -> int:
        return self._d.get("incremental_solves", 0)

    @property
    def total_time_s(self) -> float:
        return self._d.get("total_time_s", 0.0)

    @property
    def attempts(self) -> List:
        return self._d.get("attempts", [])

    @property
    def validation_errors(self) -> List[str]:
        return self._d.get("validation_errors", [])

    @property
    def strategies_raced(self) -> int:
        return self._d.get("strategies_raced", 0)

    @property
    def winner(self) -> str:
        return self._d.get("winner", "")

    @property
    def cancelled_after_s(self) -> Optional[float]:
        return self._d.get("cancelled_after_s")

    @property
    def unsat_iis(self) -> List[int]:
        return self._d.get("unsat_iis", [])

    @property
    def facts_used(self) -> int:
        return self._d.get("facts_used", 0)

    @property
    def mapping(self) -> Optional[WireMapping]:
        if self._d.get("mapping") is None:
            return None
        return WireMapping(self._d["mapping"], num_pes=self._num_pes)

    @property
    def ii(self) -> Optional[int]:
        m = self._d.get("mapping")
        return m["ii"] if m else None

    def to_dict(self) -> Dict:
        return copy.deepcopy(self._d)

    def revive(self, dfg: DFG, grid: PEGrid) -> MapResult:
        """The full artifact, once a DFG and grid exist on this side."""
        return MapResult.from_dict(dfg, grid, self._d)


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

    @classmethod
    def from_dict(
        cls,
        d: Dict,
        dfg: Optional[DFG] = None,
        grid: Optional[PEGrid] = None,
        program: Optional[Program] = None,
    ) -> "CompileResult":
        """Rebuild from :meth:`to_dict` output.  With ``dfg``/``grid``
        (or a ``program`` plus ``grid``) the mapping revives into full
        live artifacts; without them — the wire/client side — the
        ``map_result`` becomes a lossless :class:`WireMapResult` view
        (same digests, ``to_dict`` re-emits it unchanged).  The ``asm``
        artifact is never serialized — re-run the assemble stage if it is
        needed on this side of the boundary."""
        if dfg is None and program is not None:
            dfg = program.dfg
        map_result = None
        if d.get("map_result") is not None:
            if dfg is None or grid is None:
                map_result = WireMapResult(d["map_result"],
                                           num_pes=d["rows"] * d["cols"])
            else:
                map_result = MapResult.from_dict(dfg, grid, d["map_result"])
        metrics = None
        if d.get("metrics"):
            metrics = RuntimeMetrics(**d["metrics"])
        return cls(
            kernel=d["kernel"],
            rows=d["rows"],
            cols=d["cols"],
            status=d["status"],
            arch=d.get("arch"),
            stage=d.get("stage"),
            program=program,
            map_result=map_result,
            metrics=metrics,
            error=d.get("error"),
            cache_hit=d.get("cache_hit", False),
            timings=dict(d.get("timings", {})),
            failure=d.get("failure"),
            retries=d.get("retries", 0),
            degraded=d.get("degraded"),
        )

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
