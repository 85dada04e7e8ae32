"""Parallel design-space sweep: map every kernel across every grid size.

One sweep = a cross product of registered CIL kernels and CGRA
geometries, compiled through one :class:`repro_torch.toolchain.Toolchain`
session: ``compile_many`` resolves cache hits (``MappingCache``) in the
parent and fans misses out to the supervised worker fleet
(:mod:`repro_torch.toolchain.resilience` — parent-enforced per-point
deadlines, crash healing, retry/degradation ladder; ``--jobs 1`` inline
mode), where each point runs the full incremental SAT mapping with the
bitstream assembler as CEGAR oracle; the assemble/metrics stages run in
the parent.  Run-time metrics (latency cycles, energy) come from the
calibrated model over the assembled instruction grid — no JAX required —
so the whole sweep works with zero optional extras.

Sweeps are crash-resumable: with a journal path configured, every
completed point is durably appended to a ``.sweep_journal.jsonl``
(:mod:`repro_torch.dse.journal`) and ``run_sweep(cfg, resume=True)`` replays
matching rows, handing ``compile_many`` only the remainder.

This module keeps only what is sweep-specific: the row/document format
and the Pareto analysis.  Rows are emitted in deterministic kernel-major
order and all floats are rounded on the way out, so identical inputs
produce byte-identical Pareto sections (the property the CI regression
gate checks) — and a resumed sweep's correctness projection is
byte-identical to an uninterrupted one.

A copy of ``src/repro/dse/sweep.py``.  Rows are the JAX package's, field
for field; the run-time metrics come from the port's copy of the energy
model, and nothing here touches the card.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.mapper import MapperConfig, resolve_backend
from ..obs import trace as obs_trace
from ..toolchain import chaos
from ..toolchain.artifacts import CompileResult
from ..toolchain.oracles import ORACLE_TAG  # noqa: F401 (compat re-export)
from ..toolchain.resilience import ResilienceConfig
from ..toolchain.session import Toolchain
from .cache import MappingCache
from .journal import SweepJournal
from .pareto import pareto_analysis
from .space import DEFAULT_KERNELS, DEFAULT_SIZES, DesignPoint, build_space


@dataclass
class SweepConfig:
    kernels: Sequence[str] = DEFAULT_KERNELS
    sizes: Sequence[Tuple[int, int]] = DEFAULT_SIZES
    backend: str = "auto"
    #: compact strategy/portfolio spec (``repro_torch.core.backends`` grammar);
    #: ``None`` keeps the legacy ``backend`` field authoritative
    strategy: Optional[str] = None
    #: opt into the cross-point fact store (:mod:`repro_torch.core.facts`):
    #: facts proven on one design point seed every later point they
    #: soundly lift to.  Off by default — rows and committed baselines
    #: stay byte-identical, and fact-seeded results skip the cache.
    share_facts: bool = False
    per_point_timeout_s: float = 60.0
    per_ii_timeout_s: float = 15.0
    ii_max: int = 32
    jobs: Optional[int] = None          # None -> os.cpu_count(), capped
    cache_dir: Optional[str] = "results/dse_cache"  # None disables caching
    journal_path: Optional[str] = None  # None disables crash-resume journal
    resilience: Optional[ResilienceConfig] = None  # None -> fleet defaults

    def mapper_config(self) -> MapperConfig:
        return MapperConfig(backend=self.backend,
                            strategy=self.strategy,
                            per_ii_timeout_s=self.per_ii_timeout_s,
                            total_timeout_s=self.per_point_timeout_s,
                            ii_max=self.ii_max)

    def signature(self) -> Dict:
        """Everything that determines row *content* (not pacing): the
        journal refuses to resume across a change in any of these."""
        sig = {
            "kernels": list(self.kernels),
            "sizes": [f"{r}x{c}" for r, c in self.sizes],
            "backend": resolve_backend(self.backend),
            "per_point_timeout_s": self.per_point_timeout_s,
            "per_ii_timeout_s": self.per_ii_timeout_s,
            "ii_max": self.ii_max,
        }
        # emitted only when set, so pre-portfolio journals keep resuming
        if self.strategy is not None:
            sig["strategy"] = self.strategy
        if self.share_facts:
            sig["share_facts"] = True
        return sig


def _annotate_resilience(row: Dict, cr: CompileResult) -> None:
    """Fleet fields, emitted only when non-default so fault-free rows
    (and the committed baselines) stay byte-identical."""
    if cr.failure is not None:
        row["failure_kind"] = cr.failure.get("kind")
        row["failure"] = {k: cr.failure[k]
                          for k in ("stage", "type", "message", "traceback")
                          if cr.failure.get(k) is not None}
    if cr.retries:
        row["retries"] = cr.retries
    if cr.degraded is not None:
        row["degraded"] = cr.degraded
    res = cr.map_result
    if res is not None:
        # portfolio/fact telemetry: non-default only (same reasoning)
        if res.strategies_raced:
            row["strategies_raced"] = res.strategies_raced
            row["winner"] = res.winner
            row["encodings_built"] = res.encodings_built
            row["incremental_solves"] = res.incremental_solves
            if res.cancelled_after_s is not None:
                row["cancelled_after_s"] = round(res.cancelled_after_s, 4)
        if res.facts_used:
            row["facts_used"] = res.facts_used


def _record(point: DesignPoint, cr: CompileResult) -> Dict:
    """One sweep row from one compile result (deterministic fields)."""
    if cr.status in ("error", "failed"):
        row = {"kernel": point.kernel, "size": point.size,
               "rows": point.rows, "cols": point.cols,
               "num_pes": point.num_pes, "status": cr.status,
               "ii": None, "error": cr.error,
               "map_time_s": round(cr.map_time_s, 4),
               "cache_hit": cr.cache_hit}
        _annotate_resilience(row, cr)
        return row
    res = cr.map_result
    row = {
        "kernel": point.kernel, "size": point.size,
        "rows": point.rows, "cols": point.cols,
        "num_pes": point.num_pes,
        "status": res.status, "mii": res.mii,
        "backend": res.backend,
        "map_time_s": round(cr.map_time_s, 4),
        "cache_hit": cr.cache_hit,
        "cegar_rounds": res.cegar_rounds,
        "attempts": len(res.attempts),
    }
    if cr.mapping is not None:
        m = cr.metrics
        row.update({
            "ii": cr.mapping.ii,
            "utilization": round(cr.mapping.utilization, 4),
            "latency_cycles": m.cycles,
            "energy_nj": round(m.energy_nj, 4),
            "dynamic_nj": round(m.dynamic_nj, 4),
            "static_nj": round(m.static_nj, 4),
        })
    else:
        row["ii"] = None
    _annotate_resilience(row, cr)
    return row


def _resilience_summary(rows: Sequence[Dict]) -> Dict:
    """Sweep-level fleet aggregate (all zeros on a fault-free run)."""
    kinds: Dict[str, int] = {}
    for r in rows:
        kind = r.get("failure_kind")
        if kind:
            kinds[kind] = kinds.get(kind, 0) + 1
    return {
        "retries": sum(r.get("retries", 0) for r in rows),
        "degraded": sum(1 for r in rows if r.get("degraded") is not None),
        "failed": sum(1 for r in rows if r["status"] == "failed"),
        "failure_kinds": dict(sorted(kinds.items())),
    }


def run_sweep(cfg: Optional[SweepConfig] = None,
              resume: bool = False) -> Dict:
    """Execute the sweep; returns the full JSON-ready result document.

    With ``cfg.journal_path`` set, every completed point is durably
    journaled; ``resume=True`` replays rows from a matching journal and
    compiles only the remainder (a signature mismatch falls back to a
    full run).  Never raises for a per-point failure: the fleet types
    every loss and the row lands as ``status="failed"`` at worst.
    """
    cfg = cfg or SweepConfig()
    t0 = time.monotonic()
    points = build_space(cfg.kernels, cfg.sizes)
    cache = MappingCache(cfg.cache_dir) if cfg.cache_dir else None
    # session arch is just the default; compile_many spans cfg.sizes
    arch = tuple(cfg.sizes[0]) if cfg.sizes else "2x2"
    tc = Toolchain(arch, cfg.mapper_config(), cache=cache,
                   oracle="assembler",
                   facts="session" if cfg.share_facts else None)

    journal = SweepJournal(cfg.journal_path) if cfg.journal_path else None
    done_rows: Dict[Tuple[str, str], Dict] = {}
    if journal is not None:
        done_rows = journal.start(cfg.signature(), resume=resume)
    resumed = sum(1 for p in points if (p.kernel, p.size) in done_rows)

    # compile_many keys points as (kernel, grid-index), kernel-major —
    # the same order build_space emits DesignPoints in
    size_index = {f"{r}x{c}": gi for gi, (r, c) in enumerate(cfg.sizes)}
    point_of = {(p.kernel, size_index[p.size]): p for p in points}
    remaining = [(p.kernel, size_index[p.size]) for p in points
                 if (p.kernel, p.size) not in done_rows]

    fresh_rows: Dict[Tuple[str, str], Dict] = {}
    completed = 0

    def on_result(pt: Tuple[str, int], cr: CompileResult) -> None:
        nonlocal completed
        p = point_of[pt]
        row = _record(p, cr)
        fresh_rows[(p.kernel, p.size)] = row
        if journal is not None:
            journal.record(p.kernel, p.size, row)
        completed += 1
        chaos.maybe_abort(completed)  # chaos: simulate a mid-sweep kill

    try:
        with obs_trace.span("sweep", kernels=len(cfg.kernels),
                            sizes=len(cfg.sizes),
                            points=len(remaining)) as ssp:
            tc.compile_many(cfg.kernels, grids=cfg.sizes, jobs=cfg.jobs,
                            points=remaining, on_result=on_result,
                            resilience=cfg.resilience)
            ssp.set(completed=completed, resumed=resumed)
    finally:
        if journal is not None:
            journal.close()

    rows = [done_rows.get((p.kernel, p.size))
            or fresh_rows[(p.kernel, p.size)] for p in points]
    errors = sum(1 for r in rows if r["status"] in ("error", "failed"))
    doc = {
        "bench": "dse",
        "backend": resolve_backend(cfg.backend),
        "kernels": list(cfg.kernels),
        "sizes": [f"{r}x{c}" for r, c in cfg.sizes],
        "per_point_timeout_s": cfg.per_point_timeout_s,
        "points": rows,
        "pareto": pareto_analysis(rows),
        "cache": (cache.stats() if cache is not None
                  else {"dir": None, "hits": 0, "misses": 0, "corrupt": 0}),
        "errors": errors,
        "wall_time_s": round(time.monotonic() - t0, 3),
    }
    if resumed:
        doc["resumed_points"] = resumed
    resil = _resilience_summary(rows)
    if (resil["retries"] or resil["degraded"] or resil["failed"]
            or resil["failure_kinds"]):
        doc["resilience"] = resil
    return doc
