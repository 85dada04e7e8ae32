"""The compilation session: one staged pipeline from kernel to metrics.

A copy of ``src/repro/toolchain/session.py``.  :class:`Toolchain` binds
an architecture, a :class:`MapperConfig`, an optional content-addressed
mapping cache, and a CEGAR oracle, then exposes the paper's flow (Fig. 4)
as explicit, individually-inspectable stages::

    tc = Toolchain("4x4", MapperConfig(backend="cdcl"))
    prog = tc.program("dotprod")     # source  -> Program
    res = tc.map(prog)               # Program -> MapResult (SAT + CEGAR)
    asm = tc.assemble(prog, res.mapping)    # -> AssembledCIL
    m = tc.metrics(prog, res.mapping, asm)  # -> RuntimeMetrics
    sim = tc.simulate(prog, res.mapping, mem)  # on the card by default

``compile()`` runs the stages end-to-end into a :class:`CompileResult`
whose ``stage`` field names where a failing pipeline died;
``compile_many()`` fans a kernels x grids cross product through the
supervised worker fleet (:mod:`repro_torch.toolchain.resilience`) with
cache hits resolved in the parent.  The fleet enforces per-point
wall-clock deadlines from the parent, heals crashed/hung workers, retries
transient failures and degrades persistent ones, so ``compile_many``
never raises and never loses a point.  Its workers map on the host and
never touch CUDA.

Sources accepted by the ``program`` stage: a registry kernel name, a
:class:`~repro_torch.cgra.programs.LoopBuilder`, a
:class:`~repro_torch.frontend.TracedKernel`, a bare
:class:`~repro_torch.core.dfg.DFG` (map-only), or an existing
:class:`Program`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from ..archspec import ArchSpec, parse_arch
from ..cgra.arch import PEGrid, make_grid
from ..cgra.bitstream import AssembledCIL, assemble
from ..cgra.energy import RuntimeMetrics, runtime_metrics
from ..core.dfg import DFG
from ..core.mapper import (
    MapperConfig,
    MapResult,
    map_dfg_cached,
    mapping_cache_key,
)
from ..core.mapping import Mapping
from ..obs import trace as obs_trace
from . import chaos
from .artifacts import CompileResult, Program, StageError, format_error
from .oracles import assembler_oracle, resolve_oracle
from .resilience import (
    FailureKind,
    MapTask,
    ResilienceConfig,
    _arch_key,
    failure_record,
    failure_text,
    run_inline,
    run_supervised,
)

ArchLike = Union[PEGrid, ArchSpec, str, Tuple[int, int]]

PointKey = Tuple[str, int]  # (kernel, grid index)

#: map-stage verdicts worth caching: only terminal sat/unsat results.
#: Timeouts get another chance on a less-loaded machine, and transient
#: failures (worker crash, injected chaos, flaky IO) must never poison
#: the content-addressed key for every future sweep.
TERMINAL_MAP_STATUSES = ("mapped", "unsat-capped")


def resolve_arch(arch: ArchLike) -> PEGrid:
    """``PEGrid`` | ``ArchSpec`` | spec/preset string | ``(4, 4)`` ->
    :class:`PEGrid`.

    Strings go through :func:`repro_torch.archspec.parse_arch`, so ``"4x4"``
    still means the homogeneous torus while ``"mesh-4x4:mem=col0"`` or a
    preset name like ``"bordermem-4x4"`` yields a capability-annotated
    grid."""
    if isinstance(arch, PEGrid):
        return arch
    if isinstance(arch, ArchSpec):
        return arch.grid()
    if isinstance(arch, str):
        return parse_arch(arch).grid()
    rows, cols = arch
    return make_grid(int(rows), int(cols))


def arch_label(arch: ArchLike, grid: PEGrid) -> Optional[str]:
    """Display label for a non-default architecture, else ``None``.

    ``None`` keeps the homogeneous-torus digests (and their committed CI
    baselines) byte-identical; anything spec'd beyond ``RxC`` torus gets
    its canonical compact label into CLI/bench artifacts."""
    spec = None
    if isinstance(arch, ArchSpec):
        spec = arch
    elif isinstance(arch, str):
        spec = parse_arch(arch)
    if spec is not None:
        if spec.to_compact() != f"torus-{spec.rows}x{spec.cols}":
            return spec.label()
        return None
    # raw PEGrid: the capability selectors are not recoverable, so label
    # with name > topology-RxC, plus the content fingerprint when a
    # capability table makes two same-shape fabrics distinct
    fingerprint = grid.arch_fingerprint()
    if fingerprint is None and grid.spec.torus:
        return None
    if grid.spec.name:
        return grid.spec.name
    shape = (f"{grid.spec.resolved_topology()}-"
             f"{grid.spec.rows}x{grid.spec.cols}")
    if grid.caps is not None:
        return f"{shape}#{fingerprint[:8]}"
    return shape


class Toolchain:
    """A compilation session over one architecture + mapper config.

    ``cache`` is a :class:`~repro_torch.dse.cache.MappingCache`, a directory
    path (one is created there), or ``None``; only the map stage is
    cached, keyed by DFG + arch + config + oracle tag.  ``oracle`` is
    ``"assembler"`` (default), ``None``, or a custom factory — see
    :mod:`repro_torch.toolchain.oracles`.

    ``facts`` opts into the cross-point fact store
    (:mod:`repro_torch.core.facts`): ``True``/``"session"`` creates a
    session-scoped :class:`~repro_torch.core.facts.FactStore`, or pass an
    existing store to share it across sessions.  Facts proven on one
    design point (CEGAR blocking combos, UNSAT-at-II, feasible-II caps)
    then seed every later point they soundly lift to.  Off (``None``,
    the default) every artifact stays byte-identical to a store-less
    run — fact-seeded results are never written to the mapping cache.
    """

    def __init__(
        self,
        arch: ArchLike = "4x4",
        config: Optional[MapperConfig] = None,
        *,
        cache=None,
        oracle="assembler",
        facts=None,
    ):
        self.grid = resolve_arch(arch)
        self.arch = arch_label(arch, self.grid)
        self.config = config or MapperConfig()
        if isinstance(cache, str):
            from ..dse.cache import MappingCache

            cache = MappingCache(cache)
        self.cache = cache
        self.oracle_tag, self._oracle_factory = resolve_oracle(oracle)
        if facts is True or facts == "session":
            from ..core.facts import FactStore

            facts = FactStore()
        self.facts = facts
        self.last_cache_hit = False

    # -- stage 1: source -> Program ----------------------------------------

    def program(self, source) -> Program:
        """Resolve any supported source into a :class:`Program`."""
        try:
            return self._resolve_program(source)
        except StageError:
            raise
        except Exception as e:
            raise StageError("source", format_error(e), cause=e) from e

    def _resolve_program(self, source) -> Program:
        if isinstance(source, Program):
            return source
        if isinstance(source, str):
            from ..cgra.registry import get_kernel

            spec = get_kernel(source)
            builder = spec.factory()
            return Program(
                name=source,
                origin=spec.origin,
                dfg=builder.build_dfg(),
                builder=builder,
                make_mem=spec.make_mem,
                registry_name=source,
            )
        if isinstance(source, DFG):
            return Program(name=source.name, origin="dfg", dfg=source)
        if hasattr(source, "spec") and hasattr(source, "build"):
            # TracedKernel: legalize to a fresh LoopBuilder
            builder = source.build()
            return Program(
                name=source.name,
                origin="traced",
                dfg=builder.build_dfg(),
                builder=builder,
                make_mem=getattr(source, "make_mem", None),
            )
        if hasattr(source, "build_dfg"):
            # a LoopBuilder handed in directly
            return Program(
                name=getattr(source, "name", "<inline>"),
                origin="inline",
                dfg=source.build_dfg(),
                builder=source,
            )
        msg = (
            f"unsupported kernel source {type(source).__name__}: expected "
            "a registry name, LoopBuilder, TracedKernel, DFG or Program"
        )
        raise StageError("source", msg)

    # -- stage 2: Program -> MapResult -------------------------------------

    def map(
        self,
        source,
        ii_start: Optional[int] = None,
        config: Optional[MapperConfig] = None,
        jobs: Optional[int] = None,
    ) -> MapResult:
        """SAT-map with the session's CEGAR oracle and cache wired in.
        ``self.last_cache_hit`` records whether the cache answered.
        ``jobs`` bounds the portfolio racer's workers (ignored on the
        sequential path)."""
        prog = self.program(source)
        res, hit = self._map_cached(prog, ii_start=ii_start, config=config,
                                    jobs=jobs)
        self.last_cache_hit = hit
        return res

    def _oracle_active(self, prog: Program) -> bool:
        """Whether the session's CEGAR oracle applies to ``prog`` — the
        cache-key question, answered without building the per-mapping
        check closure (cheap enough to ask once per request/point).
        Custom factories may veto per program, so they are still built
        to answer; the stock assembler oracle never is."""
        if self._oracle_factory is None or prog.builder is None:
            return False
        if self._oracle_factory is assembler_oracle:
            # diagonal / one-hop interconnects cannot be assembled, so the
            # codegen oracle has nothing to say (map-only architectures)
            return self.grid.assemblable
        return self._oracle_check(prog) is not None

    def _oracle_check(self, prog: Program):
        if self._oracle_factory is None or prog.builder is None:
            return None
        if (self._oracle_factory is assembler_oracle
                and not self.grid.assemblable):
            return None
        check = self._oracle_factory(prog.builder)
        # the portfolio racer needs a *picklable* recipe for this oracle
        # to rebuild it inside racing workers; closures can't cross the
        # boundary, so attach the (kernel, oracle-spec) pair when the
        # program came from the registry (repro_torch.core.portfolio falls back
        # to the in-process race otherwise)
        if check is not None and prog.registry_name is not None:
            oracle = ("assembler"
                      if self._oracle_factory is assembler_oracle
                      else (self.oracle_tag, self._oracle_factory))
            check.race_info = {"kernel": prog.registry_name,
                               "oracle": oracle}
        return check

    def _cache_key(self, prog: Program, cfg: MapperConfig, oracled: bool) -> str:
        extra = self.oracle_tag if oracled else ""
        return mapping_cache_key(prog.dfg, self.grid, cfg, extra=extra)

    def cache_key(self, source, config: Optional[MapperConfig] = None) -> str:
        """Content-addressed identity of the map stage for ``source``
        under this session (DFG + arch + config + oracle tag) — the key
        the on-disk mapping cache and the compile server's in-flight
        dedup share."""
        prog = self.program(source)
        cfg = config or self.config
        return self._cache_key(prog, cfg, oracled=self._oracle_active(prog))

    def _map_cached(
        self,
        prog: Program,
        ii_start: Optional[int] = None,
        config: Optional[MapperConfig] = None,
        facts_seed=None,
        jobs: Optional[int] = None,
    ) -> Tuple[MapResult, bool]:
        cfg = config or self.config
        check = self._oracle_check(prog)
        extra = self.oracle_tag if check is not None else ""
        if self.facts is not None and facts_seed is None:
            facts_seed = self.facts.lift(prog.dfg, self.grid, extra)
        res, hit = map_dfg_cached(
            prog.dfg,
            self.grid,
            cfg,
            cache=self.cache,
            assemble_check=check,
            cache_extra=extra,
            ii_start=ii_start,
            facts_seed=facts_seed,
            jobs=jobs,
        )
        if self.facts is not None:
            # cache hits publish too: their stored combos/UNSAT facts are
            # proofs like any other
            self.facts.publish(prog.dfg, self.grid, extra, res)
        return res, hit

    # -- stage 3: Mapping -> AssembledCIL ----------------------------------

    def assemble(self, source, mapping: Mapping) -> AssembledCIL:
        prog = self.program(source)
        if prog.builder is None:
            msg = (
                f"{prog.name!r} is a bare DFG (origin={prog.origin!r}): "
                "code generation needs a LoopBuilder program"
            )
            raise StageError("assemble", msg)
        try:
            return assemble(prog.builder, mapping)
        except Exception as e:
            raise StageError("assemble", format_error(e), cause=e) from e

    # -- stage 4: AssembledCIL -> RuntimeMetrics ---------------------------

    def metrics(
        self,
        source,
        mapping: Mapping,
        asm: Optional[AssembledCIL] = None,
    ) -> RuntimeMetrics:
        """Calibrated latency/energy model over the assembled grid (no
        execution).  Re-assembles unless the stage-3 artifact is passed
        in.  Capability-annotated architectures get the capability-aware
        static model; plain grids keep the homogeneous constant."""
        if asm is None:
            asm = self.assemble(source, mapping)
        arch_grid = (self.grid if self.grid.caps is not None
                     or self.grid.spec.num_regs != 4 else None)
        try:
            return runtime_metrics(
                asm,
                num_cols=self.grid.spec.cols,
                utilization=mapping.utilization,
                grid=arch_grid,
            )
        except Exception as e:
            raise StageError("metrics", format_error(e), cause=e) from e

    # -- stage 5 (optional): execute on the PE-array simulator -------------

    def simulate(
        self,
        source,
        mapping: Mapping,
        mem,
        batch: int = 1,
        device="cuda",
    ):
        """Run the mapped bitstream on the PE array (the CUDA kernel on the
        card unless ``device="cpu"``); returns a
        :class:`~repro_torch.cgra.simulator.SimResult`."""
        prog = self.program(source)
        if prog.builder is None:
            msg = (
                f"{prog.name!r} is a bare DFG: execution needs a "
                "LoopBuilder program"
            )
            raise StageError("simulate", msg)
        try:
            from ..cgra.simulator import simulate

            return simulate(prog.builder, mapping, mem, batch=batch,
                            device=device)
        except StageError:
            raise
        except Exception as e:
            raise StageError("simulate", format_error(e), cause=e) from e

    # -- end-to-end --------------------------------------------------------

    def compile(
        self,
        source,
        ii_start: Optional[int] = None,
        config: Optional[MapperConfig] = None,
        jobs: Optional[int] = None,
    ) -> CompileResult:
        """source -> map -> assemble -> metrics, never raising: failures
        come back as a :class:`CompileResult` with ``stage`` set.

        ``CompileResult.timings`` is a projection of the stage trace
        spans (:mod:`repro_torch.obs.trace`): each stage runs inside a
        ``stage.*`` span whose duration is what lands in ``timings`` —
        with tracing disabled the spans degrade to plain timers, so the
        dict is populated either way and result bytes never change."""
        rows, cols = self.grid.spec.rows, self.grid.spec.cols
        if isinstance(source, str):
            kernel = source
        else:
            kernel = getattr(source, "name", type(source).__name__)
        with obs_trace.span("compile", kernel=kernel,
                            grid=f"{rows}x{cols}", arch=self.arch) as csp:
            cr = self._compile_staged(source, kernel, ii_start, config, jobs)
            csp.set(status=cr.status, stage=cr.stage,
                    cache_hit=cr.cache_hit, ii=cr.ii)
        return cr

    def _compile_staged(
        self,
        source,
        kernel: str,
        ii_start: Optional[int],
        config: Optional[MapperConfig],
        jobs: Optional[int],
    ) -> CompileResult:
        rows, cols = self.grid.spec.rows, self.grid.spec.cols
        timings: Dict[str, float] = {}
        ssp = obs_trace.timed_span("stage.source", kernel=kernel)
        try:
            with ssp:
                prog = self.program(source)
        except StageError as e:
            return CompileResult(
                kernel=kernel,
                rows=rows,
                cols=cols,
                status="error",
                arch=self.arch,
                stage=e.stage,
                error=e.error_text(),
                timings={"source": ssp.dur},
            )
        timings["source"] = ssp.dur
        cr = CompileResult(
            kernel=prog.name,
            rows=rows,
            cols=cols,
            status="error",
            arch=self.arch,
            program=prog,
            timings=timings,
        )

        msp = obs_trace.timed_span("stage.map", kernel=prog.name)
        try:
            with msp:
                res, hit = self._map_cached(prog, ii_start=ii_start,
                                            config=config, jobs=jobs)
                msp.set(cache_hit=hit, status=res.status)
        except Exception as e:
            timings["map"] = msp.dur
            cr.stage, cr.error = "map", format_error(e)
            return cr
        timings["map"] = msp.dur
        cr.map_result, cr.cache_hit = res, hit
        if res.mapping is None:
            cr.status, cr.stage = res.status, "map"
            return cr

        return self._finish(cr)

    def _finish(self, cr: CompileResult) -> CompileResult:
        """Run the post-map stages on an already-mapped result (also used
        by ``compile_many`` for cache hits and pool returns)."""
        prog, mapping = cr.program, cr.mapping
        asp = obs_trace.timed_span("stage.assemble", kernel=cr.kernel)
        try:
            with asp:
                cr.asm = self.assemble(prog, mapping)
        except StageError as e:
            cr.timings["assemble"] = asp.dur
            cr.status, cr.stage = "error", e.stage
            cr.error = e.error_text()
            return cr
        cr.timings["assemble"] = asp.dur
        msp = obs_trace.timed_span("stage.metrics", kernel=cr.kernel)
        try:
            with msp:
                cr.metrics = self.metrics(prog, mapping, cr.asm)
        except StageError as e:
            cr.timings["metrics"] = msp.dur
            cr.status, cr.stage = "error", e.stage
            cr.error = e.error_text()
            return cr
        cr.timings["metrics"] = msp.dur
        cr.status, cr.stage, cr.error = "ok", None, None
        return cr

    # -- fan-out -----------------------------------------------------------

    def compile_many(
        self,
        kernels: Sequence[str],
        grids: Optional[Sequence[ArchLike]] = None,
        jobs: Optional[int] = None,
        config: Optional[MapperConfig] = None,
        *,
        points: Optional[Sequence[PointKey]] = None,
        on_result: Optional[Callable[[PointKey, CompileResult], None]] = None,
        resilience: Optional[ResilienceConfig] = None,
    ) -> List[CompileResult]:
        """Compile a kernels x grids cross product (kernel-major order).

        Kernels must be registry names (the tasks cross a process pickle
        boundary).  ``grids`` accepts any :data:`ArchLike` — geometry
        tuples, archspec strings/presets, prebuilt grids — and
        same-geometry entries with different capability tables are
        distinct design points.  Cache hits are resolved in the parent
        and skip solving entirely; misses fan out to the supervised
        worker fleet (``os.cpu_count()``-bounded; ``jobs=1`` runs inline
        with the same retry/degradation ladder but cooperative deadlines
        only).  Solved points are written back to the cache by the
        parent — terminal sat/unsat verdicts only, and never degraded
        ones.  Post-map stages always run in the parent — they are cheap
        and keep worker payloads to plain dicts.

        ``points`` restricts the run to a subset of the cross product
        (crash-resume: the sweep journal knows what is already done);
        ``on_result`` fires in completion order as each point lands —
        the journaling hook.  ``compile_many`` itself never raises for a
        per-point failure and never drops a point: every
        :class:`CompileResult` carries either a verdict or a typed
        ``failure``.
        """
        # one "fleet" span roots the whole batch, so every fleet.point
        # bracket and every parent-side post-map stage lands in a single
        # trace tree (repro trace report shows one root per batch)
        with obs_trace.span("fleet", kernels=len(kernels),
                            jobs=jobs) as fsp:
            out = self._compile_many(kernels, grids, jobs, config,
                                     points=points, on_result=on_result,
                                     resilience=resilience)
            fsp.set(points=len(out),
                    cache_hits=sum(1 for c in out if c.cache_hit))
        return out

    def _compile_many(
        self,
        kernels: Sequence[str],
        grids: Optional[Sequence[ArchLike]] = None,
        jobs: Optional[int] = None,
        config: Optional[MapperConfig] = None,
        *,
        points: Optional[Sequence[PointKey]] = None,
        on_result: Optional[Callable[[PointKey, CompileResult], None]] = None,
        resilience: Optional[ResilienceConfig] = None,
    ) -> List[CompileResult]:
        cfg = config or self.config
        if grids is None:
            grids = [self.grid]
        grid_list = [resolve_arch(g) for g in grids]
        sessions = [self._sibling(g, src) for g, src in zip(grid_list, grids)]
        programs = {k: self.program(k) for k in kernels}
        # oracle applicability is a pure (program, grid) property: resolve
        # it once per (kernel, grid) pair at batch setup instead of
        # rebuilding the oracle closure per point and per fleet assignment
        oracle_on = {(k, gi): sessions[gi]._oracle_active(programs[k])
                     for k in kernels for gi in range(len(grid_list))}
        all_points: List[PointKey] = [(k, gi) for k in kernels
                                      for gi in range(len(grid_list))]
        if points is None:
            points = all_points
        else:
            points = [(k, int(gi)) for k, gi in points]
            bad = sorted(set(points) - set(all_points))
            if bad:
                raise ValueError(
                    f"points outside the kernels x grids product: {bad}")

        # resolve cache hits up front; only misses go to the fleet
        done: Dict[PointKey, CompileResult] = {}
        pending: List[PointKey] = []
        keys: Dict[PointKey, str] = {}
        corrupt_notes: Dict[PointKey, Dict] = {}
        for pt in points:
            kernel, gi = pt
            tc = sessions[gi]
            prog = programs[kernel]
            if self.cache is None:
                pending.append(pt)
                continue
            keys[pt] = tc._cache_key(prog, cfg, oracled=oracle_on[pt])
            stored, state = self._cache_lookup(keys[pt])
            if stored is None:
                if state == "corrupt":
                    corrupt_notes[pt] = failure_record(
                        FailureKind.CACHE_CORRUPT, "cache",
                        message=(f"quarantined corrupt cache entry for key "
                                 f"{keys[pt][:12]}; re-solving"))
                pending.append(pt)
                continue
            cr = tc.result_from_cache(prog, stored)
            self._publish_facts(tc, prog, cr.map_result)
            done[pt] = cr
            if on_result is not None:
                on_result(pt, cr)

        if pending:
            cfg_dict = dataclasses.asdict(cfg)
            if self._oracle_factory is None:
                oracle = None
            elif self._oracle_factory is assembler_oracle:
                oracle = "assembler"
            else:
                # custom oracle: ship (tag, factory) to the workers; the
                # factory must be picklable (module-level) for jobs > 1
                oracle = (self.oracle_tag, self._oracle_factory)
            tasks = []
            point_spans: Dict[PointKey, object] = {}
            for pt in pending:
                provider = None
                if self.facts is not None:
                    from ..core.facts import seed_to_jsonable

                    tc, prog = sessions[pt[1]], programs[pt[0]]
                    extra = self.oracle_tag if oracle_on[pt] else ""

                    def provider(tc=tc, prog=prog, extra=extra):
                        # late-bound: runs at *assign* time in the parent,
                        # so facts published by already-finished siblings
                        # reach every point still in the queue
                        return seed_to_jsonable(
                            self.facts.lift(prog.dfg, tc.grid, extra))

                trace_ctx = None
                if obs_trace.enabled():
                    # fleet.point brackets the task from submit to settle
                    # (queue wait included); the worker's span hangs off
                    # it via the shipped context
                    psp = obs_trace.begin(
                        "fleet.point", kernel=pt[0],
                        grid=f"{grid_list[pt[1]].spec.rows}"
                             f"x{grid_list[pt[1]].spec.cols}")
                    point_spans[pt] = psp
                    trace_ctx = psp.ship()
                tasks.append(MapTask(key=pt, kernel=pt[0],
                                     grid=grid_list[pt[1]],
                                     cfg=dict(cfg_dict), oracle=oracle,
                                     facts_provider=provider,
                                     trace_ctx=trace_ctx))

            def handle(pt: PointKey, outcome: Dict) -> None:
                cr = self._result_from_outcome(
                    pt, outcome, sessions, programs, keys, corrupt_notes)
                psp = point_spans.pop(pt, None)
                if psp is not None:
                    psp.finish(status=cr.status, retries=cr.retries,
                               degraded=cr.degraded)
                done[pt] = cr
                if on_result is not None:
                    on_result(pt, cr)

            n = jobs if jobs is not None else (os.cpu_count() or 1)
            n = max(1, min(n, len(tasks)))
            if n == 1:
                run_inline(tasks, resilience, on_outcome=handle)
            else:
                run_supervised(tasks, jobs=n, rcfg=resilience,
                               on_outcome=handle)
            for psp in point_spans.values():
                psp.finish(status="unsettled")  # defensive: never happens
        return [done[pt] for pt in points]

    def _publish_facts(self, tc: "Toolchain", prog: Program, res) -> None:
        """Feed a finished point's provable facts into the session store
        (no-op without one)."""
        if self.facts is None or res is None:
            return
        extra = self.oracle_tag if tc._oracle_active(prog) else ""
        self.facts.publish(prog.dfg, tc.grid, extra, res)

    def _cache_lookup(self, key: str):
        """``(stored, state)`` — tolerates plain dict-like caches that
        only implement ``get`` (state is then ``"miss"`` on ``None``)."""
        lookup = getattr(self.cache, "lookup", None)
        if lookup is not None:
            return lookup(key)
        stored = self.cache.get(key)
        return stored, ("hit" if stored is not None else "miss")

    def result_from_cache(self, prog: Program, stored: Dict) -> CompileResult:
        """A stored map-stage cache entry -> a finished
        :class:`CompileResult` (post-map stages run now, in this
        process).  Fact publishing stays with the caller — the store
        usually lives on a parent session."""
        res = MapResult.from_dict(prog.dfg, self.grid, stored)
        cr = CompileResult(
            kernel=prog.name,
            rows=self.grid.spec.rows,
            cols=self.grid.spec.cols,
            status="error",
            arch=self.arch,
            program=prog,
            map_result=res,
            cache_hit=True,
            timings={"map": 0.0},
        )
        if res.mapping is None:
            cr.status, cr.stage = res.status, "map"
            return cr
        return self._finish(cr)

    def result_from_outcome(
        self,
        prog: Program,
        outcome: Dict,
        cache_key: Optional[str] = None,
        corrupt_note: Optional[Dict] = None,
    ) -> CompileResult:
        """One fleet outcome
        (:func:`~repro_torch.toolchain.resilience.run_supervised` /
        :class:`~repro_torch.toolchain.resilience.WorkerPool`) -> a finished
        :class:`CompileResult`, with the parent-side cache write
        (terminal, non-degraded verdicts only, when ``cache_key`` is
        given) and the post-map stages.  Shared by ``compile_many`` and
        the :mod:`repro_torch.serve` compile server."""
        cr = CompileResult(
            kernel=prog.name,
            rows=self.grid.spec.rows,
            cols=self.grid.spec.cols,
            status="error",
            arch=self.arch,
            program=prog,
            timings={"map": outcome.get("map_time_s", 0.0)},
        )
        cr.retries = max(outcome.get("attempts", 1) - 1, 0)
        cr.degraded = outcome.get("degraded")
        cr.failure = outcome.get("failure") or corrupt_note
        if "result" not in outcome:
            cr.status = "failed"
            cr.stage = (cr.failure or {}).get("stage", "map")
            cr.error = failure_text(cr.failure)
            return cr
        res = MapResult.from_dict(prog.dfg, self.grid, outcome["result"])
        cr.map_result = res
        if (self.cache is not None and cache_key is not None
                and cr.degraded is None
                and res.status in TERMINAL_MAP_STATUSES
                # a fact-seeded solve is session-context-dependent: the
                # content-addressed key cannot see the seed, so the entry
                # must not be stored (mirrors map_dfg_cached)
                and not res.facts_used):
            self.cache.put(cache_key, outcome["result"])
            spec = chaos.active()
            if (spec is not None and spec.decide(
                    prog.name, _arch_key(self.grid), 0) == "cache-corrupt"):
                chaos.corrupt_file(self.cache._path(cache_key))
        if res.mapping is None:
            cr.status, cr.stage = res.status, "map"
            return cr
        return self._finish(cr)

    def _result_from_outcome(
        self,
        pt: PointKey,
        outcome: Dict,
        sessions: List["Toolchain"],
        programs: Dict[str, Program],
        keys: Dict[PointKey, str],
        corrupt_notes: Dict[PointKey, Dict],
    ) -> CompileResult:
        """``compile_many``'s per-point adapter over
        :meth:`result_from_outcome` (sibling-session routing + the
        parent-owned fact store)."""
        kernel, gi = pt
        tc = sessions[gi]
        prog = programs[kernel]
        cr = tc.result_from_outcome(prog, outcome, cache_key=keys.get(pt),
                                    corrupt_note=corrupt_notes.get(pt))
        self._publish_facts(tc, prog, cr.map_result)
        return cr

    def _sibling(self, grid: PEGrid, source: ArchLike = None) -> "Toolchain":
        """Same session settings over a different grid (shared cache).
        ``source`` is the original :data:`ArchLike` (for the arch label —
        a spec string carries the name the resolved grid may not)."""
        if grid is self.grid:
            return self
        if self._oracle_factory is None:
            oracle = None
        else:
            oracle = (self.oracle_tag, self._oracle_factory)
        tc = Toolchain(grid, self.config, cache=self.cache, oracle=oracle)
        if source is not None and not isinstance(source, PEGrid):
            tc.arch = arch_label(source, grid)
        return tc
