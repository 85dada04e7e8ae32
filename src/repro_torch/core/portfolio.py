"""Solver portfolio racer with a speculative II ladder.

For each II the racer launches every strategy in a
:class:`~repro_torch.core.backends.PortfolioSpec` concurrently (on the supervised
fleet of :mod:`repro_torch.toolchain.resilience`) and speculatively starts the next ``spec_ii - 1``
ladder rungs before the current one resolves.  The first *definitive*
verdict decides an II; losers are cancelled through the cooperative
interruption hooks (:meth:`CDCLSolver.interrupt` / ``z3.interrupt()``)
and their answers — tagged ``"interrupted"`` — are discarded.

Determinism
-----------
The committed result never depends on finish order, because only two
kinds of events can decide an II rung:

* a solver-**proven UNSAT**, from *any* strategy — a fact about the
  solution space, not about who searched it, so it can never conflict
  with another strategy's outcome at the same II (a SAT witness and an
  UNSAT proof cannot coexist);
* otherwise, the **primary** strategy's verdict (index 0: mapped, RA
  failure, CEGAR exhaustion, timeout) — exactly the sequential ladder's.
  A non-primary ``mapped`` or heuristic advance is telemetry, never a
  decision: two opposite-sign "decisive" verdicts for one II (primary
  RA-advance vs. racer mapped) would otherwise make the committed II a
  function of arrival order.

The final mapping is committed at the **lowest feasible II** once every
lower rung is decided infeasible, however early a speculative II+1
worker finished (:class:`RaceBook` is a pure, order-independent decision
state machine — tested by feeding it adversarial orders).  Consequently
portfolio II == sequential-primary II; the racers contribute by proving
UNSAT rungs early (cancelling the primary's doomed search — the
expensive part of the SAT-MapIt ladder) and by warming the speculative
rungs the primary has not reached yet.  Two residual, documented
divergences: racer-discovered CEGAR combos pre-block the primary's pool
(can only skip refutation rounds the sequential run would repeat), and
under ``on_timeout="fail"`` a racer's UNSAT proof can beat the primary's
terminal timeout (strictly more knowledge, never a different II).

Shared context
--------------
CEGAR counterexamples discovered by any racer are folded into the
parent's pool and shipped with every later-launched task (a blocking
clause is sound at every II and for every strategy: it excludes a
mapping the assembler rejected).  Lifted cross-point facts
(:mod:`repro_torch.core.facts`) seed the pool and pre-decide UNSAT rungs the
same way the sequential ladder consumes them.

``jobs=1`` (or an unpicklable oracle closure) degrades to an in-process
race: strategies run in spec order per II, so the primary — always
decisive — answers first and the race collapses to exactly the
sequential incremental ladder, with no subprocess overhead.

A copy of ``src/repro/core/portfolio.py``.  A racing worker rebuilds its
program and oracle on the host and never touches CUDA.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

from ..cgra.arch import PEGrid
from ..obs import trace as obs_trace
from .backends import PortfolioSpec, parse_strategy
from .dfg import DFG
from .mapper import (IIOutcome, MapperConfig, MapResult, _merge_outcome,
                     attempt_ii, combos_from_jsonable, combos_to_jsonable)
from .mii import min_ii
from .schedule import asap_alap


def _combo_key(combo) -> str:
    return repr(sorted((n, p, s.c, s.it) for (n, p, s) in combo))


class RaceBook:
    """Order-independent decision state for one portfolio race.

    Feed it ``record(ii, sidx, outcome)`` events in *any* order; it
    answers which (II, strategy) tasks are worth running
    (:meth:`wanted`), which running tasks became moot and should be
    cancelled (:meth:`moot`), and — once enough rungs are decided — the
    final resolution.  The commit rule: the lowest II with a decisive
    ``"mapped"`` outcome, reachable only through rungs decided
    ``"advance"``; a speculative II+1 finishing first changes nothing
    until every lower rung is decided.
    """

    def __init__(self, spec: PortfolioSpec, start_ii: int, ii_max: int,
                 known_unsat=()):
        self.spec = spec
        self.start = start_ii
        self.ii_max = ii_max
        self.decided: Dict[int, str] = {}   # ii -> mapped|advance|timeout
        self.mapped: Dict[int, Tuple[int, IIOutcome]] = {}  # ii -> (sidx, out)
        self.completed: Dict[Tuple[int, int], IIOutcome] = {}
        self.lost: Set[Tuple[int, int]] = set()
        for ii in known_unsat:
            # lifted UNSAT-at-II fact: the rung is decided without solving
            self.decided[int(ii)] = "advance"

    # -- decision rules ----------------------------------------------------

    def decisive(self, sidx: int, out: IIOutcome) -> bool:
        """Only a proven UNSAT (strategy-independent fact) or the primary
        strategy's own verdict may decide a rung — see the module
        docstring's determinism argument."""
        if out.verdict == "interrupted":
            return False              # cancelled racer: the II stays open
        if out.proven_unsat:
            return True
        return sidx == 0

    def record(self, ii: int, sidx: int, out: IIOutcome) -> None:
        if out.verdict != "interrupted":
            self.completed[(ii, sidx)] = out
        if ii in self.decided:
            return
        if self.decisive(sidx, out):
            self.decided[ii] = out.verdict
            if out.verdict == "mapped":
                self.mapped[ii] = (sidx, out)
            return
        self._settle_if_exhausted(ii)

    def record_lost(self, ii: int, sidx: int) -> None:
        """A racer crashed out of its retries: treat as indecisive."""
        self.lost.add((ii, sidx))
        self._settle_if_exhausted(ii)

    def _settle_if_exhausted(self, ii: int) -> None:
        """The primary is lost and every strategy has answered or is
        lost: the lowest-index completed outcome decides (deterministic —
        worker losses are themselves deterministic under the chaos
        harness, and real crashes forfeit replay determinism anyway)."""
        if ii in self.decided:
            return
        n = len(self.spec.strategies)
        if (ii, 0) not in self.lost:
            return                    # the primary will decide this rung
        if not all((ii, s) in self.completed or (ii, s) in self.lost
                   for s in range(n)):
            return
        for s in range(n):
            out = self.completed.get((ii, s))
            if out is not None:
                self.decided[ii] = out.verdict
                if out.verdict == "mapped":
                    self.mapped[ii] = (s, out)
                return
        # all lost: needs_inline() will surface it for a parent-side solve

    # -- scheduling queries ------------------------------------------------

    def window(self) -> List[int]:
        """The first ``spec_ii`` undecided rungs (skipping decided ones,
        stopping at a mapped/timeout rung and at the II cap)."""
        iis: List[int] = []
        ii = self.start
        while len(iis) < max(self.spec.spec_ii, 1) and ii <= self.ii_max:
            v = self.decided.get(ii)
            if v in ("mapped", "timeout"):
                break
            if v is None:
                iis.append(ii)
            ii += 1
        return iis

    def wanted(self) -> List[Tuple[int, int]]:
        """(ii, strategy-index) tasks worth running now, ladder-ordered."""
        return [(ii, s)
                for ii in self.window()
                for s in range(len(self.spec.strategies))
                if (ii, s) not in self.completed and (ii, s) not in self.lost]

    def moot(self, ii: int) -> bool:
        """True when a task at ``ii`` can no longer affect the result."""
        if ii in self.decided:
            return True
        return any(v == "mapped" and jj < ii
                   for jj, v in self.decided.items())

    def needs_inline(self) -> Optional[int]:
        """An undecided rung whose every racer is lost (the fleet cannot
        answer it): the parent must solve it in-process."""
        n = len(self.spec.strategies)
        for ii in self.window():
            if all((ii, s) in self.lost for s in range(n)):
                return ii
        return None

    def resolution(self) -> Optional[Tuple[str, Optional[int]]]:
        """``("mapped", ii)`` / ``("unsat-capped", None)`` /
        ``("timeout", None)`` once decided, else None (keep racing)."""
        ii = self.start
        while ii <= self.ii_max:
            v = self.decided.get(ii)
            if v == "mapped":
                return ("mapped", ii)
            if v == "timeout":
                return ("timeout", None)
            if v is None:
                return None
            ii += 1
        return ("unsat-capped", None)


# ---------------------------------------------------------------------------
# worker-side entry point (a "race-ii" payload on the fleet)
# ---------------------------------------------------------------------------


def _outcome_to_jsonable(out: IIOutcome) -> Dict[str, Any]:
    import dataclasses as _dc

    return {
        "ii": out.ii, "verdict": out.verdict,
        "mapping": out.mapping.to_dict() if out.mapping else None,
        "attempts": [_dc.asdict(a) for a in out.attempts],
        "encodings_built": out.encodings_built,
        "incremental_solves": out.incremental_solves,
        "cegar_rounds": out.cegar_rounds,
        "new_blocked": combos_to_jsonable(out.new_blocked),
        "validation_errors": list(out.validation_errors),
        "proven_unsat": out.proven_unsat,
    }


def _outcome_from_jsonable(dfg: DFG, grid: PEGrid,
                           d: Dict[str, Any]) -> IIOutcome:
    from .mapper import IIAttempt
    from .mapping import Mapping

    return IIOutcome(
        ii=d["ii"], verdict=d["verdict"],
        mapping=(Mapping.from_dict(dfg, grid, d["mapping"])
                 if d.get("mapping") else None),
        attempts=[IIAttempt(**a) for a in d.get("attempts", [])],
        encodings_built=d.get("encodings_built", 0),
        incremental_solves=d.get("incremental_solves", 0),
        cegar_rounds=d.get("cegar_rounds", 0),
        new_blocked=combos_from_jsonable(d.get("new_blocked", [])),
        validation_errors=list(d.get("validation_errors", [])),
        proven_unsat=d.get("proven_unsat", False))


def run_race_payload(payload: Dict[str, Any], inline: bool = False,
                     cancel=None) -> Dict[str, Any]:
    """One (II, strategy) attempt in a worker process.  Never raises:
    failures come back structured, like :func:`_run_map_payload`.  The
    ``cancel`` event (set by the parent's ``_Worker.cancel``) is polled
    through the solver's cooperative ``stop`` hook."""
    with obs_trace.span("worker.race", parent=payload.get("trace"),
                        kernel=payload.get("kernel"), ii=payload["ii"],
                        strategy=payload["strategy"],
                        attempt=payload.get("attempt", 0)) as wsp:
        res = _run_race_payload(payload, inline=inline, cancel=cancel)
        if "outcome" in res:
            wsp.set(verdict=res["outcome"]["verdict"])
        elif "failure" in res:
            wsp.set(failure=res["failure"].get("kind"))
    return res


def _run_race_payload(payload: Dict[str, Any], inline: bool = False,
                      cancel=None) -> Dict[str, Any]:
    from ..toolchain import chaos
    from ..toolchain.resilience import (FailureKind, _arch_key,
                                        classify_exception, failure_record)

    kernel = payload.get("kernel")
    dfg = payload.get("dfg")
    grid = payload["grid"]
    ii = payload["ii"]
    strategy_name = payload["strategy"]
    attempt = payload.get("attempt", 0)
    label = f"{kernel or getattr(dfg, 'name', 'dfg')}@ii{ii}+{strategy_name}"

    spec = chaos.active()
    if spec is not None:
        kind = spec.decide(label, _arch_key(grid), attempt)
        if kind in ("crash", "hang", "solver-error"):
            try:
                chaos.inject_worker_fault(kind, spec, inline=inline)
            except chaos.ChaosError as e:
                return {"failure": failure_record(
                    FailureKind.SOLVER_ERROR, "race", e, attempt=attempt),
                    "map_time_s": 0.0}

    t0 = time.monotonic()
    try:
        cfg = MapperConfig(**payload["cfg"])
        strategy = parse_strategy(strategy_name)
        check = None
        if dfg is None:
            # registry kernel: rebuild the program (and its oracle) here —
            # closures never cross the pickle boundary
            from ..toolchain.session import Toolchain

            tc = Toolchain(grid, cfg, oracle=payload.get("oracle"))
            prog = tc.program(kernel)
            dfg = prog.dfg
            check = tc._oracle_check(prog)
        ms = asap_alap(dfg)
        blocked = combos_from_jsonable(payload.get("blocked", ()))
        deadline = (t0 + cfg.total_timeout_s
                    if cfg.total_timeout_s is not None else None)
        stop = cancel.is_set if cancel is not None else None
        out = attempt_ii(dfg, grid, ms, ii, cfg, strategy, blocked,
                         assemble_check=check, deadline=deadline, stop=stop)
    except BaseException as e:
        if isinstance(e, (KeyboardInterrupt, SystemExit)):
            raise
        return {"failure": failure_record(
            classify_exception(e), "race", e, attempt=attempt),
            "map_time_s": time.monotonic() - t0}
    return {"outcome": _outcome_to_jsonable(out),
            "map_time_s": time.monotonic() - t0}


# ---------------------------------------------------------------------------
# the parent-side racer
# ---------------------------------------------------------------------------


@dataclass
class _RaceTask:
    """Duck-typed :class:`MapTask` stand-in for ``_Worker.assign``."""

    kernel: Optional[str]
    dfg_obj: Any                     # shipped only for oracle-less races
    grid: Any
    cfg: Dict[str, Any]
    oracle: Any
    ii: int
    sidx: int
    strategy_name: str
    blocked: List = field(default_factory=list)   # jsonable pool snapshot
    attempt: int = 0
    trace_ctx: Optional[Dict[str, str]] = None    # obs span shipping context

    def payload(self) -> Dict[str, Any]:
        p = {"kind": "race-ii", "kernel": self.kernel, "dfg": self.dfg_obj,
             "grid": self.grid, "cfg": self.cfg, "oracle": self.oracle,
             "ii": self.ii, "strategy": self.strategy_name,
             "blocked": self.blocked, "attempt": self.attempt}
        if self.trace_ctx is not None:
            p["trace"] = self.trace_ctx
        return p

    def attempt_id(self) -> Tuple[int, int, int]:
        return (self.ii, self.sidx, self.attempt)

    def deadline_s(self, rcfg) -> Optional[float]:
        return rcfg.point_deadline_s(self.cfg.get("total_timeout_s"))


def map_dfg_portfolio(dfg: DFG, grid: PEGrid, cfg: MapperConfig,
                      spec: PortfolioSpec, *,
                      ii_start: Optional[int] = None,
                      assemble_check=None,
                      facts_seed: Optional[Dict] = None,
                      jobs: Optional[int] = None) -> MapResult:
    """Race ``spec`` over the II ladder; same contract as the sequential
    :func:`repro_torch.core.mapper.map_dfg`.  Dispatched to automatically when a
    :class:`MapperConfig` strategy names more than one strategy or a
    speculation depth > 1."""
    with obs_trace.span("portfolio.race",
                        strategies=[s.name for s in spec.strategies],
                        spec_ii=spec.spec_ii) as sp:
        result = _map_dfg_portfolio(dfg, grid, cfg, spec, ii_start=ii_start,
                                    assemble_check=assemble_check,
                                    facts_seed=facts_seed, jobs=jobs)
        sp.set(status=result.status, ii=result.ii,
               raced=result.strategies_raced,
               cancelled=result.cancelled_after_s is not None,
               winner=result.winner, facts_used=result.facts_used)
    return result


def _map_dfg_portfolio(dfg: DFG, grid: PEGrid, cfg: MapperConfig,
                       spec: PortfolioSpec, *,
                       ii_start: Optional[int] = None,
                       assemble_check=None,
                       facts_seed: Optional[Dict] = None,
                       jobs: Optional[int] = None) -> MapResult:
    import os

    t_start = time.monotonic()
    deadline = (t_start + cfg.total_timeout_s
                if cfg.total_timeout_s is not None else None)
    ms = asap_alap(dfg)
    mii = min_ii(dfg, grid.num_pes)
    start = max(mii, ii_start or 0)
    result = MapResult(mapping=None, status="unsat-capped", mii=mii,
                       backend=spec.strategies[0].backend)

    pool: List = []
    pool_seen: Set[str] = set()
    known_unsat: Set[int] = set()
    ii_max = cfg.ii_max
    if facts_seed:
        for combo in facts_seed.get("blocked", ()):
            k = _combo_key(combo)
            if k not in pool_seen:
                pool_seen.add(k)
                pool.append(combo)
        known_unsat = set(facts_seed.get("unsat_iis", ()))
        cap = facts_seed.get("ii_cap")
        if cap is not None:
            ii_max = min(ii_max, cap)
        result.facts_used = (len(pool) + len(known_unsat)
                             + (1 if cap is not None else 0))

    book = RaceBook(spec, start, ii_max, known_unsat=known_unsat)
    counters = {"raced": 0, "cancelled": False, "commit_at": None}

    race_info = getattr(assemble_check, "race_info", None)
    n = jobs if jobs is not None else (os.cpu_count() or 1)
    n = max(1, min(n, len(spec.strategies) * max(spec.spec_ii, 1)))
    forked = (n > 1 and (assemble_check is None or race_info is not None))
    if forked:
        timed_out = _race_fleet(dfg, grid, cfg, spec, book,
                                race_info=race_info,
                                assemble_check=assemble_check,
                                ms=ms, pool=pool, pool_seen=pool_seen,
                                jobs=n, deadline=deadline,
                                counters=counters)
    else:
        timed_out = _race_inline(dfg, grid, cfg, spec, book,
                                 assemble_check=assemble_check, ms=ms,
                                 pool=pool, pool_seen=pool_seen,
                                 deadline=deadline, counters=counters)

    # -- assemble the MapResult (order-independent: walk (ii, sidx)) -------
    res = book.resolution()
    if timed_out and (res is None or res[0] != "mapped"):
        status, mapped_ii = "timeout", None
    elif res is None:
        status, mapped_ii = "timeout", None
    else:
        status, mapped_ii = res
    for (ii, sidx) in sorted(book.completed):
        if mapped_ii is not None and ii > mapped_ii:
            continue
        _merge_outcome(result, book.completed[(ii, sidx)])
    result.unsat_iis = sorted(set(result.unsat_iis))
    deduped: List = []
    seen: Set[str] = set()
    for combo in result.blocked_combos:
        k = _combo_key(combo)
        if k not in seen:
            seen.add(k)
            deduped.append(combo)
    result.blocked_combos = deduped
    result.status = status
    if mapped_ii is not None:
        win_sidx, win_out = book.mapped[mapped_ii]
        result.mapping = win_out.mapping
        result.backend = spec.strategies[win_sidx].backend
        result.winner = spec.strategies[win_sidx].name
    result.strategies_raced = counters["raced"]
    if counters["cancelled"]:
        commit_at = counters["commit_at"] or time.monotonic()
        result.cancelled_after_s = commit_at - t_start
    result.total_time_s = time.monotonic() - t_start
    return result


def _race_inline(dfg, grid, cfg, spec, book, *, assemble_check, ms,
                 pool, pool_seen, deadline, counters) -> bool:
    """In-process race: strategies run in spec order per rung, so the
    primary — always decisive — collapses this to the sequential ladder.
    Returns True on a wall-clock timeout."""
    while book.resolution() is None:
        if deadline is not None and time.monotonic() > deadline:
            return True
        tasks = book.wanted()
        if not tasks:
            return False   # defensive: nothing runnable, nothing decided
        ii, sidx = tasks[0]
        out = attempt_ii(dfg, grid, ms, ii, cfg, spec.strategies[sidx],
                         pool, assemble_check=assemble_check,
                         deadline=deadline)
        counters["raced"] += 1
        _absorb(pool, pool_seen, out.new_blocked)
        book.record(ii, sidx, out)
        obs_trace.event("race.verdict", ii=ii,
                        strategy=spec.strategies[sidx].name,
                        verdict=out.verdict, proven_unsat=out.proven_unsat)
    return False


def _absorb(pool, pool_seen, combos) -> None:
    for combo in combos:
        k = _combo_key(combo)
        if k not in pool_seen:
            pool_seen.add(k)
            pool.append(combo)


def _race_fleet(dfg, grid, cfg, spec, book, *, race_info, assemble_check,
                ms, pool, pool_seen, jobs, deadline, counters) -> bool:
    """Race on supervised worker processes (the fleet's primitives).
    Crashed racers retry with a fresh worker; a rung whose every racer is
    lost falls back to a parent-side inline solve.  Returns True on a
    wall-clock timeout."""
    import dataclasses as _dc
    import multiprocessing
    from multiprocessing.connection import wait as _conn_wait

    from ..toolchain.resilience import (ResilienceConfig, _classify_exitcode,
                                        _Worker)

    rcfg = ResilienceConfig()
    ctx = multiprocessing.get_context()
    cfg_dict = _dc.asdict(cfg)
    kernel = race_info["kernel"] if race_info else None
    oracle = race_info["oracle"] if race_info else None
    dfg_obj = None if kernel is not None else dfg

    workers: List[_Worker] = []
    for _ in range(jobs):
        workers.append(_Worker(ctx, peers=workers))
    inflight: Dict[Tuple[int, int], _Worker] = {}
    retries: Dict[Tuple[int, int], int] = {}
    timed_out = False

    def respawn(w: _Worker) -> None:
        idx = workers.index(w)
        others = workers[:idx] + workers[idx + 1:]
        workers[idx] = _Worker(ctx, peers=others)

    def requeue_or_lose(key: Tuple[int, int]) -> None:
        retries[key] = retries.get(key, 0) + 1
        if retries[key] > rcfg.max_retries:
            book.record_lost(*key)
            obs_trace.event("race.lost", ii=key[0], sidx=key[1])

    def cancel_moot() -> None:
        for (kii, ks), ww in list(inflight.items()):
            if book.moot(kii) and ww.cancel():
                counters["cancelled"] = True
                obs_trace.event("race.cancel", ii=kii,
                                strategy=spec.strategies[ks].name)

    try:
        while book.resolution() is None:
            now = time.monotonic()
            if deadline is not None and now > deadline:
                timed_out = True
                break
            fb = book.needs_inline()
            if fb is not None:
                out = attempt_ii(dfg, grid, ms, fb, cfg, spec.strategies[0],
                                 pool, assemble_check=assemble_check,
                                 deadline=deadline)
                counters["raced"] += 1
                _absorb(pool, pool_seen, out.new_blocked)
                book.record(fb, 0, out)
                obs_trace.event("race.verdict", ii=fb,
                                strategy=spec.strategies[0].name,
                                verdict=out.verdict, inline_fallback=True)
                continue
            want = [t for t in book.wanted() if t not in inflight]
            for w in workers:
                if w.busy or not want:
                    continue
                ii, sidx = want.pop(0)
                task = _RaceTask(kernel=kernel, dfg_obj=dfg_obj, grid=grid,
                                 cfg=dict(cfg_dict), oracle=oracle, ii=ii,
                                 sidx=sidx,
                                 strategy_name=spec.strategies[sidx].name,
                                 blocked=combos_to_jsonable(pool),
                                 attempt=retries.get((ii, sidx), 0),
                                 trace_ctx=obs_trace.shipping_context())
                w.assign(task, rcfg, now)
                inflight[(ii, sidx)] = w
                counters["raced"] += 1
            busy = [w for w in workers if w.busy]
            if not busy:
                time.sleep(0.01)
                continue
            timeout = 0.2
            for w in busy:
                if w.deadline_at is not None:
                    timeout = min(timeout, max(w.deadline_at - now, 0.0))
            for conn in _conn_wait([w.conn for w in busy], timeout):
                w = next(x for x in busy if x.conn is conn)
                task = w.task
                key = (task.ii, task.sidx)
                try:
                    task_id, out = conn.recv()
                except (EOFError, OSError):
                    w.proc.join(timeout=5.0)
                    _classify_exitcode(w.proc.exitcode)  # taxonomy hook
                    w.conn.close()
                    respawn(w)
                    inflight.pop(key, None)
                    requeue_or_lose(key)
                    continue
                if task_id != task.attempt_id():
                    continue   # stale answer from a pre-kill attempt
                w.task, w.deadline_at = None, None
                inflight.pop(key, None)
                if "failure" in out:
                    requeue_or_lose(key)
                    continue
                outcome = _outcome_from_jsonable(dfg, grid, out["outcome"])
                _absorb(pool, pool_seen, outcome.new_blocked)
                book.record(task.ii, task.sidx, outcome)
                obs_trace.event("race.verdict", ii=task.ii,
                                strategy=task.strategy_name,
                                verdict=outcome.verdict,
                                proven_unsat=outcome.proven_unsat)
                if (book.resolution() is not None
                        and counters["commit_at"] is None):
                    counters["commit_at"] = time.monotonic()
                    obs_trace.event("race.commit")
                cancel_moot()
            # parent-side per-attempt deadline: kill, heal, retry
            now = time.monotonic()
            for w in list(workers):
                if not w.busy or w.deadline_at is None or now < w.deadline_at:
                    continue
                task = w.task
                key = (task.ii, task.sidx)
                w.kill()
                respawn(w)
                inflight.pop(key, None)
                requeue_or_lose(key)
    finally:
        for w in workers:
            w.shutdown()
    return timed_out
