"""A self-contained incremental CDCL SAT solver.

Watched literals, 1-UIP learning, VSIDS, Luby restarts, phase saving —
plus the two hooks an incremental mapping loop needs:

* :meth:`CDCLSolver.add_clauses` appends clauses to a live solver, keeping
  learned clauses, watch lists and VSIDS activity intact (the CEGAR loop in
  ``repro.core.mapper`` adds one blocking clause per round instead of
  rebuilding the instance);
* :meth:`CDCLSolver.solve` accepts ``assumptions`` — literals asserted as
  scoped decisions for one call and fully undone afterwards, so the same
  solver answers a sequence of related queries;
* cooperative interruption — :meth:`CDCLSolver.interrupt` (cross-thread
  safe: it only sets a flag) or a ``stop()`` callable passed to
  :meth:`CDCLSolver.solve` makes the search return ``INTERRUPTED``
  promptly.  The portfolio racer (``repro.core.portfolio``) uses this to
  cancel losing strategies; the solver instance stays reusable.

This is the framework's Z3-independent backend: the production mapper uses
Z3 (as the paper does), but a deployable toolchain cannot hard-require a
system solver, and a second engine lets tests cross-check satisfiability
results on the same CNF.  Pure Python; tuned for the 10^3..10^5-clause
instances the KMS encoding produces at edge-CGRA sizes.

A copy of ``src/repro/sat/cdcl.py`` (the port imports nothing of the JAX
package).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from .cnf import CNF

SAT = "sat"
UNSAT = "unsat"
UNKNOWN = "unknown"
INTERRUPTED = "interrupted"


def luby(i: int) -> int:
    """Luby restart sequence (1,1,2,1,1,2,4,...), 0-indexed."""
    x = i + 1  # classic 1-indexed formulation
    k = 1
    while (1 << k) - 1 < x:
        k += 1
    while (1 << k) - 1 != x:
        x -= (1 << (k - 1)) - 1
        k = 1
        while (1 << k) - 1 < x:
            k += 1
    return 1 << (k - 1)


@dataclass
class Stats:
    decisions: int = 0
    propagations: int = 0
    conflicts: int = 0
    restarts: int = 0
    learned: int = 0
    solve_calls: int = 0
    clauses_added: int = 0
    #: cumulative wall time across every :meth:`CDCLSolver.solve` call
    time_s: float = 0.0
    #: wall time of the most recent :meth:`CDCLSolver.solve` call only
    last_solve_s: float = 0.0


class CDCLSolver:
    """Conflict-driven clause learning over a growable CNF."""

    def __init__(self, cnf: Optional[CNF] = None, seed: int = 0):
        self.nvars = 0
        self.clauses: List[List[int]] = []
        self.stats = Stats()
        # assignment: 0 unassigned, +1 true, -1 false (indexed by var)
        self.assign: List[int] = [0]
        self.level: List[int] = [0]
        self.reason: List[Optional[List[int]]] = [None]
        self.phase: List[bool] = [True]
        self.trail: List[int] = []
        self.trail_lim: List[int] = []
        self.qhead = 0
        # watches: lit -> list of clauses watching lit
        self.watches: Dict[int, List[List[int]]] = {}
        self.activity: List[float] = [0.0]
        self.var_inc = 1.0
        self.var_decay = 0.95
        self._ok = True
        self._model: Optional[List[int]] = None
        self._interrupt = False
        # progress telemetry: when set, called with ``self.stats`` every
        # ``progress_every`` conflicts (observability hook — the callback
        # must not mutate solver state)
        self.on_progress: Optional[Callable[[Stats], None]] = None
        self.progress_every = 2048
        if cnf is not None:
            self.ensure_var(cnf.num_vars)
            self.add_clauses(cnf.clauses)

    # -- growth --------------------------------------------------------------

    def ensure_var(self, v: int) -> None:
        while self.nvars < v:
            self.nvars += 1
            self.assign.append(0)
            self.level.append(0)
            self.reason.append(None)
            self.phase.append(True)
            self.activity.append(0.0)

    def add_clauses(self, clauses: Iterable[Sequence[int]]) -> bool:
        """Append clauses, preserving learned clauses and heuristic state.

        Returns False if the instance became root-level UNSAT.  Any
        in-progress assignment above the root level is undone (callers add
        clauses between :meth:`solve` calls, never mid-search).
        """
        self._backtrack(0)
        for raw in clauses:
            self.stats.clauses_added += 1
            lits = set(raw)
            if any(-l in lits for l in lits):
                continue  # tautology
            for l in lits:
                self.ensure_var(abs(l))
            # root-level simplification: drop satisfied clauses, strip
            # falsified literals (root assignments are permanent)
            clause: List[int] = []
            satisfied = False
            for l in lits:
                v = self._value(l)
                if v > 0:
                    satisfied = True
                    break
                if v == 0:
                    clause.append(l)
            if satisfied:
                continue
            if not clause:
                self._ok = False
                return False
            if len(clause) == 1:
                self._enqueue(clause[0], None)
            else:
                self.clauses.append(clause)
                self._watch(clause)
        if self._ok and self._propagate() is not None:
            self._ok = False
        return self._ok

    def _watch(self, clause: List[int]) -> None:
        self.watches.setdefault(clause[0], []).append(clause)
        self.watches.setdefault(clause[1], []).append(clause)

    # -- basic ops -----------------------------------------------------------

    def _value(self, lit: int) -> int:
        v = self.assign[abs(lit)]
        return v if lit > 0 else -v

    def _enqueue(self, lit: int, reason: Optional[List[int]]) -> None:
        v = abs(lit)
        self.assign[v] = 1 if lit > 0 else -1
        self.level[v] = len(self.trail_lim)
        self.reason[v] = reason
        self.trail.append(lit)

    def _propagate(self) -> Optional[List[int]]:
        """Unit propagation; returns a conflicting clause or None."""
        while self.qhead < len(self.trail):
            lit = self.trail[self.qhead]
            self.qhead += 1
            self.stats.propagations += 1
            neg = -lit
            watchlist = self.watches.get(neg)
            if not watchlist:
                continue
            new_list: List[List[int]] = []
            i = 0
            n = len(watchlist)
            conflict: Optional[List[int]] = None
            while i < n:
                clause = watchlist[i]
                i += 1
                # ensure clause[1] == neg
                if clause[0] == neg:
                    clause[0], clause[1] = clause[1], clause[0]
                first = clause[0]
                if self._value(first) > 0:
                    new_list.append(clause)
                    continue
                # search replacement watch
                found = False
                for j in range(2, len(clause)):
                    if self._value(clause[j]) >= 0:
                        clause[1], clause[j] = clause[j], clause[1]
                        self.watches.setdefault(clause[1], []).append(clause)
                        found = True
                        break
                if found:
                    continue
                new_list.append(clause)
                if self._value(first) < 0:
                    # conflict: keep remaining watches, bail out
                    new_list.extend(watchlist[i:])
                    conflict = clause
                    break
                self._enqueue(first, clause)
            self.watches[neg] = new_list
            if conflict is not None:
                return conflict
        return None

    # -- conflict analysis ----------------------------------------------------

    def _bump(self, v: int) -> None:
        self.activity[v] += self.var_inc
        if self.activity[v] > 1e100:
            for i in range(1, self.nvars + 1):
                self.activity[i] *= 1e-100
            self.var_inc *= 1e-100

    def _analyze(self, conflict: List[int]) -> Tuple[List[int], int]:
        """1-UIP learning. Returns (learned clause, backtrack level)."""
        learnt: List[int] = [0]  # placeholder for the asserting literal
        seen = [False] * (self.nvars + 1)
        path_count = 0
        pivot_var = 0  # variable resolved away this step (0 = none yet)
        reason: Sequence[int] = conflict
        idx = len(self.trail) - 1
        cur_level = len(self.trail_lim)
        while True:
            for q in reason:
                v = abs(q)
                if v == pivot_var:
                    continue  # the literal being resolved on
                if not seen[v] and self.level[v] > 0:
                    seen[v] = True
                    self._bump(v)
                    if self.level[v] >= cur_level:
                        path_count += 1
                    else:
                        learnt.append(q)
            # pick next literal from trail
            while not seen[abs(self.trail[idx])]:
                idx -= 1
            p = self.trail[idx]
            pivot_var = abs(p)
            seen[pivot_var] = False
            path_count -= 1
            idx -= 1
            if path_count == 0:
                learnt[0] = -p
                break
            reason = self.reason[pivot_var] or ()
        if len(learnt) == 1:
            return learnt, 0
        # backtrack to second-highest level in the clause
        bt = max(self.level[abs(q)] for q in learnt[1:])
        # move a literal of level bt to position 1 (watch invariant)
        for i in range(1, len(learnt)):
            if self.level[abs(learnt[i])] == bt:
                learnt[1], learnt[i] = learnt[i], learnt[1]
                break
        return learnt, bt

    def _backtrack(self, level: int) -> None:
        if len(self.trail_lim) <= level:
            return
        limit = self.trail_lim[level]
        for lit in self.trail[limit:]:
            v = abs(lit)
            self.phase[v] = self.assign[v] > 0  # phase saving
            self.assign[v] = 0
            self.reason[v] = None
        del self.trail[limit:]
        del self.trail_lim[level:]
        self.qhead = min(self.qhead, len(self.trail))

    def _decide(self) -> int:
        best, besta = 0, -1.0
        activity = self.activity
        assign = self.assign
        for v in range(1, self.nvars + 1):
            if assign[v] == 0 and activity[v] > besta:
                best, besta = v, activity[v]
        return best

    # -- main loop -------------------------------------------------------------

    def interrupt(self) -> None:
        """Request the in-flight :meth:`solve` call to return
        ``INTERRUPTED``.  Safe to call from another thread (it only sets
        a flag, checked at every decision and every conflict); the flag
        is cleared when the next :meth:`solve` call starts, so the
        solver instance stays reusable after a cancellation."""
        self._interrupt = True

    def solve(self, timeout_s: Optional[float] = None,
              max_conflicts: Optional[int] = None,
              assumptions: Sequence[int] = (),
              stop: Optional[Callable[[], bool]] = None) -> str:
        """Solve the current clause set under ``assumptions``.

        Learned clauses, watch lists, VSIDS activity and saved phases
        persist across calls; assumptions are asserted as scoped decisions
        and fully undone before returning.  ``max_conflicts`` bounds this
        call, not the solver lifetime.  ``stop`` is polled at every
        decision and every conflict alongside the :meth:`interrupt` flag;
        either one truthy makes this call return ``INTERRUPTED`` (learned
        state is kept — a later call may resume the search).
        """
        t0 = time.monotonic()
        self.stats.solve_calls += 1
        self._interrupt = False  # a cancel aimed at a previous call is stale
        conflicts_at_entry = self.stats.conflicts
        for a in assumptions:
            self.ensure_var(abs(a))
        self._backtrack(0)

        def finish(res: str) -> str:
            dt = time.monotonic() - t0
            self.stats.last_solve_s = dt
            self.stats.time_s += dt
            if res == SAT:
                self._model = list(self.assign)
            self._backtrack(0)
            return res

        if not self._ok:
            return finish(UNSAT)
        if self._propagate() is not None:
            self._ok = False
            return finish(UNSAT)
        restart_idx = 0
        conflicts_until_restart = 100 * luby(0)
        while True:
            if self._interrupt or (stop is not None and stop()):
                return finish(INTERRUPTED)
            if timeout_s is not None and time.monotonic() - t0 > timeout_s:
                return finish(UNKNOWN)
            if (max_conflicts is not None
                    and self.stats.conflicts - conflicts_at_entry
                    > max_conflicts):
                return finish(UNKNOWN)
            # next decision: first unmet assumption, else VSIDS choice
            lit = 0
            failed_assumption = False
            for a in assumptions:
                val = self._value(a)
                if val > 0:
                    continue
                if val < 0:
                    failed_assumption = True
                else:
                    lit = a
                break
            if failed_assumption:
                # incompatible with the clause set given earlier assumptions
                return finish(UNSAT)
            if lit == 0:
                v = self._decide()
                if v == 0:
                    return finish(SAT)
                lit = v if self.phase[v] else -v
            self.stats.decisions += 1
            self.trail_lim.append(len(self.trail))
            self._enqueue(lit, None)
            while True:
                conflict = self._propagate()
                if conflict is None:
                    break
                # the conflict loop is where long UNSAT-ish searches live;
                # polling here bounds cancellation latency by one
                # propagate+analyze step
                if self._interrupt or (stop is not None and stop()):
                    return finish(INTERRUPTED)
                self.stats.conflicts += 1
                if (self.on_progress is not None
                        and self.stats.conflicts % self.progress_every == 0):
                    self.on_progress(self.stats)
                conflicts_until_restart -= 1
                if len(self.trail_lim) == 0:
                    self._ok = False
                    return finish(UNSAT)
                learnt, bt = self._analyze(conflict)
                self._backtrack(bt)
                self.stats.learned += 1
                if len(learnt) == 1:
                    if self._value(learnt[0]) < 0:
                        self._ok = False
                        return finish(UNSAT)
                    if self.assign[abs(learnt[0])] == 0:
                        self._enqueue(learnt[0], None)
                else:
                    self.clauses.append(learnt)
                    self._watch(learnt)
                    self._enqueue(learnt[0], learnt)
                self.var_inc /= self.var_decay
                if conflicts_until_restart <= 0:
                    restart_idx += 1
                    self.stats.restarts += 1
                    conflicts_until_restart = 100 * luby(restart_idx)
                    self._backtrack(0)
                    break

    def model(self) -> Dict[int, bool]:
        """Model of the last SAT :meth:`solve` call (stable across later
        :meth:`add_clauses`/UNSAT calls until the next SAT answer).  Raises
        if no call has returned SAT yet."""
        if self._model is None:
            raise ValueError("no model available: no solve() call has "
                             "returned SAT yet")
        src = self._model
        # vars added after the snapshot default to False
        return {v: (src[v] > 0 if v < len(src) else False)
                for v in range(1, self.nvars + 1)}


def solve_cnf(cnf: CNF, timeout_s: Optional[float] = None,
              seed: int = 0) -> Tuple[str, Optional[Dict[int, bool]], Stats]:
    solver = CDCLSolver(cnf, seed=seed)
    res = solver.solve(timeout_s=timeout_s)
    return res, solver.model() if res == SAT else None, solver.stats
