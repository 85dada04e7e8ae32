"""Solver backends for the KMS encoding: Z3 (as in the paper) and our CDCL.

Both are exposed two ways:

* **Sessions** (:class:`Z3Session`, :class:`CDCLSession`) — a persistent
  solver bound to one :class:`KMSEncoding`.  The encoding is translated
  once; CEGAR blocking clauses are appended with
  :meth:`SolverSession.add_clause` and re-solves keep learned clauses /
  solver heuristic state warm.  This is what the incremental mapper loop
  uses.
* **One-shot functions** (:func:`solve_z3`, :func:`solve_cdcl`) — build a
  fresh session, solve, discard.  Kept for tests and ablation baselines.

All return ``(status, model, stats)`` with status in
{"sat", "unsat", "unknown", "interrupted"} — the last one only when a
cooperative cancellation (:meth:`SolverSession.interrupt` or a ``stop``
callable) ended the call early.

This module also owns the **Strategy API**: a :class:`Strategy` names one
(backend, at-most-one encoding) pair, a :class:`PortfolioSpec` is an
ordered roster of strategies raced per II plus a speculative-II window
width.  Both round-trip through a compact string grammar (mirroring the
``repro.archspec`` grammar)::

    cdcl-seq                               one strategy (sequential AMO)
    portfolio:cdcl-seq+z3-atmost,spec_ii=2 race two, speculate II and II+1
    portfolio:auto                         every installed strategy

The legacy ``MapperConfig.backend``/``amo`` string pair resolves onto a
single-:class:`Strategy` spec via :func:`resolve_portfolio`, so old
call sites keep working and their content-addressed cache keys stay
byte-identical (a :class:`Strategy` normalizes a backend-default ``amo``
to ``None``, exactly what the legacy configs carried).

A copy of ``src/repro/core/backends.py`` (the port imports nothing of the JAX
package).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..obs import trace as obs_trace
from ..sat.cnf import And, CNF, Formula, Not, Or, Tseitin, Var
from ..sat.cdcl import CDCLSolver, INTERRUPTED, SAT, UNSAT, UNKNOWN
from .sat_encoding import KMSEncoding, check_deadline as _check_deadline

#: per-backend default at-most-one encoding: the paper uses pairwise with
#: Z3; for the CDCL backend the linear sequential-counter encoding keeps
#: CNF size linear in the literal count and is the measured-faster default.
DEFAULT_AMO = {"z3": "pairwise", "cdcl": "sequential"}


@dataclass
class SolveStats:
    backend: str
    time_s: float
    num_vars: int
    num_clauses: int
    incremental: bool = False


class SolverSession:
    """Interface: persistent solver state over one encoding."""

    backend: str

    def add_clause(self, clause: Sequence[int]) -> None:
        raise NotImplementedError

    def solve(self, timeout_s: Optional[float] = None,
              assumptions: Sequence[int] = (),
              stop: Optional[Callable[[], bool]] = None
              ) -> Tuple[str, Optional[Dict[int, bool]], SolveStats]:
        """``stop``: optional cancellation poll — a truthy return makes
        the call come back ``("interrupted", None, stats)`` promptly."""
        raise NotImplementedError

    def interrupt(self) -> None:
        """Cross-thread cancellation: ask the in-flight (or next)
        :meth:`solve` call to return ``"interrupted"``.  Best-effort —
        a backend without native support may ignore it."""


# ---------------------------------------------------------------------------
# Z3 backend
# ---------------------------------------------------------------------------


def _to_z3(f: Formula, z3, bools, cache):
    cached = cache.get(f)
    if cached is not None:
        return cached
    if isinstance(f, Var):
        out = bools[f.index]
    elif isinstance(f, Not):
        out = z3.Not(_to_z3(f.child, z3, bools, cache))
    elif isinstance(f, And):
        out = z3.And(*[_to_z3(c, z3, bools, cache) for c in f.children])
    elif isinstance(f, Or):
        out = z3.Or(*[_to_z3(c, z3, bools, cache) for c in f.children])
    else:
        raise TypeError(f)
    cache[f] = out
    return out


class Z3Session(SolverSession):
    """Persistent ``z3.Solver`` over one encoding.

    Z3 solvers are natively incremental: clauses added between ``check()``
    calls keep learned lemmas valid (they are permanent constraints, so no
    push/pop scope is needed — CEGAR blocking clauses never retract).
    Scoped queries go through ``solve(assumptions=...)``, which maps to
    ``check(*assumptions)``.
    """

    backend = "z3"

    def __init__(self, enc: KMSEncoding, amo: Optional[str] = None,
                 deadline: Optional[float] = None):
        import z3
        self._z3 = z3
        self.enc = enc
        self.amo = amo or DEFAULT_AMO["z3"]
        self.solver = z3.Solver()
        nv = enc.stats.num_vars
        self.bools = [None] + [z3.Bool(f"v{i}") for i in range(1, nv + 1)]
        self.num_clauses = 0
        self._solved_before = False
        self._interrupted = False
        self._build(deadline)

    def _lit(self, l: int):
        return self._z3.Not(self.bools[-l]) if l < 0 else self.bools[l]

    def _build(self, deadline: Optional[float] = None) -> None:
        z3, enc, bools, amo = self._z3, self.enc, self.bools, self.amo
        if amo not in ("pairwise", "builtin"):
            raise ValueError(f"z3 backend: unknown at-most-one encoding "
                             f"{amo!r} (expected 'pairwise' or 'builtin')")
        solver = self.solver

        def check_deadline():
            _check_deadline(deadline, "z3 constraint construction",
                            enc.dfg.name, enc.kms.ii)

        n_clauses = 0
        # C1: exactly one per node
        for lits in enc.node_lits.values():
            if not lits:
                continue  # unplaceable node: is_trivially_unsat short-circuits
            check_deadline()
            solver.add(z3.Or(*[bools[l] for l in lits]))
            n_clauses += 1
            if amo == "builtin":
                solver.add(z3.AtMost(*[bools[l] for l in lits], 1))
                n_clauses += 1
            else:
                for i in range(len(lits)):
                    for j in range(i + 1, len(lits)):
                        solver.add(z3.Or(z3.Not(bools[lits[i]]),
                                         z3.Not(bools[lits[j]])))
                        n_clauses += 1
        # C2: at most one node per (PE, row)
        for lits in enc.pe_row_lits.values():
            if len(lits) < 2:
                continue
            check_deadline()
            if amo == "builtin":
                solver.add(z3.AtMost(*[bools[l] for l in lits], 1))
                n_clauses += 1
            else:
                for i in range(len(lits)):
                    for j in range(i + 1, len(lits)):
                        if enc.meta_of[lits[i]].node == enc.meta_of[lits[j]].node:
                            continue  # covered by C1
                        solver.add(z3.Or(z3.Not(bools[lits[i]]),
                                         z3.Not(bools[lits[j]])))
                        n_clauses += 1
        # C3: dependency routing
        cache: dict = {}
        for _, f in enc.edge_formulas:
            check_deadline()
            solver.add(_to_z3(f, z3, bools, cache))
            n_clauses += 1
        # C4: shared-memory-port arbitration (heterogeneous specs only)
        for lits, limit in enc.port_amo_groups:
            check_deadline()
            if limit == 1 and amo == "pairwise":
                for i in range(len(lits)):
                    for j in range(i + 1, len(lits)):
                        solver.add(z3.Or(z3.Not(bools[lits[i]]),
                                         z3.Not(bools[lits[j]])))
                        n_clauses += 1
            else:
                # at-most-k has no pairwise analogue worth emitting
                solver.add(z3.AtMost(*[bools[l] for l in lits], limit))
                n_clauses += 1
        # symmetry breaking
        for lit in enc.forced_false:
            solver.add(z3.Not(bools[lit]))
            n_clauses += 1
        # CEGAR blocking clauses (literals are DIMACS-signed var indices)
        for clause in enc.blocking_clauses:
            solver.add(z3.Or(*[self._lit(l) for l in clause]))
            n_clauses += 1
        self.num_clauses = n_clauses

    def add_clause(self, clause: Sequence[int]) -> None:
        self.solver.add(self._z3.Or(*[self._lit(l) for l in clause]))
        self.num_clauses += 1

    def interrupt(self) -> None:
        """Cancel the in-flight ``check()`` via ``z3.Context.interrupt``
        (the documented cross-thread cancellation hook); the interrupted
        call reports ``unknown``, which :meth:`solve` maps to
        ``"interrupted"`` when a cancellation was requested."""
        self._interrupted = True
        try:
            self.solver.ctx.interrupt()
        except Exception:  # pragma: no cover - best-effort, old z3 builds
            pass

    def solve(self, timeout_s: Optional[float] = None,
              assumptions: Sequence[int] = (),
              stop: Optional[Callable[[], bool]] = None
              ) -> Tuple[str, Optional[Dict[int, bool]], SolveStats]:
        z3, enc = self._z3, self.enc
        t0 = time.monotonic()
        incremental = self._solved_before
        self._solved_before = True
        self._interrupted = False
        nv = enc.stats.num_vars

        def stats() -> SolveStats:
            return SolveStats("z3", time.monotonic() - t0, nv,
                              self.num_clauses, incremental=incremental)

        if enc.is_trivially_unsat:
            return UNSAT, None, stats()
        # 0 = no limit; always set so a budget from an earlier call on this
        # persistent solver doesn't leak into an unbounded one
        self.solver.set("timeout", max(1, int(timeout_s * 1000))
                        if timeout_s is not None else 0)
        watcher = None
        if stop is not None:
            # z3 cannot poll a Python callable mid-search; a watcher
            # thread turns the poll into a ctx.interrupt() call
            import threading

            done = threading.Event()

            def watch():
                while not done.wait(0.05):
                    if stop():
                        self.interrupt()
                        return

            watcher = (threading.Thread(target=watch, daemon=True), done)
            watcher[0].start()
        try:
            res = self.solver.check(*[self._lit(l) for l in assumptions])
        finally:
            if watcher is not None:
                watcher[1].set()
                watcher[0].join()
        if res == z3.unknown and (self._interrupted
                                  or (stop is not None and stop())):
            # a definitive answer that beat the cancellation still counts
            return INTERRUPTED, None, stats()
        if res == z3.sat:
            m = self.solver.model()
            model = {i: bool(m.eval(self.bools[i], model_completion=True))
                     for i in range(1, nv + 1)}
            return SAT, model, stats()
        if res == z3.unsat:
            return UNSAT, None, stats()
        return UNKNOWN, None, stats()


# ---------------------------------------------------------------------------
# CDCL backend (self-contained)
# ---------------------------------------------------------------------------


def encoding_to_cnf(enc: KMSEncoding, amo: str = "pairwise",
                    deadline: Optional[float] = None) -> CNF:
    """Tseitin-transform an encoding.  ``deadline`` budget-guards the
    (Python-side) CNF construction the same way encoding construction is."""
    if amo not in ("pairwise", "sequential"):
        raise ValueError(f"cdcl backend: unknown at-most-one encoding "
                         f"{amo!r} (expected 'pairwise' or 'sequential')")

    def check_deadline():
        _check_deadline(deadline, "CNF construction", enc.dfg.name,
                        enc.kms.ii)

    cnf = CNF()
    cnf.ensure_var(enc.stats.num_vars)
    for lits in enc.node_lits.values():
        if not lits:
            continue  # unplaceable node: the trivially-unsat pair below fires
        check_deadline()
        cnf.exactly_one(lits, encoding="sequential" if amo == "sequential"
                        else "pairwise")
    for lits in enc.pe_row_lits.values():
        if len(lits) < 2:
            continue
        check_deadline()
        if amo == "sequential":
            cnf.at_most_one_sequential(lits)
        else:
            cnf.at_most_one_pairwise(lits)
    # C4: shared-memory-port arbitration (heterogeneous specs only)
    for lits, limit in enc.port_amo_groups:
        check_deadline()
        if limit > 1:
            cnf.at_most_k_sequential(lits, limit)
        elif amo == "sequential":
            cnf.at_most_one_sequential(lits)
        else:
            cnf.at_most_one_pairwise(lits)
    ts = Tseitin(cnf)
    for _, f in enc.edge_formulas:
        check_deadline()
        ts.assert_formula(f)
    for lit in enc.forced_false:
        cnf.add_clause((-lit,))
    for clause in enc.blocking_clauses:
        cnf.add_clause(tuple(clause))
    if enc.is_trivially_unsat:
        v = cnf.new_var()
        cnf.add_clause((v,))
        cnf.add_clause((-v,))
    return cnf


class CDCLSession(SolverSession):
    """Persistent :class:`CDCLSolver` over one encoding's Tseitin CNF.

    The CNF is built once; blocking clauses go straight into the live
    solver (learned clauses, watches, VSIDS activity and saved phases all
    survive), so a CEGAR round costs one clause plus a warm re-solve.
    """

    backend = "cdcl"

    def __init__(self, enc: KMSEncoding, amo: Optional[str] = None,
                 deadline: Optional[float] = None):
        self.enc = enc
        self.amo = amo or DEFAULT_AMO["cdcl"]
        self.cnf = encoding_to_cnf(enc, amo=self.amo, deadline=deadline)
        self.solver = CDCLSolver(self.cnf)
        self.num_clauses = len(self.cnf.clauses)

    def add_clause(self, clause: Sequence[int]) -> None:
        self.solver.add_clauses([tuple(clause)])
        self.num_clauses += 1

    def interrupt(self) -> None:
        self.solver.interrupt()

    def solve(self, timeout_s: Optional[float] = None,
              assumptions: Sequence[int] = (),
              stop: Optional[Callable[[], bool]] = None
              ) -> Tuple[str, Optional[Dict[int, bool]], SolveStats]:
        t0 = time.monotonic()
        incremental = self.solver.stats.solve_calls > 0
        # deep telemetry: while a trace span is active, periodic progress
        # samples (conflicts/decisions/propagations/restarts/learned) land
        # on it as events; costs one attribute store when tracing is off
        sp = obs_trace.current()
        if sp is not None:
            def _progress(st, _sp=sp):
                _sp.event("solver.progress", conflicts=st.conflicts,
                          decisions=st.decisions,
                          propagations=st.propagations,
                          restarts=st.restarts, learned=st.learned)
            self.solver.on_progress = _progress
        else:
            self.solver.on_progress = None
        res = self.solver.solve(timeout_s=timeout_s, assumptions=assumptions,
                                stop=stop)
        stats = SolveStats("cdcl", time.monotonic() - t0, self.cnf.num_vars,
                           self.num_clauses, incremental=incremental)
        if res == SAT:
            model = self.solver.model()
            # keep only the original encoding variables
            model = {i: model.get(i, False)
                     for i in range(1, self.enc.stats.num_vars + 1)}
            return SAT, model, stats
        return res, None, stats


SESSIONS = {"z3": Z3Session, "cdcl": CDCLSession}


def make_session(backend: str, enc: KMSEncoding, amo: Optional[str] = None,
                 deadline: Optional[float] = None) -> SolverSession:
    try:
        cls = SESSIONS[backend]
    except KeyError:
        raise KeyError(f"unknown backend {backend!r} "
                       f"(expected one of {sorted(SESSIONS)})") from None
    return cls(enc, amo=amo, deadline=deadline)


def resolve_backend(backend: str) -> str:
    """``auto`` -> z3 when importable (the paper's solver), else cdcl."""
    if backend != "auto":
        return backend
    try:
        import z3  # noqa: F401
        return "z3"
    except ImportError:
        return "cdcl"


# ---------------------------------------------------------------------------
# Strategy API: typed (backend, amo) pairs and portfolio rosters
# ---------------------------------------------------------------------------

#: named strategies of the compact grammar; a backend-default ``amo``
#: normalizes to ``None`` so single-strategy cache keys are byte-identical
#: to the legacy ``backend=``/``amo=`` pair they replace
NAMED_STRATEGIES = {
    "cdcl-seq": ("cdcl", "sequential"),
    "cdcl-pair": ("cdcl", "pairwise"),
    "z3": ("z3", "pairwise"),
    "z3-atmost": ("z3", "builtin"),
}

#: ``portfolio:auto`` roster, in race-priority order, filtered by what is
#: installed (z3 strategies drop out when z3 is not importable)
AUTO_ROSTER = ("cdcl-seq", "z3", "z3-atmost", "cdcl-pair")


@dataclass(frozen=True)
class Strategy:
    """One solver strategy: a backend plus its at-most-one encoding.

    ``amo=None`` means the backend default (:data:`DEFAULT_AMO`); an
    explicitly-passed default is normalized to ``None`` so two spellings
    of the same strategy compare (and hash, and cache-key) equal.
    """

    backend: str                   # "z3" | "cdcl"
    amo: Optional[str] = None      # None -> DEFAULT_AMO[backend]

    def __post_init__(self):
        if self.backend not in SESSIONS:
            raise ValueError(f"unknown strategy backend {self.backend!r} "
                             f"(expected one of {sorted(SESSIONS)})")
        if self.amo == DEFAULT_AMO.get(self.backend):
            object.__setattr__(self, "amo", None)

    @property
    def resolved_amo(self) -> str:
        return self.amo or DEFAULT_AMO[self.backend]

    @property
    def name(self) -> str:
        """Canonical compact name (inverse of :func:`parse_strategy`)."""
        for name, (backend, amo) in NAMED_STRATEGIES.items():
            if backend == self.backend and amo == self.resolved_amo:
                return name
        return f"{self.backend}-{self.resolved_amo}"  # pragma: no cover

    def available(self) -> bool:
        """Whether this strategy can run here (z3 needs the import)."""
        if self.backend != "z3":
            return True
        try:
            import z3  # noqa: F401
            return True
        except ImportError:
            return False

    def session(self, enc: KMSEncoding,
                deadline: Optional[float] = None) -> SolverSession:
        return make_session(self.backend, enc, amo=self.amo,
                            deadline=deadline)


def parse_strategy(text: str) -> Strategy:
    """One strategy name -> :class:`Strategy`.

    Accepts the named strategies (``cdcl-seq``, ``cdcl-pair``, ``z3``,
    ``z3-atmost``), a bare backend (``cdcl`` — its default AMO), and
    ``auto`` (the resolved backend's default strategy).
    """
    text = text.strip()
    if text in NAMED_STRATEGIES:
        backend, amo = NAMED_STRATEGIES[text]
        return Strategy(backend, amo)
    if text == "auto":
        return Strategy(resolve_backend("auto"))
    if text in SESSIONS:
        return Strategy(text)
    raise ValueError(
        f"unknown strategy {text!r} (expected one of "
        f"{sorted(NAMED_STRATEGIES)}, a backend name, or 'auto')")


@dataclass(frozen=True)
class PortfolioSpec:
    """An ordered strategy roster raced per II, plus the speculative-II
    window width (``spec_ii=2`` launches II and II+1 together).

    ``spec_ii`` counts *candidate IIs in flight*, not extra workers: the
    racer only ever commits the lowest feasible II, so speculation is a
    pure latency optimization (see :mod:`repro.core.portfolio`).
    """

    strategies: Tuple[Strategy, ...]
    spec_ii: int = 1

    def __post_init__(self):
        if not self.strategies:
            raise ValueError("a PortfolioSpec needs at least one strategy")
        if len(set(self.strategies)) != len(self.strategies):
            names = [s.name for s in self.strategies]
            raise ValueError(f"duplicate strategies in portfolio: {names}")
        if self.spec_ii < 1:
            raise ValueError(f"spec_ii must be >= 1, got {self.spec_ii}")

    @property
    def is_single_sequential(self) -> bool:
        """True when this spec degenerates to the classic sequential
        single-strategy ladder (no racing, no speculation)."""
        return len(self.strategies) == 1 and self.spec_ii == 1

    def to_compact(self) -> str:
        """Canonical compact string (round-trips via
        :func:`parse_portfolio`); single sequential specs collapse to the
        bare strategy name."""
        if self.is_single_sequential:
            return self.strategies[0].name
        names = "+".join(s.name for s in self.strategies)
        return f"portfolio:{names},spec_ii={self.spec_ii}"

    def available(self) -> "PortfolioSpec":
        """This spec filtered to installed strategies (order kept).
        Raises when nothing is left to run."""
        usable = tuple(s for s in self.strategies if s.available())
        if not usable:
            names = [s.name for s in self.strategies]
            raise RuntimeError(f"no strategy of {names} is available "
                               "(is z3 installed?)")
        if usable == self.strategies:
            return self
        return PortfolioSpec(usable, self.spec_ii)


def parse_portfolio(text: str) -> PortfolioSpec:
    """Compact string -> :class:`PortfolioSpec`.

    Grammar (mirrors the archspec grammar: a head, ``+``-joined members,
    comma-separated ``key=value`` options)::

        STRATEGY                          e.g. cdcl-seq, z3-atmost, auto
        portfolio:S1+S2[+...][,spec_ii=N] e.g. portfolio:cdcl-seq+z3,spec_ii=2
        portfolio:auto[,spec_ii=N]        every installed strategy

    A bare strategy name parses to a single sequential spec (``spec_ii``
    1); the ``portfolio:`` form defaults to ``spec_ii=2`` — II and II+1
    in flight — which is what the speculative ladder was built for.
    """
    text = text.strip()
    if not text.startswith("portfolio:"):
        return PortfolioSpec((parse_strategy(text),), spec_ii=1)
    body = text[len("portfolio:"):]
    if not body:
        raise ValueError("empty portfolio spec: expected "
                         "'portfolio:STRAT[+STRAT...][,spec_ii=N]'")
    parts = body.split(",")
    head, opts = parts[0], parts[1:]
    spec_ii = 2
    for opt in opts:
        key, sep, value = opt.partition("=")
        if not sep:
            raise ValueError(f"malformed portfolio option {opt!r} "
                             "(expected key=value)")
        if key == "spec_ii":
            try:
                spec_ii = int(value)
            except ValueError:
                raise ValueError(
                    f"spec_ii must be an integer, got {value!r}") from None
        else:
            raise ValueError(f"unknown portfolio option {key!r} "
                             "(expected 'spec_ii')")
    if head == "auto":
        strategies = tuple(parse_strategy(n) for n in AUTO_ROSTER
                           if parse_strategy(n).available())
        if not strategies:  # pragma: no cover - cdcl is always available
            raise RuntimeError("portfolio:auto found no installed strategy")
    else:
        strategies = tuple(parse_strategy(n) for n in head.split("+"))
    return PortfolioSpec(strategies, spec_ii=spec_ii)


def resolve_portfolio(strategy: Optional[str], backend: str = "auto",
                      amo: Optional[str] = None) -> PortfolioSpec:
    """The one resolution point from a :class:`MapperConfig` surface to a
    :class:`PortfolioSpec`.

    ``strategy`` (compact string) wins when set — combining it with a
    non-default ``backend``/``amo`` is ambiguous and raises.  Otherwise
    the legacy pair resolves to a single sequential strategy, exactly as
    every pre-Strategy-API call site behaved (deprecation shim: the old
    kwargs keep working, their cache keys stay byte-identical).
    """
    if strategy:
        if backend not in ("auto", None) or amo is not None:
            raise ValueError(
                f"MapperConfig.strategy={strategy!r} conflicts with "
                f"backend={backend!r}/amo={amo!r}; set one or the other")
        return parse_portfolio(strategy)
    return PortfolioSpec((Strategy(resolve_backend(backend or "auto"),
                                   amo),), spec_ii=1)


# ---------------------------------------------------------------------------
# One-shot wrappers (tests / ablations)
# ---------------------------------------------------------------------------


def solve_z3(enc: KMSEncoding, timeout_s: Optional[float] = None,
             amo: str = "pairwise") -> Tuple[str, Optional[Dict[int, bool]], SolveStats]:
    return Z3Session(enc, amo=amo).solve(timeout_s=timeout_s)


def solve_cdcl(enc: KMSEncoding, timeout_s: Optional[float] = None,
               amo: Optional[str] = None) -> Tuple[str, Optional[Dict[int, bool]], SolveStats]:
    return CDCLSession(enc, amo=amo).solve(timeout_s=timeout_s)


BACKENDS = {"z3": solve_z3, "cdcl": solve_cdcl}
