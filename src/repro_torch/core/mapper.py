"""SAT-MapIt's iterative mapping loop (paper Fig. 4), made incremental.

``map_dfg`` searches II = mII, mII+1, ... For each II it folds the mobility
schedule into the KMS, encodes C1/C2/C3 **once**, opens a persistent solver
session, and — on SAT — validates register pressure; RA failure bumps II
exactly as in the paper.  CEGAR counterexamples (from the bitstream
assembler's ``assemble_check`` oracle) append a single blocking clause to
the live session instead of rebuilding encoding + CNF + solver from
scratch, so learned clauses and solver heuristic state survive across
rounds.  ``MapResult.encodings_built`` / ``incremental_solves`` expose the
reuse for tests and benchmarks; ``incremental=False`` in
:class:`MapperConfig` restores the cold-rebuild behavior as an ablation
baseline.

``per_ii_timeout_s`` implements the paper's §5.5 *non-exact* mode (bounded
exploration per II, advancing on timeout).  ``total_timeout_s`` covers
Python-side encoding/CNF construction too (via a deadline threaded into
:class:`KMSEncoding`), not just solver time.

The per-II search lives in :func:`attempt_ii` — one (II, strategy) CEGAR
loop returning a typed :class:`IIOutcome` — consumed by both the
sequential ladder here and the portfolio racer
(:mod:`repro_torch.core.portfolio`).  A :class:`MapperConfig` with a
``strategy`` spec that races multiple strategies or speculates on the II
ladder dispatches to the racer; the legacy ``backend``/``amo`` pair (and
any single sequential strategy) stays on the sequential path.

A copy of ``src/repro/core/mapper.py``: every strategy, the fact seed and
the mapping cache map exactly as the JAX package does.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from ..cgra.arch import PEGrid
from ..obs import trace as obs_trace
from .backends import (PortfolioSpec, Strategy, make_session,
                       resolve_backend, resolve_portfolio)
from .dfg import DFG
from .mapping import Mapping, Placement, classify_handoff, validate_mapping
from .mii import min_ii
from .regalloc import allocate_registers
from .sat_encoding import EncodingBudgetExceeded, KMSEncoding
from .schedule import Slot, asap_alap, fold_kms


@dataclass
class MapperConfig:
    backend: str = "auto"          # "z3" | "cdcl" | "auto" (z3 if installed)
    amo: Optional[str] = None      # None -> backend default (z3: pairwise
                                   # as in the paper; cdcl: sequential)
    per_ii_timeout_s: Optional[float] = None
    total_timeout_s: Optional[float] = None
    ii_max: int = 50               # paper's black-cross cap
    symmetry_break: bool = False   # beyond-paper optimization
    on_timeout: str = "advance"    # "advance" (non-exact §5.5) | "fail"
    validate: bool = True
    max_cegar_rounds: int = 25     # blocking-clause refinements per II
    incremental: bool = True       # False: cold-rebuild per CEGAR round
    #: compact strategy/portfolio spec (``repro.core.backends`` grammar,
    #: e.g. ``"portfolio:cdcl-seq+z3-atmost,spec_ii=2"``).  ``None`` keeps
    #: the legacy ``backend``/``amo`` pair authoritative (deprecation
    #: shim); setting both raises in :func:`resolve_portfolio`.
    strategy: Optional[str] = None

    def __post_init__(self):
        # accept typed Strategy/PortfolioSpec objects and normalize to the
        # compact string so asdict()/pickle/cache keys stay plain data
        if isinstance(self.strategy, Strategy):
            self.strategy = PortfolioSpec((self.strategy,)).to_compact()
        elif isinstance(self.strategy, PortfolioSpec):
            self.strategy = self.strategy.to_compact()

    def portfolio(self) -> PortfolioSpec:
        """The resolved strategy roster (legacy pair -> single strategy)."""
        return resolve_portfolio(self.strategy, self.backend, self.amo)

    @classmethod
    def from_dict(cls, d: Dict) -> "MapperConfig":
        """Revive from plain data (wire requests, journals).  Unknown
        keys raise — a version-skewed client must fail loudly, not have
        its overrides silently dropped."""
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown MapperConfig keys: {unknown}")
        return cls(**d)

    @classmethod
    def for_bench(cls, backend: str = "auto",
                  per_ii_timeout_s: float = 20.0, ii_max: int = 30,
                  total_timeout_s: Optional[float] = None,
                  **overrides) -> "MapperConfig":
        """The one benchmark-lane preset.  Every ``benchmarks/*.py`` script
        used to hand-roll its own ``ii_max``/timeout fields with slightly
        different defaults; this constructor is the single source of that
        budget policy (total budget defaults to 2x the per-II budget, and
        it also covers encoding construction — see the module docstring).
        Extra keyword overrides pass straight through to the dataclass."""
        if total_timeout_s is None:
            total_timeout_s = 2.0 * per_ii_timeout_s
        return cls(backend=backend, per_ii_timeout_s=per_ii_timeout_s,
                   total_timeout_s=total_timeout_s, ii_max=ii_max,
                   **overrides)


@dataclass
class IIAttempt:
    ii: int
    status: str
    time_s: float
    num_vars: int = 0
    num_clauses: int = 0
    ra_ok: Optional[bool] = None
    encode_time_s: float = 0.0     # encoding+CNF construction (0 on reuse)
    incremental: bool = False      # solved on a warm session


def combos_to_jsonable(combos: Sequence) -> List:
    """Placement-triple combos -> plain lists (cache / pickle payloads)."""
    return [[[n, p, [slot.c, slot.it]] for (n, p, slot) in combo]
            for combo in combos]


def combos_from_jsonable(data: Sequence) -> List:
    """Inverse of :func:`combos_to_jsonable` (revives the Slots)."""
    return [[(n, p, Slot(sc, sit)) for (n, p, (sc, sit)) in combo]
            for combo in data]


@dataclass
class MapResult:
    mapping: Optional[Mapping]
    status: str                      # "mapped" | "unsat-capped" | "timeout"
    mii: int
    attempts: List[IIAttempt] = field(default_factory=list)
    total_time_s: float = 0.0
    validation_errors: List[str] = field(default_factory=list)
    backend: str = ""                # resolved backend actually used
    encodings_built: int = 0         # KMSEncoding constructions
    incremental_solves: int = 0      # solves that reused a live session
    cegar_rounds: int = 0            # blocking clauses fed back by the oracle
    # -- portfolio telemetry (defaults on the sequential path, so every
    # -- serialized form below stays byte-identical unless a race ran) ------
    strategies_raced: int = 0        # (ii, strategy) tasks launched
    winner: str = ""                 # strategy name that produced `mapping`
    cancelled_after_s: Optional[float] = None  # race start -> losers cancelled
    # -- provable facts for cross-point lifting (repro.core.facts) ----------
    blocked_combos: List = field(default_factory=list)  # oracle combos found
    unsat_iis: List[int] = field(default_factory=list)  # solver-proven UNSAT
    facts_used: int = 0              # lifted facts seeded into this solve

    @property
    def ii(self) -> Optional[int]:
        return self.mapping.ii if self.mapping else None

    # -- serialization (content-addressed mapping cache, repro.dse) ------------

    def to_dict(self) -> Dict:
        d = {
            "status": self.status,
            "mii": self.mii,
            "total_time_s": self.total_time_s,
            "validation_errors": list(self.validation_errors),
            "backend": self.backend,
            "encodings_built": self.encodings_built,
            "incremental_solves": self.incremental_solves,
            "cegar_rounds": self.cegar_rounds,
            "attempts": [dataclasses.asdict(a) for a in self.attempts],
            "mapping": self.mapping.to_dict() if self.mapping else None,
        }
        # new fields are emitted only when non-default: cache entries and
        # digests from sequential runs stay byte-identical to every
        # pre-portfolio release
        if self.strategies_raced:
            d["strategies_raced"] = self.strategies_raced
        if self.winner:
            d["winner"] = self.winner
        if self.cancelled_after_s is not None:
            d["cancelled_after_s"] = self.cancelled_after_s
        if self.blocked_combos:
            d["blocked_combos"] = combos_to_jsonable(self.blocked_combos)
        if self.unsat_iis:
            d["unsat_iis"] = list(self.unsat_iis)
        if self.facts_used:
            d["facts_used"] = self.facts_used
        return d

    @classmethod
    def from_dict(cls, dfg: DFG, grid: PEGrid, d: Dict) -> "MapResult":
        mapping = (Mapping.from_dict(dfg, grid, d["mapping"])
                   if d.get("mapping") else None)
        return cls(
            mapping=mapping, status=d["status"], mii=d["mii"],
            attempts=[IIAttempt(**a) for a in d.get("attempts", [])],
            total_time_s=d.get("total_time_s", 0.0),
            validation_errors=list(d.get("validation_errors", [])),
            backend=d.get("backend", ""),
            encodings_built=d.get("encodings_built", 0),
            incremental_solves=d.get("incremental_solves", 0),
            cegar_rounds=d.get("cegar_rounds", 0),
            strategies_raced=d.get("strategies_raced", 0),
            winner=d.get("winner", ""),
            cancelled_after_s=d.get("cancelled_after_s"),
            blocked_combos=combos_from_jsonable(d.get("blocked_combos", [])),
            unsat_iis=list(d.get("unsat_iis", [])),
            facts_used=d.get("facts_used", 0))


def _extract_mapping(dfg: DFG, grid: PEGrid, kms, enc: KMSEncoding,
                     model: Dict[int, bool]) -> Mapping:
    chosen = enc.decode_model(model)
    placements = {n: Placement(node=n, pe=m.pe, slot=m.slot)
                  for n, m in chosen.items()}
    mapping = Mapping(dfg=dfg, grid=grid, ii=kms.ii, num_folds=kms.num_folds,
                      placements=placements)
    for edge in dfg.edges:
        mapping.handoffs[(edge.src, edge.dst, edge.distance)] = \
            classify_handoff(mapping, edge)
    return mapping


@dataclass
class IIOutcome:
    """The typed verdict of one (II, strategy) CEGAR search.

    ``verdict`` is one of

    * ``"mapped"``      — a validated (and oracle-clean) mapping at this II;
    * ``"advance"``     — this II is done, bump the ladder (solver UNSAT,
      RA failure, CEGAR-round exhaustion, an unblockable counterexample,
      or a per-II timeout under ``on_timeout="advance"``);
    * ``"timeout"``     — the total budget died here (terminal);
    * ``"interrupted"`` — a cooperative cancellation (``stop``) landed;
      the II is *undecided* (racers treat it like a worker loss).

    ``proven_unsat`` marks an ``"advance"`` that the solver actually
    proved (a liftable fact), as opposed to the heuristic advances above.
    ``new_blocked`` carries the CEGAR counterexamples discovered here so
    callers can extend their shared pool.
    """

    ii: int
    verdict: str
    mapping: Optional[Mapping] = None
    attempts: List[IIAttempt] = field(default_factory=list)
    encodings_built: int = 0
    incremental_solves: int = 0
    cegar_rounds: int = 0
    new_blocked: List = field(default_factory=list)
    validation_errors: List[str] = field(default_factory=list)
    proven_unsat: bool = False


def attempt_ii(dfg: DFG, grid: PEGrid, ms, ii: int, cfg: MapperConfig,
               strategy: Strategy, blocked: Sequence,
               assemble_check=None, deadline: Optional[float] = None,
               stop: Optional[Callable[[], bool]] = None) -> IIOutcome:
    """One II, one strategy: encode, solve, CEGAR-refine.  The reusable
    inner loop of the paper's Fig. 4 ladder — the sequential
    :func:`map_dfg` walks it over II = mII, mII+1, ... while the
    portfolio racer (:mod:`repro.core.portfolio`) runs many instances
    concurrently.  ``blocked`` is the caller's counterexample pool (not
    mutated; discoveries come back in ``IIOutcome.new_blocked``)."""
    with obs_trace.span("mapper.attempt_ii", ii=ii,
                        strategy=strategy.name) as sp:
        out = _attempt_ii(dfg, grid, ms, ii, cfg, strategy, blocked,
                          assemble_check=assemble_check, deadline=deadline,
                          stop=stop)
        sp.set(verdict=out.verdict, cegar_rounds=out.cegar_rounds,
               proven_unsat=out.proven_unsat,
               encodings_built=out.encodings_built)
    return out


def _attempt_ii(dfg: DFG, grid: PEGrid, ms, ii: int, cfg: MapperConfig,
                strategy: Strategy, blocked: Sequence,
                assemble_check=None, deadline: Optional[float] = None,
                stop: Optional[Callable[[], bool]] = None) -> IIOutcome:
    out = IIOutcome(ii=ii, verdict="advance")
    kms = fold_kms(ms, ii)
    pool = list(blocked)
    enc: Optional[KMSEncoding] = None
    session = None
    new_clause = None
    for _cegar in range(max(cfg.max_cegar_rounds, 1)):
        t_enc = time.monotonic()
        try:
            if enc is None or not cfg.incremental:
                with obs_trace.span("mapper.encode", ii=ii,
                                    blocked=len(pool)):
                    enc = KMSEncoding(dfg, kms, grid,
                                      symmetry_break=cfg.symmetry_break,
                                      blocked_combinations=pool,
                                      deadline=deadline)
                    session = strategy.session(enc, deadline=deadline)
                out.encodings_built += 1
            elif new_clause is not None:
                # within a CEGAR loop only the new blocking clause
                # reaches the live solver
                session.add_clause(new_clause)
        except EncodingBudgetExceeded:
            out.verdict = "timeout"
            return out
        encode_time = time.monotonic() - t_enc
        new_clause = None
        budget = cfg.per_ii_timeout_s
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                out.verdict = "timeout"
                return out
            budget = min(budget, remaining) if budget else remaining
        with obs_trace.span("solver.solve", ii=ii,
                            backend=strategy.backend) as ssp:
            status, model, stats = session.solve(timeout_s=budget, stop=stop)
            ssp.set(status=status, incremental=stats.incremental,
                    num_vars=stats.num_vars, num_clauses=stats.num_clauses)
        attempt = IIAttempt(ii=ii, status=status, time_s=stats.time_s,
                            num_vars=stats.num_vars,
                            num_clauses=stats.num_clauses,
                            encode_time_s=encode_time,
                            incremental=stats.incremental)
        out.attempts.append(attempt)
        if stats.incremental:
            out.incremental_solves += 1
        if status == "sat":
            mapping = _extract_mapping(dfg, grid, kms, enc, model)
            ra = allocate_registers(mapping)
            attempt.ra_ok = ra.ok
            if not ra.ok:
                return out  # RA failure: paper increments II, re-searches
            if cfg.validate:
                errs = validate_mapping(mapping, kms=kms)
                out.validation_errors = errs
                if errs:
                    raise AssertionError(
                        f"solver returned invalid mapping at II={ii}: "
                        f"{errs[:3]}")
            if assemble_check is not None:
                with obs_trace.span("mapper.oracle", ii=ii) as osp:
                    counterexample = assemble_check(mapping)
                    osp.set(counterexample=bool(counterexample))
                if counterexample:
                    out.cegar_rounds += 1
                    pool.append(counterexample)
                    out.new_blocked.append(counterexample)
                    if cfg.incremental:
                        new_clause = enc.add_blocked_combination(
                            counterexample)
                        if new_clause is None:
                            # counterexample outside the literal space:
                            # nothing to block; a rebuild would loop on
                            # the same mapping, so advance II instead
                            return out
                    continue  # re-solve same II with the combo blocked
            out.mapping = mapping
            out.verdict = "mapped"
            return out
        if status == "unsat":
            out.proven_unsat = True
            return out
        if status == "interrupted":
            out.verdict = "interrupted"
            return out
        # solver timeout ("unknown")
        out.verdict = "timeout" if cfg.on_timeout == "fail" else "advance"
        return out
    return out  # CEGAR rounds exhausted: advance II


def _merge_outcome(result: MapResult, out: IIOutcome) -> None:
    """Fold one :class:`IIOutcome` into a :class:`MapResult` (counters,
    attempts, liftable facts)."""
    result.attempts.extend(out.attempts)
    result.encodings_built += out.encodings_built
    result.incremental_solves += out.incremental_solves
    result.cegar_rounds += out.cegar_rounds
    result.blocked_combos.extend(out.new_blocked)
    if out.proven_unsat:
        result.unsat_iis.append(out.ii)
    if out.validation_errors:
        result.validation_errors = out.validation_errors


def map_dfg(dfg: DFG, grid: PEGrid,
            config: Optional[MapperConfig] = None,
            ii_start: Optional[int] = None,
            assemble_check=None, *,
            facts_seed: Optional[Dict] = None,
            jobs: Optional[int] = None) -> MapResult:
    """``assemble_check(mapping)``: optional CEGAR oracle — returns None if
    the mapping survives code generation, else a placement-triple list to
    forbid (e.g. a prologue-clobber counterexample from the bitstream
    assembler); the same II is re-solved with the combination blocked.

    ``facts_seed`` (optional, from :mod:`repro_torch.core.facts`): lifted
    cross-point facts — ``{"blocked": [...combos...], "unsat_iis": [...],
    "ii_cap": int | None}`` — that pre-seed the search.  ``jobs`` bounds
    the portfolio racer's worker processes (ignored on the sequential
    path; ``None`` lets the racer pick).
    """
    cfg = config or MapperConfig()
    spec = cfg.portfolio().available()
    if not spec.is_single_sequential:
        from .portfolio import map_dfg_portfolio

        return map_dfg_portfolio(dfg, grid, cfg, spec,
                                 ii_start=ii_start,
                                 assemble_check=assemble_check,
                                 facts_seed=facts_seed, jobs=jobs)
    strategy = spec.strategies[0]
    with obs_trace.span("mapper.ladder", backend=strategy.backend) as lsp:
        t_start = time.monotonic()
        deadline = (t_start + cfg.total_timeout_s
                    if cfg.total_timeout_s is not None else None)
        ms = asap_alap(dfg)
        mii = min_ii(dfg, grid.num_pes)
        ii = max(mii, ii_start or 0)
        result = MapResult(mapping=None, status="unsat-capped", mii=mii,
                           backend=strategy.backend)

        blocked: List = []
        known_unsat: set = set()
        ii_max = cfg.ii_max
        if facts_seed:
            blocked.extend(facts_seed.get("blocked", ()))
            known_unsat = set(facts_seed.get("unsat_iis", ()))
            cap = facts_seed.get("ii_cap")
            if cap is not None:
                ii_max = min(ii_max, cap)
            result.facts_used = len(blocked) + len(known_unsat) + \
                (1 if cap is not None else 0)
            lsp.event("facts.seeded", blocked=len(blocked),
                      unsat_iis=len(known_unsat), ii_cap=cap)
        while ii <= ii_max:
            if deadline is not None and time.monotonic() > deadline:
                result.status = "timeout"
                break
            if ii in known_unsat:
                lsp.event("facts.skip_ii", ii=ii)
                ii += 1  # lifted UNSAT-at-II fact: skip without solving
                continue
            out = attempt_ii(dfg, grid, ms, ii, cfg, strategy, blocked,
                             assemble_check=assemble_check,
                             deadline=deadline)
            _merge_outcome(result, out)
            blocked.extend(out.new_blocked)
            if out.verdict == "mapped":
                result.mapping = out.mapping
                result.status = "mapped"
                break
            if out.verdict == "timeout":
                result.status = "timeout"
                break
            ii += 1  # "advance" ("interrupted" cannot happen: no stop here)
        result.total_time_s = time.monotonic() - t_start
        lsp.set(status=result.status, ii=result.ii, mii=mii,
                facts_used=result.facts_used)
    return result


def mapping_cache_key(dfg: DFG, grid: PEGrid,
                      config: Optional[MapperConfig] = None,
                      extra: str = "",
                      ii_start: Optional[int] = None) -> str:
    """Content hash of everything that determines ``map_dfg``'s output.

    Covers the DFG (node ids + ops, edges with distance/kind), the
    architecture (rows/cols/registers/torus) and every semantics-affecting
    :class:`MapperConfig` field (``backend`` is resolved first so
    ``"auto"`` and the backend it picks share cache entries).  ``extra``
    tags out-of-band inputs the signature cannot see — e.g. which CEGAR
    oracle (``assemble_check``) the caller wires in.  A non-default
    ``ii_start`` changes the search (and so the key); the unset case is
    omitted from the payload so pre-existing cache entries stay valid.
    DFG/arch *names* are deliberately excluded: the key addresses
    content, not labels.

    Heterogeneous architectures (``repro.archspec``) contribute an
    ``arch_hash`` entry covering topology + capability/port tables; the
    legacy homogeneous grids have ``arch_fingerprint() is None`` and omit
    it, so their keys stay byte-identical to every pre-archspec release.
    """
    cfg = config or MapperConfig()
    if cfg.strategy is None:
        # legacy pair: the exact pre-Strategy-API computation, so every
        # existing cache entry (and committed baseline) stays addressable
        backend_key, amo_key = resolve_backend(cfg.backend), cfg.amo
        spec = None
    else:
        spec = cfg.portfolio()
        primary = spec.strategies[0]
        # a single sequential strategy normalizes its backend-default amo
        # to None (Strategy.__post_init__), which is byte-identical to the
        # legacy default-amo key for the same backend
        backend_key, amo_key = primary.backend, primary.amo
    cfg_key = {
        "backend": backend_key,
        "amo": amo_key,
        "per_ii_timeout_s": cfg.per_ii_timeout_s,
        "total_timeout_s": cfg.total_timeout_s,
        "ii_max": cfg.ii_max,
        "symmetry_break": cfg.symmetry_break,
        "on_timeout": cfg.on_timeout,
        "max_cegar_rounds": cfg.max_cegar_rounds,
        "incremental": cfg.incremental,
        # `validate` is excluded: it checks the result, never changes it
    }
    if spec is not None and not spec.is_single_sequential:
        # racing/speculation may legitimately return a different (equal-II)
        # model than the sequential ladder, so portfolio entries get their
        # own key space; single strategies share the legacy one
        cfg_key["strategy"] = spec.to_compact()
    payload = {
        "v": 1,  # bump to invalidate every entry on schema/semantic change
        "nodes": [[n.id, n.op] for n in
                  (dfg.nodes[i] for i in dfg.node_ids())],
        "edges": sorted([e.src, e.dst, e.distance, e.kind]
                        for e in dfg.edges),
        "arch": [grid.spec.rows, grid.spec.cols, grid.spec.num_regs,
                 grid.spec.torus],
        "config": cfg_key,
        "extra": extra,
    }
    fingerprint = grid.arch_fingerprint()
    if fingerprint is not None:
        payload["arch_hash"] = fingerprint
    if ii_start:
        payload["ii_start"] = ii_start
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def map_dfg_cached(dfg: DFG, grid: PEGrid,
                   config: Optional[MapperConfig] = None,
                   cache=None, assemble_check=None,
                   cache_extra: str = "",
                   ii_start: Optional[int] = None,
                   facts_seed: Optional[Dict] = None,
                   jobs: Optional[int] = None):
    """Cache-aware ``map_dfg``: returns ``(MapResult, cache_hit)``.

    ``cache`` is any object with ``get(key) -> Optional[dict]`` /
    ``put(key, dict)`` (see :class:`repro_torch.dse.cache.MappingCache`).
    Timeout results are never stored so a rerun with the same budget gets
    another chance on a less-loaded machine.  A result produced under a
    ``facts_seed`` is never stored either: lifted facts are session-local
    context the content-addressed key cannot see.
    """
    key = None
    if cache is not None:
        key = mapping_cache_key(dfg, grid, config, extra=cache_extra,
                                ii_start=ii_start)
        stored = cache.get(key)
        if stored is not None:
            return MapResult.from_dict(dfg, grid, stored), True
    res = map_dfg(dfg, grid, config, ii_start=ii_start,
                  assemble_check=assemble_check,
                  facts_seed=facts_seed, jobs=jobs)
    if cache is not None and res.status != "timeout" and not facts_seed:
        cache.put(key, res.to_dict())
    return res, False
