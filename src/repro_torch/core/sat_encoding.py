"""SAT encoding of the KMS mapping problem (paper §4.2).

Literals are ``x_{n,p,c,it}``: node ``n`` placed on PE ``p`` at KMS row ``c``
with iteration label ``it``.  Three clause families:

* **C1** (Eq. 4): exactly one literal per node.
* **C2** (Eq. 5): at most one node per (PE, row) — every KMS row executes on
  every kernel cycle, so exclusivity is per row regardless of label.
* **C3** (Eq. 8-18): per DFG edge, a disjunction over *candidate placement
  pairs*; each pair is admissible when

  - the steady-state producer->consumer separation
    ``s = (d + it_s - it_d) * II + (c_d - c_s)`` satisfies ``1 <= s <= II``
    (``d`` = loop-carried distance).  ``s ≡ gap (mod II)`` with
    ``gap = (c_d - c_s + II) % II`` (paper Eq. 10) and ``s <= II`` enforces
    the paper's "at most one iteration apart" rule; ``s`` must equal the
    modulo gap exactly because the producer rewrites its output every II
    cycles.  This uniform rule reproduces Eq. 6 for forward edges and fixes
    an inconsistency in the printed Eq. 18: the paper's own satisfying
    assignment (§4.2, e.g. back-edge 11->10 with it_s=0, it_d=1) violates
    Eq. 18 as printed but satisfies this rule — see tests/test_paper_tables.py.
  - placement-wise, either ``gap == 1`` and the PEs are neighbors-or-same
    (γ, Eq. 11: single-cycle output-register hand-off), or ``gap != 1`` and
    the PEs are identical (ζ1, Eq. 14: register-file hand-off, validated by
    register allocation), or the PEs are neighbors and **no node executes on
    the producer PE at any row strictly between** producer and consumer
    (ζ2, Eq. 16-17: the output register must survive).

Heterogeneous fabrics (``repro.archspec``) add two resource families on
top of the paper's three:

* **op-compatibility** — a node whose op needs a load-store unit or a
  multiplier only gets literals on PEs that have one
  (``PEGrid.placeable_pes``); a node with no compatible PE makes the
  instance trivially UNSAT (``stats.unplaceable_nodes``).
* **C4 (port arbitration)** — for every shared-memory-port group and
  every kernel row, at most ``limit`` of the group's memory-op literals
  may be true (``port_amo_groups``; backends pick the cardinality
  encoding).  Homogeneous grids produce no groups, so their CNF is
  byte-identical to the historical encoding.

The encoding is built **once per (DFG, II)** and reused across CEGAR
rounds: :meth:`KMSEncoding.add_blocked_combination` converts a lazy
counterexample into a single blocking clause without re-deriving the
literal space or the C1/C2/C3 families, so an incremental backend session
only ever receives the new clause.  ``deadline`` (a ``time.monotonic``
timestamp) budget-guards construction itself — the mapper threads its
``total_timeout_s`` through so Python-side encoding work cannot overrun
the solve budget unnoticed.

A copy of ``src/repro/core/sat_encoding.py`` (the port imports nothing of the JAX
package).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..cgra.arch import MEM_OPS, PEGrid
from ..sat.cnf import And, Formula, Not, Or, Var
from .dfg import DFG, Edge
from .schedule import KMS, Slot


class EncodingBudgetExceeded(TimeoutError):
    """Encoding construction overran its deadline (mapper treats as timeout)."""


def check_deadline(deadline: Optional[float], what: str, name: str,
                   ii: int) -> None:
    """Shared budget guard for every Python-side construction phase
    (encoding, Tseitin CNF, z3 constraint build)."""
    if deadline is not None and time.monotonic() > deadline:
        raise EncodingBudgetExceeded(
            f"{what} for {name!r} at II={ii} exceeded its time budget")


@dataclass(frozen=True)
class LitMeta:
    node: int
    pe: int
    slot: Slot


@dataclass
class EncodingStats:
    num_vars: int = 0
    num_exactly_one_groups: int = 0
    num_amo_groups: int = 0
    num_edge_formulas: int = 0
    num_candidate_pairs: int = 0
    infeasible_edges: List[Tuple[int, int, int]] = field(default_factory=list)
    num_port_groups: int = 0
    unplaceable_nodes: List[int] = field(default_factory=list)


class KMSEncoding:
    """Builds the literal space and the three constraint families.

    Output is backend-neutral: C1/C2 as literal groups (so each backend can
    pick its cardinality encoding) and C3 as small formula ASTs.
    """

    def __init__(self, dfg: DFG, kms: KMS, grid: PEGrid,
                 symmetry_break: bool = False,
                 blocked_combinations=(),
                 deadline: Optional[float] = None):
        """``blocked_combinations``: iterable of placement-triple lists
        [(node, pe, Slot), ...]; each list becomes a clause forbidding that
        joint placement (CEGAR lazy constraints, e.g. prologue-clobber
        counterexamples from the bitstream assembler).  ``deadline``: abort
        construction with :class:`EncodingBudgetExceeded` past this
        ``time.monotonic()`` timestamp."""
        self.dfg = dfg
        self.kms = kms
        self.grid = grid
        self.symmetry_break = symmetry_break and grid.is_vertex_transitive()
        self.blocked_combinations: List = []
        self._deadline = deadline

        self.var_of: Dict[Tuple[int, int, Slot], int] = {}
        self.meta_of: List[Optional[LitMeta]] = [None]  # 1-indexed
        self.node_lits: Dict[int, List[int]] = {}
        self.pe_row_lits: Dict[Tuple[int, int], List[int]] = {}
        self.stats = EncodingStats()

        # hot-path precomputes shared by every edge formula
        self._reachable_pairs: List[Tuple[int, int]] = grid.reachable_pairs()
        self._var_nodes: List[Optional[Var]] = [None]
        self._blocker_cache: Dict[Tuple[int, int, int],
                                  Tuple[Tuple[int, Var], ...]] = {}

        self._build_literals()
        self.port_amo_groups: List[Tuple[List[int], int]] = []
        self._build_port_constraints()
        self.edge_formulas: List[Tuple[Edge, Formula]] = []
        self._build_edges()
        self.forced_false: List[int] = []
        self.blocking_clauses: List[List[int]] = []
        for combo in blocked_combinations:
            self.add_blocked_combination(combo)
        if self.symmetry_break:
            self._build_symmetry_breaking()
        self._deadline = None  # construction done; reuse is cheap
        self.stats.num_vars = len(self.meta_of) - 1
        self.stats.num_exactly_one_groups = len(self.node_lits)
        self.stats.num_amo_groups = len(self.pe_row_lits)
        self.stats.num_edge_formulas = len(self.edge_formulas)

    def _check_deadline(self) -> None:
        check_deadline(self._deadline, "encoding construction",
                       self.dfg.name, self.kms.ii)

    # -- literal space -----------------------------------------------------------

    def _build_literals(self) -> None:
        for n in self.dfg.node_ids():
            lits: List[int] = []
            # op-compatibility: only capability-carrying PEs get literals
            # (every PE on a homogeneous grid — identical var numbering)
            pes = self.grid.placeable_pes(self.dfg.nodes[n].op)
            for slot in self.kms.slots[n]:
                for p in pes:
                    idx = len(self.meta_of)
                    self.meta_of.append(LitMeta(node=n, pe=p, slot=slot))
                    self._var_nodes.append(Var(idx))
                    self.var_of[(n, p, slot)] = idx
                    lits.append(idx)
                    self.pe_row_lits.setdefault((p, slot.c), []).append(idx)
            self.node_lits[n] = lits
            if not lits:
                self.stats.unplaceable_nodes.append(n)

    # -- C4: shared-memory-port arbitration (heterogeneous specs) ---------------

    def _build_port_constraints(self) -> None:
        """At most ``limit`` memory ops per kernel row per port group."""
        caps = self.grid.caps
        if caps is None or not caps.port_groups:
            return
        mem_lits: Dict[Tuple[int, int], List[int]] = {}
        for idx, meta in enumerate(self.meta_of):
            if meta is None:
                continue
            if self.dfg.nodes[meta.node].op in MEM_OPS:
                mem_lits.setdefault((meta.pe, meta.slot.c), []).append(idx)
        for _label, pes, limit in caps.port_groups:
            for c in range(self.kms.ii):
                lits: List[int] = []
                for p in sorted(pes):
                    lits.extend(mem_lits.get((p, c), ()))
                if len(lits) > limit:
                    self.port_amo_groups.append((lits, limit))
        self.stats.num_port_groups = len(self.port_amo_groups)

    # -- C3 ------------------------------------------------------------------------

    def separation(self, ss: Slot, sd: Slot, distance: int) -> int:
        return (distance + ss.it - sd.it) * self.kms.ii + (sd.c - ss.c)

    def candidate_pairs(self, edge: Edge) -> List[Tuple[Slot, Slot, int]]:
        """Admissible (source-slot, dest-slot, gap) triples for an edge."""
        out: List[Tuple[Slot, Slot, int]] = []
        ii = self.kms.ii
        for ss in self.kms.slots[edge.src]:
            for sd in self.kms.slots[edge.dst]:
                if edge.src == edge.dst and ss != sd:
                    continue  # self-dependency: single placement
                s = self.separation(ss, sd, edge.distance)
                if not (1 <= s <= ii):
                    continue
                gap = (sd.c - ss.c + ii) % ii
                out.append((ss, sd, gap))
        return out

    def _blocker_lits(self, p_s: int, c_s: int,
                      eff_gap: int) -> Tuple[Tuple[int, Var], ...]:
        """(lit, Var) pairs that would overwrite p_s's output register in
        the ``eff_gap - 1`` rows strictly between producer and consumer
        (memoized — the same window recurs across slots and edges)."""
        key = (p_s, c_s, eff_gap)
        cached = self._blocker_cache.get(key)
        if cached is not None:
            return cached
        ii = self.kms.ii
        out: List[Tuple[int, Var]] = []
        for k in range(1, eff_gap):
            row = (c_s + k) % ii
            for lit in self.pe_row_lits.get((p_s, row), ()):
                out.append((lit, self._var_nodes[lit]))
        result = tuple(out)
        self._blocker_cache[key] = result
        return result

    def _blockers(self, p_s: int, c_s: int, eff_gap: int,
                  skip: Tuple[int, int]) -> List[Formula]:
        return [var for lit, var in self._blocker_lits(p_s, c_s, eff_gap)
                if lit not in skip]

    def _edge_formula(self, edge: Edge) -> Optional[Formula]:
        disjuncts: List[Formula] = []
        ii = self.kms.ii
        var_nodes = self._var_nodes
        var_of = self.var_of
        if edge.kind == "colocate":
            # same-PE pinning (pipeline-stage colocation): purely spatial —
            # no timing restriction (dataflow timing comes from data edges)
            for ss in self.kms.slots[edge.src]:
                for sd in self.kms.slots[edge.dst]:
                    for p in range(self.grid.num_pes):
                        vi = var_of.get((edge.src, p, ss))
                        wj = var_of.get((edge.dst, p, sd))
                        if vi is None or wj is None:
                            continue  # PE lacks a capability one end needs
                        disjuncts.append(And((var_nodes[vi], var_nodes[wj])))
            return Or(disjuncts)
        pairs = self.candidate_pairs(edge)
        self.stats.num_candidate_pairs += len(pairs)
        if not pairs:
            self.stats.infeasible_edges.append(
                (edge.src, edge.dst, edge.distance))
            return None
        if edge.kind == "flag":
            # PE-local flag register: same PE, no other instruction between
            for (ss, sd, gap) in pairs:
                eff = gap if gap != 0 else ii
                for p in range(self.grid.num_pes):
                    vi = var_of.get((edge.src, p, ss))
                    wj = var_of.get((edge.dst, p, sd))
                    if vi is None or wj is None:
                        continue  # PE lacks a capability one end needs
                    blockers = self._blockers(p, ss.c, eff, (vi, wj))
                    if blockers:
                        disjuncts.append(
                            And((var_nodes[vi], var_nodes[wj],
                                 Not(Or(blockers)))))
                    else:
                        disjuncts.append(And((var_nodes[vi], var_nodes[wj])))
            return Or(disjuncts)
        reachable = self._reachable_pairs
        for (ss, sd, gap) in pairs:
            if edge.src == edge.dst:
                # value loops back into the same PE through the register file
                for p in range(self.grid.num_pes):
                    vi = var_of.get((edge.src, p, ss))
                    if vi is not None:
                        disjuncts.append(var_nodes[vi])
                continue
            for (p_s, p_d) in reachable:
                vi = var_of.get((edge.src, p_s, ss))
                wj = var_of.get((edge.dst, p_d, sd))
                if vi is None or wj is None:
                    continue  # PE lacks a capability one end needs
                if gap == 1:
                    # γ (Eq. 11): one-cycle output-register hand-off
                    disjuncts.append(And((var_nodes[vi], var_nodes[wj])))
                elif p_s == p_d:
                    # ζ1 (Eq. 14): same-PE register-file hand-off
                    disjuncts.append(And((var_nodes[vi], var_nodes[wj])))
                else:
                    # ζ2 (Eq. 16): output register held across eff_gap cycles
                    eff = gap if gap != 0 else ii
                    blockers = self._blockers(p_s, ss.c, eff, (vi, wj))
                    if blockers:
                        disjuncts.append(
                            And((var_nodes[vi], var_nodes[wj],
                                 Not(Or(blockers)))))
                    else:
                        disjuncts.append(And((var_nodes[vi], var_nodes[wj])))
        return Or(disjuncts)

    def _build_edges(self) -> None:
        for edge in self.dfg.edges:
            self._check_deadline()
            f = self._edge_formula(edge)
            if isinstance(f, Or) and not f.children:
                # capability restrictions killed every placement pair
                # (e.g. no two mem-capable PEs are adjacent): trivially UNSAT
                self.stats.infeasible_edges.append(
                    (edge.src, edge.dst, edge.distance))
                continue
            if f is not None:
                self.edge_formulas.append((edge, f))

    # -- CEGAR blocking clauses (incremental) -----------------------------------------

    def blocking_clause(self, combo: Sequence[Tuple[int, int, Slot]]
                        ) -> Optional[List[int]]:
        """DIMACS clause forbidding a joint placement, or None if any triple
        names a literal outside this encoding's space (e.g. a slot that does
        not exist at this II — nothing to block then)."""
        clause: List[int] = []
        for (n, p, slot) in combo:
            var = self.var_of.get((n, p, slot))
            if var is None:
                return None
            clause.append(-var)
        return clause if clause else None

    def add_blocked_combination(self, combo) -> Optional[List[int]]:
        """Record a counterexample; returns the new blocking clause (the only
        thing an incremental solver session needs to ingest) or None."""
        self.blocked_combinations.append(list(combo))
        clause = self.blocking_clause(combo)
        if clause:
            self.blocking_clauses.append(clause)
        return clause

    # -- symmetry breaking (beyond paper) -------------------------------------------

    def _build_symmetry_breaking(self) -> None:
        """Pin the node with the fewest slots to PE 0.

        Torus translations are CGRA automorphisms, so every mapping can be
        translated to put this node on PE 0; forbidding its other PEs removes
        a |PEs|-fold symmetry.  Only sound for vertex-transitive topologies.
        """
        pick = min(self.dfg.node_ids(),
                   key=lambda n: (len(self.kms.slots[n]), n))
        for slot in self.kms.slots[pick]:
            for p in range(1, self.grid.num_pes):
                self.forced_false.append(self.var_of[(pick, p, slot)])

    # -- extraction -------------------------------------------------------------------

    def decode_model(self, model: Dict[int, bool]) -> Dict[int, LitMeta]:
        """model: var index -> bool. Returns node -> chosen placement."""
        out: Dict[int, LitMeta] = {}
        for idx, meta in enumerate(self.meta_of):
            if meta is None:
                continue
            if model.get(idx, False):
                if meta.node in out:
                    raise ValueError(
                        f"node {meta.node} placed twice (C1 violated)")
                out[meta.node] = meta
        missing = set(self.dfg.node_ids()) - set(out)
        if missing:
            raise ValueError(f"nodes without placement: {sorted(missing)}")
        return out

    @property
    def is_trivially_unsat(self) -> bool:
        return bool(self.stats.infeasible_edges
                    or self.stats.unplaceable_nodes)
