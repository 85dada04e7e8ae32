"""Boolean formula IR, CNF container, Tseitin transform, cardinality encodings.

This is the hardware-agnostic SAT substrate used by the paper's encoder
(`repro.core.sat_encoding`).  Formulas are built as a tiny immutable AST and
either handed to Z3 directly (which accepts arbitrary Boolean structure) or
Tseitin-transformed into CNF for our own CDCL solver
(:mod:`repro.sat.cdcl`).

Literal convention (DIMACS): variables are positive ints 1..n, a negative int
is the negation.  Clause = tuple of non-zero ints.

A copy of ``src/repro/sat/cnf.py`` (the port imports nothing of the JAX
package).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Sequence, Tuple

# ---------------------------------------------------------------------------
# Formula AST
# ---------------------------------------------------------------------------


class Formula:
    """Base class for Boolean formula nodes."""

    __slots__ = ()

    def __and__(self, other: "Formula") -> "Formula":
        return And((self, other))

    def __or__(self, other: "Formula") -> "Formula":
        return Or((self, other))

    def __invert__(self) -> "Formula":
        return Not(self)


@dataclass(frozen=True)
class Var(Formula):
    """A propositional variable, identified by a positive integer index."""

    index: int

    def __post_init__(self) -> None:
        if self.index <= 0:
            raise ValueError("variable indices are positive (DIMACS style)")


@dataclass(frozen=True)
class Not(Formula):
    child: Formula


@dataclass(frozen=True)
class And(Formula):
    children: Tuple[Formula, ...]

    def __init__(self, children: Iterable[Formula]):
        object.__setattr__(self, "children", tuple(children))


@dataclass(frozen=True)
class Or(Formula):
    children: Tuple[Formula, ...]

    def __init__(self, children: Iterable[Formula]):
        object.__setattr__(self, "children", tuple(children))


TRUE = And(())   # empty conjunction
FALSE = Or(())   # empty disjunction


# ---------------------------------------------------------------------------
# CNF container
# ---------------------------------------------------------------------------


@dataclass
class CNF:
    """A CNF instance with a variable allocator."""

    num_vars: int = 0
    clauses: List[Tuple[int, ...]] = field(default_factory=list)

    def new_var(self) -> int:
        self.num_vars += 1
        return self.num_vars

    def ensure_var(self, v: int) -> None:
        if v > self.num_vars:
            self.num_vars = v

    def add_clause(self, lits: Sequence[int]) -> None:
        clause = tuple(lits)
        for lit in clause:
            if lit == 0:
                raise ValueError("literal 0 is reserved (DIMACS terminator)")
            self.ensure_var(abs(lit))
        self.clauses.append(clause)

    def extend(self, clauses: Iterable[Sequence[int]]) -> None:
        for c in clauses:
            self.add_clause(c)

    # -- cardinality encodings ------------------------------------------------

    def at_most_one_pairwise(self, lits: Sequence[int]) -> None:
        """The paper's encoding (Eq. 4 alpha / Eq. 5): O(n^2) binary clauses."""
        for a, b in itertools.combinations(lits, 2):
            self.add_clause((-a, -b))

    def at_most_one_sequential(self, lits: Sequence[int]) -> None:
        """Sinz sequential-counter at-most-one: O(n) clauses + O(n) aux vars.

        Beyond-paper optimization: the paper uses pairwise encodings, which
        dominate the instance size for C2 (PE exclusivity).  The sequential
        encoding keeps instances linear in the literal count.
        """
        n = len(lits)
        if n <= 4:  # pairwise is smaller for tiny groups
            self.at_most_one_pairwise(lits)
            return
        # s_i means "some lit among lits[0..i] is true"
        s = [self.new_var() for _ in range(n - 1)]
        self.add_clause((-lits[0], s[0]))
        for i in range(1, n - 1):
            self.add_clause((-lits[i], s[i]))
            self.add_clause((-s[i - 1], s[i]))
            self.add_clause((-lits[i], -s[i - 1]))
        self.add_clause((-lits[n - 1], -s[n - 2]))

    def at_least_one(self, lits: Sequence[int]) -> None:
        self.add_clause(lits)

    def exactly_one(self, lits: Sequence[int], encoding: str = "pairwise") -> None:
        self.at_least_one(lits)
        if encoding == "pairwise":
            self.at_most_one_pairwise(lits)
        elif encoding == "sequential":
            self.at_most_one_sequential(lits)
        else:
            raise ValueError(f"unknown at-most-one encoding: {encoding}")

    def at_most_k_sequential(self, lits: Sequence[int], k: int) -> None:
        """Sinz sequential-counter at-most-k (LTn,k) [Bittner et al. 2019]."""
        n = len(lits)
        if k >= n:
            return
        if k == 0:
            for lit in lits:
                self.add_clause((-lit,))
            return
        # registers r[i][j]: among lits[0..i] at least j+1 are true
        r = [[self.new_var() for _ in range(k)] for _ in range(n - 1)]
        self.add_clause((-lits[0], r[0][0]))
        for j in range(1, k):
            self.add_clause((-r[0][j],))
        for i in range(1, n - 1):
            self.add_clause((-lits[i], r[i][0]))
            self.add_clause((-r[i - 1][0], r[i][0]))
            for j in range(1, k):
                self.add_clause((-lits[i], -r[i - 1][j - 1], r[i][j]))
                self.add_clause((-r[i - 1][j], r[i][j]))
            self.add_clause((-lits[i], -r[i - 1][k - 1]))
        self.add_clause((-lits[n - 1], -r[n - 2][k - 1]))


# ---------------------------------------------------------------------------
# Tseitin transform
# ---------------------------------------------------------------------------


class Tseitin:
    """Structure-sharing Tseitin transform: Formula -> CNF literal.

    ``assert_formula`` adds clauses forcing the formula to hold; sub-formulas
    are memoized so repeated structure (pervasive in the KMS encoding, where
    the same (v_i and w_j) pair appears in many dependency disjuncts) costs
    one definition.
    """

    def __init__(self, cnf: CNF):
        self.cnf = cnf
        self._cache: Dict[Formula, int] = {}

    def literal(self, f: Formula) -> int:
        if isinstance(f, Var):
            self.cnf.ensure_var(f.index)
            return f.index
        if isinstance(f, Not):
            return -self.literal(f.child)
        cached = self._cache.get(f)
        if cached is not None:
            return cached
        if isinstance(f, And):
            kids = [self.literal(c) for c in f.children]
            out = self.cnf.new_var()
            # out -> each kid ; all kids -> out
            for k in kids:
                self.cnf.add_clause((-out, k))
            self.cnf.add_clause(tuple(-k for k in kids) + (out,))
            self._cache[f] = out
            return out
        if isinstance(f, Or):
            kids = [self.literal(c) for c in f.children]
            out = self.cnf.new_var()
            for k in kids:
                self.cnf.add_clause((-k, out))
            self.cnf.add_clause((-out,) + tuple(kids))
            self._cache[f] = out
            return out
        raise TypeError(f"not a formula: {f!r}")

    def assert_formula(self, f: Formula) -> None:
        # Shallow CNF-aware flattening keeps the aux-variable count down.
        if isinstance(f, And):
            for c in f.children:
                self.assert_formula(c)
            return
        if isinstance(f, Or):
            flat: List[int] = []
            for c in f.children:
                flat.append(self.literal(c))
            if not flat:
                # empty Or == False -> unsatisfiable
                self.cnf.add_clause((self.cnf.new_var(),))
                self.cnf.add_clause((-self.cnf.num_vars,))
                return
            self.cnf.add_clause(tuple(flat))
            return
        self.cnf.add_clause((self.literal(f),))
