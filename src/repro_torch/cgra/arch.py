"""CGRA architectural model: PE grid, interconnect topology, capabilities.

The homogeneous default matches OpenEdgeCGRA [39]: a 2-D array of PEs with
nearest-neighbor links wrapping around rows and columns (torus) and a
4-word register file + output register + flags per PE.  Real fabrics are
heterogeneous: ADRES-style meshes, border-only load/store units, shared
per-row/column memory ports.  Those are described declaratively by
:class:`repro.archspec.ArchSpec`, which compiles down to a
:class:`PEGrid` carrying an :class:`ArchCaps` capability/port table.

The reference fabric's "one memory port per column" arbitration is
*enforced* only when a spec asks for it (e.g. the ``openedge-4x4``
preset): plain :func:`make_grid` grids stay unconstrained, so the
committed benchmark baselines (and their cache keys) are byte-identical
to the historical homogeneous behavior.

A copy of ``src/repro/cgra/arch.py`` that is also the port's one grid
class for execution: :func:`Grid` builds the :class:`PEGrid` an artifact
stores as ``(rows, cols, topology)``, grids compare by value, and
:func:`neighbor_table` (the counterpart of ``neighbor_table`` in
``src/repro/cgra/simulator.py``) gives the N/E/S/W wiring the PE array
executes with.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Tuple

from .isa import LOAD_OPS, MUL_OPS, STORE_OPS

#: ops that need a load-store unit / a multiplier on their PE
MEM_OPS: Tuple[str, ...] = LOAD_OPS + STORE_OPS

#: supported interconnects; only the torus wraps around the borders
TOPOLOGIES = ("torus", "mesh", "diagonal", "one-hop")

#: interconnects the Table-5 ISA can lower to bitstreams (it only has
#: N/E/S/W neighbor source selectors); the rest are mappable DSE ablations
ASSEMBLABLE_TOPOLOGIES = ("torus", "mesh")

_DELTAS_NEWS = ((-1, 0), (1, 0), (0, -1), (0, 1))
TOPOLOGY_DELTAS: Dict[str, Tuple[Tuple[int, int], ...]] = {
    "torus": _DELTAS_NEWS,
    "mesh": _DELTAS_NEWS,
    # mesh + the four diagonal links (HyCUBE-style richer interconnect)
    "diagonal": _DELTAS_NEWS + ((-1, -1), (-1, 1), (1, -1), (1, 1)),
    # mesh + distance-2 straight bypass links
    "one-hop": _DELTAS_NEWS + ((-2, 0), (2, 0), (0, -2), (0, 2)),
}


@dataclass(frozen=True)
class ArchCaps:
    """Capability/port table attached to a :class:`PEGrid` by archspec.

    ``mem_pes`` / ``mul_pes``: the PEs allowed to execute load-store /
    multiply ops (``None`` = every PE).  ``port_groups``: ``(label, pes,
    limit)`` triples — at most ``limit`` memory operations may issue in
    the same kernel row across the group's PEs (shared-port arbitration).
    """

    mem_pes: Optional[FrozenSet[int]] = None
    mul_pes: Optional[FrozenSet[int]] = None
    port_groups: Tuple[Tuple[str, FrozenSet[int], int], ...] = ()

    def to_dict(self) -> Dict:
        return {
            "mem_pes": sorted(self.mem_pes) if self.mem_pes is not None
            else None,
            "mul_pes": sorted(self.mul_pes) if self.mul_pes is not None
            else None,
            "port_groups": [[label, sorted(pes), limit]
                            for label, pes, limit in self.port_groups],
        }


@dataclass(frozen=True)
class CGRASpec:
    rows: int
    cols: int
    num_regs: int = 4
    torus: bool = True
    name: str = ""
    #: "" = legacy (the ``torus`` flag decides torus vs mesh); otherwise
    #: one of :data:`TOPOLOGIES` and must agree with ``torus``
    topology: str = ""

    def __post_init__(self) -> None:
        if self.topology:
            if self.topology not in TOPOLOGIES:
                raise ValueError(f"unknown topology {self.topology!r}; "
                                 f"expected one of {TOPOLOGIES}")
            if (self.topology == "torus") != self.torus:
                raise ValueError(
                    f"topology {self.topology!r} disagrees with "
                    f"torus={self.torus}")

    @property
    def num_pes(self) -> int:
        return self.rows * self.cols

    def resolved_topology(self) -> str:
        return self.topology or ("torus" if self.torus else "mesh")

    def label(self) -> str:
        return self.name or f"{self.rows}x{self.cols}"


class PEGrid:
    """Topology + capability queries over a :class:`CGRASpec`.

    PEs are numbered row-major: ``p = r * cols + c``.  The *neighborhood
    function* (paper Eq. 7): 2 for distinct adjacent PEs, 1 for the same PE,
    0 otherwise.  ``caps`` (optional, attached by
    :meth:`repro.archspec.ArchSpec.grid`) restricts op placement and adds
    shared-memory-port groups; ``None`` keeps every PE fully capable.
    """

    def __init__(self, spec: CGRASpec, caps: Optional[ArchCaps] = None):
        self.spec = spec
        self.caps = caps
        self._neighbors: List[FrozenSet[int]] = []
        for p in range(spec.num_pes):
            self._neighbors.append(frozenset(self._compute_neighbors(p)))

    def _identity(self) -> Tuple:
        spec = self.spec
        return (spec.rows, spec.cols, spec.num_regs,
                spec.resolved_topology(), self.caps)

    def __eq__(self, other) -> bool:
        if not isinstance(other, PEGrid):
            return NotImplemented
        return self._identity() == other._identity()

    def __hash__(self) -> int:
        return hash(self._identity())

    def __repr__(self) -> str:
        caps = "" if self.caps is None else ", caps"
        return (f"PEGrid({self.rows}x{self.cols} {self.topology}, "
                f"regs={self.spec.num_regs}{caps})")

    @property
    def rows(self) -> int:
        return self.spec.rows

    @property
    def cols(self) -> int:
        return self.spec.cols

    @property
    def topology(self) -> str:
        return self.spec.resolved_topology()

    # -- numbering --------------------------------------------------------------

    @property
    def num_pes(self) -> int:
        return self.spec.num_pes

    def coords(self, p: int) -> Tuple[int, int]:
        return divmod(p, self.spec.cols)

    def pe_at(self, r: int, c: int) -> int:
        return (r % self.spec.rows) * self.spec.cols + (c % self.spec.cols)

    # -- topology ----------------------------------------------------------------

    def _compute_neighbors(self, p: int) -> List[int]:
        r, c = self.coords(p)
        rows, cols = self.spec.rows, self.spec.cols
        wrap = self.spec.resolved_topology() == "torus"
        out = set()
        for dr, dc in TOPOLOGY_DELTAS[self.spec.resolved_topology()]:
            nr, nc = r + dr, c + dc
            if wrap:
                nr %= rows
                nc %= cols
            elif not (0 <= nr < rows and 0 <= nc < cols):
                continue
            q = nr * cols + nc
            if q != p:
                out.add(q)
        return sorted(out)

    def neighbors(self, p: int) -> FrozenSet[int]:
        return self._neighbors[p]

    def f_n(self, p1: int, p2: int) -> int:
        """Paper Eq. 7 neighborhood function."""
        if p1 == p2:
            return 1
        return 2 if p2 in self._neighbors[p1] else 0

    def reachable_pairs(self) -> List[Tuple[int, int]]:
        """All (p_s, p_d) with f_n > 0."""
        out = []
        for p in range(self.num_pes):
            out.append((p, p))
            for q in self._neighbors[p]:
                out.append((p, q))
        return out

    def is_vertex_transitive(self) -> bool:
        """Torus translations act transitively on PEs -> sound PE-symmetry
        breaking.  Plain (non-wrapping) meshes are not vertex transitive,
        and any capability/port table makes PEs distinguishable, so both
        disable symmetry breaking."""
        return self.spec.resolved_topology() == "torus" and self.caps is None

    @property
    def assemblable(self) -> bool:
        """The Table-5 ISA only has N/E/S/W neighbor source selectors, so
        diagonal / one-hop links are mappable (DSE ablations) but cannot
        be lowered to bitstreams."""
        return self.spec.resolved_topology() in ASSEMBLABLE_TOPOLOGIES

    # -- capabilities -------------------------------------------------------------

    def placeable_pes(self, op: str) -> List[int]:
        """PEs allowed to execute ``op`` (all of them without a caps table)."""
        caps = self.caps
        if caps is not None:
            if op in MEM_OPS and caps.mem_pes is not None:
                return sorted(caps.mem_pes)
            if op in MUL_OPS and caps.mul_pes is not None:
                return sorted(caps.mul_pes)
        return list(range(self.num_pes))

    def arch_fingerprint(self) -> Optional[str]:
        """Content hash of everything beyond (rows, cols, regs, torus).

        ``None`` for a legacy homogeneous torus/mesh grid — those fields
        already live in the historical cache-key payload, so pre-existing
        cache entries stay valid and homogeneous keys stay byte-identical.
        """
        topo = self.spec.resolved_topology()
        if self.caps is None and topo in ASSEMBLABLE_TOPOLOGIES:
            return None
        payload = {"topology": topo,
                   "caps": self.caps.to_dict() if self.caps else None}
        blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


def make_grid(rows: int, cols: int, num_regs: int = 4, torus: bool = True) -> PEGrid:
    return PEGrid(CGRASpec(rows=rows, cols=cols, num_regs=num_regs, torus=torus))


def Grid(rows: int, cols: int, topology: str = "torus") -> PEGrid:
    """The homogeneous grid an artifact was mapped onto, from the
    ``(rows, cols, topology)`` it stores; only the topologies the ISA can
    lower to bitstreams are accepted."""
    if topology not in ASSEMBLABLE_TOPOLOGIES:
        raise ValueError(f"unknown topology {topology!r}; "
                         f"expected one of {ASSEMBLABLE_TOPOLOGIES}")
    return make_grid(rows, cols, torus=topology == "torus")


def neighbor_table(grid: PEGrid) -> Tuple[Tuple[int, int, int, int], ...]:
    """(N, E, S, W) neighbour PE ids per PE, honouring the grid's
    resolved topology.

    Only the torus wraps: on a mesh an edge PE has no neighbour in the
    off-grid direction, so that selector is wired back to the PE itself
    (it reads the PE's own OUT; the assembler never emits such a read).
    """
    wrap = grid.topology == "torus"
    out = []
    for p in range(grid.num_pes):
        r, c = grid.coords(p)
        ids = []
        for dr, dc in ((-1, 0), (0, 1), (1, 0), (0, -1)):   # N, E, S, W
            nr, nc = r + dr, c + dc
            if wrap:
                ids.append(grid.pe_at(nr, nc))
            elif 0 <= nr < grid.rows and 0 <= nc < grid.cols:
                ids.append(nr * grid.cols + nc)
            else:
                ids.append(p)
        out.append(tuple(ids))
    return tuple(out)
