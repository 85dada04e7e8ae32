"""Cross-point fact store: lift solver-proven facts between DSE points.

During a DSE sweep (or a compile-farm session) the same kernel is mapped
onto many grids.  Three kinds of facts proven on one grid transfer to
another, and re-deriving them is pure waste:

* **CEGAR blocking combos** — the assembler oracle rejected a joint
  placement (e.g. a prologue clobber).  The counterexample is a function
  of node schedule slots, PE *coordinates* and mesh adjacency only, so it
  transfers along any embedding that preserves those.
* **UNSAT-at-II** — the solver proved no mapping exists at some II.
  Removing PEs only shrinks the solution space, so the proof transfers
  *downward* (from a grid to any grid that embeds into it).
* **Feasible II** — a validated mapping at II.  Adding PEs only grows the
  solution space, so feasibility transfers *upward* and caps the II
  ladder on any larger grid.

Lifting condition (``embeds_in``)
---------------------------------
Grid *A* embeds in grid *B* iff the identity map on coordinates,
``(r, c) -> (r, c)``, is a sound sub-grid embedding:

1. both are plain **mesh** topologies (no torus/diagonal/one-hop: a torus
   wrap edge of *A*, e.g. ``(0,0)-(0,cols-1)``, is not an edge of a wider
   torus, so adjacency would *not* be preserved);
2. ``A.rows <= B.rows`` and ``A.cols <= B.cols``;
3. identical register-file size (``num_regs``) — register-pressure facts
   depend on it;
4. both grids are homogeneous (``arch_fingerprint() is None``): capability
   or port tables tie a fact to specific PEs and break transfer.

Under 1–4 the embedding preserves coordinates, adjacency and per-PE
resources, so any mapping of *A* is verbatim a mapping of *B* (SAT lifts
up), any UNSAT proof on *B* covers the restriction to *A* (UNSAT lifts
down), and an oracle counterexample on *A* re-assembles identically on
*B* (combos lift up, with PEs re-indexed to *B*'s row stride).  Facts on
the *exact* same architecture (any topology, including heterogeneous
specs, keyed by fingerprint) always transfer verbatim.

Facts are keyed by (DFG content, oracle tag): a combo proven under the
bitstream-prologue oracle must never seed an oracle-less solve, and vice
versa.  The store is **opt-in** (``Toolchain(..., facts=...)``,
``repro dse --share-facts``): fact-seeded results are never written to
the content-addressed mapping cache (the key cannot see the seed), and
with the store off every byte of cache/baseline output is unchanged.

A copy of ``src/repro/core/facts.py``: the seeds it lifts equal the JAX
package's, fact for fact and in the same order.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..cgra.arch import PEGrid
from .dfg import DFG
from .schedule import Slot

#: (rows, cols, topology, num_regs, fingerprint-or-None) — everything the
#: lifting condition inspects.
GridMeta = Tuple[int, int, str, int, Optional[str]]


def grid_meta(grid: PEGrid) -> GridMeta:
    return (grid.spec.rows, grid.spec.cols, grid.spec.resolved_topology(),
            grid.spec.num_regs, grid.arch_fingerprint())


def embeds_in(src: GridMeta, dst: GridMeta) -> bool:
    """True iff the identity coordinate map embeds ``src`` into ``dst``
    (the four-clause lifting condition in the module docstring).  Equal
    metas trivially embed."""
    if src == dst:
        return True
    s_rows, s_cols, s_topo, s_regs, s_fp = src
    d_rows, d_cols, d_topo, d_regs, d_fp = dst
    return (s_topo == "mesh" and d_topo == "mesh"
            and s_rows <= d_rows and s_cols <= d_cols
            and s_regs == d_regs
            and s_fp is None and d_fp is None)


def remap_combo(combo, src_cols: int, dst_cols: int):
    """Re-index a placement-triple combo from a ``src_cols``-wide mesh to
    a ``dst_cols``-wide one (row-major PE ids; coordinates unchanged)."""
    if src_cols == dst_cols:
        return list(combo)
    out = []
    for (n, p, slot) in combo:
        r, c = divmod(p, src_cols)
        out.append((n, r * dst_cols + c, slot))
    return out


def dfg_fact_key(dfg: DFG) -> str:
    """Content hash of the DFG (same fields :func:`mapping_cache_key`
    hashes; names excluded)."""
    payload = {
        "nodes": [[n.id, n.op] for n in
                  (dfg.nodes[i] for i in dfg.node_ids())],
        "edges": sorted([e.src, e.dst, e.distance, e.kind]
                        for e in dfg.edges),
    }
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def _combo_fp(combo) -> str:
    return json.dumps([[n, p, [s.c, s.it]] for (n, p, s) in
                       sorted(combo, key=lambda t: (t[0], t[1]))],
                      separators=(",", ":"))


@dataclass
class FactStore:
    """Session-scoped store of liftable facts, keyed by (DFG, oracle).

    ``publish`` records the provable parts of a :class:`MapResult`
    (discovered combos, solver-proven UNSAT IIs, the feasible II of a
    mapped result).  ``lift`` assembles a ``facts_seed`` dict for a target
    grid from every stored fact whose grid satisfies the lifting
    condition.  Heuristic advances (RA failure, CEGAR exhaustion,
    timeouts) are never published: they are not proofs.
    """

    #: (dfg_key, oracle_tag) -> list of (grid_meta, combo)
    _combos: Dict[Tuple[str, str], List[Tuple[GridMeta, list]]] = field(
        default_factory=dict
    )
    #: (dfg_key, oracle_tag) -> list of (grid_meta, ii) proven UNSAT
    _unsat: Dict[Tuple[str, str], List[Tuple[GridMeta, int]]] = field(
        default_factory=dict
    )
    #: (dfg_key, oracle_tag) -> list of (grid_meta, ii) proven feasible
    _feasible: Dict[Tuple[str, str], List[Tuple[GridMeta, int]]] = field(
        default_factory=dict
    )
    _seen: Set[Tuple] = field(default_factory=set)
    published: int = 0
    lifted: int = 0
    lift_hits: int = 0

    def publish(self, dfg: DFG, grid: PEGrid, oracle_tag: str,
                result) -> int:
        """Record the provable facts of ``result`` (a MapResult).  Returns
        how many new facts were stored."""
        key = (dfg_fact_key(dfg), oracle_tag)
        meta = grid_meta(grid)
        new = 0
        for combo in result.blocked_combos:
            fp = ("combo", key, meta, _combo_fp(combo))
            if fp in self._seen:
                continue
            self._seen.add(fp)
            self._combos.setdefault(key, []).append((meta, list(combo)))
            new += 1
        for ii in result.unsat_iis:
            fp = ("unsat", key, meta, ii)
            if fp in self._seen:
                continue
            self._seen.add(fp)
            self._unsat.setdefault(key, []).append((meta, ii))
            new += 1
        if result.status == "mapped" and result.mapping is not None:
            fp = ("feasible", key, meta, result.mapping.ii)
            if fp not in self._seen:
                self._seen.add(fp)
                self._feasible.setdefault(key, []).append(
                    (meta, result.mapping.ii))
                new += 1
        self.published += new
        return new

    def lift(self, dfg: DFG, grid: PEGrid,
             oracle_tag: str) -> Optional[Dict]:
        """Assemble a ``facts_seed`` for mapping ``dfg`` onto ``grid``:
        ``{"blocked": [...], "unsat_iis": [...], "ii_cap": int | None}``,
        or None when no stored fact lifts to this grid."""
        key = (dfg_fact_key(dfg), oracle_tag)
        meta = grid_meta(grid)
        blocked: List = []
        combo_seen: Set[str] = set()
        for (src, combo) in self._combos.get(key, ()):
            # combos lift upward: the source grid must embed in the target
            if embeds_in(src, meta):
                lifted = remap_combo(combo, src[1], meta[1])
                fp = _combo_fp(lifted)
                if fp not in combo_seen:
                    combo_seen.add(fp)
                    blocked.append(lifted)
        unsat_iis = sorted({ii for (src, ii) in self._unsat.get(key, ())
                            # UNSAT lifts downward: the *target* must embed
                            # in the grid the proof was found on
                            if embeds_in(meta, src)})
        caps = [ii for (src, ii) in self._feasible.get(key, ())
                # feasibility lifts upward, capping the II ladder
                if embeds_in(src, meta)]
        ii_cap = min(caps) if caps else None
        if not blocked and not unsat_iis and ii_cap is None:
            return None
        self.lifted += 1
        self.lift_hits += (len(blocked) + len(unsat_iis)
                           + (1 if ii_cap is not None else 0))
        return {"blocked": blocked, "unsat_iis": unsat_iis,
                "ii_cap": ii_cap}

    def stats(self) -> Dict:
        return {"published": self.published, "lifted": self.lifted,
                "lift_hits": self.lift_hits}


def seed_to_jsonable(seed: Optional[Dict]) -> Optional[Dict]:
    """``facts_seed`` -> plain JSON (for worker payloads)."""
    if not seed:
        return None
    return {"blocked": [[[n, p, [s.c, s.it]] for (n, p, s) in combo]
                        for combo in seed.get("blocked", ())],
            "unsat_iis": list(seed.get("unsat_iis", ())),
            "ii_cap": seed.get("ii_cap")}


def seed_from_jsonable(data: Optional[Dict]) -> Optional[Dict]:
    """Inverse of :func:`seed_to_jsonable` (revives the Slots)."""
    if not data:
        return None
    return {"blocked": [[(n, p, Slot(sc, sit)) for (n, p, (sc, sit))
                         in combo] for combo in data.get("blocked", ())],
            "unsat_iis": list(data.get("unsat_iis", ())),
            "ii_cap": data.get("ii_cap")}
