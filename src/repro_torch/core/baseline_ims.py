"""Heuristic modulo-scheduling baseline (RAMP / PathSeeker stand-in).

The paper compares against RAMP [10] and PathSeeker [3]: heuristics that
(1) iteratively modulo-schedule with resource tables [Rau 96], (2) greedily
place & route, inserting *routing nodes* when producer and consumer cannot be
made adjacent, and (3) randomize/retry on failure (CRIMSON-style).  Their
original binaries are not available offline, so this module re-implements the
approach; it reproduces the qualitative SoA behaviours the paper reports —
occasional failures on tight 2x2 meshes, routing-node insertion, and IIs that
are sometimes above mII (see benchmarks/fig7_ii.py).

Results are returned as the same :class:`Mapping` type and are checked by the
same independent validator as the SAT mapper.

A copy of ``src/repro/core/baseline_ims.py``: the same ``random.Random``
draws in the same order, so the port's heuristic returns the JAX
package's mappings, node for node.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..cgra.arch import PEGrid
from .dfg import DFG, Edge, Node
from .mapper import IIAttempt, MapResult
from .mapping import Mapping, Placement, classify_handoff, validate_mapping
from .mii import min_ii
from .regalloc import allocate_registers
from .schedule import Slot, asap_alap


@dataclass
class HeuristicConfig:
    seed: int = 0
    tries_per_ii: int = 10
    ii_max: int = 50
    allow_routing: bool = True
    max_routing_nodes: int = 8
    total_timeout_s: Optional[float] = None


# ---------------------------------------------------------------------------
# Phase 1: iterative modulo scheduling (times, not places)
# ---------------------------------------------------------------------------


def _heights(dfg: DFG) -> Dict[int, int]:
    order = dfg.topo_order()
    h = {n: 0 for n in order}
    for n in reversed(order):
        for e in dfg.succs[n]:
            if not e.is_back:
                h[n] = max(h[n], h[e.dst] + 1)
    return h


def _modulo_schedule(dfg: DFG, ii: int, num_pes: int,
                     rng: random.Random) -> Optional[Dict[int, int]]:
    """Rau-style IMS with a random tie-break; returns node -> unfolded time.

    Lifetime rule: every dependency must satisfy
    ``1 <= t_d - t_s + d*II <= II`` (the architecture holds a value at most
    one initiation interval — same restriction the SAT model encodes).
    """
    heights = _heights(dfg)
    order = sorted(dfg.node_ids(),
                   key=lambda n: (-heights[n], rng.random()))
    times: Dict[int, int] = {}
    usage: Dict[int, int] = {r: 0 for r in range(ii)}
    budget = len(order) * 8

    def window(n: int) -> Tuple[int, int]:
        lo, hi = 0, 10 * ii + len(order)
        for e in dfg.preds[n]:
            if e.src in times:
                s = times[e.src]
                lo = max(lo, s + 1 - e.distance * ii)
                hi = min(hi, s + ii - e.distance * ii)
        for e in dfg.succs[n]:
            if e.dst in times and e.src != e.dst:
                d = times[e.dst]
                hi = min(hi, d - 1 + e.distance * ii)
                lo = max(lo, d - ii + e.distance * ii)
        return lo, hi

    pending = list(order)
    while pending and budget > 0:
        n = pending.pop(0)
        budget -= 1
        lo, hi = window(n)
        placed_at = None
        for t in range(max(lo, 0), hi + 1):
            if usage[t % ii] < num_pes:
                placed_at = t
                break
        if placed_at is None:
            # evict a random conflicting row occupant and retry later
            if lo > hi or lo < 0:
                return None
            t = rng.randint(max(lo, 0), hi)
            victims = [m for m, tm in times.items() if tm % ii == t % ii]
            if not victims:
                return None
            v = rng.choice(victims)
            usage[times[v] % ii] -= 1
            del times[v]
            pending.append(v)
            pending.append(n)
            continue
        times[n] = placed_at
        usage[placed_at % ii] += 1
    if pending:
        return None
    return times


# ---------------------------------------------------------------------------
# Phase 2: greedy placement with routing-node insertion
# ---------------------------------------------------------------------------


def _sep(t_s: int, t_d: int, d: int, ii: int) -> int:
    return t_d - t_s + d * ii


def _place(dfg: DFG, times: Dict[int, int], ii: int, grid: PEGrid,
           rng: random.Random, allow_routing: bool,
           max_routing: int) -> Optional[Tuple[DFG, Dict[int, int], Dict[int, int], int]]:
    """Returns (possibly extended dfg, times, node->pe, #routing) or None."""
    nodes = sorted(times, key=lambda n: (times[n], rng.random()))
    pe_of: Dict[int, int] = {}
    occupied: Set[Tuple[int, int]] = set()   # (pe, row)
    held: Set[Tuple[int, int]] = set()       # rows reserved for output holds
    routing_added = 0
    work_dfg = dfg
    next_id = max(dfg.nodes) + 1

    def feasible(n: int, p: int) -> bool:
        row = times[n] % ii
        if (p, row) in occupied or (p, row) in held:
            return False
        for e in work_dfg.preds[n] + work_dfg.succs[n]:
            other = e.src if e.dst == n else e.dst
            if other == n or other not in pe_of:
                continue
            src, dst = (other, n) if e.dst == n else (n, other)
            ps = pe_of[src] if src != n else p
            pd = pe_of[dst] if dst != n else p
            s = _sep(times[src], times[dst], e.distance, ii)
            if not (1 <= s <= ii):
                return False
            if e.kind == "flag":
                if ps != pd:
                    return False
                for k in range(1, s):
                    r = (times[src] + k) % ii
                    if (ps, r) in occupied or (ps, r) in held:
                        return False
                continue
            if grid.f_n(ps, pd) == 0:
                return False
            if s > 1 and ps != pd:
                # would need an output-register hold; check + don't commit yet
                for k in range(1, s):
                    r = (times[src] + k) % ii
                    if (ps, r) in occupied or (ps, r) in held:
                        return False
        return True

    def commit(n: int, p: int) -> None:
        pe_of[n] = p
        occupied.add((p, times[n] % ii))
        for e in work_dfg.preds[n] + work_dfg.succs[n]:
            other = e.src if e.dst == n else e.dst
            if other not in pe_of:
                continue
            src, dst = (e.src, e.dst)
            if src not in pe_of or dst not in pe_of:
                continue
            s = _sep(times[src], times[dst], e.distance, ii)
            if (s > 1 and pe_of[src] != pe_of[dst]) or \
                    (e.kind == "flag" and s > 1):
                for k in range(1, s):
                    held.add((pe_of[src], (times[src] + k) % ii))

    i = 0
    while i < len(nodes):
        n = nodes[i]
        pes = list(range(grid.num_pes))
        rng.shuffle(pes)
        # prefer PEs adjacent to already-placed dependency partners
        def score(p: int) -> int:
            sc = 0
            for e in work_dfg.preds[n] + work_dfg.succs[n]:
                other = e.src if e.dst == n else e.dst
                if other in pe_of and grid.f_n(pe_of[other], p) > 0:
                    sc -= 1
            return sc
        pes.sort(key=score)
        chosen = next((p for p in pes if feasible(n, p)), None)
        if chosen is None:
            if not allow_routing or routing_added >= max_routing:
                return None
            # insert a routing (mov) node on the tightest violated edge
            edge = None
            for e in work_dfg.preds[n]:
                if e.src in pe_of:
                    edge = e
                    break
            if edge is None:
                return None
            mid_t = times[edge.src] + 1
            mov = Node(next_id, op="mov", operands=(edge.src,))
            next_id += 1
            new_edges = [x for x in work_dfg.edges if x is not edge]
            new_edges.append(Edge(edge.src, mov.id, edge.distance))
            new_edges.append(Edge(mov.id, edge.dst, 0))
            work_dfg = DFG(list(work_dfg.nodes.values()) + [mov], new_edges,
                           name=work_dfg.name)
            times[mov.id] = mid_t
            routing_added += 1
            nodes.insert(i, mov.id)
            continue
        commit(n, chosen)
        i += 1
    return work_dfg, times, pe_of, routing_added


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def map_dfg_heuristic(dfg: DFG, grid: PEGrid,
                      config: Optional[HeuristicConfig] = None) -> MapResult:
    cfg = config or HeuristicConfig()
    t0 = time.monotonic()
    mii = min_ii(dfg, grid.num_pes)
    result = MapResult(mapping=None, status="unsat-capped", mii=mii)
    for ii in range(mii, cfg.ii_max + 1):
        t_ii = time.monotonic()
        for trial in range(cfg.tries_per_ii):
            if (cfg.total_timeout_s is not None
                    and time.monotonic() - t0 > cfg.total_timeout_s):
                result.status = "timeout"
                result.total_time_s = time.monotonic() - t0
                return result
            rng = random.Random(cfg.seed * 1_000_003 + ii * 7919 + trial)
            times = _modulo_schedule(dfg, ii, grid.num_pes, rng)
            if times is None:
                continue
            placed = _place(dfg, dict(times), ii, grid, rng,
                            cfg.allow_routing, cfg.max_routing_nodes)
            if placed is None:
                continue
            work_dfg, times2, pe_of, n_routing = placed
            max_t = max(times2.values())
            num_folds = max_t // ii + 1
            placements = {
                n: Placement(node=n, pe=pe_of[n],
                             slot=Slot(c=times2[n] % ii,
                                       it=num_folds - 1 - times2[n] // ii))
                for n in times2}
            mapping = Mapping(dfg=work_dfg, grid=grid, ii=ii,
                              num_folds=num_folds, placements=placements,
                              routing_nodes=n_routing)
            ra = allocate_registers(mapping)
            if not ra.ok:
                continue
            errs = validate_mapping(mapping)
            if errs:
                continue  # heuristic produced an illegal candidate; retry
            for e in work_dfg.edges:
                mapping.handoffs[(e.src, e.dst, e.distance)] = \
                    classify_handoff(mapping, e)
            result.mapping = mapping
            result.status = "mapped"
            result.attempts.append(IIAttempt(
                ii=ii, status="sat", time_s=time.monotonic() - t_ii))
            result.total_time_s = time.monotonic() - t0
            return result
        result.attempts.append(IIAttempt(
            ii=ii, status="fail", time_s=time.monotonic() - t_ii))
    result.total_time_s = time.monotonic() - t0
    return result
