"""Register allocation as a decoupled post-pass (paper §4.3).

For each PE we collect the values handed off through the register file
(ζ1-style same-PE dependencies) and build an interference graph over their
*cyclic* live ranges in modulo time, then color it with the PE's register
budget.  The paper leverages SSA-form optimality [Hack & Goos]; live ranges
folded modulo II form circular-arc graphs, so we use a rotation-greedy
coloring (exact for interval graphs, <= OPT+1 colors on circular arcs, and we
additionally verify against the max-overlap lower bound before failing).

A copy of ``src/repro/core/regalloc.py`` (the port imports nothing of the JAX
package).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from .dfg import DFG
from .mapping import Mapping, REG, classify_handoff, separation


@dataclass
class LiveValue:
    """A register-file-resident value on one PE.

    The producing node writes at the *end* of its row; the last register-file
    consumer reads at the *start* of its row.  In units of 1/2 row on a circle
    of circumference 2*II: live on the open interval
    (2*c_def + 1, 2*c_def + 2*span) — write-after-read in the same row does
    not interfere.
    """

    node: int
    pe: int
    def_row: int
    span: int  # in rows (== max separation among reg-file consumers)

    def ticks(self, ii: int) -> List[int]:
        """Occupied half-row ticks on the circle of size 2*ii."""
        start = 2 * self.def_row + 2  # first start-of-row after the write
        length = 2 * self.span - 1    # up to the consumer's start-of-row
        return [(start + t) % (2 * ii) for t in range(length)]


@dataclass
class RAResult:
    ok: bool
    max_colors_used: int
    colors: Dict[int, int] = field(default_factory=dict)  # node -> register
    worst_pe: int = -1
    lower_bound: int = 0


def live_values(mapping: Mapping) -> List[LiveValue]:
    spans: Dict[int, int] = {}
    for edge in mapping.dfg.edges:
        if edge.kind in ("flag", "colocate"):
            continue
        if classify_handoff(mapping, edge) != REG:
            continue
        s = separation(mapping, edge)
        spans[edge.src] = max(spans.get(edge.src, 0), s)
    out = []
    for node, span in spans.items():
        pl = mapping.placements[node]
        out.append(LiveValue(node=node, pe=pl.pe, def_row=pl.slot.c, span=span))
    return out


def _color_pe(values: List[LiveValue], ii: int, budget: int) -> Tuple[bool, int, Dict[int, int], int]:
    """Greedy circular-arc coloring with several rotation orders."""
    if not values:
        return True, 0, {}, 0
    ticks = {v.node: set(v.ticks(ii)) for v in values}
    # max-overlap lower bound
    occupancy: Dict[int, int] = {}
    for tset in ticks.values():
        for t in tset:
            occupancy[t] = occupancy.get(t, 0) + 1
    lower = max(occupancy.values())
    best_used = len(values) + 1
    best_colors: Dict[int, int] = {}
    orders = [
        sorted(values, key=lambda v: (-v.span, v.def_row, v.node)),
        sorted(values, key=lambda v: (v.def_row, -v.span, v.node)),
        sorted(values, key=lambda v: v.node),
    ]
    for order in orders:
        colors: Dict[int, int] = {}
        used = 0
        for v in order:
            taken = set()
            for u, cu in colors.items():
                if ticks[v.node] & ticks[u]:
                    taken.add(cu)
            c = 0
            while c in taken:
                c += 1
            colors[v.node] = c
            used = max(used, c + 1)
        if used < best_used:
            best_used, best_colors = used, colors
        if best_used == lower:
            break
    return best_used <= budget, best_used, best_colors, lower


def allocate_registers(mapping: Mapping) -> RAResult:
    ii = mapping.ii
    budget = mapping.grid.spec.num_regs
    per_pe: Dict[int, List[LiveValue]] = {}
    for v in live_values(mapping):
        per_pe.setdefault(v.pe, []).append(v)
    all_colors: Dict[int, int] = {}
    worst_used, worst_pe, worst_lower = 0, -1, 0
    ok = True
    for pe, values in per_pe.items():
        pe_ok, used, colors, lower = _color_pe(values, ii, budget)
        all_colors.update(colors)
        if used > worst_used:
            worst_used, worst_pe, worst_lower = used, pe, lower
        if not pe_ok:
            ok = False
    return RAResult(ok=ok, max_colors_used=worst_used, colors=all_colors,
                    worst_pe=worst_pe, lower_bound=worst_lower)
