"""ASAP/ALAP schedules, Mobility Schedule, Kernel Mobility Schedule (paper §4.1).

The KMS is the paper's central data structure: the Mobility Schedule folded by
II, each folded copy labelled with the iteration it belongs to.  Folding
convention (reverse-engineered from paper Tables 1-2 and verified in tests):

* the MS has ``L`` rows; with ``K = ceil(L / II)`` folds the MS is padded *at
  the top* to ``K * II`` rows (``pad = K*II - L``),
* MS row ``r`` lands at KMS row ``c = (r + pad) % II`` with iteration label
  ``it = K - 1 - (r + pad) // II``;

so the *deepest* MS rows carry label 0 (the oldest in-flight iteration) and
the shallowest rows carry label ``K-1`` (the newest), exactly as in Table 2.

A copy of ``src/repro/core/schedule.py`` (the port imports nothing of the JAX
package).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from .dfg import DFG


@dataclass
class MobilitySchedule:
    """ASAP/ALAP windows per node + derived row sets."""

    asap: Dict[int, int]
    alap: Dict[int, int]
    length: int  # schedule length L (rows 0..L-1)

    def mobility(self, n: int) -> range:
        return range(self.asap[n], self.alap[n] + 1)

    def rows(self) -> List[Set[int]]:
        out: List[Set[int]] = [set() for _ in range(self.length)]
        for n in self.asap:
            for r in self.mobility(n):
                out[r].add(n)
        return out

    def asap_rows(self) -> List[Set[int]]:
        out: List[Set[int]] = [set() for _ in range(self.length)]
        for n, r in self.asap.items():
            out[r].add(n)
        return out

    def alap_rows(self) -> List[Set[int]]:
        out: List[Set[int]] = [set() for _ in range(self.length)]
        for n, r in self.alap.items():
            out[r].add(n)
        return out


def asap_alap(dfg: DFG, latency: int = 1) -> MobilitySchedule:
    """Longest-path ASAP/ALAP over the forward (distance-0) subgraph."""
    order = dfg.topo_order()
    asap: Dict[int, int] = {n: 0 for n in order}
    for n in order:
        for e in dfg.succs[n]:
            if e.is_back:
                continue
            asap[e.dst] = max(asap[e.dst], asap[n] + latency)
    length = max(asap.values()) + 1 if asap else 0
    alap: Dict[int, int] = {n: length - 1 for n in order}
    for n in reversed(order):
        for e in dfg.succs[n]:
            if e.is_back:
                continue
            alap[n] = min(alap[n], alap[e.dst] - latency)
    return MobilitySchedule(asap=asap, alap=alap, length=length)


def kms_ii_upper_bound(dfg: DFG, num_pes: Optional[int] = None) -> int:
    """Largest II at which modulo scheduling is still meaningful.

    At ``II = L`` (the mobility-schedule length) the KMS degenerates to a
    single un-folded copy of the MS — successive iterations no longer
    overlap, so any II beyond it buys nothing.  Traced kernels assert they
    map at some ``II <= kms_ii_upper_bound``
    (repro_torch.frontend.verify); a failure means the front-end emitted
    a DFG the mapper cannot even serialize.  ``num_pes`` folds in the
    resource/recurrence lower bound so the result is always a valid
    search ceiling (``>= mII``).
    """
    ub = max(1, asap_alap(dfg).length)
    if num_pes is not None:
        from .mii import min_ii  # deferred: mii has no schedule dependency

        ub = max(ub, min_ii(dfg, num_pes))
    return ub


@dataclass(frozen=True)
class Slot:
    """A (row, iteration-label) position in the KMS."""

    c: int
    it: int


@dataclass
class KMS:
    """Kernel Mobility Schedule for a given II.

    ``slots[n]`` lists the (c, it) positions where node ``n`` may be placed;
    ``rows[c][it]`` is the set of nodes present at KMS row ``c`` with label
    ``it``.  ``num_folds`` (K) is the number of interleaved iterations in the
    steady-state kernel.
    """

    ii: int
    num_folds: int
    pad: int
    slots: Dict[int, List[Slot]]
    rows: List[Dict[int, Set[int]]]

    def stage(self, it: int) -> int:
        """Pipeline stage index of an iteration label (0 = earliest stage)."""
        return self.num_folds - 1 - it

    def schedule_time(self, slot: Slot) -> int:
        """Position in the *unfolded* (padded) mobility schedule.

        For loop iteration ``j`` the operation executes at absolute CGRA-cycle
        ``j * II + schedule_time``; two slots' schedule-time difference is the
        steady-state timing distance used for dependence checking.
        """
        return slot.c + self.stage(slot.it) * self.ii

    def nodes_at(self, c: int) -> Set[int]:
        out: Set[int] = set()
        for nodes in self.rows[c].values():
            out |= nodes
        return out


def fold_kms(ms: MobilitySchedule, ii: int) -> KMS:
    if ii <= 0:
        raise ValueError("II must be positive")
    length = ms.length
    num_folds = -(-length // ii)  # ceil
    pad = num_folds * ii - length
    slots: Dict[int, List[Slot]] = {}
    rows: List[Dict[int, Set[int]]] = [dict() for _ in range(ii)]
    for n in sorted(ms.asap):
        positions: List[Slot] = []
        for r in ms.mobility(n):
            q = r + pad
            c = q % ii
            it = num_folds - 1 - q // ii
            slot = Slot(c=c, it=it)
            positions.append(slot)
            rows[c].setdefault(it, set()).add(n)
        slots[n] = positions
    return KMS(ii=ii, num_folds=num_folds, pad=pad, slots=slots, rows=rows)
