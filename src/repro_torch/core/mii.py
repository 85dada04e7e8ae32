"""Minimum initiation interval: mII = max(ResII, RecII)   (paper Eq. 2, [Rau 96]).

* ``ResII = ceil(#nodes / #PEs)`` — resource bound.
* ``RecII = max over cycles l of ceil(latency(l) / distance(l))`` — recurrence
  bound.  Enumerating cycles is exponential, so we compute RecII as the
  smallest II for which the constraint graph with edge weights
  ``latency - II * distance`` has no positive-weight cycle (Bellman-Ford
  longest-path relaxation); the two definitions coincide.

A copy of ``src/repro/core/mii.py`` (the port imports nothing of the JAX
package).
"""
from __future__ import annotations

from .dfg import DFG


def res_ii(dfg: DFG, num_pes: int) -> int:
    if num_pes <= 0:
        raise ValueError("num_pes must be positive")
    return -(-dfg.num_nodes // num_pes)


def _has_positive_cycle(dfg: DFG, ii: int, latency: int = 1) -> bool:
    nodes = dfg.node_ids()
    idx = {n: i for i, n in enumerate(nodes)}
    n = len(nodes)
    # longest-path Bellman-Ford from a virtual source connected with weight 0
    dist = [0.0] * n
    edges = [(idx[e.src], idx[e.dst], latency - ii * e.distance)
             for e in dfg.edges]
    for it in range(n):
        changed = False
        for (u, v, w) in edges:
            if dist[u] + w > dist[v]:
                dist[v] = dist[u] + w
                changed = True
        if not changed:
            return False
    # one more pass: any further relaxation implies a positive cycle
    for (u, v, w) in edges:
        if dist[u] + w > dist[v]:
            return True
    return False


def rec_ii(dfg: DFG, latency: int = 1) -> int:
    """Smallest II admitting no positive cycle; 1 when there are no back-edges
    participating in cycles."""
    if not dfg.back_edges():
        return 1
    # II is bounded by total latency of all nodes (any simple cycle's latency
    # sum <= N * latency and distance >= 1).
    lo, hi = 1, max(1, dfg.num_nodes * latency)
    if _has_positive_cycle(dfg, hi):
        # distances sum > 1 per cycle keeps this unreachable; guard anyway
        hi = dfg.num_nodes * latency * 2
    while lo < hi:
        mid = (lo + hi) // 2
        if _has_positive_cycle(dfg, mid):
            lo = mid + 1
        else:
            hi = mid
    return lo


def min_ii(dfg: DFG, num_pes: int, latency: int = 1) -> int:
    return max(res_ii(dfg, num_pes), rec_ii(dfg, latency))
