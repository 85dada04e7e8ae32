"""k-dimensional Pareto fronts + the paper's Fig. 11 pruning metric.

All objectives are *minimized*.  Domination is weak: ``a`` dominates ``b``
iff ``a <= b`` component-wise with at least one strict inequality — so
exact duplicates never dominate each other and both stay on the front
(matching how the paper counts tied architecture cells).

The DSE question (paper §7.3): if an architect prunes the design space
using **compiler-level** metrics alone (II, utilization — known without
running anything), what fraction of the true run-time Pareto set
(latency, energy, II) survives?  ``kernel_pareto`` answers that per CIL;
``pareto_analysis`` aggregates across kernels.

A copy of ``src/repro/dse/pareto.py``: fronts keep the reference's tie
order, so both packages serialize one sweep to the same bytes.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

Point = Tuple[float, ...]


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """Weak Pareto domination (minimize all objectives)."""
    if len(a) != len(b):
        raise ValueError(f"dimension mismatch: {len(a)} vs {len(b)}")
    return all(x <= y for x, y in zip(a, b)) and \
        any(x < y for x, y in zip(a, b))


def pareto_front(points: Sequence[Sequence[float]]) -> List[int]:
    """Sorted indices of the non-dominated points (ties all survive)."""
    return [i for i, p in enumerate(points)
            if not any(dominates(q, p)
                       for j, q in enumerate(points) if j != i)]


def kernel_pareto(points: List[Dict], label_key: str = "size",
                  extra_objectives: Sequence[str] = ()) -> Dict:
    """Fronts + pruning metric for one kernel's mapped design points.

    Each record needs ``ii``, ``utilization``, ``latency_cycles``,
    ``energy_nj`` and the ``label_key`` field (``"size"`` for the classic
    geometry ladder, ``"arch"`` for the widened architecture space).
    ``extra_objectives`` appends fields — e.g. ``("area",)`` — to *both*
    fronts: area is known at spec time, so the compiler-metric architect
    legitimately prunes with it.  Returns labels (sorted, so repeated
    sweeps serialize byte-identically) rather than indices.
    """
    extras = [tuple(p[k] for k in extra_objectives) for p in points]
    runtime = pareto_front(
        [(p["ii"], p["latency_cycles"], p["energy_nj"]) + e
         for p, e in zip(points, extras)])
    compiler = pareto_front(
        [(p["ii"], round(1.0 - p["utilization"], 9)) + e
         for p, e in zip(points, extras)])
    runtime_set = {points[i][label_key] for i in runtime}
    compiler_set = {points[i][label_key] for i in compiler}
    retained = (len(runtime_set & compiler_set) / len(runtime_set)
                if runtime_set else 1.0)
    pruned = 1.0 - len(compiler_set) / len(points) if points else 0.0
    return {
        "points": len(points),
        "runtime_front": sorted(runtime_set),
        "compiler_front": sorted(compiler_set),
        "retained_fraction": round(retained, 4),
        "pruned_fraction": round(pruned, 4),
    }


def pareto_analysis(records: List[Dict], label_key: str = "size",
                    extra_objectives: Sequence[str] = ()) -> Dict:
    """Per-kernel fronts + cross-kernel aggregates over mapped records."""
    per_kernel: Dict[str, List[Dict]] = {}
    for r in records:
        if r.get("status") == "mapped":
            per_kernel.setdefault(r["kernel"], []).append(r)
    out = {k: kernel_pareto(v, label_key, extra_objectives)
           for k, v in sorted(per_kernel.items())}
    retained = [v["retained_fraction"] for v in out.values()]
    pruned = [v["pruned_fraction"] for v in out.values()]
    summary = {
        "kernels": len(out),
        "mapped_points": sum(v["points"] for v in out.values()),
        "mean_retained_fraction": (round(sum(retained) / len(retained), 4)
                                   if retained else None),
        "mean_pruned_fraction": (round(sum(pruned) / len(pruned), 4)
                                 if pruned else None),
    }
    return {"per_kernel": out, "summary": summary}
