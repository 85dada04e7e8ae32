"""Markdown rendering of a DSE sweep document (Pareto tables).

A copy of ``src/repro/dse/report.py``."""
from __future__ import annotations

from typing import Dict, List


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:g}"
    return str(v)


def markdown_report(doc: Dict) -> str:
    """One table per kernel; front membership marked in the last column
    (``R`` = run-time Pareto front, ``C`` = compiler-metric front)."""
    lines: List[str] = ["# DSE sweep — Pareto fronts", ""]
    lines.append(f"Backend `{doc['backend']}`, sizes "
                 f"{', '.join(doc['sizes'])}; cache hits "
                 f"{doc['cache']['hits']}, misses {doc['cache']['misses']}; "
                 f"wall time {doc['wall_time_s']}s.")
    per_kernel = doc["pareto"]["per_kernel"]
    by_kernel: Dict[str, List[Dict]] = {}
    for row in doc["points"]:
        by_kernel.setdefault(row["kernel"], []).append(row)
    for kernel, rows in by_kernel.items():
        pa = per_kernel.get(kernel)
        lines.append("")
        lines.append(f"## {kernel}")
        if pa:
            lines.append(
                f"retained fraction {pa['retained_fraction']} "
                f"(run-time front size {len(pa['runtime_front'])}), "
                f"pruned fraction {pa['pruned_fraction']}")
        lines.append("")
        lines.append("| size | status | II | U | cycles | energy (nJ) "
                     "| map (s) | front |")
        lines.append("|------|--------|----|---|--------|-------------"
                     "|---------|-------|")
        for r in rows:
            marks = []
            if pa and r["size"] in pa["runtime_front"]:
                marks.append("R")
            if pa and r["size"] in pa["compiler_front"]:
                marks.append("C")
            lines.append(
                f"| {r['size']} | {r['status']} | {_fmt(r.get('ii'))} "
                f"| {_fmt(r.get('utilization'))} "
                f"| {_fmt(r.get('latency_cycles'))} "
                f"| {_fmt(r.get('energy_nj'))} "
                f"| {_fmt(r.get('map_time_s'))} "
                f"| {''.join(marks) or '-'} |")
    s = doc["pareto"]["summary"]
    lines.append("")
    lines.append(
        f"**Summary:** {s['mapped_points']} mapped points over "
        f"{s['kernels']} kernels; mean retained fraction "
        f"{_fmt(s['mean_retained_fraction'])}, mean pruned fraction "
        f"{_fmt(s['mean_pruned_fraction'])}.")
    return "\n".join(lines) + "\n"
