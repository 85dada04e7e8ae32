"""Trace analysis: merge shards, validate, attribute time, export.

The on-disk form of a trace is a directory of per-process
``shard-*.jsonl`` files (see :mod:`repro_torch.obs.trace`). This module merges
them into one record list and answers "where did the time go":

- :func:`validate` — schema + span-tree well-formedness diagnostics.
- :func:`attribution` — per-root coverage (how much of each root span's
  wall time is inside named child spans) and a per-name aggregate table
  across the whole trace (the "per-sweep" view).
- :func:`render_report` — the ``repro_torch trace report`` text rendering:
  critical-path breakdown per compile plus the aggregate table.
- :func:`to_chrome` — Chrome trace-event JSON (open in Perfetto or
  ``chrome://tracing``).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List, Optional, Tuple

from .trace import SCHEMA_VERSION

_SPAN_KEYS = ("v", "k", "trace", "span", "parent", "name", "pid", "tid", "ts", "dur", "attrs")
_EVENT_KEYS = ("v", "k", "trace", "span", "name", "pid", "tid", "ts", "attrs")


def load(path: str) -> List[Dict[str, Any]]:
    """Load a trace from a directory of shards or a single JSONL file."""
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "shard-*.jsonl")))
    else:
        files = [path]
    records: List[Dict[str, Any]] = []
    for fn in files:
        with open(fn, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if line:
                    records.append(json.loads(line))
    return records


def validate(records: List[Dict[str, Any]]) -> List[str]:
    """Return a list of problems (empty when the trace is well-formed).

    Checks per-record schema (version, kind, required keys and types)
    and tree structure (every non-null parent resolves to a span in the
    same trace, every event's owner span exists, no span is its own
    ancestor).
    """
    problems: List[str] = []
    spans: Dict[str, Dict[str, Any]] = {}
    for i, rec in enumerate(records):
        if rec.get("v") != SCHEMA_VERSION:
            problems.append(f"record {i}: unknown schema version {rec.get('v')!r}")
            continue
        kind = rec.get("k")
        if kind == "span":
            missing = [k for k in _SPAN_KEYS if k not in rec]
            if missing:
                problems.append(f"record {i}: span missing keys {missing}")
                continue
            if not isinstance(rec["dur"], (int, float)) or rec["dur"] < 0:
                problems.append(f"record {i}: bad dur {rec['dur']!r}")
            if not isinstance(rec["attrs"], dict):
                problems.append(f"record {i}: attrs not a dict")
            if rec["span"] in spans:
                problems.append(f"record {i}: duplicate span id {rec['span']}")
            spans[rec["span"]] = rec
        elif kind == "event":
            missing = [k for k in _EVENT_KEYS if k not in rec]
            if missing:
                problems.append(f"record {i}: event missing keys {missing}")
        else:
            problems.append(f"record {i}: unknown kind {kind!r}")
    for sid, rec in spans.items():
        parent = rec.get("parent")
        if parent is not None:
            prec = spans.get(parent)
            if prec is None:
                problems.append(f"span {sid} ({rec['name']}): parent {parent} not found")
            elif prec["trace"] != rec["trace"]:
                problems.append(f"span {sid}: parent in different trace")
        # ancestor cycle check
        seen = {sid}
        cur = parent
        while cur is not None:
            if cur in seen:
                problems.append(f"span {sid}: ancestor cycle via {cur}")
                break
            seen.add(cur)
            nxt = spans.get(cur)
            cur = nxt.get("parent") if nxt else None
    for i, rec in enumerate(records):
        if rec.get("k") == "event" and rec.get("v") == SCHEMA_VERSION:
            if rec.get("span") not in spans:
                problems.append(f"record {i}: event {rec.get('name')!r} owner span missing")
    return problems


def _children(records: List[Dict[str, Any]]) -> Tuple[Dict[str, Dict[str, Any]], Dict[Optional[str], List[Dict[str, Any]]]]:
    spans = {r["span"]: r for r in records if r.get("k") == "span"}
    kids: Dict[Optional[str], List[Dict[str, Any]]] = {}
    for rec in spans.values():
        parent = rec.get("parent")
        if parent is not None and parent not in spans:
            parent = None  # orphan: treat as root rather than losing it
        kids.setdefault(parent, []).append(rec)
    for lst in kids.values():
        lst.sort(key=lambda r: r["ts"])
    return spans, kids


def _union(intervals: List[Tuple[float, float]]) -> float:
    """Total length of the union of [start, end) intervals."""
    if not intervals:
        return 0.0
    intervals.sort()
    total = 0.0
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    total += cur_e - cur_s
    return total


def coverage(rec: Dict[str, Any], kids: Dict[Optional[str], List[Dict[str, Any]]]) -> float:
    """Fraction of ``rec``'s duration covered by its direct children."""
    if rec["dur"] <= 0:
        return 1.0
    lo, hi = rec["ts"], rec["ts"] + rec["dur"]
    ivals = []
    for ch in kids.get(rec["span"], []):
        s = max(lo, ch["ts"])
        e = min(hi, ch["ts"] + ch["dur"])
        if e > s:
            ivals.append((s, e))
    return min(1.0, _union(ivals) / rec["dur"])


def attribution(records: List[Dict[str, Any]], root_name: Optional[str] = None) -> Dict[str, Any]:
    """Attribute wall time to named spans.

    Per *root* (a span with no parent, or, when ``root_name`` is given,
    every span with that name): ``attributed`` is the fraction of its
    wall time lying inside its direct children — the acceptance metric
    "wall time attributed to named spans". The ``by_name`` table
    aggregates total/self time per span name across the whole trace
    (self = duration minus the union of direct-child intervals).
    """
    spans, kids = _children(records)
    if root_name is None:
        roots = kids.get(None, [])
    else:
        roots = [r for r in spans.values() if r["name"] == root_name]
    root_rows = []
    for rec in roots:
        cov = coverage(rec, kids)
        root_rows.append(
            {
                "span": rec["span"],
                "name": rec["name"],
                "dur_s": rec["dur"],
                "attributed": round(cov, 4),
                "attrs": rec.get("attrs", {}),
            }
        )
    total_dur = sum(r["dur_s"] for r in root_rows)
    weighted = (
        sum(r["dur_s"] * r["attributed"] for r in root_rows) / total_dur
        if total_dur > 0
        else 1.0
    )
    by_name: Dict[str, Dict[str, Any]] = {}
    for rec in spans.values():
        row = by_name.setdefault(
            rec["name"], {"count": 0, "total_s": 0.0, "self_s": 0.0}
        )
        row["count"] += 1
        row["total_s"] += rec["dur"]
        row["self_s"] += rec["dur"] * (1.0 - coverage(rec, kids))
    for row in by_name.values():
        row["total_s"] = round(row["total_s"], 6)
        row["self_s"] = round(row["self_s"], 6)
    return {
        "roots": root_rows,
        "attributed": round(weighted, 4),
        "by_name": dict(sorted(by_name.items(), key=lambda kv: -kv[1]["self_s"])),
        "spans": len(spans),
        "events": sum(1 for r in records if r.get("k") == "event"),
        "pids": len({r["pid"] for r in records if "pid" in r}),
    }


def _fmt_tree(rec, kids, depth, lines, max_depth=12) -> None:
    pad = "  " * depth
    attrs = rec.get("attrs", {})
    keys = ("kernel", "grid", "ii", "strategy", "backend", "status", "verdict", "cache_hit")
    shown = " ".join(f"{k}={attrs[k]}" for k in keys if k in attrs)
    lines.append(f"{pad}{rec['name']:<24} {rec['dur'] * 1e3:9.2f} ms  {shown}")
    if depth >= max_depth:
        return
    for ch in kids.get(rec["span"], []):
        _fmt_tree(ch, kids, depth + 1, lines, max_depth)


def render_report(records: List[Dict[str, Any]], min_attribution: Optional[float] = None) -> str:
    """Human-readable report: per-root critical-path tree + aggregate table."""
    spans, kids = _children(records)
    att = attribution(records)
    lines: List[str] = []
    lines.append(
        f"trace: {att['spans']} spans, {att['events']} events, "
        f"{att['pids']} process(es), {len(att['roots'])} root(s)"
    )
    lines.append("")
    for root in sorted(att["roots"], key=lambda r: -r["dur_s"]):
        rec = spans[root["span"]]
        lines.append(
            f"== {rec['name']} [{root['span']}] {rec['dur'] * 1e3:.2f} ms "
            f"(attributed {root['attributed'] * 100:.1f}%)"
        )
        _fmt_tree(rec, kids, 1, lines)
        lines.append("")
    lines.append("aggregate attribution by span name (self time, descending):")
    lines.append(f"  {'name':<24}{'count':>7}{'total ms':>12}{'self ms':>12}")
    for name, row in att["by_name"].items():
        lines.append(
            f"  {name:<24}{row['count']:>7}{row['total_s'] * 1e3:>12.2f}"
            f"{row['self_s'] * 1e3:>12.2f}"
        )
    lines.append("")
    lines.append(f"overall attributed fraction: {att['attributed'] * 100:.1f}%")
    if min_attribution is not None:
        verdict = "PASS" if att["attributed"] >= min_attribution else "FAIL"
        lines.append(
            f"attribution gate (>= {min_attribution * 100:.0f}%): {verdict}"
        )
    return "\n".join(lines)


def to_chrome(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Chrome trace-event JSON (``traceEvents`` array, ``X``/``i`` phases).

    Timestamps are microseconds relative to the earliest record so the
    viewer opens at t=0. Load in Perfetto (ui.perfetto.dev) or
    ``chrome://tracing``.

A copy of ``src/repro/obs/report.py``.  The shard schema is the JAX
package's (:data:`~repro_torch.obs.trace.SCHEMA_VERSION` is the same), so
each package's report reads the other's traces; Chrome events keep the
category ``"repro"``.
    """
    t0 = min((r["ts"] for r in records if "ts" in r), default=0.0)
    events: List[Dict[str, Any]] = []
    for rec in records:
        if rec.get("k") == "span":
            events.append(
                {
                    "name": rec["name"],
                    "cat": "repro",
                    "ph": "X",
                    "ts": round((rec["ts"] - t0) * 1e6, 1),
                    "dur": round(rec["dur"] * 1e6, 1),
                    "pid": rec["pid"],
                    "tid": rec["tid"],
                    "args": dict(rec.get("attrs", {}), trace=rec["trace"], span=rec["span"]),
                }
            )
        elif rec.get("k") == "event":
            events.append(
                {
                    "name": rec["name"],
                    "cat": "repro",
                    "ph": "i",
                    "s": "t",
                    "ts": round((rec["ts"] - t0) * 1e6, 1),
                    "pid": rec["pid"],
                    "tid": rec["tid"],
                    "args": dict(rec.get("attrs", {}), span=rec["span"]),
                }
            )
    return {"traceEvents": events, "displayTimeUnit": "ms"}
