"""What one ``torch.profiler`` window over the measured loop says: the
device's busy time, every device operation in order, and where the device
sat idle and what the host was doing then.

It reads the profiler's raw events (``kineto_results``), which costs a
fraction of building its event tree.  A device operation is a kernel, a
copy or a set on the card: the device-side ranges of annotations
(``record_function``) span other work and are left out.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

#: how many entries of each breakdown list the result line carries
TOP = 10
#: how far back a gap's host op is looked for among the host events
_LOOKBACK = 4096
#: the label of the window's own annotations (``window._label``)
LABEL = "portbench."


@dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    ops: List[Tuple[str, float, float]]          # (name, start s, seconds)
    breakdown: Dict = field(default_factory=dict)


def _merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], end))
        else:
            out.append((start, end))
    return out


def _host_at(host: List[Tuple[float, float, str]], starts: List[float],
             t: float) -> str:
    """What the host was doing at ``t``: the innermost host event running
    then (the latest-starting one not yet ended)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - _LOOKBACK, -1), -1):
        _, end, name = host[j]
        if end >= t:
            return (f"{name}: host outside torch ops"
                    if name.startswith(LABEL) else name)
    return "host outside every recorded op"


def _top(totals: Dict[str, float]) -> List[List]:
    return [[k, v] for k, v in sorted(totals.items(),
                                      key=lambda kv: -kv[1])[:TOP]]


def read(prof, window_s: float) -> DeviceTrace:
    """Reduce a finished profiler to the window's device trace."""
    from torch.autograd import DeviceType

    results = prof.profiler.kineto_results
    base = results.trace_start_ns()
    device, host = [], []
    for e in results.events():
        span = ((e.start_ns() - base) / 1e9, (e.end_ns() - base) / 1e9,
                e.name())
        if e.device_type() == DeviceType.CPU:
            host.append(span)
        elif not e.is_user_annotation():
            device.append(span)
    device.sort()
    host.sort()
    busy = _merged([(s, e) for s, e, _ in device])

    by_op: Dict[str, float] = defaultdict(float)
    for s, e, name in device:
        by_op[name[:120]] += e - s
    starts = [s for s, _, _ in host]
    by_gap: Dict[str, float] = defaultdict(float)
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        by_gap[_host_at(host, starts, (end + nxt) / 2)[:120]] += nxt - end
    return DeviceTrace(
        window_s=window_s, busy_s=sum(e - s for s, e in busy),
        ops=[(name, s, e - s) for s, e, name in device],
        breakdown={"device_ops": _top(by_op), "idle_gaps": _top(by_gap)})
