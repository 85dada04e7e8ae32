"""The comparison that decides ``correct``.

Once the window has closed, the plain reference (``reference.py``, numpy
alone) works out again, from the frozen artifacts and the benchmark's
memories, what each checked call had to answer, and this module counts
how far the program's answers stand from it.  Every number has a limit of
its own (``LIMITS``); a run is correct when no number passes its limit.

* ``failed_calls``: calls that raised or came back with a status other
  than ``ok`` or ``mismatch`` (every call).
* ``lost_memories``: memories sent but not reported (every call).
* ``verdict_diff``: memories whose verdict differs from the reference's.
* ``activity_diff``: entries of the activity report that differ.

The reference judges a sample of calls drawn from the seed, which always
holds a call of the kernel with the most rows.  All limits are 0: each
number is exact.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from . import memgen, reference
from .window import Call, Window

LIMITS: Dict[str, int] = {
    "failed_calls": 0, "lost_memories": 0, "verdict_diff": 0,
    "activity_diff": 0,
}
_STATUSES = ("ok", "mismatch")


def sample(win: Window) -> List[Call]:
    """The calls the reference judges."""
    calls = [c for c in win.calls if c.report is not None]
    if not calls:
        return calls
    want = int(win.cell.traffic["check_calls"])
    rng = memgen.rng_for(win.seed, win.cell.name, "check")
    longest = max(range(len(calls)),
                  key=lambda i: (len(calls[i].doc["words"]), -i))
    rest = [i for i in range(len(calls)) if i != longest]
    picked = rng.choice(rest, size=min(want - 1, len(rest)), replace=False)
    return [calls[i] for i in sorted([longest, *picked.tolist()])]


def activity_diff(got, want: Dict) -> int:
    """Entries of two activity reports that differ (a missing report
    differs everywhere)."""
    if not isinstance(got, dict):
        return 1 + sum(len(v) if isinstance(v, dict) else 1
                       for v in want.values())
    diff = 0
    for key in set(got) | set(want):
        a, b = got.get(key), want.get(key)
        if isinstance(a, dict) and isinstance(b, dict):
            diff += sum(a.get(k) != b.get(k) for k in set(a) | set(b))
        else:
            diff += a != b
    return diff


def judge_call(call: Call) -> Dict[str, int]:
    """The numbers of one answered call against the reference."""
    want = reference.fuzz_verdicts(call.doc, call.memories)
    rep = call.report
    return {
        "verdict_diff": len(set(rep.failing) ^ set(want.failing)),
        "activity_diff": activity_diff(rep.activity, want.activity),
    }


def judge(win: Window) -> Dict[str, Tuple[int, int]]:
    """{number: (value, limit)} of the run."""
    nums = dict.fromkeys(LIMITS, 0)
    for call in win.calls:
        rep = call.report
        if call.error is not None or rep is None or rep.status not in _STATUSES:
            nums["failed_calls"] += 1
            continue
        nums["lost_memories"] += abs(len(call.memories) - int(rep.memories))
    for call in sample(win):
        for k, v in judge_call(call).items():
            nums[k] += v
    return {k: (int(v), LIMITS[k]) for k, v in nums.items()}


def correct(numbers: Dict[str, Tuple[int, int]]) -> bool:
    return all(v <= limit for v, limit in numbers.values())
