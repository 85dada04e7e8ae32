"""activity_setup_ms_per_kmem: the set-up part of the program's
``fuzz.activity`` spans (``FuzzReport.activity_setup_s``: the accumulator's
replay of the schedule, once a call, before the first chunk) summed over
the window, in ms per 1000 memories.  A part of activity_ms_per_kmem.
None where the program reports no such time."""


def read(win):
    reports = [c.report for c in win.calls if c.report is not None]
    done = sum(int(r.memories) for r in reports)
    if not done or any(getattr(r, "activity_setup_s", None) is None
                       for r in reports):
        return None
    return sum(r.activity_setup_s for r in reports) * 1e3 / (done / 1e3)
