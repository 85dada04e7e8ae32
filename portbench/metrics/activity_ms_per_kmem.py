"""activity_ms_per_kmem: the program's ``fuzz.activity`` spans
(``FuzzReport.activity_time_s``: the accumulator's set-up, each chunk's
harvest as the host enqueues it, and the report's read-back) summed over
the window, in ms per 1000 memories.  None where the program reports no
such time."""


def read(win):
    reports = [c.report for c in win.calls if c.report is not None]
    done = sum(int(r.memories) for r in reports)
    if not done or any(getattr(r, "activity_time_s", None) is None
                       for r in reports):
        return None
    return sum(r.activity_time_s for r in reports) * 1e3 / (done / 1e3)
