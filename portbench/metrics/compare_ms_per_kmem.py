"""compare_ms_per_kmem: the program's ``fuzz.compare`` spans
(``FuzzReport.compare_time_s``: ``compare_batch`` against the oracle and
the mismatch lines) summed over the window, in ms per 1000 memories.
None where the program reports no such time."""


def read(win):
    reports = [c.report for c in win.calls if c.report is not None]
    done = sum(int(r.memories) for r in reports)
    if not done or any(getattr(r, "compare_time_s", None) is None
                       for r in reports):
        return None
    return sum(r.compare_time_s for r in reports) * 1e3 / (done / 1e3)
