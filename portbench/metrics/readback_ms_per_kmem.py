"""readback_ms_per_kmem: the program's ``fuzz.readback`` spans
(``FuzzReport.readback_time_s``: from the launch's return to the host
holding the node values and the final memories; the wait on the card and
the copies back) summed over the window, in ms per 1000 memories.  It is
a part of ``exec_ms_per_kmem``.  None where the program reports no such
time."""


def read(win):
    reports = [c.report for c in win.calls if c.report is not None]
    done = sum(int(r.memories) for r in reports)
    if not done or any(getattr(r, "readback_time_s", None) is None
                       for r in reports):
        return None
    return sum(r.readback_time_s for r in reports) * 1e3 / (done / 1e3)
