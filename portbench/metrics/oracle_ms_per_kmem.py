"""oracle_ms_per_kmem: the program's own oracle timer
(``FuzzReport.oracle_time_s``, the batched numpy oracle) summed over the
window, in ms per 1000 memories."""


def read(win):
    reports = [c.report for c in win.calls if c.report is not None]
    done = sum(int(r.memories) for r in reports)
    if not done:
        return None
    return sum(r.oracle_time_s for r in reports) * 1e3 / (done / 1e3)
