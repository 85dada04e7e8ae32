"""exec_ms_per_kmem: the program's own execution timer
(``FuzzReport.exec_time_s``: ``execute_asm`` on the host, the launch, the
trace gathers and the copies back) summed over the window, in ms per 1000
memories."""


def read(win):
    reports = [c.report for c in win.calls if c.report is not None]
    done = sum(int(r.memories) for r in reports)
    if not done:
        return None
    return sum(r.exec_time_s for r in reports) * 1e3 / (done / 1e3)
