"""unattributed_ms_per_kmem: the window's seconds outside every phase the
program times (the client's loop, building the reports, the final sync),
in ms per 1000 memories: the window less the summed execution, oracle,
compare and activity times.  With those four readings it adds up to
10**6 / mem_per_s of the same window.  None where the program reports no
compare or activity time."""

PHASES = ("exec_time_s", "oracle_time_s", "compare_time_s",
          "activity_time_s")


def read(win):
    reports = [c.report for c in win.calls if c.report is not None]
    done = sum(int(r.memories) for r in reports)
    if not done or any(getattr(r, k, None) is None
                       for r in reports for k in PHASES):
        return None
    inside = sum(getattr(r, k) for r in reports for k in PHASES)
    return (win.window_s - inside) * 1e3 / (done / 1e3)
