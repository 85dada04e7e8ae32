"""mem_per_s: memories brought to a verdict in the window (executed on the
card, checked against the oracle, activity harvested), over the window's
seconds on the host clock: all the work over all the time."""


def read(win):
    done = sum(int(c.report.memories) for c in win.calls
               if c.report is not None)
    return done / win.window_s if done else None
