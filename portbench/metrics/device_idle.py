"""device_idle: percent of the profiled window in which no kernel and no
copy ran on the card."""


def read(win):
    if win.trace is None or win.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - win.trace.busy_s / win.trace.window_s)
