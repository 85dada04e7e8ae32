"""harvest_ms_per_kmem: the profiled device time of every launch of the
activity harvest's kernel (a device op whose name holds
``harvest_kernel``) in the window, summed, in ms per 1000 memories brought
to a verdict.  The program harvests each chunk in one launch, so the
launches are matched with the chunks the window's calls sent: where their
counts differ (a program without the kernel has none), or no call
answered, there is nothing to read."""
KERNEL = "harvest_kernel"


def read(win):
    if win.trace is None or any(c.report is None for c in win.calls):
        return None
    sent = sum(len(c.launches) for c in win.calls)
    ran = [seconds for name, _, seconds in win.trace.ops if KERNEL in name]
    done = sum(int(c.report.memories) for c in win.calls)
    if not done or len(ran) != sent:
        return None
    return sum(ran) * 1e3 / (done / 1e3)
