"""pe_array_ms_per_kmem: the profiled device time of every launch of the
PE-array kernels in the window (``roofline.PE_ARRAY_KERNELS``), summed, in
ms per 1000 memories brought to a verdict.  As for the roofline shares,
the launches are matched with the chunks the window's calls sent: where
their counts differ, or no call answered, there is nothing to read."""
from portbench.harness.roofline import PE_ARRAY_KERNELS


def read(win):
    if win.trace is None or any(c.report is None for c in win.calls):
        return None
    sent = sum(len(c.launches) for c in win.calls)
    ran = [seconds for name, _, seconds in win.trace.ops
           if any(k in name for k in PE_ARRAY_KERNELS)]
    done = sum(int(c.report.memories) for c in win.calls)
    if not done or len(ran) != sent:
        return None
    return sum(ran) * 1e3 / (done / 1e3)
