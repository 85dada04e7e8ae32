"""run_cycles_roofline: percent of the least time (``harness/roofline.py``)
in the profiled device time of every ``run_cycles_kernel`` launch of the
window."""
from portbench.harness.roofline import share


def read(win):
    return share(win, "run_cycles_kernel")
