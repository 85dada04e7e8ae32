"""The least time the card could take for one launch of the PE-array
kernels, and the peaks it is counted against.

Copied from ``chip_smoke.py`` (``state_bytes``, ``program_bytes``,
``program_ops``, ``bound``), counted here from a frozen artifact's words
so that the count is of the work and not of whatever implements it.
Peaks: NVIDIA H100 SXM data sheet at 700 W.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM HBM3
INT32_OPS_PER_S = 132 * 64 * 1.98e9       # 132 SMs x 64 INT32 lanes x 1.98 GHz
#: two source selects, the ALU op, the address and its clamp, two flags,
#: the OUT write (the note of the port's csrc/pe_array.cu)
INT_OPS_PER_PE_CYCLE = 8
#: the kernels one launch of the port's run_cycles takes
PE_ARRAY_KERNELS = ("run_lanes_kernel", "run_cycles_kernel")


def shape(doc: Dict) -> Tuple[int, int, int]:
    """(T rows, P PEs, non-NOP cells) of an artifact's program."""
    words = np.asarray(doc["words"], np.int64)
    live = int((((words >> 27) & 0x1F) != 0).sum())
    return words.shape[0], words.shape[1], live


def launch_bytes(T: int, B: int, P: int, M: int) -> int:
    """The state read and written once, the (T, B, P) trace written once,
    the five (T, P) instruction fields read once."""
    return 2 * 4 * B * (7 * P + M) + 4 * T * B * P + 20 * T * P


def launch_ops(live: int, B: int) -> int:
    """int32 operations: ``INT_OPS_PER_PE_CYCLE`` for every non-NOP cell of
    the program, for each of the B memories."""
    return INT_OPS_PER_PE_CYCLE * live * B


def bound_s(T: int, B: int, P: int, M: int, live: int) -> float:
    """The larger of the bytes over the HBM rate and the operations over
    the INT32 rate, in seconds."""
    return max(launch_bytes(T, B, P, M) / HBM_BYTES_PER_S,
               launch_ops(live, B) / INT32_OPS_PER_S)


def share(win, kernel: str) -> Optional[float]:
    """Percent of the least time in the device time of every profiled
    launch of ``kernel`` (a substring of its name) in the window.  The
    launches of the PE-array kernels in the trace are matched in order
    with the chunks the window's calls sent; where their counts differ, or
    no launch took ``kernel``, there is nothing to read."""
    if win.trace is None or any(c.report is None for c in win.calls):
        return None
    sent = [(c.doc, B, c.memories.shape[1]) for c in win.calls
            for B in c.launches]
    ran = [(name, seconds) for name, _, seconds in win.trace.ops
           if any(k in name for k in PE_ARRAY_KERNELS)]
    if len(ran) != len(sent):
        return None
    least = spent = 0.0
    for (name, seconds), (doc, B, M) in zip(ran, sent):
        if kernel in name:
            T, P, live = shape(doc)
            least += bound_s(T, B, P, M, live)
            spent += seconds
    return 100.0 * least / spent if spent > 0 else None
