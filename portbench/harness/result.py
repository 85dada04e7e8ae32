"""One run of a cell from set-up to its result line."""
from __future__ import annotations

import subprocess
import sys
from typing import Dict, Optional, Tuple

from . import check, spec, window

#: top-level module names that may not be loaded when the result prints
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded top-level modules of ``FORBIDDEN``, compared whole (the
    port's ``repro_torch`` begins with ``repro`` and is not one)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def _device(device: str, chips: int) -> Dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips)),
            "power_limit": _power_limit()}


def run_once(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None
             ) -> Tuple[Dict, Dict[str, Tuple[int, int]]]:
    """(result line, {number: (value, limit)}) of one run."""
    win = window.run(cell, seed, seconds, trace, device, t_start)
    dev = _device(device, cell.chips)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = spec.reader(cell.root, m["name"])(win)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    if trace and win.trace is not None:
        dev["busy_s"] = win.trace.busy_s
        dev["window_s"] = win.trace.window_s
    numbers = check.judge(win)
    line = {
        "correct": check.correct(numbers),
        "attempted": len(win.calls),
        "failed": numbers["failed_calls"][0],
        "metrics": metrics,
        "device": dev,
        "passes": win.passes,
        "window_s": win.window_s,
        "pass_s": win.pass_s,
    }
    if trace and win.trace is not None:
        line["breakdown"] = win.trace.breakdown
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in numbers.items()}
    return line, numbers
