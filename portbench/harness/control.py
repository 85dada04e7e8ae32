"""The control of the check: the plain reference put in the program's
place with its arithmetic rounded through float32, which breaks the
configurations' guarantee of bit-exact int32 results.  A sound check
calls every run of it incorrect.

    python3 -m portbench.harness.control --workload fuzz-4x4-b16384 \\
        --seeds 11,12,13

runs one whole pass of the cell's traffic per seed at the cell's own
sizes, with the control answering every call, judges it as a run is
judged, and prints one JSON line per seed.  It needs no card.
"""
from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

from . import check, reference, window
from .spec import ROOT, Cell, load_cell


@dataclass
class ControlReport:
    """The fields of the program's report that the check reads."""

    memories: int
    failing: List[int]
    activity: Dict
    status: str


def answer(doc: Dict, mems) -> ControlReport:
    got = reference.fuzz_verdicts(doc, mems, "float32")
    return ControlReport(memories=len(mems), failing=got.failing,
                         activity=got.activity,
                         status="mismatch" if got.failing else "ok")


class ControlClient(window._Client):
    """A client whose every call the control answers; it loads nothing of
    the program."""

    def __init__(self, cell: Cell, pool, device: str):
        self.cell, self.pool, self.device = cell, pool, device
        self.batch = int(cell.traffic["batch"])

    def fuzz(self, i: int, mems) -> ControlReport:
        return answer(self.cell.docs[i], mems)

    def warm(self) -> None:
        pass


def run_control(cell: Cell, seed: int) -> Dict:
    win = window.run(cell, seed, 0.0, False, "cpu", client=ControlClient)
    numbers = check.judge(win)
    return {"workload": cell.name, "seed": seed,
            "correct": check.correct(numbers), "calls": len(win.calls),
            "numbers": {k: v for k, (v, _) in numbers.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the check's control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload, Path(ROOT))
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(run_control(cell, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
