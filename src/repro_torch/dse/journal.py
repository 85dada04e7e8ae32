"""Crash-resumable sweep journal (``.sweep_journal.jsonl`` next to the output).

A 20-minute arch-DSE sweep that dies at point 180/200 — OOM-killed
runner, dropped SSH session, chaos-injected ``kill -9`` — used to start
over from zero.  The journal makes the sweep an append-only log instead:
the first line is a header binding the file to one *sweep signature*
(kernels, sizes, backend, budgets — everything that determines row
content), and every completed point appends one self-contained JSON row,
flushed and fsynced before the sweep moves on.  ``python -m repro_torch sweep
--resume`` replays matching rows and re-runs only the remainder; the
correctness projection of the resumed document is byte-identical to a
single uninterrupted run (the chaos CI lane asserts exactly this).

Torn tails are expected — a kill can land mid-append — so the loader
simply ignores any line that does not parse; the half-written point is
re-run.  A signature mismatch (different kernels/sizes/config) ignores
the whole file rather than resuming someone else's sweep.

A copy of ``src/repro/dse/journal.py``: one journal format for both
packages.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

SCHEMA = 1

PointId = Tuple[str, str]  # (kernel, size-or-arch label)


class SweepJournal:
    def __init__(self, path: str):
        self.path = path
        self._fh = None

    # -- reading -----------------------------------------------------------

    def load(self, signature: Dict) -> Dict[PointId, Dict]:
        """Completed rows from a journal whose header matches
        ``signature``; ``{}`` when absent, mismatched or unreadable."""
        try:
            with open(self.path) as fh:
                lines = fh.read().splitlines()
        except OSError:
            return {}
        if not lines:
            return {}
        try:
            header = json.loads(lines[0])
        except ValueError:
            return {}
        if (header.get("sweep_journal") != SCHEMA
                or header.get("signature") != signature):
            return {}
        rows: Dict[PointId, Dict] = {}
        for line in lines[1:]:
            try:
                entry = json.loads(line)
                point = (entry["kernel"], entry["size"])
                row = entry["row"]
            except (ValueError, KeyError, TypeError):
                continue  # torn tail from a mid-append kill: re-run it
            rows[point] = row  # duplicates: last write wins
        return rows

    # -- writing -----------------------------------------------------------

    def start(self, signature: Dict, resume: bool = False,
              ) -> Dict[PointId, Dict]:
        """Open for appending and return the rows already done.

        ``resume=True`` keeps a matching journal and appends to it;
        otherwise (or on mismatch) the file is rewritten with a fresh
        header.  Returns the replayable rows (empty unless resuming)."""
        done = self.load(signature) if resume else {}
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        if done:
            self._fh = open(self.path, "a")
        else:
            self._fh = open(self.path, "w")
            self._append({"sweep_journal": SCHEMA, "signature": signature})
        return done

    def record(self, kernel: str, size: str, row: Dict) -> None:
        """Durably append one completed point (flush + fsync: the row
        must survive a ``kill -9`` that lands right after)."""
        if self._fh is None:
            raise RuntimeError("journal not started")
        self._append({"kernel": kernel, "size": size, "row": row})

    def _append(self, entry: Dict) -> None:
        self._fh.write(json.dumps(entry, sort_keys=True,
                                  separators=(",", ":")) + "\n")
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "SweepJournal":
        return self

    def __exit__(self, *exc) -> Optional[bool]:
        self.close()
        return None
