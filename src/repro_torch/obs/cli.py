"""``repro_torch trace`` — analyze recorded traces.

Verbs:

- ``repro_torch trace report TRACE [--json] [--min-attribution F]`` —
  per-compile critical-path breakdown and per-sweep aggregate
  attribution table ("where did the time go").
- ``repro_torch trace export TRACE --chrome [-o OUT]`` — Chrome trace-event
  JSON, viewable in Perfetto (ui.perfetto.dev) or ``chrome://tracing``.
- ``repro_torch trace check TRACE [--min-attribution F]`` — schema + tree
  validation; exit 1 on problems or attribution below the floor (CI).

``TRACE`` is a trace directory of ``shard-*.jsonl`` files (as produced
by ``REPRO_TRACE=dir`` or ``repro_torch map --trace dir``) or a single merged
JSONL file.

A copy of ``src/repro/obs/cli.py``, run as ``python -m repro_torch trace``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from . import report as rpt


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m repro_torch trace", description=__doc__)
    sub = p.add_subparsers(dest="verb", required=True)

    rp = sub.add_parser("report", help="critical-path + attribution report")
    rp.add_argument("trace", help="trace directory or JSONL file")
    rp.add_argument("--json", action="store_true", help="machine-readable output")
    rp.add_argument("--min-attribution", type=float, default=None, metavar="F",
                    help="also print a PASS/FAIL gate at this fraction")

    ex = sub.add_parser("export", help="export to an external viewer format")
    ex.add_argument("trace", help="trace directory or JSONL file")
    ex.add_argument("--chrome", action="store_true",
                    help="Chrome trace-event JSON (Perfetto-viewable)")
    ex.add_argument("-o", "--out", default=None, help="output path (default stdout)")

    ck = sub.add_parser("check", help="validate schema and span-tree shape")
    ck.add_argument("trace", help="trace directory or JSONL file")
    ck.add_argument("--min-attribution", type=float, default=None, metavar="F",
                    help="fail unless attributed fraction >= F (e.g. 0.95)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        records = rpt.load(args.trace)
    except OSError as e:
        print(f"cannot read trace {args.trace}: {e}", file=sys.stderr)
        return 1
    if not records:
        print(f"no trace records found in {args.trace}", file=sys.stderr)
        return 1

    if args.verb == "report":
        if args.json:
            doc = rpt.attribution(records)
            print(json.dumps(doc, indent=1, sort_keys=True))
        else:
            print(rpt.render_report(records, min_attribution=args.min_attribution))
        return 0

    if args.verb == "export":
        if not args.chrome:
            print("export: specify a format (--chrome)", file=sys.stderr)
            return 2
        doc = rpt.to_chrome(records)
        payload = json.dumps(doc)
        if args.out:
            with open(args.out, "w", encoding="utf-8") as fh:
                fh.write(payload)
            print(f"wrote {len(doc['traceEvents'])} events -> {args.out}")
        else:
            print(payload)
        return 0

    # check
    problems = rpt.validate(records)
    for prob in problems:
        print(f"INVALID: {prob}", file=sys.stderr)
    att = rpt.attribution(records)
    print(
        f"trace ok: {att['spans']} spans, {att['events']} events, "
        f"{att['pids']} process(es), attributed {att['attributed'] * 100:.1f}%"
        if not problems
        else f"{len(problems)} problem(s)"
    )
    if problems:
        return 1
    if args.min_attribution is not None and att["attributed"] < args.min_attribution:
        print(
            f"attribution {att['attributed']:.4f} below floor "
            f"{args.min_attribution:.4f}",
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
