"""``python -m repro_torch sweep`` — run a design-space sweep from the shell.

Smoke mode (CI): 4 kernels × 3 grid sizes on the dependency-free CDCL
backend, run **twice** against the same cache — the second pass must be
all cache hits and must reproduce the first pass's Pareto sections
byte-for-byte (``repeat_check`` in the emitted JSON records both).

A copy of ``src/repro/dse/cli.py`` with other default outputs.  The JAX
package's smoke artifact, ``results/BENCH_dse.json`` (and its ``.md``),
is the committed baseline that the port's smoke sweep is held to, so the
port never writes it: its smoke default is ``results/torch/BENCH_dse.json``
and its full-sweep default ``results/torch/dse.json``, each with a markdown
Pareto table next to it.  The mapping cache default,
``results/dse_cache``, is shared with the JAX package (one layout).

Full sweeps journal every completed point next to the output file
(``.sweep_journal.jsonl``); a killed sweep picks up where it left off
with ``--resume``.  ``--chaos '{"seed":1,"rate":0.2}'`` arms the
deterministic fault-injection harness (:mod:`repro_torch.toolchain.chaos`)
for the whole run — the nightly chaos CI lane drives exactly this path.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from ..toolchain import chaos
from .report import markdown_report
from .space import (DEFAULT_KERNELS, DEFAULT_SIZES, SMOKE_KERNELS,
                    SMOKE_SIZES, parse_sizes)
from .sweep import SweepConfig, run_sweep

# never the JAX package's committed baseline (results/BENCH_dse.json),
# which the port's smoke is compared against
SMOKE_OUT = "results/torch/BENCH_dse.json"
DEFAULT_OUT = "results/torch/dse.json"


def pareto_bytes(doc: dict) -> bytes:
    """Canonical serialization of the Pareto sections (the byte-identity
    contract of the CI gate — excludes wall times and cache counters)."""
    stable = {
        "pareto": doc["pareto"],
        "fronts": [{k: row.get(k) for k in
                    ("kernel", "size", "status", "ii", "utilization",
                     "latency_cycles", "energy_nj")}
                   for row in doc["points"]],
    }
    return json.dumps(stable, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def run_smoke(out: str = SMOKE_OUT, jobs: Optional[int] = None,
              cache_dir: str = "results/dse_cache") -> dict:
    """The CI lane: sweep twice, assert cache reuse + determinism."""
    cfg = SweepConfig(kernels=SMOKE_KERNELS, sizes=SMOKE_SIZES,
                      backend="cdcl", per_point_timeout_s=30.0,
                      per_ii_timeout_s=10.0, jobs=jobs,
                      cache_dir=cache_dir)
    first = run_sweep(cfg)
    second = run_sweep(cfg)
    identical = pareto_bytes(first) == pareto_bytes(second)
    second["repeat_check"] = {
        "cache_hits_second_run": second["cache"]["hits"],
        "pareto_identical": identical,
        "first_run_wall_s": first["wall_time_s"],
    }
    _emit(second, out)
    if not identical:
        raise AssertionError("repeated sweep changed the Pareto sections")
    if second["cache"]["hits"] == 0:
        raise AssertionError("repeated sweep did not hit the mapping cache")
    return second


def _emit(doc: dict, out: str) -> None:
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
    md = os.path.splitext(out)[0] + ".md"
    with open(md, "w") as fh:
        fh.write(markdown_report(doc))
    for row in doc["points"]:
        print("BENCH", json.dumps(dict(row, bench="dse")), flush=True)
    print("BENCH", json.dumps({
        "bench": "dse", "summary": doc["pareto"]["summary"],
        "cache": doc["cache"], "errors": doc["errors"],
        "wall_time_s": doc["wall_time_s"]}), flush=True)
    print(f"wrote {out} and {md}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch sweep",
        description="Design-space exploration sweep (kernels x CGRA sizes)")
    ap.add_argument("--smoke", action="store_true",
                    help="CI subset + repeated-run cache/determinism check")
    ap.add_argument("--kernels", default=None,
                    help="comma-separated kernel names "
                         f"(default: {','.join(DEFAULT_KERNELS)})")
    ap.add_argument("--sizes", default=None,
                    help="comma-separated grid sizes, e.g. 2x2,3x3,4x4")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "cdcl", "z3"])
    ap.add_argument("--strategy", default=None,
                    help="solver strategy or portfolio spec "
                         "(e.g. cdcl-seq, portfolio:cdcl-seq+cdcl-pair,"
                         "spec_ii=2, portfolio:auto); mutually exclusive "
                         "with a non-default --backend")
    ap.add_argument("--share-facts", action="store_true",
                    help="lift CEGAR blocking clauses and UNSAT-at-II "
                         "facts across design points within this sweep")
    ap.add_argument("--jobs", type=int, default=None,
                    help="worker processes (default: os.cpu_count())")
    ap.add_argument("--timeout", type=float, default=60.0,
                    help="per-point mapping budget in seconds")
    ap.add_argument("--out", default=None,
                    help=f"output JSON (default: {DEFAULT_OUT}; "
                         f"--smoke: {SMOKE_OUT})")
    ap.add_argument("--cache-dir", default="results/dse_cache")
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="replay completed points from the sweep journal "
                         "and run only the remainder")
    ap.add_argument("--journal", default=None,
                    help="journal path (default: .sweep_journal.jsonl "
                         "next to --out)")
    ap.add_argument("--no-journal", action="store_true",
                    help="disable the crash-resume journal")
    ap.add_argument("--chaos", default=None, metavar="JSON",
                    help="arm the deterministic fault-injection harness, "
                         'e.g. \'{"seed":1,"rate":0.2}\'')
    args = ap.parse_args(argv)

    if args.chaos is not None:
        try:
            spec = chaos.ChaosSpec.from_json(args.chaos)
        except (ValueError, TypeError) as e:
            ap.error(f"--chaos: {e}")
        os.environ[chaos.ENV_KEY] = spec.to_json()

    cache_dir = None if args.no_cache else args.cache_dir
    if args.smoke:
        if args.no_cache:
            ap.error("--smoke needs the cache (its repeated run asserts "
                     "cache hits); drop --no-cache")
        if args.resume:
            ap.error("--smoke runs are journal-free; drop --resume")
        doc = run_smoke(out=args.out or SMOKE_OUT, jobs=args.jobs,
                        cache_dir=cache_dir)
        return 1 if doc["errors"] else 0

    out = args.out or DEFAULT_OUT
    if args.no_journal:
        journal_path = None
    elif args.journal is not None:
        journal_path = args.journal
    else:
        journal_path = os.path.join(os.path.dirname(out) or ".",
                                    ".sweep_journal.jsonl")
    cfg = SweepConfig(
        kernels=(args.kernels.split(",") if args.kernels
                 else DEFAULT_KERNELS),
        sizes=parse_sizes(args.sizes) if args.sizes else DEFAULT_SIZES,
        backend=args.backend, strategy=args.strategy,
        share_facts=args.share_facts, per_point_timeout_s=args.timeout,
        jobs=args.jobs, cache_dir=cache_dir, journal_path=journal_path)
    doc = run_sweep(cfg, resume=args.resume)
    _emit(doc, out)
    return 1 if doc["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
