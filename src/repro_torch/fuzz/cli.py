"""``python -m repro_torch fuzz``: the batched differential fuzzing fleet
on the port.

Examples::

    python -m repro_torch fuzz --kernels all --memories 2048
    python -m repro_torch fuzz --kernels gsm,fir4 --device cpu --json
    python -m repro_torch fuzz --kernels gsm --memories 4096 --shrink

Each (kernel, arch) pair runs its shipped artifact over a deterministic
seeded corpus in batched PE-array runs, checked against the vectorized
oracle, with its switching activity and energy delta.  ``--shrink`` turns
mismatches into single-memory reproducer JSONs under ``--failures-dir``.
The JSON digest has the fields of ``python -m repro fuzz --json``;
``backend`` is ``cuda`` on the card and ``ref`` on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from ..cgra.artifact import artifact_names
from .corpus import STRATEGIES
from .engine import FuzzReport, fuzz_kernel


def _resolve_kernels(spec: str, arch: str) -> List[str]:
    shipped = artifact_names(arch)
    if spec == "all":
        return shipped
    names = [k.strip() for k in spec.split(",") if k.strip()]
    unknown = [k for k in names if k not in shipped]
    if unknown:
        raise SystemExit(f"no artifact on {arch} for: {', '.join(unknown)} "
                         f"(shipped: {', '.join(shipped)})")
    return names


def _print_human(rep: FuzzReport) -> None:
    verdict = "ok" if rep.ok else f"MISMATCH ({len(rep.failing)} memories)"
    print(f"{rep.kernel} @ {rep.arch}: {verdict}  II={rep.ii}  "
          f"{rep.memories} memories @ {rep.mem_rate:.0f} mem/s "
          f"(batch {rep.batch}, {rep.backend})")
    if rep.energy:
        e = rep.energy
        print(f"  dynamic energy: static {e['static_dynamic_nj']} nJ -> "
              f"empirical {e['empirical_dynamic_nj']} nJ "
              f"({e['delta_pct']:+.1f}%)")
    for line in rep.mismatches[:4]:
        print(f"  {line}")
    if rep.divergence:
        d = rep.divergence
        print(f"  first divergence: cycle {d['cycle']}, PE {d['pe']}, "
              f"node {d['node']} (iteration {d['iteration']})")
    if rep.reproducer:
        print(f"  reproducer: {rep.reproducer}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch fuzz",
        description="batched differential fuzzing of mapped-kernel "
                    "artifacts")
    ap.add_argument("--kernels", default="all",
                    help="comma-separated kernels, or 'all' shipped for "
                         "the arch (default)")
    ap.add_argument("--arch", default="4x4",
                    help="comma-separated artifact archs (default 4x4)")
    ap.add_argument("--memories", type=int, default=1024,
                    help="corpus size per (kernel, arch) (default 1024)")
    ap.add_argument("--batch", type=int, default=1024,
                    help="memories per PE-array run (default 1024)")
    ap.add_argument("--seed", type=int, default=0,
                    help="corpus base seed (default 0)")
    ap.add_argument("--strategies", default=None,
                    help=f"comma-separated corpus strategies "
                         f"(default: all of {','.join(STRATEGIES)})")
    ap.add_argument("--shrink", action="store_true",
                    help="on mismatch: bisect to one memory, replay the "
                         "divergence, write a reproducer JSON")
    ap.add_argument("--failures-dir", default="results/fuzz_failures",
                    help="where --shrink writes reproducers")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the kernel (default); cpu the plain "
                         "PyTorch version")
    ap.add_argument("--json", action="store_true",
                    help="print the JSON digest instead of a summary")
    ap.add_argument("--out", default=None, help="also write the digest here")
    args = ap.parse_args(argv)

    archs = [a.strip() for a in args.arch.split(",") if a.strip()]
    strategies = (tuple(s.strip() for s in args.strategies.split(","))
                  if args.strategies else None)
    plan = [(arch, name) for arch in archs
            for name in _resolve_kernels(args.kernels, arch)]

    reports: List[FuzzReport] = []
    for arch, name in plan:
        rep = fuzz_kernel(name, arch=arch, memories=args.memories,
                          batch=args.batch, seed=args.seed,
                          shrink=args.shrink,
                          failures_dir=args.failures_dir,
                          strategies=strategies, device=args.device)
        reports.append(rep)
        if not args.json:
            _print_human(rep)

    doc = {
        "bench": "fuzz",
        "archs": archs,
        "kernels": list(dict.fromkeys(name for _, name in plan)),
        "memories": args.memories,
        "batch": args.batch,
        "backend": "cuda" if args.device == "cuda" else "ref",
        "seed": args.seed,
        "results": [r.to_dict() for r in reports],
        "mismatches": sum(1 for r in reports if r.status == "mismatch"),
        "errors": sum(1 for r in reports if r.status == "error"),
        "unmapped": 0,      # artifacts are mapped ahead of time
    }
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
    if args.json:
        print(json.dumps(doc, indent=1, sort_keys=True))
    bad = doc["mismatches"] + doc["errors"]
    if bad and not args.json:
        print(f"{bad}/{len(reports)} (kernel, arch) pairs failed")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
