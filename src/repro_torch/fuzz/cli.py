"""``python -m repro_torch fuzz``: the batched differential fuzzing fleet
on the port.

Examples::

    python -m repro_torch fuzz --kernels all --memories 2048
    python -m repro_torch fuzz --kernels gsm,fir4 --device cpu --json
    python -m repro_torch fuzz --kernels gsm --memories 4096 --shrink
    python -m repro_torch fuzz --kernels gsm_f160,stencil3_f160 \
        --memories 16384 --batch 16384

A copy of ``src/repro/fuzz/cli.py``.  Each (kernel, arch) pair is mapped
through the port's :class:`~repro_torch.toolchain.session.Toolchain`,
fuzzed over a deterministic seeded corpus in batched PE-array runs,
checked against the vectorized oracle, with its switching activity and
energy delta.  A kernel of a port-only suite (``gsm_f160``: one GSM 06.10
frame, 160 iterations) is fuzzed on images of its own size (512 words).
``--shrink`` turns mismatches into single-memory reproducer JSONs under
``--failures-dir``.  The JSON digest has the fields
of ``python -m repro fuzz --json``; ``backend`` is ``cuda`` on the card
and ``ref`` on the CPU.  ``--cache-dir`` reads and writes the
content-addressed mapping cache, which both packages share.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from .corpus import STRATEGIES
from .engine import FuzzReport, fuzz_kernel


def _resolve_kernels(spec: str) -> List[str]:
    """``all`` (the default suite) or registry names of any suite."""
    from ..cgra.registry import is_registered, kernel_names

    if spec == "all":
        return kernel_names()
    names = [k.strip() for k in spec.split(",") if k.strip()]
    unknown = [k for k in names if not is_registered(k)]
    if unknown:
        raise SystemExit(f"unknown kernel(s): {', '.join(unknown)} "
                         f"(registered: {', '.join(kernel_names())})")
    return names


def _print_human(rep: FuzzReport) -> None:
    head = f"{rep.kernel} @ {rep.arch}"
    if rep.status in ("unmapped", "timeout", "error"):
        why = f" — {rep.error}" if rep.error else ""
        print(f"{head}: {rep.status}{why}")
        return
    verdict = "ok" if rep.ok else f"MISMATCH ({len(rep.failing)} memories)"
    print(f"{head}: {verdict}  II={rep.ii}  {rep.memories} memories "
          f"@ {rep.mem_rate:.0f} mem/s (batch {rep.batch}, {rep.backend})")
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
        description="batched differential fuzzing of mapped kernels")
    ap.add_argument("--kernels", default="all",
                    help="comma-separated registry kernels of any suite "
                         "(gsm_f160), or 'all' of the default suite "
                         "(default)")
    ap.add_argument("--arch", default="4x4",
                    help="comma-separated architecture specs/presets "
                         "(default 4x4)")
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
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="total mapping budget per kernel in seconds "
                         "(default 120)")
    ap.add_argument("--ii-max", type=int, default=32)
    ap.add_argument("--cache-dir", default=None,
                    help="content-addressed mapping cache")
    ap.add_argument("--strict", action="store_true",
                    help="also exit non-zero on unmapped/timed-out kernels "
                         "(default: only mismatches and engine errors fail "
                         "the fleet)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the kernel (default); cpu the plain "
                         "PyTorch version")
    ap.add_argument("--json", action="store_true",
                    help="print the JSON digest instead of a summary")
    ap.add_argument("--out", default=None, help="also write the digest here")
    args = ap.parse_args(argv)

    from ..core.mapper import MapperConfig

    kernels = _resolve_kernels(args.kernels)
    archs = [a.strip() for a in args.arch.split(",") if a.strip()]
    cfg = MapperConfig(per_ii_timeout_s=args.timeout / 2,
                       total_timeout_s=args.timeout, ii_max=args.ii_max)
    strategies = (tuple(s.strip() for s in args.strategies.split(","))
                  if args.strategies else None)

    reports: List[FuzzReport] = []
    for arch in archs:
        for name in kernels:
            rep = fuzz_kernel(name, arch=arch, memories=args.memories,
                              batch=args.batch, seed=args.seed,
                              shrink=args.shrink, config=cfg,
                              cache=args.cache_dir,
                              failures_dir=args.failures_dir,
                              strategies=strategies, device=args.device)
            reports.append(rep)
            if not args.json:
                _print_human(rep)

    doc = {
        "bench": "fuzz",
        "archs": archs,
        "kernels": kernels,
        "memories": args.memories,
        "batch": args.batch,
        "backend": "cuda" if args.device == "cuda" else "ref",
        "seed": args.seed,
        "results": [r.to_dict() for r in reports],
        "mismatches": sum(1 for r in reports if r.status == "mismatch"),
        "errors": sum(1 for r in reports if r.status == "error"),
        "unmapped": sum(1 for r in reports
                        if r.status in ("unmapped", "timeout")),
    }
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
    if args.json:
        print(json.dumps(doc, indent=1, sort_keys=True))
    if doc["unmapped"] and not args.json:
        gaps = [f"{r.kernel}@{r.arch}" for r in reports
                if r.status in ("unmapped", "timeout")]
        print(f"NOTE coverage gaps (not fuzzed, mapping budget): "
              f"{', '.join(gaps)}")
    bad = doc["mismatches"] + doc["errors"]
    if args.strict:
        bad += doc["unmapped"]
    if bad and not args.json:
        print(f"{bad}/{len(reports)} (kernel, arch) pairs failed")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
