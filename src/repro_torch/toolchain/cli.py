"""``python -m repro_torch map``: compile one registry kernel end to end;
``python -m repro_torch list``: name the registered kernels;
``python -m repro_torch arch {list,show}``: architecture presets and specs.

Counterparts of the ``map``, ``list`` and ``arch`` verbs of
``src/repro/toolchain/cli.py``::

    python -m repro_torch map gsm --grid 2x2 --json
    python -m repro_torch map dotprod --arch bordermem-4x4 --no-oracle
    python -m repro_torch map fir4 --strategy portfolio:cdcl-seq+cdcl-pair \
        --jobs 4 --cache-dir build/mapping_cache
    python -m repro_torch list --origin traced
    python -m repro_torch arch list
    python -m repro_torch arch show mesh-4x4:mem=col0,regs=8,ports=1/row

It runs a :class:`~repro_torch.toolchain.session.Toolchain` compile
(source -> map -> assemble -> metrics) and prints a human summary or the
JSON digest of ``python -m repro map --json``.  ``--strategy`` races a
portfolio (on ``--jobs`` worker processes), and ``--cache-dir`` reads and
writes the content-addressed mapping cache that both packages share.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

from ..core.mapper import MapperConfig
from .session import Toolchain


def _print_human(cr) -> None:
    where = cr.arch or cr.size
    if cr.ok:
        m = cr.metrics
        hit = " (cache hit)" if cr.cache_hit else ""
        race = (f" winner={cr.map_result.winner} "
                f"raced={cr.map_result.strategies_raced}"
                if cr.map_result.strategies_raced else "")
        print(f"{cr.kernel} @ {where}: II={cr.ii} (mII={cr.mii}) "
              f"backend={cr.map_result.backend} "
              f"cegar={cr.map_result.cegar_rounds}{race}")
        print(f"  cycles={m.cycles} energy={m.energy_nj:.2f}nJ "
              f"utilization={m.utilization:.3f} "
              f"map_time={cr.map_time_s:.2f}s{hit}")
    else:
        why = f" — {cr.error}" if cr.error else ""
        print(f"{cr.kernel} @ {where}: {cr.status} at stage {cr.stage!r}{why}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch map",
        description="compile one kernel to metrics")
    ap.add_argument("kernel", help="registered kernel name")
    ap.add_argument("--grid", default="4x4", help="CGRA size (default 4x4)")
    ap.add_argument("--arch", default=None,
                    help="architecture spec or preset (overrides --grid)")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "cdcl", "z3"])
    ap.add_argument("--strategy", default=None,
                    help="solver strategy or portfolio spec: a name like "
                         "cdcl-seq / z3-atmost, or "
                         "portfolio:cdcl-seq+z3-atmost,spec_ii=2, or "
                         "portfolio:auto; mutually exclusive with a "
                         "non-default --backend")
    ap.add_argument("--jobs", type=int, default=None,
                    help="worker processes for a portfolio race "
                         "(default: cpu count; 1 = in-process race)")
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="total mapping budget in seconds (default 120)")
    ap.add_argument("--ii-max", type=int, default=32)
    ap.add_argument("--json", action="store_true",
                    help="print the JSON digest instead of a summary")
    ap.add_argument("--out", default=None, help="also write the digest here")
    ap.add_argument("--cache-dir", default=None,
                    help="reuse a content-addressed mapping cache")
    ap.add_argument("--no-oracle", action="store_true",
                    help="disable the assembler CEGAR oracle")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="record a trace of the compile into DIR")
    args = ap.parse_args(argv)

    cfg = MapperConfig(backend=args.backend,
                       per_ii_timeout_s=args.timeout / 2,
                       total_timeout_s=args.timeout, ii_max=args.ii_max,
                       strategy=args.strategy)
    if args.trace:
        from ..obs import trace as obs_trace

        obs_trace.enable(args.trace)
    oracle = None if args.no_oracle else "assembler"
    tc = Toolchain(args.arch or args.grid, cfg, cache=args.cache_dir,
                   oracle=oracle)
    t0 = time.monotonic()
    cr = tc.compile(args.kernel, jobs=args.jobs)
    doc = cr.summary()
    doc["bench"] = "toolchain_map"
    doc["oracle"] = tc.oracle_tag
    doc["wall_time_s"] = round(time.monotonic() - t0, 4)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
    if args.json:
        print(json.dumps(doc, indent=1, sort_keys=True))
    else:
        _print_human(cr)
    return 0 if cr.ok else 1


def list_main(argv: Optional[List[str]] = None) -> int:
    """The registered kernels in registration order, one per line with its
    origin, then their count."""
    from ..cgra.registry import ORIGINS, get_kernel, kernel_names

    ap = argparse.ArgumentParser(prog="python -m repro_torch list",
                                 description="list registered kernels")
    ap.add_argument("--origin", default=None, choices=ORIGINS)
    args = ap.parse_args(argv)
    names = kernel_names(origin=args.origin)
    for name in names:
        spec = get_kernel(name)
        print(f"{name:16s} {spec.origin}")
    print(f"{len(names)} kernels")
    return 0



def _cmd_arch_list(args) -> int:
    from ..archspec import PRESETS

    print("presets:")
    for name in sorted(PRESETS):
        spec = PRESETS[name]
        print(f"  {name:16s} {spec.to_compact()}")
    print()
    print("spec grammar: TOPOLOGY-RxC[:mem=SEL,mul=SEL,regs=N,ports=K/SCOPE]")
    print("  topologies: torus mesh diagonal one-hop")
    print("  selectors:  all none colK rowK border peA.B.C (+-unions)")
    print("  scopes:     col row global")
    print("  example:    mesh-4x4:mem=col0,regs=8,ports=1/row")
    return 0


def _cmd_arch_show(args) -> int:
    from ..archspec import parse_arch

    spec = parse_arch(args.spec)
    grid = spec.grid()
    print(f"{spec.label()}  ({spec.to_compact()})")
    print(f"  geometry:   {spec.rows}x{spec.cols} ({spec.num_pes} PEs), "
          f"{spec.num_regs} regs/PE")
    print(f"  topology:   {spec.topology} "
          f"(vertex-transitive: {grid.is_vertex_transitive()}, "
          f"assemblable: {spec.assemblable})")
    mem, mul = spec.mem_pes(), spec.mul_pes()
    print(f"  mem PEs:    {'all' if mem is None else sorted(mem)}")
    print(f"  mul PEs:    {'all' if mul is None else sorted(mul)}")
    if spec.ports:
        for label, pes, limit in spec.port_groups():
            print(f"  port {label}: {limit} port(s) over PEs {sorted(pes)}")
    else:
        print("  ports:      unconstrained")
    print(f"  arch hash:  {spec.arch_hash()}")
    # capability map: M = load-store unit, X = multiplier, . = ALU-only
    print("  capability map (M=mem X=mul *=both .=alu):")
    for r in range(spec.rows):
        cells = []
        for c in range(spec.cols):
            p = r * spec.cols + c
            has_mem = mem is None or p in mem
            has_mul = mul is None or p in mul
            cells.append("*" if has_mem and has_mul
                         else "M" if has_mem else "X" if has_mul else ".")
        print("    " + " ".join(cells))
    return 0


def arch_main(argv: Optional[List[str]] = None) -> int:
    """``arch list`` (presets and the spec grammar) and ``arch show SPEC``
    (one spec, fully expanded), printed as ``python -m repro arch`` prints
    them."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch arch",
                                 description="architecture presets and specs")
    arsub = ap.add_subparsers(dest="arch_cmd", required=True)
    al = arsub.add_parser("list", help="presets + the spec grammar")
    al.set_defaults(fn=_cmd_arch_list)
    ash = arsub.add_parser("show", help="expand one spec/preset")
    ash.add_argument("spec", help="spec string or preset name")
    ash.set_defaults(fn=_cmd_arch_show)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
