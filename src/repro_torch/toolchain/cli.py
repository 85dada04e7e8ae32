"""``python -m repro_torch map``: compile one registry kernel end to end;
``python -m repro_torch serve``: the compile server;
``python -m repro_torch submit``: one request to a compile server;
``python -m repro_torch list``: name the registered kernels;
``python -m repro_torch arch {list,show}``: architecture presets and specs.

Counterparts of the ``map``, ``serve``, ``submit``, ``list`` and ``arch``
verbs of ``src/repro/toolchain/cli.py``, with their flags and defaults::

    python -m repro_torch map gsm --grid 2x2 --json
    python -m repro_torch map dotprod --arch bordermem-4x4 --no-oracle
    python -m repro_torch map fir4 --strategy portfolio:cdcl-seq+cdcl-pair \
        --jobs 4 --cache-dir build/mapping_cache
    python -m repro_torch serve --port 0 --inline --cache-dir build/serve
    python -m repro_torch submit gsm --grid 2x2 --backend cdcl --json
    python -m repro_torch map gsm_f160 --grid 4x4 --backend cdcl
    python -m repro_torch list --origin traced
    python -m repro_torch arch list
    python -m repro_torch arch show mesh-4x4:mem=col0,regs=8,ports=1/row

``map`` runs a :class:`~repro_torch.toolchain.session.Toolchain` compile
(source -> map -> assemble -> metrics) and prints a human summary or the
JSON digest of ``python -m repro map --json``.  ``--strategy`` races a
portfolio (on ``--jobs`` worker processes), and ``--cache-dir`` reads and
writes the content-addressed mapping cache that both packages share.
``serve`` and ``submit`` speak the wire protocol of
:mod:`repro_torch.serve`, which is the JAX package's: either end may be
either package's, and ``submit --json`` prints the document of ``python -m
repro submit --json``.  Like ``map``, they run on the host and take no
``--device``.
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
    ap.add_argument("kernel", help="registered kernel name, of any suite "
                                   "(gsm, gsm_f160)")
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


def serve_main(argv: Optional[List[str]] = None) -> int:
    """Start the compile server over TCP (``--port``) or on this process's
    stdin/stdout (``--stdio``) and serve until a client sends
    ``shutdown``."""
    import asyncio

    from ..serve.protocol import DEFAULT_PORT
    from ..serve.server import CompileServer

    sv = argparse.ArgumentParser(prog="python -m repro_torch serve",
                                 description="start the compile server")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=None,
                    help="TCP port (default: repro_torch.serve.DEFAULT_PORT;"
                         " 0 = ephemeral)")
    sv.add_argument("--stdio", action="store_true",
                    help="serve one connection over stdin/stdout instead "
                         "of TCP")
    sv.add_argument("--arch", default="4x4",
                    help="default architecture for the hello banner")
    sv.add_argument("--jobs", type=int, default=None,
                    help="warm solver workers (default: cpu count)")
    sv.add_argument("--inline", action="store_true",
                    help="thread-backed workers instead of processes (no "
                         "fork; cooperative deadlines only)")
    sv.add_argument("--backend", default="auto",
                    choices=["auto", "cdcl", "z3"])
    sv.add_argument("--timeout", type=float, default=120.0,
                    help="per-request mapping budget in seconds "
                         "(default 120)")
    sv.add_argument("--ii-max", type=int, default=32)
    sv.add_argument("--cache-dir", default=None,
                    help="content-addressed mapping cache shared by all "
                         "requests")
    sv.add_argument("--tenant-budget", type=int, default=None,
                    help="max concurrently-admitted requests per tenant "
                         "(default: unlimited)")
    sv.add_argument("--no-oracle", action="store_true",
                    help="disable the assembler CEGAR oracle")
    args = sv.parse_args(argv)

    cfg = MapperConfig(backend=args.backend,
                       per_ii_timeout_s=args.timeout / 2,
                       total_timeout_s=args.timeout, ii_max=args.ii_max)
    server = CompileServer(args.arch, cfg, cache=args.cache_dir,
                           jobs=args.jobs, tenant_budget=args.tenant_budget,
                           inline=args.inline,
                           oracle=None if args.no_oracle else "assembler")
    listen_port = args.port if args.port is not None else DEFAULT_PORT

    async def run() -> None:
        if args.stdio:
            await server.serve_stdio()
        else:
            host, port = await server.start(args.host, listen_port)
            print(f"repro-serve listening on {host}:{port} "
                  f"(jobs={server.jobs}, arch={args.arch})",
                  file=sys.stderr, flush=True)
            await server.wait_closed()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    return 0


def submit_main(argv: Optional[List[str]] = None) -> int:
    """Send one compile request to a running server and print its result
    as ``map`` prints one, plus how it was served."""
    from ..serve.client import request_sync
    from ..serve.protocol import DEFAULT_PORT
    from .artifacts import CompileResult

    sb = argparse.ArgumentParser(prog="python -m repro_torch submit",
                                 description="send one request to a "
                                             "compile server")
    sb.add_argument("kernel", help="registered kernel name")
    sb.add_argument("--host", default="127.0.0.1")
    sb.add_argument("--port", type=int, default=None)
    sb.add_argument("--grid", default="4x4")
    sb.add_argument("--arch", default=None,
                    help="architecture spec or preset (overrides --grid)")
    sb.add_argument("--backend", default="auto",
                    choices=["auto", "cdcl", "z3"])
    sb.add_argument("--strategy", default=None,
                    help="solver strategy / portfolio spec")
    sb.add_argument("--timeout", type=float, default=None,
                    help="override the server's mapping budget for this "
                         "request")
    sb.add_argument("--ii-max", type=int, default=None)
    sb.add_argument("--priority", type=int, default=0,
                    help="queue priority (higher runs sooner)")
    sb.add_argument("--tenant", default="default",
                    help="admission-budget bucket")
    sb.add_argument("--json", action="store_true",
                    help="print the JSON digest instead of a summary")
    sb.add_argument("--out", default=None, help="also write the digest here")
    sb.add_argument("--shutdown", action="store_true",
                    help="ask the server to shut down after answering")
    args = sb.parse_args(argv)

    port = args.port if args.port is not None else DEFAULT_PORT
    config = {}
    if args.backend != "auto":
        config["backend"] = args.backend
    if args.timeout is not None:
        config["total_timeout_s"] = args.timeout
        config["per_ii_timeout_s"] = args.timeout / 2
    if args.ii_max is not None:
        config["ii_max"] = args.ii_max
    resp = request_sync(args.kernel, host=args.host, port=port,
                        shutdown=args.shutdown, arch=args.arch or args.grid,
                        config=config or None, strategy=args.strategy,
                        priority=args.priority, tenant=args.tenant)
    if resp.get("type") != "result":
        print(json.dumps(resp, indent=1, sort_keys=True), file=sys.stderr)
        return 1
    cr = CompileResult.from_dict(resp["result"])
    doc = cr.summary()
    doc["served"] = resp["served"]
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
    if args.json:
        print(json.dumps(doc, indent=1, sort_keys=True))
    else:
        _print_human(cr)
        print(f"  served={resp['served']}")
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
