"""Differential co-simulation: prove traced mappings correct by execution.

A copy of ``src/repro/frontend/verify.py``.  A thin wrapper over one
:class:`repro_torch.toolchain.Toolchain` session per kernel: the harness
(1) legalizes it (the session's ``program`` stage), (2) SAT-maps it with
the bitstream assembler as CEGAR oracle (the ``map`` stage), (3) asserts
the achieved II is within the KMS upper bound (``kms_ii_upper_bound`` —
beyond it modulo scheduling degenerated, which means the front-end emitted
a broken DFG), (4) executes the bitstream on the PE-array simulator (the
``simulate`` stage: one ``run_cycles`` kernel launch for the whole seed
batch on the card, the plain PyTorch loop with ``device="cpu"``) over a
*batch* of randomized input memories, and (5) compares every result carry
and the entire final data memory bit-exactly against the plain reference
(``batched_reference`` — the same loop body run on int32 values in numpy,
independent of the legalizer).  Only the comparison logic lives here.

The one difference from the JAX package is the simulator argument: its
``backend="ref"|"pallas"`` is ``device="cuda"|"cpu"`` here, and the
default is the card (asking for it without one raises).
``CoSimReport.backend`` is still the mapping backend.

A front-end lowering bug, an encoder regression, or a scheduler/routing
bug all surface as an execution mismatch here — caught by running the
program, not by inspecting the mapping.

CLI::

    python -m repro_torch cosim --out results/frontend_cosim.json
    python -m repro_torch cosim --device cpu --kernels dotprod --seeds 4

exits non-zero unless every traced kernel maps within its bound and
co-simulates bit-exactly.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.mapper import MapperConfig
from ..core.schedule import kms_ii_upper_bound
from ..device import resolve_device
from ..toolchain.session import Toolchain
from .ir import M32
from .tracer import batched_reference

# generous per-kernel budget: nightly uses it as-is; the tier-1 test passes
# a tighter config so a slow CI box degrades to skip, not to failure
DEFAULT_CONFIG = MapperConfig(per_ii_timeout_s=60.0, total_timeout_s=120.0,
                              ii_max=32)


@dataclass
class CoSimReport:
    """One kernel's verdict.  ``status``: ``ok`` (mapped within bound,
    bit-exact), ``mapped`` (execution skipped), ``ii-above-bound``,
    ``mismatch``, ``unmapped`` or ``timeout``."""

    kernel: str
    status: str
    ii: Optional[int] = None
    mii: int = 0
    ii_bound: int = 0
    nodes: int = 0
    edges: int = 0
    seeds: int = 0
    map_time_s: float = 0.0
    cegar_rounds: int = 0
    backend: str = ""
    mismatches: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.status in ("ok", "mapped")

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def cosimulate(tk, rows: int = 4, cols: int = 4, seeds: int = 16,
               config: Optional[MapperConfig] = None, device="cuda",
               execute: bool = True) -> CoSimReport:
    """Map one traced kernel and (optionally) execute it against the
    reference over ``seeds`` randomized inputs on ``device``; see the
    module docstring."""
    if execute:
        resolve_device(device)  # no card: raise before mapping
    cfg = config or DEFAULT_CONFIG
    tc = Toolchain((rows, cols), cfg)
    art = tc.program(tk)
    bound = kms_ii_upper_bound(art.dfg, tc.grid.num_pes)
    t0 = time.monotonic()
    res = tc.map(art)
    rep = CoSimReport(
        kernel=tk.name, status="", mii=res.mii, ii_bound=bound,
        nodes=art.dfg.num_nodes, edges=art.dfg.num_edges,
        map_time_s=round(time.monotonic() - t0, 3),
        cegar_rounds=res.cegar_rounds, backend=res.backend)
    if res.mapping is None:
        rep.status = "timeout" if res.status == "timeout" else "unmapped"
        return rep
    rep.ii = res.mapping.ii
    if rep.ii > bound:
        rep.status = "ii-above-bound"
        return rep
    if not execute:
        rep.status = "mapped"
        return rep

    mems = np.stack([tk.make_mem(seed) for seed in range(seeds)])
    sim = tc.simulate(art, res.mapping, mems, batch=seeds, device=device)
    rep.seeds = seeds
    # one vectorized reference run over the whole seed batch; mismatch
    # lines keep the JAX package's format and ordering
    ref_vals, ref_mems = batched_reference(tk.spec, tk.body, mems)
    ref_mem_all = np.asarray(ref_mems, np.int64) & M32
    for b in range(seeds):
        for name, exp in ref_vals.items():
            node = art.builder.result_nodes[name]
            got = int(sim.node_values[node][b]) & M32
            want = int(exp[b]) & M32
            if got != want:
                rep.mismatches.append(
                    f"seed {b}: result {name!r} sim {got:#x} != "
                    f"ref {want:#x}")
        sim_mem = sim.final_mem[b].astype(np.int64) & M32
        for addr in np.nonzero(sim_mem != ref_mem_all[b])[0]:
            rep.mismatches.append(
                f"seed {b}: mem[{int(addr)}] sim {int(sim_mem[addr]):#x} != "
                f"ref {int(ref_mem_all[b][addr]):#x}")
    rep.status = "ok" if not rep.mismatches else "mismatch"
    return rep


def run_all(kernels: Optional[Sequence[str]] = None, rows: int = 4,
            cols: int = 4, seeds: int = 16,
            config: Optional[MapperConfig] = None, device="cuda",
            execute: bool = True) -> Dict:
    """Co-simulate every (or the named) traced kernels; JSON-ready doc."""
    from .kernels import TRACED_KERNELS

    names = list(kernels) if kernels else sorted(TRACED_KERNELS)
    unknown = [n for n in names if n not in TRACED_KERNELS]
    if unknown:
        raise KeyError(f"unknown traced kernels {unknown}; "
                       f"available: {sorted(TRACED_KERNELS)}")
    t0 = time.monotonic()
    reports = [cosimulate(TRACED_KERNELS[n], rows=rows, cols=cols,
                          seeds=seeds, config=config, device=device,
                          execute=execute)
               for n in names]
    return {
        "bench": "frontend_cosim",
        "grid": f"{rows}x{cols}",
        "seeds": seeds,
        "execute": execute,
        "kernels": [r.to_dict() for r in reports],
        "summary": {
            "total": len(reports),
            "ok": sum(1 for r in reports if r.ok),
            "cosimulated": sum(1 for r in reports if r.status == "ok"),
            "failed": sum(1 for r in reports if not r.ok),
        },
        "wall_time_s": round(time.monotonic() - t0, 3),
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch cosim",
        description="differential co-simulation of all traced kernels")
    ap.add_argument("--grid", default="4x4", help="CGRA size (default 4x4)")
    ap.add_argument("--seeds", type=int, default=16,
                    help="randomized inputs per kernel (default 16)")
    ap.add_argument("--kernels", default="",
                    help="comma-separated subset (default: all traced)")
    ap.add_argument("--out", default="results/frontend_cosim.json")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the bitstreams run (default: the card)")
    ap.add_argument("--map-only", action="store_true",
                    help="skip execution: map + II bound")
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="per-kernel mapping budget in seconds")
    args = ap.parse_args(argv)
    r, _, c = args.grid.lower().partition("x")
    cfg = MapperConfig(per_ii_timeout_s=args.timeout / 2,
                       total_timeout_s=args.timeout, ii_max=32)
    names = [k.strip() for k in args.kernels.split(",") if k.strip()] or None
    doc = run_all(kernels=names, rows=int(r), cols=int(c), seeds=args.seeds,
                  config=cfg, device=args.device,
                  execute=not args.map_only)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
    for rep in doc["kernels"]:
        print("BENCH", json.dumps(dict(rep, bench="frontend_cosim"),
                                  sort_keys=True), flush=True)
    s = doc["summary"]
    print(f"wrote {args.out}: {s['ok']}/{s['total']} ok, "
          f"{s['failed']} failed")
    return 1 if s["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
