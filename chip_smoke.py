#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the PE-array kernels (the cycle step and the whole-program run) from
``src/repro_torch/kernels/csrc`` with nvcc, then, printing one JSON object
per line:

1. the card (nvidia-smi name and power limit, torch and CUDA versions);
2. the build and its time;
3. a. the cycle step against its plain PyTorch version on the card,
      bit-equal on all five state fields after every step: random
      collision-free programs over P in {4, 9, 16, 25, 36}, M in {64, 128,
      256}, B in {1, 37, 1000, 4096};
   b. every shipped artifact's full program at B=1024 through
      ``run_program`` (one whole-program launch each) against a loop of
      the plain step;
   c. the whole-program run against its plain version and against a chain
      of cycle-step launches, trace and final state bit-equal: random
      programs of 64 rows on the same grid of shapes, plus programs of 0
      and 1 rows and an all-NOP program;
   d. the stacked run (K programs of one grid in one launch) against its
      plain version and against K single whole-program launches, trace and
      final state bit-equal: random programs of different lengths,
      NOP-padded, K in {1, 2, 5}, P in {9, 16}, B in {1, 37, 1000};
4. the map phase: the port's own ``Toolchain`` maps and assembles all 16
   shipped kernels (fir4 included) on the host with the CDCL backend that
   made them (``MAP_CONFIG``), each fresh artifact equal to the committed
   JSON key for key, and ``fuzz_kernel`` reports sha (``ii_max`` 4) and
   sha2 at 2x2 ``unmapped``, the ``unsat-capped`` rows of
   ``results/BENCH_fuzz.json``; map seconds per kernel and their sum.
   Then the cosim phase: ``repro_torch.frontend.run_all`` (the path of
   ``python -m repro_torch cosim``) traces, legalizes, maps (``MAP_CONFIG``)
   and runs the 11 traced kernels at 4x4 over 16 seeds each, one
   whole-program launch a kernel and the cycle step never; each ``ok``
   with no mismatch, at the II of its shipped artifact, with that
   artifact's program, and its simulation bit-equal to the CPU plain
   path's from the same mapping; seconds, the mapping's share and the
   launches.  Then the main path: ``fuzz_kernel`` on the 16 shipped
   kernels, each mapped live under ``MAP_CONFIG`` (its time to a verdict
   includes the mapping), 2048 memories in batches of 1024, every verdict ``ok`` and
   equal to the status of the same kernel in ``results/BENCH_fuzz.json``;
   the whole-program kernel must launch once per batch chunk and the
   cycle step never;
   b. the stacked main path: ``fuzz_stacked`` on the 15 4x4 artifacts x
      2048 seed-0 memories, one launch, every verdict ``ok`` and its
      failing memories equal to phase 4's and to ``stacked_failing`` in
      ``results/BENCH_fuzz.json``;
   c. activity and energy: every phase 4 report carries both; for gsm,
      fir4 and sqrt they equal the CPU plain path's on the same corpus;
      and ``mem_rate`` with activity on and off, in turns, per kernel;
   d. triage on the card: gsm with an injected fault over 2048 memories
      gives the CPU run's verdicts, shrinks to the same memory and
      divergence, and writes the CPU run's reproducer apart from
      ``backend`` (under ``build/``);
5. a stream: gsm over 65,536 memories in batches of 16,384, and one
   main-path run of gsm under ``torch.profiler`` (device busy and idle
   share, the kernel's device time per launch);
6. times at B in {1024, 16384}: the cycle step per launch on a random row
   (P=16, M=128), and the whole-program run on gsm's program (T=84), each
   as device time under ``torch.profiler`` and at the host's issue pace
   with CUDA events, beside its byte bound and its plain version; for the
   whole-program run also the serial floor (an all-NOP program of the same
   length, no trace); and the stacked run of the 15 4x4 programs at
   B=2048 (T=112), first held bit-equal, trace and final state, to its
   plain version and to 15 single launches at that shape, then timed
   beside its byte bound, its serial floor, those 15 single launches and
   its plain version;
7. the kernels line (the whole-program run's launches summed over the
   fuzz main path and the cosim phase, and given per path), then the
   device line last.

Any failure raises and exits non-zero.  Without CUDA it exits 1 and
prints no result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
SWEEP_STEPS = 64
MAIN_MEMORIES, MAIN_BATCH = 2048, 1024
STACK_ARCH = "4x4"                 # the stacked rung of BENCH_fuzz.json
ACTIVITY_KERNELS = (("4x4", "gsm"), ("4x4", "fir4"), ("3x3", "sqrt"))
#: the mapper budget of ``fuzz_kernel`` and the artifact exporter, with
#: the backend that made the shipped artifacts and BENCH_fuzz.json: where
#: z3 is installed, "auto" picks it, and z3 maps differ from those and
#: from one call to the next in one process
MAP_CONFIG = dict(backend="cdcl", per_ii_timeout_s=60.0,
                  total_timeout_s=120.0, ii_max=32)
#: the ``unsat-capped`` rows of BENCH_fuzz.json, with their ``ii_max``
#: (``benchmarks/fuzz_throughput.py:KERNEL_CONFIG``)
UNMAPPED = (("sha", 4), ("sha2", 32))
FAILURES_DIR = ROOT / "build" / "chip_smoke_failures"
COSIM_SEEDS = 16                   # python -m repro_torch cosim's default
STREAM_MEMORIES, STREAM_BATCH = 65536, 16384
TIMED_BATCHES = (1024, 16384)
TIMED_P, TIMED_M = 16, 128


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke failed: {what}")


def state_bytes(B: int, P: int, M: int) -> int:
    """Bytes one cycle step must move: the state read once, written once."""
    return 2 * 4 * B * (7 * P + M)


def program_bytes(T: int, B: int, P: int, M: int, trace: bool = True) -> int:
    """Bytes a whole-program run must move: the state read and written
    once, the (T, B, P) trace written once, the five (T, P) instruction
    fields read once."""
    return state_bytes(B, P, M) + 4 * T * B * P * trace + 20 * T * P


def map_config(**overrides):
    """``MAP_CONFIG`` as a ``MapperConfig``, with ``overrides``."""
    from repro_torch.core.mapper import MapperConfig

    return MapperConfig(**{**MAP_CONFIG, **overrides})


def max_diff(a, b) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def grid_for(P: int):
    from repro_torch.cgra.arch import Grid

    side = int(round(P ** 0.5))
    return Grid(side, side, "torus")


def tensors(arrays, device):
    import torch

    return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}


def kernel_vs_plain(device) -> int:
    """Phase 3a: random programs, every field after every step.  Returns
    the largest absolute difference seen (0 when bit-equal)."""
    import numpy as np
    import torch
    from repro_torch.cgra.arch import neighbor_table
    from repro_torch.kernels.pe_array import cycle_step
    from repro_torch.kernels.ref import InstrRow, PEState, cycle_step_ref
    from repro_torch.kernels.sample import random_fields, random_state

    worst = 0
    cases = 0
    t0 = time.monotonic()
    for P in (4, 9, 16, 25, 36):
        nbr = torch.as_tensor(np.asarray(neighbor_table(grid_for(P)),
                                         np.int32), device=device)
        for M in (64, 128, 256):
            for B in (1, 37, 1000, 4096):
                rng = np.random.RandomState(P * 100_003 + M * 101 + B)
                f = tensors(random_fields(rng, SWEEP_STEPS, P, M,
                                          full_encoding=True), device)
                rows = [InstrRow(*r) for r in zip(
                    *(f[k].unbind(0) for k in InstrRow._fields))]
                s = tensors(random_state(rng, B, P, M), device)
                kern = plain = PEState(**s)
                for t, row in enumerate(rows):
                    kern = cycle_step(kern, row, nbr)
                    plain = cycle_step_ref(plain, row, nbr)
                    for name, a, b in zip(PEState._fields, kern, plain):
                        diff = max_diff(a, b)
                        worst = max(worst, diff)
                        check(diff == 0, f"P={P} M={M} B={B} step {t}: "
                                         f"{name} differs by {diff}")
                cases += 1
    emit({"phase": "kernel_vs_plain", "cases": cases,
          "steps_each": SWEEP_STEPS, "max_abs_err": worst,
          "seconds": round(time.monotonic() - t0, 3)})
    return worst


def artifacts_vs_plain(device, artifacts) -> int:
    """Phase 3b: every artifact's full program at B=1024, kernel
    ``run_program`` against a loop of the plain step on the card."""
    import numpy as np
    import torch
    from repro_torch.cgra.arch import neighbor_table
    from repro_torch.cgra.simulator import preset_state
    from repro_torch.fuzz.corpus import make_corpus
    from repro_torch.kernels.ops import decode_fields, run_program
    from repro_torch.kernels.pe_array import run_cycles
    from repro_torch.kernels.ref import InstrRow, cycle_step_ref

    worst = 0
    t0 = time.monotonic()
    before = run_cycles.launches
    for art in artifacts:
        mems = make_corpus(art, MAIN_BATCH, seed=7)
        fields = decode_fields(art.asm.words(), device)
        state = preset_state(art.asm, art.grid.num_pes, mems, MAIN_BATCH,
                             device)
        nbr = neighbor_table(art.grid)
        final, outs = run_program(fields, state, nbr, device)
        nbr_t = torch.as_tensor(np.asarray(nbr, np.int32), device=device)
        plain = state
        for t, row in enumerate(zip(*(f.unbind(0) for f in fields))):
            plain = cycle_step_ref(plain, InstrRow(*row), nbr_t)
            diff = max_diff(outs[t], plain.out)
            worst = max(worst, diff)
            check(diff == 0, f"{art.kernel}: out differs at row {t}")
        for name, a, b in zip(plain._fields, final, plain):
            diff = max_diff(a, b)
            worst = max(worst, diff)
            check(diff == 0, f"{art.kernel}: final {name} differs")
    launches = run_cycles.launches - before
    check(launches == len(artifacts),
          f"run_cycles launched {launches} times for {len(artifacts)} "
          f"programs")
    emit({"phase": "artifacts_vs_plain", "artifacts": len(artifacts),
          "batch": MAIN_BATCH, "run_cycles_launches": launches,
          "max_abs_err": worst, "seconds": round(time.monotonic() - t0, 3)})
    return worst


def run_cycles_vs_plain(device) -> int:
    """Phase 3c: the whole-program kernel against its plain version and a
    chain of cycle-step launches, on random programs (64 rows, the 3a grid
    of shapes, other seeds), programs of 0 and 1 rows and an all-NOP
    program.  Returns the largest absolute difference seen."""
    import numpy as np
    import torch
    from repro_torch.cgra.arch import neighbor_table
    from repro_torch.cgra.isa import OPCODE
    from repro_torch.kernels.pe_array import cycle_step, run_cycles
    from repro_torch.kernels.ref import InstrRow, PEState, run_cycles_ref
    from repro_torch.kernels.sample import random_fields, random_state

    cases = [(P, M, B, SWEEP_STEPS, False) for P in (4, 9, 16, 25, 36)
             for M in (64, 128, 256) for B in (1, 37, 1000, 4096)]
    cases += [(P, 128, 1000, T, nop) for P in (4, 16, 36)
              for T, nop in ((0, False), (1, False), (SWEEP_STEPS, True))]
    worst = 0
    t0 = time.monotonic()
    before = run_cycles.launches
    for P, M, B, T, nop in cases:
        nbr = torch.as_tensor(np.asarray(neighbor_table(grid_for(P)),
                                         np.int32), device=device)
        rng = np.random.RandomState(7 + P * 100_003 + M * 101 + B + T)
        f = random_fields(rng, T, P, M, full_encoding=True)
        if nop:
            f["op"][:] = OPCODE["NOP"]
        f = tensors(f, device)
        fields = InstrRow(*(f[k] for k in InstrRow._fields))
        state = PEState(**tensors(random_state(rng, B, P, M), device))
        final, outs = run_cycles(fields, state, nbr)
        plain, plain_outs = run_cycles_ref(fields, state, nbr)
        chain = state
        for t in range(T):
            chain = cycle_step(chain, InstrRow(*(x[t] for x in fields)), nbr)
            diff = max_diff(outs[t], chain.out)
            worst = max(worst, diff)
            check(diff == 0, f"P={P} M={M} B={B} T={T}: out at row {t} "
                             f"differs from the cycle-step chain by {diff}")
        check(tuple(outs.shape) == (T, B, P), f"trace shape {outs.shape}")
        diff = max_diff(outs, plain_outs)
        worst = max(worst, diff)
        check(diff == 0, f"P={P} M={M} B={B} T={T}: trace differs from "
                         f"the plain version by {diff}")
        for name, a, b, c in zip(PEState._fields, final, plain, chain):
            diff = max(max_diff(a, b), max_diff(a, c))
            worst = max(worst, diff)
            check(diff == 0, f"P={P} M={M} B={B} T={T}: final {name} "
                             f"differs by {diff}")
    launches = run_cycles.launches - before
    want = sum(1 for case in cases if case[3] > 0)
    check(launches == want, f"run_cycles launched {launches} times for "
                            f"{want} programs with rows")
    emit({"phase": "run_cycles_vs_plain", "cases": len(cases),
          "rows_each": SWEEP_STEPS, "run_cycles_launches": launches,
          "max_abs_err": worst, "seconds": round(time.monotonic() - t0, 3)})
    return worst


def check_stack(fields, state, nbr, singles, what: str) -> int:
    """One stacked launch of NOP-padded programs against the plain version
    and against a single launch of each unpadded program (``singles``):
    trace, padding rows and every final-state tensor bit-equal.  Returns
    the largest absolute difference seen (0, or it raises)."""
    from repro_torch.kernels.pe_array import run_cycles
    from repro_torch.kernels.ref import PEState, run_stacked_ref

    K, T_max, P = fields.op.shape
    B = state.out.shape[1]
    before = run_cycles.launches
    final, outs = run_cycles(fields, state, nbr)
    check(run_cycles.launches - before == 1,
          f"{what}: the stack took {run_cycles.launches - before} "
          f"launches, not 1")
    check(tuple(outs.shape) == (K, T_max, B, P),
          f"{what}: stacked trace shape {tuple(outs.shape)}")
    plain, plain_outs = run_stacked_ref(fields, state, nbr)
    worst = max_diff(outs, plain_outs)
    check(worst == 0, f"{what}: stacked trace differs from the plain "
                      f"version by {worst}")
    for name, a, b in zip(PEState._fields, final, plain):
        diff = max_diff(a, b)
        worst = max(worst, diff)
        check(diff == 0, f"{what}: final {name} differs from the plain "
                         f"version by {diff}")
    for k, single in enumerate(singles):
        T = single.op.shape[0]
        s_final, s_outs = run_cycles(single, PEState(*(t[k] for t in state)),
                                     nbr)
        diff = max_diff(outs[k, :T], s_outs)
        if T < T_max:      # a padding row repeats the program's last row
            diff = max(diff, max_diff(outs[k, T:], s_outs[-1:].expand(
                T_max - T, B, P)))
        for a, b in zip(final, s_final):
            diff = max(diff, max_diff(a[k], b))
        worst = max(worst, diff)
        check(diff == 0, f"{what}: program {k} (T={T}) differs from its "
                         f"single launch by {diff}")
    return worst


def stacked_vs_plain(device) -> int:
    """Phase 3d: the stacked whole-program kernel (K programs of different
    lengths, NOP-padded, in one launch) against its plain version and
    against K single launches of the unpadded programs.  Returns the
    largest absolute difference seen."""
    import numpy as np
    import torch
    from repro_torch.cgra.arch import neighbor_table
    from repro_torch.fuzz.engine import _pad_fields
    from repro_torch.kernels.ref import InstrRow, PEState
    from repro_torch.kernels.sample import random_fields, random_state

    M = 128
    cases = [(K, P, B) for K in (1, 2, 5) for P in (9, 16)
             for B in (1, 37, 1000)]
    worst = 0
    t0 = time.monotonic()
    for K, P, B in cases:
        nbr = torch.as_tensor(np.asarray(neighbor_table(grid_for(P)),
                                         np.int32), device=device)
        rng = np.random.RandomState(11 + K * 1009 + P * 101 + B)
        lengths = [SWEEP_STEPS * (5 - k) // 5 for k in range(K)]
        progs = [random_fields(rng, T, P, M, full_encoding=True)
                 for T in lengths]
        states = [random_state(rng, B, P, M) for _ in range(K)]
        singles = [InstrRow(*(torch.as_tensor(f[n], device=device)
                              for n in InstrRow._fields)) for f in progs]
        fields = InstrRow(*(torch.stack(fs) for fs in zip(
            *(_pad_fields(f, SWEEP_STEPS) for f in singles))))
        state = PEState(*(torch.as_tensor(np.stack([s[k] for s in states]),
                                          device=device)
                          for k in PEState._fields))
        worst = max(worst, check_stack(fields, state, nbr, singles,
                                       f"K={K} P={P} B={B}"))
    emit({"phase": "stacked_vs_plain", "cases": len(cases),
          "rows_max": SWEEP_STEPS, "stacked_launches": len(cases),
          "max_abs_err": worst, "seconds": round(time.monotonic() - t0, 3)})
    return worst


def map_phase(artifacts, device) -> None:
    """Phase 4, first part: the port maps and assembles every shipped
    kernel itself, and the fresh artifact equals the committed JSON key
    for key; sha and sha2 at 2x2 come out ``unmapped``, as
    ``results/BENCH_fuzz.json`` has them.  Mapping runs on the host."""
    from repro_torch.cgra.artifact import ARTIFACT_ROOT, Artifact
    from repro_torch.core.backends import resolve_backend
    from repro_torch.fuzz.engine import fuzz_kernel
    from repro_torch.toolchain import Toolchain

    bench = {row["kernel"]: row for row in json.loads(
        (ROOT / "results" / "BENCH_fuzz.json").read_text())["rows"]}
    t0 = time.monotonic()
    seconds = {}
    for art in artifacts:
        tc = Toolchain(art.arch, map_config())
        prog = tc.program(art.kernel)
        t1 = time.monotonic()
        res = tc.map(prog)
        seconds[art.kernel] = round(time.monotonic() - t1, 3)
        check(res.status == "mapped", f"{art.kernel}: {res.status}")
        fresh = Artifact.from_mapping(prog.builder, res.mapping,
                                      arch=art.arch).to_dict()
        shipped = json.loads(
            (ARTIFACT_ROOT / art.arch / f"{art.kernel}.json").read_text())
        differ = sorted(k for k in shipped.keys() | fresh.keys()
                        if shipped.get(k) != fresh.get(k))
        check(not differ, f"{art.kernel}: fresh artifact differs from the "
                          f"shipped one in {differ}")
        emit({"phase": "map", "kernel": art.kernel, "arch": art.arch,
              "status": res.status, "ii": res.ii, "mii": res.mii,
              "cegar_rounds": res.cegar_rounds,
              "map_seconds": seconds[art.kernel],
              "equal_to_shipped": True})
    unmapped = {}
    for name, ii_max in UNMAPPED:
        row = bench[name]
        rep = fuzz_kernel(name, row["arch"], memories=MAIN_MEMORIES,
                          batch=MAIN_BATCH, config=map_config(ii_max=ii_max),
                          device=device)
        check(rep.status == "unmapped" and row["status"] == "unsat-capped",
              f"{name}@{row['arch']}: {rep.status}, BENCH_fuzz.json "
              f"{row['status']}")
        unmapped[name] = rep.map_time_s
        emit({"phase": "map", "kernel": name, "arch": rep.arch,
              "status": rep.status, "ii_max": ii_max,
              "map_seconds": rep.map_time_s})
    emit({"phase": "map_summary", "kernels": len(seconds),
          "equal_to_shipped": len(seconds), "unmapped": sorted(unmapped),
          "map_seconds_total": round(sum(seconds.values()), 3),
          "backend": MAP_CONFIG["backend"],
          "auto_backend_here": resolve_backend("auto"),
          "unmapped_map_seconds": unmapped,
          "seconds": round(time.monotonic() - t0, 3)})


def cosim_phase(device) -> int:
    """Phase 4, second part: ``repro_torch.frontend.run_all``, the
    ``cosim`` verb's path, over the 11 traced kernels at 4x4 with 16 seeds
    each under ``MAP_CONFIG``: each kernel traced and legalized by the
    port's front-end, mapped on the host, its 16-memory batch run in one
    whole-program launch and compared bit for bit with the numpy
    reference.  Every kernel must come out ``ok`` at the II of its shipped
    artifact, with the artifact's program, and its simulation, re-run from
    the same mapping on the CPU plain path, bit-equal to the card's.  A
    wrapper around ``Toolchain.simulate`` records each simulation (its
    mapping, memories, result and seconds) for those checks.  Returns the
    launches of the whole-program kernel over the run."""
    import numpy as np
    from repro_torch.cgra.artifact import ARTIFACT_ROOT
    from repro_torch.frontend import TRACED_KERNELS, run_all
    from repro_torch.kernels.pe_array import cycle_step, run_cycles
    from repro_torch.toolchain import Toolchain

    simulate, sims = Toolchain.simulate, {}

    def recorded(self, source, mapping, mem, batch=1, device="cuda"):
        t1 = time.monotonic()
        sim = simulate(self, source, mapping, mem, batch=batch, device=device)
        sims[source.name] = (self, source, mapping, mem, batch, sim,
                             time.monotonic() - t1)
        return sim

    t0 = time.monotonic()
    Toolchain.simulate = recorded
    try:
        cycle_step.launches = run_cycles.launches = 0
        doc = run_all(seeds=COSIM_SEEDS, config=map_config(), device=device)
        steps, runs = cycle_step.launches, run_cycles.launches
    finally:
        Toolchain.simulate = simulate
    wall = time.monotonic() - t0
    reports = doc["kernels"]
    check(sorted(r["kernel"] for r in reports) == sorted(TRACED_KERNELS)
          and len(reports) == 11, f"cosim ran {len(reports)} kernels")
    for rep in reports:
        name = rep["kernel"]
        check(rep["status"] == "ok" and rep["mismatches"] == []
              and rep["seeds"] == COSIM_SEEDS,
              f"cosim {name}: {rep['status']} {rep['mismatches'][:2]}")
        check(rep["backend"] == MAP_CONFIG["backend"],
              f"cosim {name}: mapped by {rep['backend']}")
        shipped = json.loads(
            (ARTIFACT_ROOT / "4x4" / f"{name}.json").read_text())
        check(rep["ii"] == shipped["ii"],
              f"cosim {name}: II {rep['ii']} != shipped {shipped['ii']}")
        tc, prog, mapping, mems, batch, sim, exec_s = sims[name]
        check(prog.builder.to_dict() == shipped["program"]
              and TRACED_KERNELS[name].build().to_dict()
              == shipped["program"],
              f"cosim {name}: traced program differs from the artifact's")
        cpu = tc.simulate(prog, mapping, mems, batch=batch, device="cpu")
        check(np.array_equal(sim.final_mem, cpu.final_mem)
              and sim.node_values.keys() == cpu.node_values.keys()
              and all(np.array_equal(v, cpu.node_values[n])
                      for n, v in sim.node_values.items()),
              f"cosim {name}: the card's run differs from the CPU's")
        emit({"phase": "cosim", "kernel": name, "status": rep["status"],
              "ii": rep["ii"], "mii": rep["mii"],
              "ii_bound": rep["ii_bound"], "map_time_s": rep["map_time_s"],
              "cegar_rounds": rep["cegar_rounds"],
              "exec_seconds": round(exec_s, 6), "seeds": rep["seeds"],
              "program_equal_to_shipped": True, "equal_to_cpu": True})
    check(runs == len(reports),
          f"cosim launched run_cycles {runs} times, not once a kernel")
    check(steps == 0, f"cycle_step launched {steps} times in cosim")
    map_s = sum(r["map_time_s"] for r in reports)
    emit({"phase": "cosim_summary", "kernels": len(reports),
          "ok": doc["summary"]["ok"], "seeds": COSIM_SEEDS,
          "run_cycles_launches": runs, "cycle_step_launches": steps,
          "map_seconds": round(map_s, 3),
          "map_share": round(map_s / wall, 4),
          "exec_seconds": round(sum(v[-1] for v in sims.values()), 6),
          "seconds": round(wall, 3)})
    return runs


def main_path(artifacts, device):
    """Phase 4: the fuzz path on every shipped kernel, each mapped live.
    Returns the launches of (cycle_step, run_cycles) over the run."""
    from repro_torch.fuzz.engine import fuzz_kernel
    from repro_torch.kernels.pe_array import cycle_step, run_cycles

    bench = json.loads((ROOT / "results" / "BENCH_fuzz.json").read_text())
    expected_status = {row["kernel"]: row["status"] for row in bench["rows"]}
    chunks = -(-MAIN_MEMORIES // MAIN_BATCH)
    rows_run = sum(a.asm.total_rows * chunks for a in artifacts)
    t0 = time.monotonic()
    cycle_step.launches = run_cycles.launches = 0
    reports = [fuzz_kernel(a.kernel, a.arch, memories=MAIN_MEMORIES,
                           batch=MAIN_BATCH, seed=0, config=map_config(),
                           device=device)
               for a in artifacts]
    steps, runs = cycle_step.launches, run_cycles.launches
    wall = time.monotonic() - t0
    for rep in reports:
        emit({"phase": "fuzz", "kernel": rep.kernel, "arch": rep.arch,
              "status": rep.status, "ii": rep.ii, "memories": rep.memories,
              "batch": rep.batch, "backend": rep.backend,
              "mem_rate": rep.mem_rate, "map_time_s": rep.map_time_s,
              "exec_time_s": rep.exec_time_s,
              "oracle_time_s": rep.oracle_time_s})
        check(rep.status == "ok" and rep.failing == [],
              f"{rep.kernel}: {rep.status} {rep.mismatches[:2]}")
        check(rep.status == expected_status.get(rep.kernel),
              f"{rep.kernel}: status {rep.status} != BENCH_fuzz.json "
              f"{expected_status.get(rep.kernel)}")
    check(runs == len(artifacts) * chunks,
          f"run_cycles launched {runs} times, not once for each of "
          f"{len(artifacts) * chunks} batch chunks")
    check(steps == 0, f"cycle_step launched {steps} times on the main path")
    emit({"phase": "main_path", "kernels": len(reports),
          "memories_each": MAIN_MEMORIES, "batch": MAIN_BATCH,
          "run_cycles_launches": runs, "cycle_step_launches": steps,
          "rows_run": rows_run,
          "map_seconds": round(sum(r.map_time_s for r in reports), 3),
          "seconds": round(wall, 3)})
    return steps, runs, reports


def stacked_main_path(artifacts, single_reports, device) -> int:
    """Phase 4b: ``fuzz_stacked`` on every 4x4 artifact over its seed-0
    corpus of 2048 memories, as the stacked rung of
    ``benchmarks/fuzz_throughput.py`` runs it.  Returns the launches of
    the whole-program kernel over the run (one)."""
    import numpy as np
    from repro_torch.fuzz.corpus import make_corpus
    from repro_torch.fuzz.engine import fuzz_stacked
    from repro_torch.kernels.pe_array import cycle_step, run_cycles

    bench = json.loads((ROOT / "results" / "BENCH_fuzz.json").read_text())
    stacked_failing = {row["kernel"]: row.get("stacked_failing")
                       for row in bench["rows"]}
    single = {r.kernel: r for r in single_reports}
    stack = [a for a in artifacts if a.arch == STACK_ARCH]
    mems = np.stack([make_corpus(a, MAIN_MEMORIES, seed=0) for a in stack])
    t0 = time.monotonic()
    cycle_step.launches = run_cycles.launches = 0
    reports = fuzz_stacked(stack, mems, device=device)
    steps, runs = cycle_step.launches, run_cycles.launches
    wall = time.monotonic() - t0
    for rep in reports:
        check(rep.status == "ok" and rep.backend == "cuda",
              f"stacked {rep.kernel}: {rep.status} {rep.mismatches[:2]}")
        check(rep.failing == single[rep.kernel].failing,
              f"stacked {rep.kernel}: failing {rep.failing} != the single "
              f"run's {single[rep.kernel].failing}")
        check(rep.failing == stacked_failing.get(rep.kernel),
              f"stacked {rep.kernel}: failing {rep.failing} != "
              f"BENCH_fuzz.json {stacked_failing.get(rep.kernel)}")
    check(runs == 1, f"fuzz_stacked launched run_cycles {runs} times")
    check(steps == 0, f"cycle_step launched {steps} times on the stack")
    emit({"phase": "stacked_main_path", "kernels": len(reports),
          "memories_each": MAIN_MEMORIES,
          "t_max": max(a.asm.total_rows for a in stack),
          "rows_real": sum(a.asm.total_rows for a in stack),
          "run_cycles_launches": runs, "cycle_step_launches": steps,
          "exec_time_s_each": reports[0].exec_time_s,
          "mem_rate": [r.mem_rate for r in reports],
          "seconds": round(wall, 3)})
    return runs


def activity_phase(reports) -> None:
    """Phase 4c: every main-path report carries activity and energy; for a
    few kernels they equal the CPU plain path's on the same corpus."""
    from repro_torch.fuzz.engine import fuzz_kernel

    for rep in reports:
        check(rep.activity is not None and rep.energy is not None,
              f"{rep.kernel}: no activity or energy on the main path")
        check(rep.activity["memories"] == MAIN_MEMORIES,
              f"{rep.kernel}: activity over {rep.activity['memories']} "
              f"memories")
    on_card = {(r.arch, r.kernel): r for r in reports}
    t0 = time.monotonic()
    for arch, kernel in ACTIVITY_KERNELS:
        cpu = fuzz_kernel(kernel, arch, memories=MAIN_MEMORIES,
                          batch=MAIN_BATCH, seed=0, config=map_config(),
                          device="cpu")
        card = on_card[(arch, kernel)]
        check(card.activity == cpu.activity,
              f"{kernel}: activity on the card differs from the CPU path's")
        check(card.energy == cpu.energy,
              f"{kernel}: energy on the card {card.energy} != CPU "
              f"{cpu.energy}")
    emit({"phase": "activity", "reports_with_activity": len(reports),
          "equal_to_cpu": [k for _, k in ACTIVITY_KERNELS],
          "energy": {r.kernel: r.energy["delta_pct"] for r in reports},
          "seconds": round(time.monotonic() - t0, 3)})


def activity_cost(artifacts, device) -> None:
    """Phase 4c, part two: what the activity harvest costs ``mem_rate``.
    ``fuzz_program`` on every artifact's 2048-memory seed-0 corpus with
    activity on and off, in turns (on, off, off, on) after one warm run
    of each, so both sides see the same card and host."""
    from repro_torch.fuzz.corpus import make_corpus
    from repro_torch.fuzz.engine import fuzz_program

    corpora = [(a, make_corpus(a, MAIN_MEMORIES, seed=0)) for a in artifacts]
    rates = {(a.kernel, on): [] for a in artifacts for on in (True, False)}
    t0 = time.monotonic()
    for rnd, on in enumerate((None, True, False, False, True)):
        for art, mems in corpora:
            for flag in ((True, False) if on is None else (on,)):
                rep = fuzz_program(art, mems, batch=MAIN_BATCH,
                                   device=device, collect_activity=flag)
                check(rep.status == "ok", f"{art.kernel}: {rep.status}")
                if on is not None:
                    rates[(art.kernel, flag)].append(rep.mem_rate)
    med = {k: statistics.median(v) for k, v in rates.items()}
    ratios = [med[(a.kernel, True)] / med[(a.kernel, False)]
              for a in artifacts]
    emit({"phase": "activity_cost", "memories": MAIN_MEMORIES,
          "batch": MAIN_BATCH, "runs_each": 2,
          "mem_rate_on": {a.kernel: med[(a.kernel, True)] for a in artifacts},
          "mem_rate_off": {a.kernel: med[(a.kernel, False)]
                           for a in artifacts},
          "on_over_off": {a.kernel: r for a, r in zip(artifacts, ratios)},
          "on_over_off_median": statistics.median(ratios),
          "seconds": round(time.monotonic() - t0, 3)})


def triage_phase(device) -> None:
    """Phase 4d: an injected fault in gsm, fuzzed, shrunk and explained on
    the card exactly as on the CPU."""
    import dataclasses
    from repro_torch.cgra.artifact import load_artifact
    from repro_torch.fuzz.corpus import make_corpus
    from repro_torch.fuzz.engine import fuzz_program
    from repro_torch.fuzz.triage import inject_fault, triage_failure

    art = load_artifact("4x4", "gsm")
    mutated, cell, label = inject_fault(art.asm)
    faulty = dataclasses.replace(art, asm=mutated)
    mems = make_corpus(art, MAIN_MEMORIES, seed=0)
    t0 = time.monotonic()
    runs = {}
    for name, dev in (("cuda", device), ("ref", "cpu")):
        rep = fuzz_program(faulty, mems, batch=MAIN_BATCH, device=dev,
                           collect_activity=False)
        triage_failure(faulty, mems, rep, device=dev,
                       out_dir=str(FAILURES_DIR / name))
        runs[name] = rep
    card, cpu = runs["cuda"], runs["ref"]
    check(card.status == cpu.status == "mismatch",
          f"injected fault: {card.status} on the card, {cpu.status} on "
          f"the CPU")
    check(card.failing == cpu.failing, "injected fault: failing memories "
                                       "differ between card and CPU")
    check(card.divergence == cpu.divergence is not None,
          f"divergence {card.divergence} != CPU {cpu.divergence}")
    docs = [json.loads(Path(r.reproducer).read_text()) for r in (card, cpu)]
    check(docs[0].pop("backend") == "cuda" and docs[1].pop("backend") == "ref"
          and docs[0] == docs[1], "reproducers differ apart from backend")
    emit({"phase": "triage", "kernel": "gsm", "fault": label,
          "cell": list(cell), "memories": MAIN_MEMORIES,
          "failing": len(card.failing), "divergence": card.divergence,
          "reproducer": os.path.relpath(card.reproducer, ROOT),
          "seconds": round(time.monotonic() - t0, 3)})


def stream_phase(device) -> None:
    """Phase 5: one kernel over a large corpus in large batches."""
    from repro_torch.fuzz.engine import fuzz_kernel
    from repro_torch.kernels.pe_array import run_cycles

    run_cycles.launches = 0
    rep = fuzz_kernel("gsm", "4x4", memories=STREAM_MEMORIES,
                      batch=STREAM_BATCH, seed=1, config=map_config(),
                      device=device)
    check(rep.status == "ok" and rep.failing == [],
          f"gsm stream: {rep.status} {rep.mismatches[:2]}")
    chunks = -(-STREAM_MEMORIES // STREAM_BATCH)
    check(run_cycles.launches == chunks,
          f"stream: run_cycles launched {run_cycles.launches} times, "
          f"not {chunks}")
    emit({"phase": "stream", "kernel": "gsm", "arch": "4x4",
          "memories": rep.memories, "batch": rep.batch,
          "run_cycles_launches": run_cycles.launches,
          "mem_rate": rep.mem_rate, "exec_time_s": rep.exec_time_s,
          "oracle_time_s": rep.oracle_time_s})


def device_us(event) -> float:
    """Device time of one averaged profiler event, in µs."""
    return float(getattr(event, "self_device_time_total",
                         getattr(event, "self_cuda_time_total", 0.0)))


def on_device(prof):
    """The profiler's averaged events that ran on the GPU (kernels and
    copies), leaving out the host-side operators that launched them, whose
    device time would count the same work twice."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def profile_phase(device) -> None:
    """Phase 5b: device busy time of one main-path fuzz run (gsm, 2048
    memories, batch 1024) under ``torch.profiler``: the kernel's device
    time per launch and the device's idle share of the run's wall time
    (the profiler's own host overhead lengthens that wall time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.cgra.artifact import load_artifact
    from repro_torch.fuzz.corpus import make_corpus
    from repro_torch.fuzz.engine import fuzz_program

    art = load_artifact("4x4", "gsm")
    mems = make_corpus(art, MAIN_MEMORIES)
    fuzz_program(art, mems[:MAIN_BATCH], batch=MAIN_BATCH, device=device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rep = fuzz_program(art, mems, batch=MAIN_BATCH, device=device)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    check(rep.status == "ok", f"profiled gsm run: {rep.status}")

    events = on_device(prof)
    busy_us = sum(device_us(e) for e in events)
    fused = [e for e in events if "run_cycles_kernel" in e.key]
    steps = [e for e in events if "cycle_step_kernel" in e.key]
    launches = sum(e.count for e in fused)
    fused_us = sum(device_us(e) for e in fused)
    chunks = -(-MAIN_MEMORIES // MAIN_BATCH)
    check(launches == chunks, f"profile saw {launches} run_cycles_kernel "
                              f"launches, not {chunks}")
    check(not steps, "profile saw cycle_step_kernel on the main path")
    emit({"phase": "profile", "kernel": "gsm", "memories": MAIN_MEMORIES,
          "batch": MAIN_BATCH, "wall_us": wall_us,
          "device_busy_us": busy_us,
          "idle_share": (1 - busy_us / wall_us) if busy_us else None,
          "run_cycles_kernel_launches": launches,
          "run_cycles_kernel_device_us_per_launch": fused_us / launches,
          "top": [(e.key[:80], e.count, device_us(e)) for e in sorted(
              events, key=device_us, reverse=True)[:6]]})


def host_paced_ms(fn, calls: int, reps: int) -> float:
    """Median milliseconds per call of ``fn`` over ``reps`` runs of
    ``calls`` back-to-back calls, each run timed with CUDA events: the
    pace at which the host issues the calls, which is what the main path
    pays."""
    import torch

    for _ in range(3):
        fn()
    per = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / calls)
    return statistics.median(per)


def device_ms(fn, calls: int, warmup: int = 3) -> float:
    """Milliseconds of device time per call of ``fn``: the GPU time of
    every kernel and copy it ran, over ``calls`` calls, under
    ``torch.profiler`` (gaps between launches left out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(device_us(e) for e in on_device(prof))
    check(busy_us > 0, "the profiler recorded no device time")
    return busy_us / calls / 1e3


def timing(device):
    """Phase 6: kernel and plain time per cycle step at the fuzz path's
    shapes, as device time and at the host's issue pace.  Returns
    {B: (kernel_ms, kernel_paced_ms, plain_ms, bound_ms)}."""
    import numpy as np
    import torch
    from repro_torch.cgra.arch import neighbor_table
    from repro_torch.kernels.pe_array import cycle_step
    from repro_torch.kernels.ref import InstrRow, PEState, cycle_step_ref
    from repro_torch.kernels.sample import random_fields, random_state

    nbr = torch.as_tensor(np.asarray(neighbor_table(grid_for(TIMED_P)),
                                     np.int32), device=device)
    out = {}
    for B in TIMED_BATCHES:
        rng = np.random.RandomState(B)
        f = tensors(random_fields(rng, 1, TIMED_P, TIMED_M), device)
        row = InstrRow(*(f[k][0] for k in InstrRow._fields))
        bufs = [PEState(**tensors(random_state(rng, B, TIMED_P, TIMED_M),
                                  device)) for _ in range(2)]
        flip = [0]

        def kernel_step():
            i = flip[0]
            cycle_step(bufs[i], row, nbr, out=bufs[1 - i])
            flip[0] = 1 - i

        def plain_step():
            cycle_step_ref(bufs[0], row, nbr)

        kernel_ms = device_ms(kernel_step, 200)
        kernel_paced_ms = host_paced_ms(kernel_step, 200, 15)
        plain_ms = device_ms(plain_step, 20)
        plain_paced_ms = host_paced_ms(plain_step, 20, 7)
        bound_ms = state_bytes(B, TIMED_P, TIMED_M) / HBM_BYTES_PER_S * 1e3
        out[B] = (kernel_ms, kernel_paced_ms, plain_ms, bound_ms)
        emit({"phase": "timing", "kernel": "pe_array.cycle_step", "B": B,
              "P": TIMED_P, "M": TIMED_M,
              "kernel_device_us": kernel_ms * 1e3,
              "kernel_host_paced_us": kernel_paced_ms * 1e3,
              "plain_device_us": plain_ms * 1e3,
              "plain_host_paced_us": plain_paced_ms * 1e3,
              "bound_us": bound_ms * 1e3,
              "bytes": state_bytes(B, TIMED_P, TIMED_M)})
    return out


def program_timing(device, step_times):
    """Phase 6b: the whole-program kernel on gsm's program (T=84, P=16,
    M=128) from its preset state, as device time and at the host's issue
    pace, beside its byte bound, its serial floor (an all-NOP program of
    the same length without a trace: T cycles of two barriers each), the
    plain loop, and T cycle-step launches timed in phase 6.  Returns
    {B: (kernel_ms, plain_ms, bound_ms)}."""
    import numpy as np
    import torch
    from repro_torch.cgra.arch import neighbor_table
    from repro_torch.cgra.artifact import load_artifact
    from repro_torch.cgra.simulator import preset_state
    from repro_torch.fuzz.corpus import make_corpus
    from repro_torch.kernels.ops import decode_fields
    from repro_torch.kernels.pe_array import run_cycles
    from repro_torch.kernels.ref import run_cycles_ref

    art = load_artifact("4x4", "gsm")
    fields = decode_fields(art.asm.words(), device)
    nops = fields._replace(op=torch.zeros_like(fields.op))
    T, P = fields.op.shape
    nbr = torch.as_tensor(np.asarray(neighbor_table(art.grid), np.int32),
                          device=device)
    mems = make_corpus(art, MAIN_BATCH, seed=7)
    out = {}
    for B in TIMED_BATCHES:
        state = preset_state(art.asm, P, np.resize(mems, (B, mems.shape[1])),
                             B, device)
        M = state.mem.shape[1]

        def fused():
            run_cycles(fields, state, nbr)

        def floor():
            run_cycles(nops, state, nbr, trace=False)

        def plain():
            run_cycles_ref(fields, state, nbr)

        kernel_ms = device_ms(fused, 50)
        paced_ms = host_paced_ms(fused, 50, 15)
        floor_ms = device_ms(floor, 50)
        plain_ms = device_ms(plain, 2)
        bound_ms = program_bytes(T, B, P, M) / HBM_BYTES_PER_S * 1e3
        step_ms, step_paced_ms = step_times[B][:2]
        out[B] = (kernel_ms, plain_ms, bound_ms)
        emit({"phase": "timing", "kernel": "pe_array.run_cycles",
              "program": "gsm", "B": B, "T": T, "P": P, "M": M,
              "kernel_device_us": kernel_ms * 1e3,
              "kernel_host_paced_us": paced_ms * 1e3,
              "bound_us": bound_ms * 1e3,
              "bytes": program_bytes(T, B, P, M),
              "trace_bytes": 4 * T * B * P,
              "serial_floor_device_us": floor_ms * 1e3,
              "serial_floor_us_per_cycle": floor_ms * 1e3 / T,
              "plain_device_us": plain_ms * 1e3,
              "cycle_step_x_T_device_us": step_ms * T * 1e3,
              "cycle_step_x_T_host_paced_us": step_paced_ms * T * 1e3})
    return out


def stacked_timing(device, artifacts):
    """Phase 6c: the stacked whole-program kernel on the 15 4x4 programs
    (NOP-padded to T_max=112) at B=2048 from their preset states, as
    device time and at the host's issue pace, beside its byte bound, its
    serial floor (an all-NOP stack of the same shape, no trace), 15 single
    launches of the unpadded programs, and the plain version.  Before the
    timing, the stack's trace and final state at this shape are held bit
    for bit against the plain version and the 15 single launches.  Returns
    (max_abs_err, kernel_ms, plain_ms, bound_ms)."""
    import numpy as np
    import torch
    from repro_torch.cgra.arch import neighbor_table
    from repro_torch.cgra.simulator import stacked_preset_state
    from repro_torch.fuzz.corpus import make_corpus
    from repro_torch.fuzz.engine import _pad_words
    from repro_torch.kernels.ops import decode_fields
    from repro_torch.kernels.pe_array import run_cycles
    from repro_torch.kernels.ref import PEState, run_stacked_ref

    stack = [a for a in artifacts if a.arch == STACK_ARCH]
    K, B = len(stack), MAIN_MEMORIES
    T = max(a.asm.total_rows for a in stack)
    P = stack[0].grid.num_pes
    fields = decode_fields(np.stack([_pad_words(a.asm.words(), T)
                                     for a in stack]), device)
    nops = fields._replace(op=torch.zeros_like(fields.op))
    singles = [decode_fields(a.asm.words(), device) for a in stack]
    state = stacked_preset_state(
        [a.asm for a in stack], P,
        np.stack([make_corpus(a, B, seed=0) for a in stack]), device)
    states = [PEState(*(t[k] for t in state)) for k in range(K)]
    M = state.mem.shape[-1]
    nbr = torch.as_tensor(np.asarray(neighbor_table(stack[0].grid),
                                     np.int32), device=device)

    err = check_stack(fields, state, nbr, singles,
                      f"stack of {K} at B={B}")

    def stacked():
        run_cycles(fields, state, nbr)

    def floor():
        run_cycles(nops, state, nbr, trace=False)

    def one_by_one():
        for f, s in zip(singles, states):
            run_cycles(f, s, nbr)

    def plain():
        run_stacked_ref(fields, state, nbr)

    kernel_ms = device_ms(stacked, 20)
    paced_ms = host_paced_ms(stacked, 20, 15)
    floor_ms = device_ms(floor, 20)
    singles_ms = device_ms(one_by_one, 10)
    singles_paced_ms = host_paced_ms(one_by_one, 10, 9)
    plain_ms = device_ms(plain, 1, warmup=1)
    bytes_ = K * program_bytes(T, B, P, M)
    bound_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    rows_real = sum(a.asm.total_rows for a in stack)
    emit({"phase": "timing", "kernel": "pe_array.run_cycles (stacked)",
          "programs": K, "B": B, "T_max": T, "rows_real": rows_real,
          "rows_padded": K * T, "P": P, "M": M,
          "kernel_device_us": kernel_ms * 1e3,
          "kernel_host_paced_us": paced_ms * 1e3,
          "bound_us": bound_ms * 1e3, "bytes": bytes_,
          "serial_floor_device_us": floor_ms * 1e3,
          "single_launches_device_us": singles_ms * 1e3,
          "single_launches_host_paced_us": singles_paced_ms * 1e3,
          "plain_device_us": plain_ms * 1e3, "max_abs_err": err})
    return err, kernel_ms, plain_ms, bound_ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.cgra.artifact import artifact_names, load_artifact
    from repro_torch.kernels import build

    t_start = time.monotonic()
    device = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    emit({"phase": "card", "nvidia_smi": card,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    t0 = time.monotonic()
    built = build.build()
    build.library()
    emit({"phase": "build", "seconds": round(time.monotonic() - t0, 3),
          "nvcc_seconds": round(built.seconds, 3), "library": built.path.name,
          "ptxas": [ln for ln in built.log.splitlines() if "ptxas" in ln]})

    artifacts = [load_artifact(arch, name) for arch in ("4x4", "3x3")
                 for name in artifact_names(arch)]
    check(len(artifacts) == 16, f"{len(artifacts)} artifacts shipped, not 16")

    step_err = kernel_vs_plain(device)
    fused_err = max(artifacts_vs_plain(device, artifacts),
                    run_cycles_vs_plain(device))
    stacked_err = stacked_vs_plain(device)
    map_phase(artifacts, device)
    cosim_runs = cosim_phase(device)
    steps, runs, reports = main_path(artifacts, device)
    stacked_runs = stacked_main_path(artifacts, reports, device)
    activity_phase(reports)
    activity_cost(artifacts, device)
    triage_phase(device)
    stream_phase(device)
    profile_phase(device)
    step_times = timing(device)
    fused_times = program_timing(device, step_times)
    stacked_times = stacked_timing(device, artifacts)

    def line(name, launches, err, ms, plain_ms, bound_ms,
             replaces="src/repro/kernels/pe_array.py:67", **extra):
        return {"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/pe_array.cu",
                "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": "bytes", "library_ms": None, **extra}

    step_ms, _, step_plain_ms, step_bound_ms = step_times[MAIN_BATCH]
    emit({"phase": "done", "seconds": round(time.monotonic() - t_start, 3)})
    emit({"kernels": [
        line("pe_array.cycle_step", steps, step_err, step_ms, step_plain_ms,
             step_bound_ms),
        line("pe_array.run_cycles", runs + cosim_runs, fused_err,
             *fused_times[MAIN_BATCH],
             launches_by_path={"fuzz main path": runs,
                               "cosim": cosim_runs}),
        line("pe_array.run_cycles (stacked)", stacked_runs,
             max(stacked_err, stacked_times[0]), *stacked_times[1:],
             replaces="src/repro/fuzz/engine.py:508")]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
