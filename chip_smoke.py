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
      of cycle-step launches, trace and final state bit-equal, traced and
      untraced: random programs of 64 rows on the same grid of shapes,
      plus programs of 0 and 1 rows and an all-NOP program; then the
      hazard programs of ``sample.HAZARDS`` (all-NOP rows mid program,
      trailing NOP rows, a load in row t + 1 of what row t stored, from the
      same PE and another, stores and loads over every address of M) at P
      in {4, 9, 16, 25, 36, 64} and B in {37, 1001}, not multiples of a
      block's rows, each in both layouts of the run where the shape takes
      the lane layout (P <= 32); then programs that run from a ring of two
      chunks and memory images kept in device memory (``RING_CASES``);
   d. the stacked run (K programs of one grid in one launch) against its
      plain version and against K single whole-program launches, trace and
      final state bit-equal: random programs of different lengths,
      NOP-padded, K in {1, 2, 5}, P in {9, 16}, B in {1, 37, 1000}; then
      stacks of the hazard programs with lengths from 0 to T_max, at the
      hazard P and B, in both layouts as in c;
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
   kernels, each mapped live under ``MAP_CONFIG`` into a fresh mapping
   cache (its time to a verdict includes the mapping), 2048 memories in
   batches of 1024, every verdict ``ok`` and equal to the status of the
   same kernel in ``results/BENCH_fuzz.json``; the whole-program kernel
   must launch once per batch chunk, in the lane layout, and the cycle
   step never;
   b. the stacked main path: ``fuzz_stacked`` on the 15 4x4 artifacts x
      2048 seed-0 memories, one launch in the uniform layout, every
      verdict ``ok`` and its
      failing memories equal to phase 4's and to ``stacked_failing`` in
      ``results/BENCH_fuzz.json``;
   c. activity and energy: every phase 4 report carries both; for gsm,
      fir4 and sqrt they equal the CPU plain path's on the same corpus;
      and ``mem_rate`` with activity on and off, in turns, per kernel;
   d. triage on the card: gsm with an injected fault over 2048 memories
      gives the CPU run's verdicts, shrinks to the same memory and
      divergence, and writes the CPU run's reproducer apart from
      ``backend`` (under ``build/``);
   e. the main path again through its cache: 16 hits, each artifact
      equal to the cold pass's, status, failing memories, activity and
      energy equal; cold and warm seconds and their mapping seconds;
5. a stream: gsm over 65,536 memories in batches of 16,384, and one
   main-path run of gsm under ``torch.profiler`` (device busy and idle
   share, the kernel's device time per launch);
6. times at B in {1024, 16384}: the cycle step per launch on a random row
   (P=16, M=128), and the whole-program run on gsm's program (T=84), each
   as device time under ``torch.profiler`` and at the host's issue pace
   with CUDA events, beside its plain version and its bound, the larger
   of its bytes over the HBM rate and its int32 operations over the INT32
   rate (``bound_by`` names which); for the whole-program run also the
   serial floor (every cell a live SADD of ZERO, no trace), the all-NOP
   program, µs per cycle and the device time of the layout the shape
   does not choose; and the stacked run of the 15 4x4 programs
   at B=2048 (T=112), first held bit-equal, trace and final state, to its
   plain version and to 15 single launches at that shape, then timed
   beside the same, those 15 single launches and its plain version.  With
   ``--parent DIR`` (a copy of the parent commit's
   ``src/repro_torch/kernels``, e.g. ``git archive HEAD~1
   src/repro_torch/kernels | tar -x -C build/parent --strip-components=2``
   and ``--parent build/parent/kernels``), the parent's whole-program
   kernel is held bit-equal and timed in turns with this one (parent,
   new, new, parent) in each of these readings, host pace included, and
   the records gain the ``parent_*`` and ``turns_*`` keys;
7. mapping at scale, forked after CUDA is up:
   a. the fleet: ``compile_many`` over the 16 shipped (kernel, arch)
      points on min(8, CPUs) workers into a fresh cache, 16 of 16 ``ok``
      at the shipped II with the shipped mapping (or the worker grid's,
      see ``fleet_phase``), each bitstream fuzzed ``ok`` on the card;
      the same call again: 16 cache hits;
   b. the race: fir4 and stencil3 at 4x4 raced with
      ``portfolio:cdcl-seq+cdcl-pair`` on 4 workers, each ``mapped`` at
      its shipped II and fuzzed ``ok`` on the card, race seconds beside
      phase ``map``'s; gsm with ``portfolio:auto`` (z3 where installed)
      ``ok``;
   c. chaos: ``REPRO_CHAOS`` crashes each worker's first attempt on a
      two-point ``compile_many``; both heal on the retry at the clean
      fleet's II;
8. the paper's design-space analysis (the sweep phases pin CDCL, each
   into a fresh cache):
   a. ``sweep_smoke``: the port's ``sweep --smoke`` twice, its Pareto bytes
      equal to the committed ``results/BENCH_dse.json`` (never written),
      the second pass 12 of 12 cache hits;
   b. ``sweep``: the size ladder 2x2 to 6x6 over the registry kernels but
      sha and sha2 (``SWEEP_CUT``), traced, on min(8, CPUs) workers; each
      grid shape new to the card held bit-equal to the plain loop, then
      every ``mapped`` point fuzzed on the card from the sweep's cache
      (every map a hit), ``ok`` but for ``REFERENCE_MISMATCHES`` (mappings
      the JAX package gets wrong too, whose mismatch must equal the CPU
      path's), one line a point, then the Pareto section;
   c. ``heuristic``: ``map_dfg_heuristic`` on Fig. 7's handwritten kernels
      at 2x2 to 5x5 beside the sweep's SAT rows; every mapping validates,
      every routing-free one runs on the card with no mismatch;
   d. ``trace``: the sweep's trace validates, its roots at least 95%
      attributed, and the ten span names with the most seconds;
   e. ``serve``: the serving lane's 320 requests (``benchmarks/serving.py``
      full mode, copied) through the port's ``CompileServer`` over TCP, on
      8 process workers forked after CUDA is up, into a fresh cache, equal
      to the committed ``results/BENCH_serving.json`` on all 46 points and
      the dedup contract (timings and the cache/coalesced split are
      printed, not compared); then ``python -m repro_torch serve`` and
      ``submit`` as subprocesses (a cache hit, a new point at the port's
      own II, ``stats``, ``--shutdown``); then every point the server
      mapped fuzzed on the card from its cache (every map a hit), ``ok``;
9. the kernels line (the whole-program run's launches summed over the
   paths that run it, and given per path and, where counted, per layout;
   each layout must have run on the main path), then the device line
   last.

Any failure raises and exits non-zero.  Without CUDA it exits 1 and
prints no result.  Run with no arguments it needs one card and nothing but
the checkout.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
#: H100 SXM: 132 SMs x 64 INT32 lanes at the 1.98 GHz boost clock
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: int32 operations of one executed PE-cycle: two source selects, the ALU
#: op, the address and its clamp, two flags, the OUT write (the note of
#: csrc/pe_array.cu)
INT_OPS_PER_PE_CYCLE = 8
SWEEP_STEPS = 64
#: phases 3c/3d: the hazard programs run at these P (one above 36, where a
#: warp runs two PEs) and batches that are not a multiple of a block's rows
HAZARD_PES = (4, 9, 16, 25, 36, 64)
HAZARD_BATCHES = (37, 1001)
#: a stack's program lengths, in eighths of T_max: 0 to T_max
HAZARD_LENGTHS = (0, 1, 3, 4, 7, 8)
#: (P, M, B, T) of phase 3c that run from a ring of two program chunks, or
#: keep the memory image in device memory (the last, M near 227 KB)
RING_CASES = ((16, 128, 1000, 300), (36, 128, 37, 400), (4, 58_000, 3, 16),
              (16, 58_080, 8, 16))
MAIN_MEMORIES, MAIN_BATCH = 2048, 1024
#: run_cycles launches by layout in the phases that count them (the fuzz
#: main path, cold and warm, the sweep's fuzz runs and the stacked path)
LAYOUT_LAUNCHES = {}
#: ``Geometry.layout`` by name: run_cycles_kernel, run_lanes_kernel
LAYOUT_NAMES = ("uniform", "lane")
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
#: fresh mapping caches of the main path and the fleet (under build/,
#: which git ignores)
CACHE_ROOT = ROOT / "build" / "chip_smoke_cache"
#: the racing strategy of phase ``race`` (CDCL only: z3 mappings differ
#: from run to run, ROADMAP.md section 3), its kernels, and its workers
RACE_STRATEGY = "portfolio:cdcl-seq+cdcl-pair"
RACE_KERNELS = ("fir4", "stencil3")
RACE_JOBS = 4
#: phase ``sweep`` is the paper's size ladder (``DEFAULT_SIZES``, 2x2 to
#: 6x6) over every registry kernel but these two: under the pure-Python
#: CDCL they do not map within a sweep point's 60 s budget
SWEEP_CUT = ("sha", "sha2")
#: swept points that the JAX package's mapper gets wrong too: both
#: packages map them to the same words, which execute wrong on every
#: simulator (a loop-carried operand handed through a neighbour's OUT
#: register is clobbered before its first read, and the assembler oracle
#: does not see it; ROADMAP.md section 3).  On the card each must give
#: exactly the CPU path's mismatch; every other mapped point ``ok``
REFERENCE_MISMATCHES = (("popcount", "2x2"), ("popcount", "2x3"))
#: memories of such a point that the CPU path runs to compare verdicts
REFERENCE_CPU_MEMORIES = 256
#: grid shapes whose assembled programs earlier phases run on the card;
#: each other swept shape is first held to the plain loop
SHIPPED_SHAPES = ("3x3", "4x4")
#: ``benchmarks/fig7_table4.py``: its handwritten kernels less
#: ``SWEEP_CUT``, its sizes and its heuristic settings
HEURISTIC_KERNELS = ("reversebits", "bitcount", "sqrt", "stringsearch", "gsm")
HEURISTIC_SIZES = ("2x2", "3x3", "4x4", "5x5")
HEURISTIC_CONFIG = dict(seed=0, tries_per_ii=10, ii_max=40,
                        total_timeout_s=45)
#: root coverage floor of phase ``trace``, as ``trace check
#: --min-attribution 0.95`` enforces it
TRACE_FLOOR = 0.95
#: the sweep phases' outputs and trace (under build/, which git ignores)
SWEEP_ROOT = ROOT / "build" / "chip_smoke_sweep"

#: phase ``serve``: the full mode of the serving lane
#: (``benchmarks/serving.py``; this script imports nothing of
#: ``benchmarks``, so its settings are copied here): 320 requests drawn
#: Zipf(1.1) from seed 7 over the registry kernels x ``SERVE_ARCHES``,
#: the heavyweight kernels on the rungs where they end deterministically,
#: each request under ``MAP_CONFIG`` (CDCL pinned) plus its kernel's
#: overrides, 8 in flight on one connection, to a server with 8 workers
SERVE_ARCHES = ("4x4", "mesh-4x4", "bordermem-4x4")
SERVE_KERNEL_ARCHES = {
    "sqrt": ["3x3", "mesh-3x3", "bordermem-3x3"],
    "sha": ["2x2", "mesh-2x2", "bordermem-2x2"],
    "sha2": ["2x2", "mesh-2x2", "bordermem-2x2"],
}
SERVE_KERNEL_CONFIG = {"sha": {"ii_max": 4}}
SERVE_PRIORITIES = (0, 1, 5)
SERVE_TENANTS = ("alice", "bob", "carol")
SERVE_SEED, SERVE_ZIPF_S, SERVE_REQUESTS = 7, 1.1, 320
SERVE_CONCURRENCY = SERVE_JOBS = 8
#: summary keys that vary run to run or by how a request was served
SERVE_VOLATILE_KEYS = ("stage_times_s", "cache_hit", "cancelled_after_s")
#: lane keys that are timings, or the cache/coalesced split, which
#: depends on arrival times: reported, never compared
SERVE_TIMED_KEYS = ("served", "throughput_rps", "p50_ms", "p99_ms",
                    "wall_time_s")
#: a point the lane does not hold, submitted through the verbs (CEGAR)
SERVE_NEW_POINT = ("gsm", "2x2")
#: seconds a client waits for the whole lane, or for one ``submit``
SERVE_CLIENT_TIMEOUT_S = 600


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


def program_ops(fields, B: int) -> int:
    """int32 operations a whole-program run must do on these inputs:
    ``INT_OPS_PER_PE_CYCLE`` for every executed (non-NOP) instruction of
    the program (or stack), for each of the B batch rows."""
    return INT_OPS_PER_PE_CYCLE * int((fields.op != 0).sum()) * B


def bound(bytes_: int, ops: int):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the int32 operations over the INT32 rate."""
    by_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    by_ops = ops / INT32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                          "operations")


def parent_kernels(path):
    """The parent commit's ``repro_torch/kernels`` package, copied to
    ``path``, loaded beside the current one as
    ``repro_torch.parent_kernels`` (its ``build`` compiles its own source
    into the same cache, under its own hash).  Returns its ``pe_array``
    module, or None without a path."""
    import importlib
    import importlib.util

    if path is None:
        return None
    path = Path(path).resolve()
    check((path / "pe_array.py").is_file() and (path / "csrc").is_dir(),
          f"--parent {path}: not a copy of src/repro_torch/kernels")
    name = "repro_torch.parent_kernels"
    spec = importlib.util.spec_from_file_location(
        name, path / "__init__.py", submodule_search_locations=[str(path)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return importlib.import_module(name + ".pe_array")


def in_turns(measure, new_fn, parent_fn):
    """``measure`` of the parent's and the new call in turns (parent, new,
    new, parent): (new mean, parent mean, [the four readings]); the parent
    entries are None without a parent."""
    if parent_fn is None:
        return measure(new_fn), None, None
    turns = [measure(parent_fn), measure(new_fn), measure(new_fn),
             measure(parent_fn)]
    return ((turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2,
            [t * 1e3 for t in turns])


def parent_fields(parent, device_ms_, paced_ms, floor_ms, nop_ms, turns,
                  paced_turns, **more):
    """The readings of the parent's kernel for a timing record: none
    without a parent."""
    if parent is None:
        return {}
    return {"parent_device_us": us(device_ms_),
            "parent_host_paced_us": us(paced_ms),
            "parent_serial_floor_device_us": us(floor_ms),
            "parent_nop_program_device_us": us(nop_ms),
            "turns_device_us": turns, "turns_host_paced_us": paced_turns,
            **more}


def us(ms):
    return None if ms is None else ms * 1e3


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


def fresh_dir(path: Path) -> Path:
    """``path``, emptied."""
    import shutil

    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return path


def fresh_cache(name: str):
    """An empty ``MappingCache`` under ``CACHE_ROOT``."""
    from repro_torch.dse import MappingCache

    return MappingCache(str(fresh_dir(CACHE_ROOT / name)))


@contextlib.contextmanager
def recorded_artifacts():
    """Within the block, every ``Artifact.from_mapping`` (what
    ``fuzz_kernel`` calls on each fresh or cached mapping) also lands in
    the yielded dict, keyed by kernel."""
    from repro_torch.cgra.artifact import Artifact

    made, orig = {}, Artifact.__dict__["from_mapping"]
    make = Artifact.from_mapping

    def from_mapping(program, mapping, arch=None):
        art = make(program, mapping, arch=arch)
        made[art.kernel] = art
        return art

    Artifact.from_mapping = from_mapping
    try:
        yield made
    finally:
        Artifact.from_mapping = orig


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
    program; then the hazard programs of ``sample.HAZARDS`` (NOP rows mid
    program and at the tail, a load right after a store from the same PE
    and another, stores and loads over every address) at every P of
    ``HAZARD_PES`` and batches that are not a multiple of the block's rows,
    in each layout that takes the shape; then programs that run from a ring of two chunks and memory images
    that stay in device memory (``RING_CASES``).  Returns the largest
    absolute difference seen."""
    import numpy as np
    import torch
    from repro_torch.cgra.arch import neighbor_table
    from repro_torch.cgra.isa import OPCODE
    from repro_torch.kernels.pe_array import (UNIFORM_LAYOUT, cycle_step,
                                              run_cycles,
                                              run_cycles_geometry)
    from repro_torch.kernels.ref import InstrRow, PEState, run_cycles_ref
    from repro_torch.kernels.sample import (HAZARDS, hazard_fields,
                                            random_fields, random_state)

    cases = [(P, M, B, SWEEP_STEPS, "random") for P in (4, 9, 16, 25, 36)
             for M in (64, 128, 256) for B in (1, 37, 1000, 4096)]
    cases += [(P, 128, 1000, T, kind) for P in (4, 16, 36)
              for T, kind in ((0, "random"), (1, "random"),
                              (SWEEP_STEPS, "all_nop"))]
    cases += [(P, 128, B, SWEEP_STEPS, kind) for P in HAZARD_PES
              for B in HAZARD_BATCHES for kind in HAZARDS]
    cases += [(P, M, B, T, "ring") for P, M, B, T in RING_CASES]
    worst = 0
    kinds = {}
    layout_runs = {}
    want = 0
    t0 = time.monotonic()
    before = run_cycles.launches
    for P, M, B, T, kind in cases:
        layouts = (hazard_layouts(P, M) if kind in HAZARDS
                   else (UNIFORM_LAYOUT,) if kind == "ring" else (None,))
        nbr = torch.as_tensor(np.asarray(neighbor_table(grid_for(P)),
                                         np.int32), device=device)
        rng = np.random.RandomState(7 + P * 100_003 + M * 101 + B + T)
        if kind in HAZARDS:
            f = hazard_fields(rng, kind, T, P, M)
        else:
            f = random_fields(rng, T, P, M, full_encoding=True)
        if kind == "all_nop":
            f["op"][:] = OPCODE["NOP"]
        if kind == "ring":
            geom = run_cycles_geometry(B, P, M, T=T, layout=UNIFORM_LAYOUT)
            check(geom.chunk_rows < T or not geom.memory_in_shared,
                  f"P={P} M={M} B={B} T={T} is not a ring or device-memory "
                  f"case: {geom}")
            f["op"][T // 2:T // 2 + 40] = OPCODE["NOP"]
        kinds[kind] = kinds.get(kind, 0) + 1
        f = tensors(f, device)
        fields = InstrRow(*(f[k] for k in InstrRow._fields))
        state = PEState(**tensors(random_state(rng, B, P, M), device))
        plain, plain_outs = run_cycles_ref(fields, state, nbr)
        chain, chain_outs = state, []
        for t in range(T):
            chain = cycle_step(chain, InstrRow(*(x[t] for x in fields)), nbr)
            chain_outs.append(chain.out)
        for layout in layouts:
            what = f"{kind} P={P} M={M} B={B} T={T} layout={layout}"
            final, outs = run_cycles(fields, state, nbr, layout=layout)
            lname = LAYOUT_NAMES[run_cycles_geometry(B, P, M, 1, T,
                                                     layout).layout]
            layout_runs[lname] = layout_runs.get(lname, 0) + (T > 0)
            for t in range(T):
                diff = max_diff(outs[t], chain_outs[t])
                worst = max(worst, diff)
                check(diff == 0, f"{what}: out at row {t} differs from the "
                                 f"cycle-step chain by {diff}")
            check(tuple(outs.shape) == (T, B, P),
                  f"trace shape {outs.shape}")
            diff = max_diff(outs, plain_outs)
            worst = max(worst, diff)
            check(diff == 0, f"{what}: trace differs from the plain version "
                             f"by {diff}")
            untraced, _ = run_cycles(fields, state, nbr, trace=False,
                                     layout=layout)
            for name, a, b, c, d in zip(PEState._fields, final, plain, chain,
                                        untraced):
                diff = max(max_diff(a, b), max_diff(a, c), max_diff(a, d))
                worst = max(worst, diff)
                check(diff == 0, f"{what}: final {name} differs by {diff}")
            want += 2 * (T > 0)
    launches = run_cycles.launches - before
    check(launches == want, f"run_cycles launched {launches} times for "
                            f"{want // 2} runs with rows, traced and not")
    check(all(layout_runs.get(n, 0) > 0 for n in LAYOUT_NAMES),
          f"phase 3c ran a layout no time: {layout_runs}")
    emit({"phase": "run_cycles_vs_plain", "cases": len(cases),
          "cases_by_kind": kinds, "runs_by_layout": layout_runs,
          "hazard_pes": list(HAZARD_PES),
          "rows_each": SWEEP_STEPS, "run_cycles_launches": launches,
          "max_abs_err": worst, "seconds": round(time.monotonic() - t0, 3)})
    return worst


def hazard_layouts(P: int, M: int):
    """The layouts a hazard program runs in: the uniform one, and the lane
    one where P PEs over M words fit it."""
    from repro_torch.kernels.pe_array import (LANE_LAYOUT, UNIFORM_LAYOUT,
                                              lanes_fit)

    return (UNIFORM_LAYOUT,) + ((LANE_LAYOUT,) if lanes_fit(P, M) else ())


def check_stack(fields, state, nbr, singles, what: str,
                layout=None) -> int:
    """One stacked launch of NOP-padded programs (in ``layout``, or the
    one chosen for the shape) against the plain version and against a
    single launch of each unpadded program (``singles``): trace, padding
    rows and every final-state tensor bit-equal.  Returns the largest
    absolute difference seen (0, or it raises)."""
    from repro_torch.kernels.pe_array import run_cycles
    from repro_torch.kernels.ref import PEState, run_stacked_ref

    K, T_max, P = fields.op.shape
    B = state.out.shape[1]
    before = run_cycles.launches
    final, outs = run_cycles(fields, state, nbr, layout=layout)
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
            last = s_outs[-1] if T else state.out[k]
            diff = max(diff, max_diff(outs[k, T:], last.expand(
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
    against K single launches of the unpadded programs: random programs,
    then stacks of the hazard programs whose lengths run from 0 to T_max,
    at every P of ``HAZARD_PES``, in each layout that takes the shape.
    Returns the largest absolute difference seen."""
    import numpy as np
    import torch
    from repro_torch.cgra.arch import neighbor_table
    from repro_torch.fuzz.engine import _pad_fields
    from repro_torch.kernels.ref import InstrRow, PEState
    from repro_torch.kernels.sample import (HAZARDS, hazard_fields,
                                            random_fields, random_state)

    M = 128
    cases = [(K, P, B, "random", None) for K in (1, 2, 5) for P in (9, 16)
             for B in (1, 37, 1000)]
    cases += [(len(HAZARD_LENGTHS), P, B, "hazard", layout)
              for P in HAZARD_PES for B in HAZARD_BATCHES
              for layout in hazard_layouts(P, M)]
    worst = 0
    t0 = time.monotonic()
    for K, P, B, kind, layout in cases:
        nbr = torch.as_tensor(np.asarray(neighbor_table(grid_for(P)),
                                         np.int32), device=device)
        rng = np.random.RandomState(11 + K * 1009 + P * 101 + B)
        if kind == "random":
            lengths = [SWEEP_STEPS * (5 - k) // 5 for k in range(K)]
            progs = [random_fields(rng, T, P, M, full_encoding=True)
                     for T in lengths]
        else:
            lengths = [SWEEP_STEPS * n // 8 for n in HAZARD_LENGTHS]
            progs = [{k: v[:T] for k, v in hazard_fields(
                rng, HAZARDS[i % len(HAZARDS)], SWEEP_STEPS, P, M).items()}
                for i, T in enumerate(lengths)]
        states = [random_state(rng, B, P, M) for _ in range(K)]
        singles = [InstrRow(*(torch.as_tensor(f[n], device=device)
                              for n in InstrRow._fields)) for f in progs]
        fields = InstrRow(*(torch.stack(fs) for fs in zip(
            *(_pad_fields(f, SWEEP_STEPS) for f in singles))))
        state = PEState(*(torch.as_tensor(np.stack([s[k] for s in states]),
                                          device=device)
                          for k in PEState._fields))
        worst = max(worst, check_stack(
            fields, state, nbr, singles,
            f"{kind} K={K} P={P} B={B} layout={layout}", layout))
    emit({"phase": "stacked_vs_plain", "cases": len(cases),
          "hazard_lengths": [SWEEP_STEPS * n // 8 for n in HAZARD_LENGTHS],
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
    return seconds


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


def main_path(artifacts, device, cache, warm=False):
    """Phase 4: the fuzz path on every shipped kernel, each mapped live
    into ``cache`` (a fresh directory), or, with ``warm``, answered from
    it.  Returns the launches of (cycle_step, run_cycles) over the run,
    the reports and the artifacts ``fuzz_kernel`` built."""
    from repro_torch.fuzz.engine import fuzz_kernel
    from repro_torch.kernels.pe_array import cycle_step, run_cycles

    bench = json.loads((ROOT / "results" / "BENCH_fuzz.json").read_text())
    expected_status = {row["kernel"]: row["status"] for row in bench["rows"]}
    chunks = -(-MAIN_MEMORIES // MAIN_BATCH)
    rows_run = sum(a.asm.total_rows * chunks for a in artifacts)
    phase = "main_path_warm" if warm else "main_path"
    t0 = time.monotonic()
    with recorded_artifacts() as made:
        cycle_step.launches = run_cycles.launches = 0
        run_cycles.lane_launches = 0
        reports = [fuzz_kernel(a.kernel, a.arch, memories=MAIN_MEMORIES,
                               batch=MAIN_BATCH, seed=0, config=map_config(),
                               cache=cache, device=device)
                   for a in artifacts]
        steps, runs = cycle_step.launches, run_cycles.launches
        lanes = run_cycles.lane_launches
    wall = time.monotonic() - t0
    LAYOUT_LAUNCHES[phase] = {"lane": lanes, "uniform": runs - lanes}
    for rep in reports:
        emit({"phase": "fuzz_warm" if warm else "fuzz", "kernel": rep.kernel,
              "arch": rep.arch,
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
    check(lanes == runs, f"{phase}: {runs - lanes} of {runs} launches at "
                         f"B={MAIN_BATCH} left the lane layout")
    check(sorted(made) == sorted(a.kernel for a in artifacts),
          f"{phase}: fuzz_kernel built artifacts for {sorted(made)}")
    emit({"phase": phase, "kernels": len(reports),
          "memories_each": MAIN_MEMORIES, "batch": MAIN_BATCH,
          "run_cycles_launches": runs, "cycle_step_launches": steps,
          "layout_launches": LAYOUT_LAUNCHES[phase],
          "rows_run": rows_run, "cache": cache.stats(),
          "cache_entries": len(cache),
          "map_seconds": round(sum(r.map_time_s for r in reports), 3),
          "seconds": round(wall, 3)})
    return steps, runs, reports, made


def main_path_warm(artifacts, device, cache, cold_reports, cold_made,
                   cold_seconds):
    """Phase 4e: the 16 kernels again through the main path's cache: 16
    hits, no new entry, each artifact equal to the cold pass's, and
    status, failing memories, activity and energy equal.  Returns the
    launches of run_cycles over the run."""
    hits, misses = cache.stats()["hits"], cache.stats()["misses"]
    check(hits == 0 and misses == len(artifacts) == len(cache),
          f"cold pass: cache {cache.stats()}, {len(cache)} entries")
    t0 = time.monotonic()
    steps, runs, reports, made = main_path(artifacts, device, cache,
                                           warm=True)
    wall = time.monotonic() - t0
    stats = cache.stats()
    check(stats["hits"] == len(artifacts) and stats["misses"] == misses
          and len(cache) == len(artifacts),
          f"warm pass: cache {stats}, {len(cache)} entries")
    cold = {r.kernel: r for r in cold_reports}
    for rep in reports:
        was = cold[rep.kernel]
        check(made[rep.kernel].to_dict() == cold_made[rep.kernel].to_dict(),
              f"{rep.kernel}: warm artifact differs from the cold one")
        check((rep.status, rep.ii, rep.failing, rep.activity, rep.energy)
              == (was.status, was.ii, was.failing, was.activity, was.energy),
              f"{rep.kernel}: warm report differs from the cold one")
    emit({"phase": "main_path_warm_summary", "kernels": len(reports),
          "cache_hits": stats["hits"], "artifacts_equal": len(reports),
          "reports_equal": len(reports),
          "cold_seconds": round(cold_seconds, 3),
          "warm_seconds": round(wall, 3),
          "cold_map_seconds": round(sum(r.map_time_s
                                        for r in cold_reports), 3),
          "warm_map_seconds": round(sum(r.map_time_s for r in reports), 3)})
    return runs


def fleet_phase(artifacts, device):
    """Phase 7a: ``compile_many`` over the 16 shipped (kernel, arch)
    points (``points=``, CDCL, a fresh cache) on min(8, CPUs) worker
    processes forked after CUDA is up: 16 of 16 ``ok``, no failure, the
    shipped II, and each mapping equal to the shipped artifact's or, where
    not, to the parent's own solve on the grid as a worker receives it
    (pickled: ``PEGrid`` neighbour sets come back in another iteration
    order, which the encoder follows, in both packages; ROADMAP.md
    section 3); every fleet bitstream fuzzed ``ok`` on the card over 2048
    memories.  Then the same call again answers all 16 from the cache.
    Returns the fleet's results by kernel and the run_cycles launches of
    the fuzz check."""
    import multiprocessing
    import pickle

    from repro_torch.cgra.artifact import ARTIFACT_ROOT, Artifact
    from repro_torch.fuzz.corpus import make_corpus
    from repro_torch.fuzz.engine import fuzz_program
    from repro_torch.kernels.pe_array import cycle_step, run_cycles
    from repro_torch.toolchain import Toolchain

    kernels = [a.kernel for a in artifacts]
    grids = ["4x4", "3x3"]
    points = [(a.kernel, grids.index(a.arch)) for a in artifacts]
    jobs = min(8, os.cpu_count() or 1)
    cache = fresh_cache("fleet")
    tc = Toolchain("4x4", map_config(), cache=cache)
    cycle_step.launches = run_cycles.launches = 0
    t0 = time.monotonic()
    cold = tc.compile_many(kernels, grids, jobs=jobs, points=points)
    cold_s = time.monotonic() - t0
    t1 = time.monotonic()
    warm = tc.compile_many(kernels, grids, jobs=jobs, points=points)
    warm_s = time.monotonic() - t1
    check(run_cycles.launches == cycle_step.launches == 0,
          "the compile fleet launched a kernel")
    as_shipped, as_worker = [], []
    for cr, again, art in zip(cold, warm, artifacts):
        check((cr.kernel, cr.arch or cr.size) == (art.kernel, art.arch),
              f"fleet row {cr.kernel}@{cr.size} for {art.kernel}@{art.arch}")
        check(cr.ok and cr.failure is None and not cr.cache_hit
              and not cr.map_result.validation_errors,
              f"fleet {cr.kernel}: {cr.status} {cr.error} {cr.failure}")
        fresh = Artifact.from_mapping(cr.program.builder,
                                      cr.map_result.mapping, arch=art.arch)
        shipped = json.loads(
            (ARTIFACT_ROOT / art.arch / f"{art.kernel}.json").read_text())
        check(cr.ii == shipped["ii"],
              f"fleet {cr.kernel}: II {cr.ii} != shipped {shipped['ii']}")
        if fresh.to_dict() == shipped:
            as_shipped.append(cr.kernel)
        else:
            grid = pickle.loads(pickle.dumps(cr.map_result.mapping.grid))
            own = Toolchain(grid, map_config()).map(cr.kernel)
            check(own.mapping.to_dict() == cr.map_result.mapping.to_dict(),
                  f"fleet {cr.kernel}: mapping differs from the shipped one "
                  f"and from the parent's solve on the worker's grid")
            as_worker.append(cr.kernel)
        check(again.ok and again.cache_hit and again.ii == cr.ii,
              f"fleet {cr.kernel}: second call {again.status}, hit "
              f"{again.cache_hit}")
        rep = fuzz_program(fresh, make_corpus(fresh, MAIN_MEMORIES, seed=0),
                           batch=MAIN_BATCH, device=device)
        check(rep.status == "ok" and rep.failing == [],
              f"fleet {cr.kernel}: fuzz {rep.status} {rep.mismatches[:2]}")
    runs = run_cycles.launches
    chunks = -(-MAIN_MEMORIES // MAIN_BATCH)
    check(runs == len(cold) * chunks and cycle_step.launches == 0,
          f"fleet fuzz check launched run_cycles {runs} times")
    emit({"phase": "fleet", "points": len(cold), "ok": len(cold),
          "ii_equal_to_shipped": len(cold),
          "mapping_equal_to_shipped": as_shipped,
          "mapping_equal_to_worker_grid_solve": as_worker,
          "fuzz_ok": len(cold), "run_cycles_launches": runs, "jobs": jobs,
          "cpu_count": os.cpu_count(), "wall_seconds": round(cold_s, 3),
          "map_seconds_summed": round(sum(c.map_time_s for c in cold), 3),
          "warm_cache_hits": sum(c.cache_hit for c in warm),
          "warm_wall_seconds": round(warm_s, 3),
          "start_method": multiprocessing.get_start_method()})
    return {cr.kernel: cr for cr in cold}, runs


def race_phase(device, seq_seconds):
    """Phase 7b: fir4 and stencil3 at 4x4 raced with ``RACE_STRATEGY`` on
    ``RACE_JOBS`` workers: each ``mapped`` at its shipped II, its
    bitstream fuzzed over 2048 memories on the card ``ok``; race wall
    seconds beside phase ``map``'s sequential seconds.  Then gsm with
    ``portfolio:auto`` (z3 where installed) must come out ``ok``.
    Returns the launches of run_cycles over the phase."""
    from repro_torch.cgra.artifact import Artifact, load_artifact
    from repro_torch.core.backends import parse_portfolio
    from repro_torch.fuzz.corpus import make_corpus
    from repro_torch.fuzz.engine import fuzz_program
    from repro_torch.kernels.pe_array import cycle_step, run_cycles
    from repro_torch.toolchain import Toolchain

    cases = [(k, RACE_STRATEGY) for k in RACE_KERNELS] + \
        [("gsm", "portfolio:auto")]
    cycle_step.launches = run_cycles.launches = 0
    for kernel, strategy in cases:
        shipped = load_artifact("4x4", kernel)
        tc = Toolchain("4x4", map_config(backend="auto", strategy=strategy))
        prog = tc.program(kernel)
        t0 = time.monotonic()
        res = tc.map(prog, jobs=RACE_JOBS)
        race_s = time.monotonic() - t0
        check(res.status == "mapped" and res.strategies_raced >= 2,
              f"race {kernel} ({strategy}): {res.status}, "
              f"{res.strategies_raced} raced")
        if strategy == RACE_STRATEGY:
            check(res.ii == shipped.asm.ii,
                  f"race {kernel}: II {res.ii} != shipped {shipped.asm.ii}")
        art = Artifact.from_mapping(prog.builder, res.mapping, arch="4x4")
        rep = fuzz_program(art, make_corpus(art, MAIN_MEMORIES, seed=0),
                           batch=MAIN_BATCH, device=device)
        check(rep.status == "ok" and rep.failing == [] and
              rep.backend == "cuda",
              f"race {kernel}: fuzz {rep.status} {rep.mismatches[:2]}")
        emit({"phase": "race", "kernel": kernel, "strategy": strategy,
              "roster": [s.name for s in
                         parse_portfolio(strategy).available().strategies],
              "jobs": RACE_JOBS, "status": res.status, "ii": res.ii,
              "shipped_ii": shipped.asm.ii, "winner": res.winner,
              "strategies_raced": res.strategies_raced,
              "cancelled_after_s": res.cancelled_after_s,
              "race_seconds": round(race_s, 3),
              "sequential_map_seconds": seq_seconds.get(kernel),
              "fuzz": rep.status, "memories": rep.memories})
    steps, runs = cycle_step.launches, run_cycles.launches
    chunks = -(-MAIN_MEMORIES // MAIN_BATCH)
    check(runs == len(cases) * chunks and steps == 0,
          f"race phase launched run_cycles {runs}, cycle_step {steps} times")
    return runs


def fleet_chaos_phase(fleet_rows):
    """Phase 7c: ``REPRO_CHAOS`` crashes every worker's first attempt on
    a two-point ``compile_many`` forked after CUDA is up: both points
    heal on the retry, their failure recorded as a worker crash, at the
    II of the clean fleet run."""
    from repro_torch.kernels.pe_array import run_cycles
    from repro_torch.toolchain import FailureKind, Toolchain
    from repro_torch.toolchain.chaos import ENV_KEY, ChaosSpec

    kernels = ["gsm", "dotprod"]
    spec = ChaosSpec(seed=0, rate=1.0, kinds=("crash",), attempts=(0,))
    os.environ[ENV_KEY] = spec.to_json()
    run_cycles.launches = 0
    t0 = time.monotonic()
    try:
        rows = Toolchain("4x4", map_config()).compile_many(kernels, jobs=2)
    finally:
        del os.environ[ENV_KEY]
    wall = time.monotonic() - t0
    check(run_cycles.launches == 0, "the chaos fleet launched a kernel")
    for cr in rows:
        check(cr.ok and cr.retries == 1
              and cr.failure_kind == FailureKind.WORKER_CRASH
              and cr.ii == fleet_rows[cr.kernel].ii,
              f"chaos {cr.kernel}: {cr.status} retries {cr.retries} "
              f"failure {cr.failure} II {cr.ii}")
    emit({"phase": "fleet_chaos", "points": len(rows), "healed": len(rows),
          "failure_kinds": [cr.failure_kind for cr in rows],
          "messages": [cr.failure["message"] for cr in rows],
          "iis": [cr.ii for cr in rows], "seconds": round(wall, 3)})


def sweep_smoke_phase() -> None:
    """Phase 8a: ``run_smoke``, the port's ``sweep --smoke``
    (``SMOKE_KERNELS`` x ``SMOKE_SIZES``, CDCL, swept twice) into a fresh
    cache: its Pareto bytes equal those of the committed
    ``results/BENCH_dse.json``, which is read and never written, and the
    second pass answers all 12 points from the cache."""
    from repro_torch.dse.cli import pareto_bytes, run_smoke
    from repro_torch.kernels.pe_array import run_cycles

    committed = ROOT / "results" / "BENCH_dse.json"
    before = committed.read_bytes()
    jobs = min(8, os.cpu_count() or 1)
    out = fresh_dir(SWEEP_ROOT / "smoke") / "BENCH_dse.json"
    run_cycles.launches = 0
    t0 = time.monotonic()
    # run_smoke prints a BENCH line a point; keep them beside its output
    with open(out.with_suffix(".log"), "w") as log, \
            contextlib.redirect_stdout(log):
        doc = run_smoke(out=str(out), jobs=jobs,
                        cache_dir=str(fresh_dir(CACHE_ROOT / "sweep_smoke")))
    wall = time.monotonic() - t0
    check(run_cycles.launches == 0, "the smoke sweep launched a kernel")
    points = len(doc["points"])
    check(points == 12 and doc["errors"] == 0,
          f"smoke sweep: {points} points, {doc['errors']} errors")
    check(doc["cache"]["hits"] == points and doc["cache"]["misses"] == 0,
          f"smoke sweep second pass: cache {doc['cache']}")
    check(pareto_bytes(doc) == pareto_bytes(json.loads(before)),
          "smoke sweep: Pareto bytes differ from results/BENCH_dse.json")
    check(committed.read_bytes() == before,
          "smoke sweep rewrote results/BENCH_dse.json")
    emit({"phase": "sweep_smoke", "points": points,
          "second_pass_hits": doc["cache"]["hits"],
          "pareto_equal_to_committed": True,
          "pareto_identical_on_repeat": doc["repeat_check"][
              "pareto_identical"],
          "summary": doc["pareto"]["summary"], "jobs": jobs,
          "first_pass_seconds": doc["repeat_check"]["first_run_wall_s"],
          "seconds": round(wall, 3)})


def shape_vs_plain(row, cfg, cache_dir, device) -> int:
    """Phase 8b, before the first fuzz of a grid shape new to the card:
    the swept artifact of ``row`` (replayed from the sweep's cache) through
    ``run_program`` at B=1024 against the plain loop ``run_cycles_ref`` on
    the card, trace and final state bit-equal.  Returns the largest
    absolute difference."""
    import numpy as np
    import torch
    from repro_torch.cgra.arch import neighbor_table
    from repro_torch.cgra.artifact import Artifact
    from repro_torch.cgra.simulator import preset_state
    from repro_torch.dse import MappingCache
    from repro_torch.fuzz.corpus import make_corpus
    from repro_torch.kernels.ops import decode_fields, run_program
    from repro_torch.kernels.ref import run_cycles_ref
    from repro_torch.toolchain import Toolchain

    size = row["size"]
    tc = Toolchain(size, cfg.mapper_config(), cache=MappingCache(cache_dir))
    prog = tc.program(row["kernel"])
    res = tc.map(prog)
    check(tc.last_cache_hit and res.mapping is not None
          and res.mapping.ii == row["ii"],
          f"{row['kernel']}@{size}: not replayed from the sweep's cache")
    art = Artifact.from_mapping(prog.builder, res.mapping, arch=size)
    mems = make_corpus(art, MAIN_BATCH, seed=7)
    fields = decode_fields(art.asm.words(), device)
    state = preset_state(art.asm, art.grid.num_pes, mems, MAIN_BATCH, device)
    nbr = neighbor_table(art.grid)
    final, outs = run_program(fields, state, nbr, device)
    plain, plain_outs = run_cycles_ref(
        fields, state, torch.as_tensor(np.asarray(nbr, np.int32),
                                       device=device))
    diffs = {"out trace": max_diff(outs, plain_outs)}
    diffs.update((name, max_diff(a, b))
                 for name, a, b in zip(plain._fields, final, plain))
    worst = max(diffs.values())
    check(worst == 0, f"{art.kernel}@{size}: kernel differs from the plain "
                      f"loop {diffs}")
    emit({"phase": "sweep_shape_vs_plain", "kernel": art.kernel,
          "size": size, "P": art.grid.num_pes, "rows": art.asm.total_rows,
          "batch": MAIN_BATCH, "neighbors": nbr, "max_abs_err": worst})
    return worst


def sweep_phase(device):
    """Phase 8b: the paper's design-space sweep at full width, the size
    ladder ``DEFAULT_SIZES`` (2x2 to 6x6) over the registry kernels less
    ``SWEEP_CUT``, through ``run_sweep`` (CDCL, the sweep's own budgets,
    min(8, CPUs) workers forked after CUDA is up, a fresh cache) under
    tracing.  Every ``mapped`` point is then fuzzed on the card through
    ``fuzz_kernel`` from the sweep's cache (each map a hit), 2048 memories
    in batches of 1024, every verdict ``ok`` but those of
    ``REFERENCE_MISMATCHES``, whose mismatch must equal the CPU path's on
    the same memories; each grid shape new to the card is first held to
    the plain loop (``shape_vs_plain``).  Returns the sweep's rows, the
    run_cycles launches of the fuzz runs, the largest kernel-vs-plain
    difference and the trace directory."""
    from repro_torch.dse import (DEFAULT_KERNELS, DEFAULT_SIZES,
                                 MappingCache, SweepConfig, run_sweep)
    from repro_torch.fuzz.corpus import make_corpus
    from repro_torch.fuzz.engine import fuzz_kernel, fuzz_program
    from repro_torch.kernels.pe_array import cycle_step, run_cycles
    from repro_torch.obs import trace as obs_trace

    kernels = tuple(k for k in DEFAULT_KERNELS if k not in SWEEP_CUT)
    jobs = min(8, os.cpu_count() or 1)
    cache_dir = str(fresh_dir(CACHE_ROOT / "sweep"))
    trace_dir = fresh_dir(SWEEP_ROOT / "trace")
    cfg = SweepConfig(kernels=kernels, sizes=DEFAULT_SIZES, backend="cdcl",
                      jobs=jobs, cache_dir=cache_dir)
    emit({"phase": "sweep_plan", "kernels": list(kernels),
          "sizes": [f"{r}x{c}" for r, c in DEFAULT_SIZES],
          "points": len(kernels) * len(DEFAULT_SIZES),
          "cut": list(SWEEP_CUT),
          "why_cut": "no mapping under pure-Python CDCL within a sweep "
                     "point's budget", "backend": cfg.backend, "jobs": jobs,
          "per_point_timeout_s": cfg.per_point_timeout_s,
          "per_ii_timeout_s": cfg.per_ii_timeout_s, "ii_max": cfg.ii_max})
    cycle_step.launches = run_cycles.launches = 0
    obs_trace.enable(str(trace_dir))
    t0 = time.monotonic()
    try:
        doc = run_sweep(cfg)
    finally:
        obs_trace.disable()
    sweep_s = time.monotonic() - t0
    check(run_cycles.launches == cycle_step.launches == 0,
          "the sweep's mapping launched a kernel")
    rows = doc["points"]
    check(doc["errors"] == 0
          and len(rows) == len(kernels) * len(DEFAULT_SIZES),
          f"sweep: {doc['errors']} errors over {len(rows)} points")
    mapped = [r for r in rows if r["status"] == "mapped"]
    check(len(mapped) > 0, "sweep mapped no point")
    worst, shapes = 0, {}
    for row in mapped:
        if row["size"] not in SHIPPED_SHAPES and row["size"] not in shapes:
            shapes[row["size"]] = row["kernel"]
            worst = max(worst, shape_vs_plain(row, cfg, cache_dir, device))
    cache = MappingCache(cache_dir)
    cycle_step.launches = run_cycles.launches = 0
    run_cycles.lane_launches = 0
    t1 = time.monotonic()
    verdicts = {}
    for row in rows:
        point = (row["kernel"], row["size"])
        line = {"phase": "sweep_point", "kernel": row["kernel"],
                "size": row["size"], "status": row["status"],
                "ii": row["ii"], "mii": row.get("mii"),
                "map_time_s": row["map_time_s"]}
        if row["status"] == "mapped":
            with recorded_artifacts() as made:
                rep = fuzz_kernel(row["kernel"], arch=row["size"],
                                  memories=MAIN_MEMORIES, batch=MAIN_BATCH,
                                  seed=0, config=cfg.mapper_config(),
                                  cache=cache, device=device)
            want = "mismatch" if point in REFERENCE_MISMATCHES else "ok"
            check(rep.status == want and rep.backend == "cuda"
                  and rep.ii == row["ii"],
                  f"sweep {row['kernel']}@{row['size']}: fuzz {rep.status} "
                  f"(not {want}) II {rep.ii} {rep.mismatches[:2]}")
            if want == "mismatch":
                n = REFERENCE_CPU_MEMORIES
                mems = make_corpus(row["kernel"], MAIN_MEMORIES, seed=0)[:n]
                cpu = fuzz_program(made[row["kernel"]], mems, batch=n,
                                   device="cpu")
                check(cpu.status == "mismatch"
                      and cpu.failing == [i for i in rep.failing if i < n]
                      and cpu.mismatches == rep.mismatches,
                      f"sweep {row['kernel']}@{row['size']}: the card's "
                      f"mismatch differs from the CPU path's")
                line.update(failing=len(rep.failing),
                            failing_equal_to_cpu=n,
                            mismatch=rep.mismatches[0])
            verdicts[rep.status] = verdicts.get(rep.status, 0) + 1
            line.update(latency_cycles=row["latency_cycles"],
                        energy_nj=row["energy_nj"],
                        activity_energy_nj=rep.energy["empirical_total_nj"],
                        fuzz=rep.status, mem_rate=rep.mem_rate)
        emit(line)
    fuzz_s = time.monotonic() - t1
    check(all(r["status"] == "mapped" for r in rows
              if (r["kernel"], r["size"]) in REFERENCE_MISMATCHES),
          "sweep: a point of REFERENCE_MISMATCHES did not map")
    steps, runs = cycle_step.launches, run_cycles.launches
    lanes = run_cycles.lane_launches
    LAYOUT_LAUNCHES["sweep"] = {"lane": lanes, "uniform": runs - lanes}
    stats = cache.stats()
    check(stats["hits"] == len(mapped) and stats["misses"] == 0,
          f"sweep fuzz: cache {stats} for {len(mapped)} mapped points")
    check(runs == len(mapped) * -(-MAIN_MEMORIES // MAIN_BATCH)
          and steps == 0,
          f"sweep fuzz launched run_cycles {runs}, cycle_step {steps} times")
    pareto = doc["pareto"]
    emit({"phase": "sweep_pareto", "summary": pareto["summary"],
          "per_kernel": {k: {"retained_fraction": v["retained_fraction"],
                             "pruned_fraction": v["pruned_fraction"],
                             "runtime_front": v["runtime_front"],
                             "compiler_front": v["compiler_front"]}
                         for k, v in pareto["per_kernel"].items()}})
    statuses = {}
    for r in rows:
        statuses[r["status"]] = statuses.get(r["status"], 0) + 1
    emit({"phase": "sweep", "points": len(rows), "statuses": statuses,
          "not_mapped": [f"{r['kernel']}@{r['size']} {r['status']}"
                         for r in rows if r["status"] != "mapped"],
          "fuzz_verdicts": verdicts,
          "reference_mismatches": [f"{k}@{s}"
                                   for k, s in REFERENCE_MISMATCHES],
          "fuzz_cache_hits": stats["hits"],
          "new_shapes_vs_plain": shapes, "run_cycles_launches": runs,
          "layout_launches": LAYOUT_LAUNCHES["sweep"], "jobs": jobs, "sweep_seconds": round(sweep_s, 3),
          "sweep_wall_time_s": doc["wall_time_s"],
          "map_seconds_summed": round(sum(r["map_time_s"] for r in rows), 3),
          "fuzz_seconds": round(fuzz_s, 3)})
    return rows, runs, worst, trace_dir


def heuristic_phase(device, sweep_rows) -> int:
    """Phase 8c: the paper's Fig. 7 / Table 4 on the card.  For each of
    ``HEURISTIC_KERNELS`` at ``HEURISTIC_SIZES``, ``map_dfg_heuristic``
    under ``HEURISTIC_CONFIG`` beside phase ``sweep``'s SAT row (no
    mapping again); every heuristic mapping passes ``validate_mapping``,
    and every routing-free one runs on the card over 2048 memories of its
    corpus (two launches) with no mismatch.  Mappings with routing nodes
    are counted, not run: their MOV nodes are not wired to the program's
    source table.  SAT II <= heuristic II is counted, not asserted (it
    fails on some random DFGs in the JAX package too).  Returns the
    launches of run_cycles over the phase."""
    from repro_torch.cgra.arch import make_grid
    from repro_torch.cgra.artifact import Artifact
    from repro_torch.cgra.registry import kernel_program
    from repro_torch.core import (HeuristicConfig, map_dfg_heuristic,
                                  validate_mapping)
    from repro_torch.fuzz.corpus import make_corpus
    from repro_torch.fuzz.engine import fuzz_program
    from repro_torch.kernels.pe_array import cycle_step, run_cycles

    sat = {(r["kernel"], r["size"]): r for r in sweep_rows}
    tally = {"sat_better": 0, "equal": 0, "sat_worse": 0, "only_sat": 0,
             "only_heuristic": 0, "neither": 0}
    mapped = executed = routed = 0
    cycle_step.launches = run_cycles.launches = 0
    t0 = time.monotonic()
    for kernel in HEURISTIC_KERNELS:
        prog = kernel_program(kernel)
        for size in HEURISTIC_SIZES:
            rows, cols = map(int, size.split("x"))
            t1 = time.monotonic()
            res = map_dfg_heuristic(prog.build_dfg(), make_grid(rows, cols),
                                    HeuristicConfig(**HEURISTIC_CONFIG))
            heur_s = time.monotonic() - t1
            s_row = sat[(kernel, size)]
            line = {"phase": "heuristic_cell", "kernel": kernel, "size": size,
                    "sat_status": s_row["status"], "sat_ii": s_row["ii"],
                    "heuristic_status": res.status,
                    "heuristic_ii": res.mapping.ii if res.mapping else None,
                    "heuristic_seconds": round(heur_s, 4)}
            if res.mapping is not None:
                mapped += 1
                errors = validate_mapping(res.mapping)
                check(errors == [], f"heuristic {kernel}@{size}: {errors}")
                line["routing_nodes"] = res.mapping.routing_nodes
                if res.mapping.routing_nodes:
                    routed += 1
                else:
                    art = Artifact.from_mapping(prog, res.mapping, arch=size)
                    rep = fuzz_program(art, make_corpus(art, MAIN_MEMORIES,
                                                        seed=0),
                                       batch=MAIN_BATCH, device=device)
                    check(rep.status == "ok" and rep.failing == []
                          and rep.backend == "cuda",
                          f"heuristic {kernel}@{size}: fuzz {rep.status} "
                          f"{rep.mismatches[:2]}")
                    executed += 1
                    line.update(fuzz=rep.status, memories=rep.memories)
            if s_row["ii"] is not None and res.mapping is not None:
                d = s_row["ii"] - res.mapping.ii
                tally["sat_better" if d < 0 else "sat_worse" if d > 0
                      else "equal"] += 1
            else:
                tally["only_sat" if s_row["ii"] is not None
                      else "only_heuristic" if res.mapping is not None
                      else "neither"] += 1
            emit(line)
    steps, runs = cycle_step.launches, run_cycles.launches
    check(runs == executed * -(-MAIN_MEMORIES // MAIN_BATCH) and steps == 0,
          f"heuristic phase launched run_cycles {runs}, cycle_step {steps} "
          f"times for {executed} runs")
    emit({"phase": "heuristic", "cells": len(HEURISTIC_KERNELS)
          * len(HEURISTIC_SIZES), "mapped": mapped, "validated": mapped,
          "routing_free_run_ok": executed, "with_routing_not_run": routed,
          "sat_vs_heuristic": tally, "run_cycles_launches": runs,
          "seconds": round(time.monotonic() - t0, 3)})
    return runs


def mapping_split(records):
    """Seconds of encoding (KMS + CNF), SAT search and the CEGAR oracle,
    summed by the outcome of the II ladder they ran under (``mapped``,
    ``timeout``, ...), with the ladders' count and the search split by the
    solver's answer."""
    spans = {r["span"]: r for r in records if r.get("k") == "span"}

    def ladder_of(rec):
        while rec is not None and rec["name"] != "mapper.ladder":
            rec = spans.get(rec.get("parent"))
        return rec

    split, by_answer = {}, {}
    for rec in spans.values():
        if rec["name"] == "mapper.ladder":
            row = split.setdefault(rec["attrs"].get("status"), {})
            row["ladders"] = row.get("ladders", 0) + 1
        elif rec["name"] in ("mapper.encode", "solver.solve",
                             "mapper.oracle"):
            ladder = ladder_of(rec)
            row = split.setdefault(
                ladder["attrs"].get("status") if ladder else None, {})
            row[rec["name"]] = row.get(rec["name"], 0.0) + rec["dur"]
            if rec["name"] == "solver.solve":
                answer = rec["attrs"].get("status")
                by_answer[answer] = by_answer.get(answer, 0.0) + rec["dur"]
    rounded = {k: {n: round(v, 3) for n, v in row.items()}
               for k, row in split.items()}
    return rounded, {k: round(v, 3) for k, v in by_answer.items()}


def trace_phase(trace_dir) -> None:
    """Phase 8d: the report of phase ``sweep``'s trace: it validates, its
    roots are at least ``TRACE_FLOOR`` covered by named child spans, and
    the ten span names with the most total seconds and ``mapping_split``
    give the split of mapping time on this host."""
    from repro_torch.obs.report import attribution, load, validate

    records = load(str(trace_dir))
    problems = validate(records)
    check(records and problems == [],
          f"sweep trace: {len(records)} records, problems {problems[:3]}")
    att = attribution(records)
    check(att["attributed"] >= TRACE_FLOOR,
          f"sweep trace: roots attributed {att['attributed']} < "
          f"{TRACE_FLOOR}")
    top = sorted(att["by_name"].items(), key=lambda kv: -kv[1]["total_s"])
    split, by_answer = mapping_split(records)
    emit({"phase": "trace", "spans": att["spans"], "events": att["events"],
          "pids": att["pids"], "attributed": att["attributed"],
          "roots": [{k: r[k] for k in ("name", "dur_s", "attributed")}
                    for r in att["roots"]],
          "top_total_s": [dict(row, name=name) for name, row in top[:10]],
          "mapping_split_by_ladder_status": split,
          "solve_seconds_by_answer": by_answer})


def build_workload(kernels, arches, n, seed, zipf_s):
    """The serving lane's request list (``benchmarks/serving.py``):
    Zipf-ranked (kernel, arch) points with round-robin tenants and seeded
    priorities."""
    import random

    points = [(k, a) for k in kernels
              for a in SERVE_KERNEL_ARCHES.get(k, arches)]
    rng = random.Random(seed)
    weights = [1.0 / (rank + 1) ** zipf_s for rank in range(len(points))]
    draws = rng.choices(points, weights=weights, k=n)
    return [{"kernel": k, "arch": a,
             "priority": rng.choice(SERVE_PRIORITIES),
             "tenant": SERVE_TENANTS[i % len(SERVE_TENANTS)]}
            for i, (k, a) in enumerate(draws)]


def serve_projection(summary) -> str:
    """Canonical bytes of a result summary less ``SERVE_VOLATILE_KEYS``:
    what must be identical across a dedup group."""
    stable = {k: v for k, v in summary.items()
              if k not in SERVE_VOLATILE_KEYS}
    return json.dumps(stable, sort_keys=True, separators=(",", ":"))


def request_config(kernel):
    """The mapper overrides one lane request of ``kernel`` carries."""
    return dict(MAP_CONFIG, **SERVE_KERNEL_CONFIG.get(kernel, {}))


def serve_lane(kernels, arches, n, mode, cache_dir, jobs, concurrency,
               inline=False):
    """The serving lane through the port: a ``CompileServer`` (``jobs``
    process workers, or threads with ``inline``) on a free TCP port with
    the mapping cache at ``cache_dir``, driven by one ``ServeClient``
    connection with ``concurrency`` requests in flight, over the workload
    of ``build_workload(kernels, arches, n, SERVE_SEED, SERVE_ZIPF_S)``.
    A rejection, a server error or a client timeout raises.  Returns the
    lane's document, with the keys of ``results/BENCH_serving.json``, and
    the ``(latency_s, "kernel@arch", served)`` of its slowest requests."""
    import asyncio

    from repro_torch.serve import CompileServer, ServeClient

    workload = build_workload(kernels, arches, n, SERVE_SEED, SERVE_ZIPF_S)

    async def drive():
        server = CompileServer(jobs=jobs, inline=inline, cache=cache_dir)
        try:
            host, port = await server.start(port=0)
            client = await ServeClient.connect(host, port)
            sem = asyncio.Semaphore(concurrency)
            results, lat = [None] * n, [0.0] * n

            async def one(i, r):
                async with sem:
                    t0 = time.monotonic()
                    results[i] = await client.compile(
                        r["kernel"], arch=r["arch"],
                        config=request_config(r["kernel"]),
                        priority=r["priority"], tenant=r["tenant"])
                    lat[i] = time.monotonic() - t0

            t0 = time.monotonic()
            await asyncio.wait_for(
                asyncio.gather(*(one(i, r) for i, r in enumerate(workload))),
                SERVE_CLIENT_TIMEOUT_S)
            wall = time.monotonic() - t0
            stats = await client.stats()
            await client.shutdown()
            await server.wait_closed()
            await client.close()
            return results, lat, wall, stats
        finally:
            server.close()

    results, lat, wall, stats = asyncio.run(drive())
    by_point = {}
    for i, r in enumerate(workload):
        by_point.setdefault((r["kernel"], r["arch"]), []).append(i)
    identical, points = 0, []
    for (kernel, arch), idxs in sorted(by_point.items()):
        ref_cr = results[idxs[0]][0]
        ref = serve_projection(ref_cr.summary())
        identical += sum(serve_projection(results[i][0].summary()) == ref
                         for i in idxs[1:])
        s = ref_cr.summary()
        points.append({
            "kernel": kernel, "arch": arch, "requests": len(idxs),
            "status": s["status"], "stage": s["stage"], "error": s["error"],
            "ii": s["ii"], "mii": s["mii"], "map_status": s.get("map_status"),
            "backend": s.get("backend"),
            "utilization": s.get("utilization")})
    unique, duplicates = len(by_point), n - len(by_point)
    slowest = sorted(((lat[i], f"{r['kernel']}@{r['arch']}", results[i][1])
                      for i, r in enumerate(workload)), reverse=True)[:5]
    lat = sorted(lat)

    def pctl(q):
        return lat[min(n - 1, int(q * (n - 1) + 0.5))]

    doc = {
        "bench": "serving", "mode": mode, "seed": SERVE_SEED,
        "zipf_s": SERVE_ZIPF_S, "arches": list(arches),
        "kernels": list(kernels),
        "kernel_arches": {k: v for k, v in sorted(SERVE_KERNEL_ARCHES.items())
                          if k in kernels},
        "kernel_config": {k: v for k, v in sorted(SERVE_KERNEL_CONFIG.items())
                          if k in kernels},
        "backend": MAP_CONFIG["backend"], "n_requests": n,
        "unique_points": unique, "compiles": stats["mapper_invocations"],
        "duplicates": duplicates, "identical_duplicates": identical,
        "dedup_ok": (stats["mapper_invocations"] == unique
                     and identical == duplicates),
        "cache_hit_ratio": round(duplicates / n, 4),
        "served": {"compiled": stats["serving"]["compiled"],
                   "cache": stats["serving"]["cache_hits"],
                   "coalesced": stats["serving"]["coalesced"]},
        "rejected": stats["serving"]["rejected"],
        "errors": stats["serving"]["errors"],
        "throughput_rps": round(n / wall, 2),
        "p50_ms": round(pctl(0.50) * 1e3, 2),
        "p99_ms": round(pctl(0.99) * 1e3, 2),
        "wall_time_s": round(wall, 3), "points": points}
    return doc, slowest


def serve_verbs(cache_dir) -> dict:
    """Phase 8e, second part: ``python -m repro_torch serve`` as a
    subprocess (``--jobs 4``, on ``cache_dir``), then ``submit`` as users
    run it: gsm@4x4, which the lane served, comes from the cache; gsm@2x2,
    which it did not (the CEGAR case), is ``compiled`` and ``mapped`` at
    the II of the port's own ``Toolchain`` in this process; a ``stats``
    request carries ``STATS_SCHEMA`` 2, every field of the v1 golden body
    with its JSON type, and the request-latency percentiles; ``submit
    --shutdown`` stops the server, which exits 0."""
    from repro_torch.serve import request_sync
    from repro_torch.toolchain import Toolchain

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    server = subprocess.Popen(
        [sys.executable, "-m", "repro_torch", "serve", "--port", "0",
         "--jobs", "4", "--cache-dir", cache_dir],
        stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    drain = None
    try:
        banner = server.stderr.readline()
        while banner and "listening on" not in banner:
            banner = server.stderr.readline()
        check("listening on" in banner, "serve verb exited before listening")
        port = banner.split("listening on ")[1].split()[0].rsplit(":", 1)[1]
        # keep reading its stderr, so that a full pipe never blocks it
        drain = threading.Thread(target=server.stderr.read, daemon=True)
        drain.start()

        def submit(kernel, grid, *extra):
            t0 = time.monotonic()
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch", "submit", kernel,
                 "--grid", grid, "--backend", MAP_CONFIG["backend"],
                 "--port", port, "--json", *extra],
                capture_output=True, text=True, env=env, cwd=ROOT,
                timeout=SERVE_CLIENT_TIMEOUT_S)
            check(proc.returncode == 0,
                  f"submit {kernel}@{grid}: rc {proc.returncode} "
                  f"{proc.stderr[-400:]}")
            return json.loads(proc.stdout), time.monotonic() - t0

        hit, hit_s = submit("gsm", "4x4")
        check(hit["served"] == "cache" and hit["cache_hit"]
              and hit["status"] == "ok",
              f"submit gsm@4x4: {hit['served']} {hit['status']}")
        kernel, grid = SERVE_NEW_POINT
        new, new_s = submit(kernel, grid)
        own = Toolchain(grid, map_config()).map(kernel)
        check(new["served"] == "compiled" and new["map_status"] == "mapped"
              and new["status"] == "ok" and new["ii"] == own.ii,
              f"submit {kernel}@{grid}: {new['served']} {new['map_status']} "
              f"II {new['ii']}, the port's Toolchain II {own.ii}")
        stats = request_sync(None, "127.0.0.1", int(port))["stats"]
        golden = json.loads((ROOT / "tests" / "fixtures" /
                             "wire_stats_v1.json").read_text())
        golden.pop("_comment")
        for key, val in golden.items():
            check(type(stats.get(key)) is type(val),
                  f"serve stats: v1 field {key} missing or retyped")
        latency = stats["metrics"]["histograms"]["serve.request_s"]
        check(stats["stats_schema"] == 2 and latency["count"] == 2
              and {"p50", "p90", "p99"} <= set(latency),
              f"serve stats: schema {stats['stats_schema']}, {latency}")
        bye, _ = submit(kernel, grid, "--shutdown")
        check(bye["served"] == "cache", f"submit --shutdown: {bye['served']}")
        rc = server.wait(timeout=60)
        check(rc == 0, f"serve verb exited {rc}")
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()
        if drain is not None:
            drain.join(timeout=10)
        server.stderr.close()
    return {"cache_point": f"gsm@4x4 {hit['served']}",
            "new_point": f"{kernel}@{grid} {new['served']} II {new['ii']}",
            "toolchain_ii": own.ii, "stats_schema": stats["stats_schema"],
            "serving": stats["serving"],
            "request_s": {k: latency[k] for k in ("p50", "p90", "p99")},
            "submit_seconds": {"cache": round(hit_s, 3),
                               "compiled": round(new_s, 3)},
            "server_exit": rc}


def serve_phase(device) -> int:
    """Phase 8e: the compile server at the serving lane's full width.
    The 320 requests of ``benchmarks/serving.py``'s full mode go through
    ``serve_lane`` (``SERVE_JOBS`` process workers forked after CUDA is
    up, a fresh cache) and must equal the committed
    ``results/BENCH_serving.json`` on every point and on the dedup
    contract, timings and the cache/coalesced split apart; then the verbs
    (``serve_verbs``); then every point the server mapped is fuzzed on the
    card through ``fuzz_kernel`` from the server's cache under its
    request's config (each map a hit), 2048 memories, ``ok``.  Returns the
    launches of run_cycles over the fuzz runs."""
    from repro_torch.cgra.registry import kernel_names
    from repro_torch.core.mapper import MapperConfig
    from repro_torch.dse import MappingCache
    from repro_torch.fuzz.engine import fuzz_kernel
    from repro_torch.kernels.pe_array import cycle_step, run_cycles

    committed = json.loads(
        (ROOT / "results" / "BENCH_serving.json").read_text())
    cache_dir = str(fresh_dir(CACHE_ROOT / "serve"))
    emit({"phase": "serve_plan", "requests": SERVE_REQUESTS,
          "kernels": len(kernel_names()), "arches": list(SERVE_ARCHES),
          "kernel_arches": SERVE_KERNEL_ARCHES,
          "kernel_config": SERVE_KERNEL_CONFIG, "jobs": SERVE_JOBS,
          "concurrency": SERVE_CONCURRENCY, "config": MAP_CONFIG})
    cycle_step.launches = run_cycles.launches = 0
    doc, slowest = serve_lane(kernel_names(), list(SERVE_ARCHES),
                              SERVE_REQUESTS, "full", cache_dir, SERVE_JOBS,
                              SERVE_CONCURRENCY)
    check(run_cycles.launches == cycle_step.launches == 0,
          "the compile server launched a kernel")
    for got in doc["points"]:
        emit({"phase": "serve_point", **got})
    wrong = [got for got, want in zip(doc["points"], committed["points"])
             if got != want]
    check(not wrong, f"serve points differ from results/BENCH_serving.json:"
                     f" {wrong[:3]}")
    differ = sorted(k for k in committed
                    if k not in SERVE_TIMED_KEYS and doc[k] != committed[k])
    check(not differ and doc["compiles"] == doc["unique_points"] == 46
          and doc["identical_duplicates"] == doc["duplicates"] == 274,
          f"serve lane differs from results/BENCH_serving.json in {differ}")
    emit({"phase": "serve", "card": card_line(),
          **{k: doc[k] for k in (
              "n_requests", "unique_points", "compiles", "duplicates",
              "identical_duplicates", "cache_hit_ratio", "rejected",
              "errors", "served", "throughput_rps", "p50_ms", "p99_ms",
              "wall_time_s")},
          "slowest_requests_ms": [[round(t * 1e3, 2), point, served]
                                  for t, point, served in slowest],
          "committed_host_wall_time_s": committed["wall_time_s"]})
    emit({"phase": "serve_verbs", **serve_verbs(cache_dir)})

    cache = MappingCache(cache_dir)
    mapped = [p for p in doc["points"] if p["map_status"] == "mapped"]
    t0 = time.monotonic()
    for p in mapped:
        rep = fuzz_kernel(p["kernel"], p["arch"], memories=MAIN_MEMORIES,
                          batch=MAIN_BATCH, seed=0,
                          config=MapperConfig(**request_config(p["kernel"])),
                          cache=cache, device=device)
        check(rep.status == "ok" and rep.backend == "cuda"
              and rep.ii == p["ii"],
              f"served {p['kernel']}@{p['arch']}: fuzz {rep.status} II "
              f"{rep.ii} {rep.mismatches[:2]}")
        emit({"phase": "serve_fuzz", "kernel": p["kernel"],
              "arch": p["arch"], "ii": rep.ii, "fuzz": rep.status,
              "mem_rate": rep.mem_rate})
    fuzz_s = time.monotonic() - t0
    stats = cache.stats()
    steps, runs = cycle_step.launches, run_cycles.launches
    check(stats["hits"] == len(mapped) and stats["misses"] == 0,
          f"serve fuzz: cache {stats} for {len(mapped)} mapped points")
    check(runs == len(mapped) * -(-MAIN_MEMORIES // MAIN_BATCH)
          and steps == 0,
          f"serve fuzz launched run_cycles {runs}, cycle_step {steps} times")
    emit({"phase": "serve_fuzz_summary", "points": len(mapped),
          "ok": len(mapped), "cache_hits": stats["hits"],
          "not_run": [f"{p['kernel']}@{p['arch']} {p['status']}"
                      for p in doc["points"]
                      if p["map_status"] != "mapped"],
          "run_cycles_launches": runs, "fuzz_seconds": round(fuzz_s, 3)})
    return runs


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
    run_cycles.lane_launches = 0
    reports = fuzz_stacked(stack, mems, device=device)
    steps, runs = cycle_step.launches, run_cycles.launches
    lanes = run_cycles.lane_launches
    wall = time.monotonic() - t0
    LAYOUT_LAUNCHES["stacked_main_path"] = {"lane": lanes,
                                            "uniform": runs - lanes}
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
    check(lanes == 0, "the stack of 15 x 2048 memories ran in the lane "
                      "layout")
    check(steps == 0, f"cycle_step launched {steps} times on the stack")
    emit({"phase": "stacked_main_path", "kernels": len(reports),
          "memories_each": MAIN_MEMORIES,
          "t_max": max(a.asm.total_rows for a in stack),
          "rows_real": sum(a.asm.total_rows for a in stack),
          "run_cycles_launches": runs, "cycle_step_launches": steps,
          "layout_launches": LAYOUT_LAUNCHES["stacked_main_path"],
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
    time per launch (``run_lanes_kernel`` there, counted with
    ``run_cycles_kernel`` under the old key) and the device's idle share
    of the run's wall time (the profiler's own host overhead lengthens
    that wall time)."""
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
    fused = [e for e in events if "run_cycles_kernel" in e.key
             or "run_lanes_kernel" in e.key]
    steps = [e for e in events if "cycle_step_kernel" in e.key]
    launches = sum(e.count for e in fused)
    lanes = sum(e.count for e in fused if "run_lanes_kernel" in e.key)
    fused_us = sum(device_us(e) for e in fused)
    chunks = -(-MAIN_MEMORIES // MAIN_BATCH)
    check(launches == chunks, f"profile saw {launches} launches of "
                              f"run_cycles' kernels, not {chunks}")
    check(lanes == launches, f"profile: {launches - lanes} of {launches} "
                             f"launches at B={MAIN_BATCH} left the lane "
                             f"layout")
    check(not steps, "profile saw cycle_step_kernel on the main path")
    emit({"phase": "profile", "kernel": "gsm", "memories": MAIN_MEMORIES,
          "batch": MAIN_BATCH, "wall_us": wall_us,
          "device_busy_us": busy_us,
          "idle_share": (1 - busy_us / wall_us) if busy_us else None,
          "run_cycles_kernel_launches": launches,
          "run_lanes_kernel_launches": lanes,
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
    ``torch.profiler`` (gaps between launches left out).  A window in which
    the profiler recorded no device time is taken again, up to three
    times; then the phase fails, as a time paced by the host is not
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        busy_us = sum(device_us(e) for e in on_device(prof))
        if busy_us > 0:
            return busy_us / calls / 1e3
    check(False, "the profiler recorded no device time in three windows")


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


def floor_programs(fields):
    """The serial floors of a program's shape, without a trace: every cell
    an SADD of ZERO and ZERO that writes no register (T live rows, one
    barrier each, no memory), and every cell a NOP."""
    import torch
    from repro_torch.cgra.isa import DST_NONE, OPCODE, SRC_ZERO

    def full(v):
        return torch.full_like(fields.op, v)

    live = fields._replace(op=full(OPCODE["SADD"]), dst=full(DST_NONE),
                           sa=full(SRC_ZERO), sb=full(SRC_ZERO))
    return live, fields._replace(op=torch.zeros_like(fields.op))


def program_timing(device, step_times, parent=None):
    """Phase 6b: the whole-program kernel on gsm's program (T=84, P=16,
    M=128) from its preset state, as device time and at the host's issue
    pace, beside its bound (bytes and int32 operations), its serial floor
    (T live rows of an SADD of ZERO, no trace), the all-NOP program
    without a trace, µs per cycle, the plain loop, and T cycle-step
    launches timed in phase 6.  With ``parent`` (the parent commit's
    ``pe_array``), the parent's kernel is held bit-equal and timed in turns
    with the new one (parent, new, new, parent) in every reading.  Returns
    {B: (kernel_ms, plain_ms, bound_ms, bound_by)}."""
    import numpy as np
    import torch
    from repro_torch.cgra.arch import neighbor_table
    from repro_torch.cgra.artifact import load_artifact
    from repro_torch.cgra.simulator import preset_state
    from repro_torch.fuzz.corpus import make_corpus
    from repro_torch.kernels import pe_array
    from repro_torch.kernels.ops import decode_fields
    from repro_torch.kernels.ref import run_cycles_ref

    art = load_artifact("4x4", "gsm")
    fields = decode_fields(art.asm.words(), device)
    live, nops = floor_programs(fields)
    T, P = fields.op.shape
    nbr = torch.as_tensor(np.asarray(neighbor_table(art.grid), np.int32),
                          device=device)
    mems = make_corpus(art, MAIN_BATCH, seed=7)
    out = {}
    for B in TIMED_BATCHES:
        state = preset_state(art.asm, P, np.resize(mems, (B, mems.shape[1])),
                             B, device)
        M = state.mem.shape[1]

        def call(mod, f=fields, trace=True):
            if mod is None:
                return None
            return lambda: mod.run_cycles(f, state, nbr, trace=trace)

        if parent is not None:
            got, want = call(pe_array)(), call(parent)()
            for a, b in zip((*got[0], got[1]), (*want[0], want[1])):
                check(max_diff(a, b) == 0,
                      f"gsm B={B}: the parent kernel's run differs")

        kernel_ms, parent_ms, turns = in_turns(
            lambda fn: device_ms(fn, 50), call(pe_array), call(parent))
        paced_ms, parent_paced_ms, paced_turns = in_turns(
            lambda fn: host_paced_ms(fn, 50, 15), call(pe_array),
            call(parent))
        floor_ms, parent_floor_ms, _ = in_turns(
            lambda fn: device_ms(fn, 50), call(pe_array, live, False),
            call(parent, live, False))
        nop_ms, parent_nop_ms, _ = in_turns(
            lambda fn: device_ms(fn, 50), call(pe_array, nops, False),
            call(parent, nops, False))
        geom = pe_array.run_cycles_geometry(B, P, M, 1, T)
        other = 1 - geom.layout

        def other_call():
            return pe_array.run_cycles(fields, state, nbr, layout=other)

        other_ms = device_ms(other_call, 50)
        plain_ms = device_ms(lambda: run_cycles_ref(fields, state, nbr), 2)
        bytes_, ops = program_bytes(T, B, P, M), program_ops(fields, B)
        bound_ms, bound_by = bound(bytes_, ops)
        step_ms, step_paced_ms = step_times[B][:2]
        out[B] = (kernel_ms, plain_ms, bound_ms, bound_by)
        emit({"phase": "timing", "kernel": "pe_array.run_cycles",
              "program": "gsm", "B": B, "T": T, "P": P, "M": M,
              "geometry": geom._asdict(),
              "layout": LAYOUT_NAMES[geom.layout],
              "kernel_device_us": us(kernel_ms),
              "kernel_host_paced_us": us(paced_ms),
              "kernel_us_per_cycle": us(kernel_ms) / T,
              "bound_us": us(bound_ms), "bound_by": bound_by,
              "bytes": bytes_, "trace_bytes": 4 * T * B * P,
              "bytes_bound_us": bytes_ / HBM_BYTES_PER_S * 1e6,
              "int32_ops": ops, "ops_bound_us": ops / INT32_OPS_PER_S * 1e6,
              "share_of_bound": bound_ms / kernel_ms,
              "serial_floor_device_us": us(floor_ms),
              "serial_floor_us_per_cycle": us(floor_ms) / T,
              "nop_program_device_us": us(nop_ms),
              "other_layout": LAYOUT_NAMES[other],
              "other_layout_device_us": us(other_ms),
              **parent_fields(parent, parent_ms, parent_paced_ms,
                              parent_floor_ms, parent_nop_ms, turns,
                              paced_turns),
              "plain_device_us": us(plain_ms),
              "cycle_step_x_T_device_us": step_ms * T * 1e3,
              "cycle_step_x_T_host_paced_us": step_paced_ms * T * 1e3})
    return out


def stacked_timing(device, artifacts, parent=None):
    """Phase 6c: the stacked whole-program kernel on the 15 4x4 programs
    (NOP-padded to T_max=112) at B=2048 from their preset states, as
    device time and at the host's issue pace, beside its bound (bytes and
    int32 operations), its serial floor (every cell a live SADD of ZERO, no
    trace) and the all-NOP stack, µs per cycle of T_max, 15 single
    launches of the unpadded programs, and the plain version.  Before the
    timing, the stack's trace and final state at this shape are held bit
    for bit against the plain version and the 15 single launches.  With
    ``parent``, the parent's kernel is held bit-equal and timed in turns.
    Returns (max_abs_err, kernel_ms, plain_ms, bound_ms, bound_by)."""
    import numpy as np
    import torch
    from repro_torch.cgra.arch import neighbor_table
    from repro_torch.cgra.simulator import stacked_preset_state
    from repro_torch.fuzz.corpus import make_corpus
    from repro_torch.fuzz.engine import _pad_words
    from repro_torch.kernels import pe_array
    from repro_torch.kernels.ops import decode_fields
    from repro_torch.kernels.ref import PEState, run_stacked_ref

    stack = [a for a in artifacts if a.arch == STACK_ARCH]
    K, B = len(stack), MAIN_MEMORIES
    T = max(a.asm.total_rows for a in stack)
    P = stack[0].grid.num_pes
    fields = decode_fields(np.stack([_pad_words(a.asm.words(), T)
                                     for a in stack]), device)
    live, nops = floor_programs(fields)
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

    def call(mod, f=fields, trace=True):
        if mod is None:
            return None
        return lambda: mod.run_cycles(f, state, nbr, trace=trace)

    if parent is not None:
        got, want = call(pe_array)(), call(parent)()
        for a, b in zip((*got[0], got[1]), (*want[0], want[1])):
            check(max_diff(a, b) == 0, "stack: the parent kernel's run "
                                       "differs")

    def one_by_one(mod):
        if mod is None:
            return None

        def run():
            for f, s in zip(singles, states):
                mod.run_cycles(f, s, nbr)
        return run

    kernel_ms, parent_ms, turns = in_turns(
        lambda fn: device_ms(fn, 20), call(pe_array), call(parent))
    paced_ms, parent_paced_ms, paced_turns = in_turns(
        lambda fn: host_paced_ms(fn, 20, 15), call(pe_array), call(parent))
    floor_ms, parent_floor_ms, _ = in_turns(
        lambda fn: device_ms(fn, 20), call(pe_array, live, False),
        call(parent, live, False))
    nop_ms, parent_nop_ms, _ = in_turns(
        lambda fn: device_ms(fn, 20), call(pe_array, nops, False),
        call(parent, nops, False))
    singles_ms, parent_singles_ms, _ = in_turns(
        lambda fn: device_ms(fn, 10), one_by_one(pe_array),
        one_by_one(parent))
    singles_paced_ms = host_paced_ms(one_by_one(pe_array), 10, 9)
    geom = pe_array.run_cycles_geometry(B, P, M, K, T)
    other = 1 - geom.layout
    other_ms = device_ms(lambda: pe_array.run_cycles(fields, state, nbr,
                                                     layout=other), 20)
    plain_ms = device_ms(lambda: run_stacked_ref(fields, state, nbr), 1,
                         warmup=1)
    bytes_, ops = K * program_bytes(T, B, P, M), program_ops(fields, B)
    bound_ms, bound_by = bound(bytes_, ops)
    rows_real = sum(a.asm.total_rows for a in stack)
    emit({"phase": "timing", "kernel": "pe_array.run_cycles (stacked)",
          "programs": K, "B": B, "T_max": T, "rows_real": rows_real,
          "rows_padded": K * T, "P": P, "M": M,
          "geometry": geom._asdict(), "layout": LAYOUT_NAMES[geom.layout],
          "kernel_device_us": us(kernel_ms),
          "kernel_host_paced_us": us(paced_ms),
          "kernel_us_per_cycle": us(kernel_ms) / T,
          "bound_us": us(bound_ms), "bound_by": bound_by, "bytes": bytes_,
          "bytes_bound_us": bytes_ / HBM_BYTES_PER_S * 1e6,
          "int32_ops": ops, "ops_bound_us": ops / INT32_OPS_PER_S * 1e6,
          "share_of_bound": bound_ms / kernel_ms,
          "serial_floor_device_us": us(floor_ms),
          "serial_floor_us_per_cycle": us(floor_ms) / T,
          "nop_program_device_us": us(nop_ms),
          "single_launches_device_us": us(singles_ms),
          "single_launches_host_paced_us": us(singles_paced_ms),
          "other_layout": LAYOUT_NAMES[other],
          "other_layout_device_us": us(other_ms),
          **parent_fields(parent, parent_ms, parent_paced_ms,
                          parent_floor_ms, parent_nop_ms, turns, paced_turns,
                          parent_single_launches_device_us=us(
                              parent_singles_ms)),
          "plain_device_us": us(plain_ms), "max_abs_err": err})
    return err, kernel_ms, plain_ms, bound_ms, bound_by


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the port on one "
                                             "GPU (see the module docstring)")
    ap.add_argument("--parent", metavar="DIR",
                    help="a copy of the parent commit's src/repro_torch/"
                         "kernels: phases 6b/6c time its whole-program "
                         "kernel in turns with this one")
    args = ap.parse_args(argv)
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
    seq_seconds = map_phase(artifacts, device)
    cosim_runs = cosim_phase(device)
    cache = fresh_cache("main_path")
    t0 = time.monotonic()
    steps, runs, reports, made = main_path(artifacts, device, cache)
    warm_runs = main_path_warm(artifacts, device, cache, reports, made,
                               time.monotonic() - t0)
    stacked_runs = stacked_main_path(artifacts, reports, device)
    activity_phase(reports)
    activity_cost(artifacts, device)
    triage_phase(device)
    stream_phase(device)
    profile_phase(device)
    step_times = timing(device)
    parent = parent_kernels(args.parent)
    fused_times = program_timing(device, step_times, parent)
    stacked_times = stacked_timing(device, artifacts, parent)
    fleet_rows, fleet_runs = fleet_phase(artifacts, device)
    race_runs = race_phase(device, seq_seconds)
    fleet_chaos_phase(fleet_rows)
    sweep_smoke_phase()
    sweep_rows, sweep_runs, sweep_err, trace_dir = sweep_phase(device)
    heuristic_runs = heuristic_phase(device, sweep_rows)
    trace_phase(trace_dir)
    serve_runs = serve_phase(device)
    fused_err = max(fused_err, sweep_err)

    def line(name, launches, err, ms, plain_ms, bound_ms, bound_by="bytes",
             replaces="src/repro/kernels/pe_array.py:67", **extra):
        return {"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/pe_array.cu",
                "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None, **extra}

    step_ms, _, step_plain_ms, step_bound_ms = step_times[MAIN_BATCH]
    for name in LAYOUT_NAMES:
        check(sum(n[name] for n in LAYOUT_LAUNCHES.values()) > 0,
              f"the {name} layout of run_cycles was launched no time on "
              f"the main path: {LAYOUT_LAUNCHES}")
    emit({"phase": "done", "seconds": round(time.monotonic() - t_start, 3)})
    emit({"kernels": [
        line("pe_array.cycle_step", steps, step_err, step_ms, step_plain_ms,
             step_bound_ms),
        line("pe_array.run_cycles",
             runs + cosim_runs + warm_runs + fleet_runs + race_runs
             + sweep_runs + heuristic_runs + serve_runs,
             fused_err, *fused_times[MAIN_BATCH],
             launches_by_path={"fuzz main path": runs,
                               "cosim": cosim_runs,
                               "fuzz main path, warm cache": warm_runs,
                               "fleet": fleet_runs, "race": race_runs,
                               "sweep": sweep_runs,
                               "heuristic": heuristic_runs,
                               "serve": serve_runs},
             launches_by_layout={k: v for k, v in LAYOUT_LAUNCHES.items()
                                 if k != "stacked_main_path"}),
        line("pe_array.run_cycles (stacked)", stacked_runs,
             max(stacked_err, stacked_times[0]), *stacked_times[1:],
             replaces="src/repro/fuzz/engine.py:508",
             launches_by_layout=LAYOUT_LAUNCHES["stacked_main_path"])]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
