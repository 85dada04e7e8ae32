"""The phase spans of ``repro_torch.fuzz``: ``fuzz_program``'s times are
projections of its ``fuzz.*`` spans, the spans nest and cover the call,
they reach a ``torch.profiler`` trace as host ranges (and enter none
without a profiler), and ``fuzz_kernel``'s stages and the ``fuzz`` verb's
trace pass ``trace check``.  Everything runs on the CPU.
"""
import os
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import pytest

torch = pytest.importorskip("torch",
                            reason="optional extra: pip install .[torch]")

from repro_torch.cgra.artifact import load_artifact  # noqa: E402
from repro_torch.fuzz import engine  # noqa: E402
from repro_torch.fuzz.corpus import make_corpus  # noqa: E402
from repro_torch.obs import report  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
PHASES = ("fuzz.execute", "fuzz.readback", "fuzz.oracle", "fuzz.compare",
          "fuzz.activity")
MEMORIES, BATCH = 256, 64          # four chunks


@pytest.fixture(scope="module")
def call():
    art = load_artifact("4x4", "gsm")
    return art, make_corpus(art, MEMORIES, seed=5)


@pytest.fixture
def traced(tmp_path):
    """Tracing on into a fresh directory for the test, off after it."""
    obs_trace.enable(str(tmp_path / "trace"))
    yield str(tmp_path / "trace")
    obs_trace.disable()


def _fuzz(call):
    art, mems = call
    t0 = time.monotonic()
    rep = engine.fuzz_program(art, mems, batch=BATCH, device="cpu")
    return rep, time.monotonic() - t0


def _totals(records):
    out = defaultdict(float)
    for r in records:
        if r["k"] == "span":
            out[r["name"]] += r["dur"]
    return out


def test_exec_time_is_execute_plus_readback(call, traced):
    rep, _ = _fuzz(call)
    assert rep.status == "ok"
    got = _totals(report.load(traced))
    rounding = 1e-4
    assert abs(rep.exec_time_s - got["fuzz.execute"]
               - got["fuzz.readback"]) <= rounding
    assert abs(rep.readback_time_s - got["fuzz.readback"]) <= rounding
    assert abs(rep.oracle_time_s - got["fuzz.oracle"]) <= rounding
    assert abs(rep.compare_time_s - got["fuzz.compare"]) <= rounding
    assert abs(rep.activity_time_s - got["fuzz.activity"]) <= rounding
    assert 0 < rep.readback_time_s < rep.exec_time_s


@pytest.mark.parametrize("tracing", [False, True], ids=["off", "on"])
def test_the_phases_cover_the_call(call, tmp_path, tracing):
    """execute + readback + oracle + compare + activity: no more than the
    call's wall time, and at least 95% of it."""
    if tracing:
        obs_trace.enable(str(tmp_path / "trace"))
    try:
        rep, wall = _fuzz(call)
    finally:
        obs_trace.disable()
    inside = (rep.exec_time_s + rep.oracle_time_s + rep.compare_time_s
              + rep.activity_time_s)
    assert 0.95 * wall <= inside <= wall + 2e-4      # four roundings
    assert rep.mem_rate > 0


def test_shards_validate_and_the_chunks_cover_the_program(call, traced):
    _fuzz(call)
    records = report.load(traced)
    assert report.validate(records) == []
    assert report.attribution(records, "fuzz.program")["attributed"] >= 0.95
    spans = {r["span"]: r for r in records if r["k"] == "span"}
    (root,) = [r for r in spans.values() if r["name"] == "fuzz.program"]
    art, _ = call
    assert root["attrs"] == {"kernel": "gsm", "memories": MEMORIES,
                             "batch": BATCH, "chunks": MEMORIES // BATCH,
                             "rows": 84, "mem_words": 128}
    kids = defaultdict(list)
    for r in sorted(spans.values(), key=lambda r: r["ts"]):
        kids[r["parent"]].append(r)
    top = kids[root["span"]]
    assert [r["name"] for r in top] == (
        ["fuzz.activity"] + ["fuzz.chunk"] * 4 + ["fuzz.activity"])
    cells = int((art.asm.words() >> 27 != 0).sum())   # executed cells
    assert (top[0]["attrs"], top[-1]["attrs"]) == (
        {"part": "setup", "cells": cells}, {"part": "report"})
    for i, chunk in enumerate(top[1:-1]):
        assert chunk["attrs"] == {"lo": i * BATCH, "rows": BATCH,
                                  "upload_bytes": 0}
        assert [r["name"] for r in kids[chunk["span"]]] == list(PHASES)


def _host_ranges(prof):
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CPU]


@pytest.mark.parametrize("tracing", [False, True], ids=["off", "on"])
def test_phases_are_host_ranges_of_the_profiler(call, tmp_path, tracing):
    """Under a profiler each phase is a host event nested in the
    ``fuzz.program`` range, with tracing on (spans) or off (timers)."""
    from torch.profiler import ProfilerActivity, profile

    if tracing:
        obs_trace.enable(str(tmp_path / "trace"))
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _fuzz(call)
    finally:
        obs_trace.disable()
    ranges = _host_ranges(prof)
    (root,) = [r for r in ranges if r[0] == "fuzz.program"]
    counts = defaultdict(int)
    for name, start, end in ranges:
        if name.startswith("fuzz."):
            counts[name] += 1
            assert root[1] <= start <= end <= root[2], name
    assert counts == {"fuzz.program": 1, "fuzz.chunk": 4, "fuzz.execute": 4,
                      "fuzz.readback": 4, "fuzz.oracle": 4,
                      "fuzz.compare": 4, "fuzz.activity": 6}


def test_span_ts_is_on_the_profilers_clock(call, traced):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _fuzz(call)
    (ranged,) = [s for n, s, _ in _host_ranges(prof) if n == "fuzz.program"]
    (rec,) = [r for r in report.load(traced)
              if r["k"] == "span" and r["name"] == "fuzz.program"]
    assert abs(rec["ts"] - ranged / 1e9) < 0.05


@pytest.mark.parametrize("tracing", [False, True], ids=["off", "on"])
def test_no_range_is_entered_without_a_profiler(call, tmp_path, monkeypatch,
                                                tracing):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    if tracing:
        obs_trace.enable(str(tmp_path / "trace"))
    try:
        rep, _ = _fuzz(call)
    finally:
        obs_trace.disable()
    assert rep.status == "ok"


def test_timed_span_is_a_duration_only_timer_with_tracing_off():
    assert not obs_trace.enabled()
    sp = obs_trace.timed_span("fuzz.oracle", part="x")
    assert sp is not obs_trace.NULL_SPAN and not isinstance(sp, obs_trace.Span)
    with sp:
        time.sleep(0.01)
    assert 0.01 <= sp.dur < 1.0 and sp.set(a=1) is sp
    assert obs_trace.span("fuzz.oracle") is obs_trace.NULL_SPAN
    assert obs_trace.trace_dir() is None


def test_fuzz_kernel_stages_are_spans(tmp_path, traced):
    """``fuzz.kernel``'s children cover it; ``map_time_s`` is ``fuzz.map``,
    which says whether the cache answered."""
    reps = [engine.fuzz_kernel("gsm", "4x4", memories=64, batch=32, seed=1,
                               cache=str(tmp_path / "cache"), device="cpu")
            for _ in range(2)]
    records = report.load(traced)
    assert report.validate(records) == []
    att = report.attribution(records, "fuzz.kernel")
    assert len(att["roots"]) == 2 and att["attributed"] >= 0.95
    spans = [r for r in records if r["k"] == "span"]
    roots = {r["span"] for r in spans if r["name"] == "fuzz.kernel"}
    kids = [r for r in sorted(spans, key=lambda r: r["ts"])
            if r["parent"] in roots]
    stages = ["fuzz.setup", "fuzz.map", "fuzz.assemble", "fuzz.corpus",
              "fuzz.program", "fuzz.energy"]
    assert [r["name"] for r in kids] == stages * 2
    maps = [r for r in kids if r["name"] == "fuzz.map"]
    assert [m["attrs"]["cache_hit"] for m in maps] == [False, True]
    for rep, m in zip(reps, maps):
        assert rep.status == "ok" and rep.map_time_s == round(m["dur"], 3)


def test_the_fuzz_verb_passes_trace_check(tmp_path):
    d = str(tmp_path / "trace")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "fuzz", "--device", "cpu",
         "--kernels", "gsm", "--memories", "256", "--batch", "64"],
        capture_output=True, text=True, timeout=300,
        env={**ENV, obs_trace.ENV_VAR: d})
    assert proc.returncode == 0, proc.stderr[-2000:]
    check = subprocess.run(
        [sys.executable, "-m", "repro_torch", "trace", "check", d,
         "--min-attribution", "0.95"], capture_output=True, text=True,
        timeout=120, env=ENV)
    assert check.returncode == 0, check.stdout + check.stderr
    shown = subprocess.run(
        [sys.executable, "-m", "repro_torch", "trace", "report", d],
        capture_output=True, text=True, timeout=120, env=ENV).stdout
    table = shown.split("aggregate attribution by span name")[1]
    for name in ("fuzz.kernel", "fuzz.map", "fuzz.corpus", "fuzz.program",
                 "fuzz.chunk") + PHASES:
        assert f"  {name} " in table, name
