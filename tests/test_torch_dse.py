"""The port's design-space sweep against the JAX package's: the Pareto
functions on seeded random rows (ties and unmapped rows included), the
crash-resume journal, ``run_sweep`` at smoke size inline and on a two-worker
fleet, the committed smoke baseline's Pareto bytes, the markdown report,
one mapping cache read across the packages, a chaos-killed sweep resumed,
and the ``sweep`` verb, which never writes the JAX package's committed
``results/BENCH_dse.json``.  Every comparison is exact, wall-clock fields
aside.
"""
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch", reason="optional extra: pip install .[torch]")
pytest.importorskip("jax", reason="optional extra: pip install .[jax]")

from repro import dse as jax_dse  # noqa: E402
from repro.dse import journal as jax_journal  # noqa: E402
from repro.dse.report import markdown_report as jax_markdown  # noqa: E402
from repro_torch import dse  # noqa: E402
from repro_torch.dse import cli  # noqa: E402
from repro_torch.dse.journal import SweepJournal  # noqa: E402
from repro_torch.dse.report import markdown_report  # noqa: E402
from repro_torch.toolchain.chaos import ABORT_EXIT_CODE, ENV_KEY  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
COMMITTED = ROOT / "results" / "BENCH_dse.json"
#: sweep-row and document fields read from the wall clock or a path
_TIMED = ("map_time_s", "cancelled_after_s", "wall_time_s", "dir")


def _untimed(doc):
    if isinstance(doc, dict):
        return {k: _untimed(v) for k, v in doc.items() if k not in _TIMED}
    if isinstance(doc, list):
        return [_untimed(v) for v in doc]
    return doc


def _random_rows(seed, n=40, label_key="size"):
    rng = random.Random(seed)
    rows = []
    for i in range(n):
        row = {"kernel": rng.choice(("a", "b", "c")),
               label_key: f"L{i % 9}",
               "status": rng.choice(("mapped",) * 4 + ("timeout",
                                                       "unsat-capped")),
               "ii": rng.randint(1, 4),
               "utilization": rng.choice((0.25, 0.5, 0.5, 0.75)),
               "latency_cycles": rng.choice((40, 50, 50, 60)),
               "energy_nj": rng.choice((1.0, 1.5, 1.5, 2.0)),
               "area": rng.choice((4, 9, 16))}
        rows.append(row)
    return rows


@pytest.mark.parametrize("seed", range(6))
def test_pareto_functions_equal_jax(seed):
    rows = _random_rows(seed)
    pts = [(r["ii"], r["latency_cycles"], r["energy_nj"]) for r in rows]
    assert dse.pareto_front(pts) == jax_dse.pareto_front(pts)
    for a, b in zip(pts, pts[1:] + pts[:1]):
        assert dse.dominates(a, b) == jax_dse.dominates(a, b)
    mapped = [r for r in rows if r["status"] == "mapped"]
    assert dse.kernel_pareto(mapped) == jax_dse.kernel_pareto(mapped)
    assert dse.kernel_pareto([]) == jax_dse.kernel_pareto([])
    assert dse.pareto_analysis(rows) == jax_dse.pareto_analysis(rows)
    assert dse.pareto_analysis(rows, extra_objectives=("area",)) == \
        jax_dse.pareto_analysis(rows, extra_objectives=("area",))
    arch = _random_rows(seed, label_key="arch")
    assert dse.pareto_analysis(arch, label_key="arch") == \
        jax_dse.pareto_analysis(arch, label_key="arch")
    unmapped = [dict(r, status="timeout") for r in rows]
    assert dse.pareto_analysis(unmapped) == jax_dse.pareto_analysis(unmapped)
    with pytest.raises(ValueError, match="dimension mismatch"):
        dse.dominates((1, 2), (1, 2, 3))


def test_space_equals_jax():
    assert dse.DEFAULT_SIZES == jax_dse.DEFAULT_SIZES
    assert dse.DEFAULT_KERNELS == jax_dse.DEFAULT_KERNELS
    assert (dse.SMOKE_KERNELS, dse.SMOKE_SIZES) == \
        (jax_dse.SMOKE_KERNELS, jax_dse.SMOKE_SIZES)
    assert dse.arch_space() == jax_dse.arch_space()
    assert dse.parse_sizes(" 2x3,,4X4") == jax_dse.parse_sizes(" 2x3,,4X4")
    assert dse.build_space(["gsm", "sqrt"], dse.DEFAULT_SIZES) == [
        dse.DesignPoint(p.kernel, p.rows, p.cols)
        for p in jax_dse.build_space(["gsm", "sqrt"], jax_dse.DEFAULT_SIZES)]
    assert [(p.kernel, p.arch) for p in dse.build_arch_space(
        ["gsm"], dse.arch_space())] == [
        (p.kernel, p.arch) for p in jax_dse.build_arch_space(
            ["gsm"], jax_dse.arch_space())]
    with pytest.raises(ValueError, match="unknown kernels"):
        dse.build_space(["nope"], [(2, 2)])


def test_journal_records_resumes_and_refuses_other_sweeps(tmp_path):
    sig = dse.SweepConfig(kernels=("gsm",), sizes=((2, 2),),
                          backend="cdcl").signature()
    assert sig == jax_dse.SweepConfig(kernels=("gsm",), sizes=((2, 2),),
                                      backend="cdcl").signature()
    rows = {("gsm", "2x2"): {"status": "mapped", "ii": 4},
            ("gsm", "3x3"): {"status": "mapped", "ii": 3}}
    port, ref = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    for cls, path in ((SweepJournal, port), (jax_journal.SweepJournal, ref)):
        with cls(str(path)) as j:
            assert j.start(sig) == {}
            for (k, s), row in rows.items():
                j.record(k, s, row)
    assert port.read_bytes() == ref.read_bytes()
    with SweepJournal(str(port)) as j:
        assert j.start(sig, resume=True) == rows
        j.record("gsm", "2x2", {"status": "timeout", "ii": None})
    assert SweepJournal(str(port)).load(sig)[("gsm", "2x2")]["status"] == \
        "timeout"
    # a torn tail (a kill mid-append) is re-run, not a failure; the first
    # row a resumed sweep appends lands on the torn line and is lost with
    # it, in both packages alike
    torn = '{"kernel": "gsm", "si'
    for cls, path in ((SweepJournal, port), (jax_journal.SweepJournal, ref)):
        with open(path, "a") as fh:
            fh.write(torn)
        assert cls(str(path)).load(dict(sig, ii_max=8)) == {}
        done = cls(str(path)).load(sig)
        assert ("gsm", "3x3") in done
        with cls(str(path)) as j:
            assert j.start(sig, resume=True) == done
            j.record("gsm", "4x4", {"status": "mapped", "ii": 2})
        assert cls(str(path)).load(sig) == done
        assert path.read_text().endswith(
            torn + '{"kernel":"gsm","row":{"ii":2,"status":"mapped"},'
            '"size":"4x4"}\n')
    with SweepJournal(str(port)) as j:  # mismatch: rewritten from scratch
        assert j.start(dict(sig, ii_max=8), resume=True) == {}
    assert SweepJournal(str(port)).load(sig) == {}
    with pytest.raises(RuntimeError, match="not started"):
        SweepJournal(str(tmp_path / "x")).record("gsm", "2x2", {})


def _smoke_cfg(cls, cache_dir, jobs):
    return cls(kernels=cli.SMOKE_KERNELS, sizes=cli.SMOKE_SIZES,
               backend="cdcl", per_point_timeout_s=30.0,
               per_ii_timeout_s=10.0, jobs=jobs, cache_dir=str(cache_dir))


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """The smoke sweep of each package, inline and on two workers, each
    into a fresh cache."""
    root = tmp_path_factory.mktemp("sweeps")
    out = {}
    for jobs in (1, 2):
        out["port", jobs] = dse.run_sweep(
            _smoke_cfg(dse.SweepConfig, root / f"port{jobs}", jobs))
        out["jax", jobs] = jax_dse.run_sweep(
            _smoke_cfg(jax_dse.SweepConfig, root / f"jax{jobs}", jobs))
    out["root"] = root
    return out


@pytest.mark.parametrize("jobs", [1, 2])
def test_run_sweep_equals_jax(sweeps, jobs):
    got, want = sweeps["port", jobs], sweeps["jax", jobs]
    assert _untimed(got) == _untimed(want)
    assert got["pareto"] == want["pareto"]
    assert got["cache"]["misses"] == 12 and got["errors"] == 0
    assert cli.pareto_bytes(got) == \
        cli.pareto_bytes(json.loads(COMMITTED.read_text()))


def test_markdown_report_equals_jax(sweeps):
    for doc in (sweeps["port", 1], sweeps["port", 2], sweeps["jax", 1],
                json.loads(COMMITTED.read_text())):
        assert markdown_report(doc) == jax_markdown(doc)


def test_one_cache_serves_both_sweeps(sweeps):
    """Each package's sweep reads the other's cache as 12 hits, and the
    rows it replays equal the writer's."""
    root = sweeps["root"]
    from_jax = dse.run_sweep(_smoke_cfg(dse.SweepConfig, root / "jax1", 1))
    from_port = jax_dse.run_sweep(
        _smoke_cfg(jax_dse.SweepConfig, root / "port1", 1))
    for doc, writer in ((from_jax, sweeps["jax", 1]),
                        (from_port, sweeps["port", 1])):
        assert doc["cache"]["hits"] == 12 and doc["cache"]["misses"] == 0
        assert all(r["cache_hit"] for r in doc["points"])
        assert cli.pareto_bytes(doc) == cli.pareto_bytes(writer)


@pytest.mark.parametrize("size", ["2x2", "2x3"])
def test_swept_popcount_mismatches_as_in_jax(size):
    """At the sweep's budgets both packages map popcount at 2x2 and 2x3 to
    words that run wrong (a loop-carried operand in a neighbour's OUT
    register is clobbered before its first read; ROADMAP §3).  The port
    reproduces the reference's verdict, failing memories and mismatch
    strings exactly; it does not fix the mapping."""
    from repro.fuzz.engine import fuzz_kernel as jax_fuzz_kernel
    from repro_torch.fuzz.engine import fuzz_kernel

    got = fuzz_kernel("popcount", arch=size, memories=64, batch=64,
                      config=dse.SweepConfig(backend="cdcl").mapper_config(),
                      device="cpu")
    want = jax_fuzz_kernel(
        "popcount", arch=size, memories=64, batch=64,
        config=jax_dse.SweepConfig(backend="cdcl").mapper_config())
    assert got.status == want.status == "mismatch"
    assert (got.ii, got.failing, got.mismatches) == \
        (want.ii, want.failing, want.mismatches)


def _projection(doc):
    keys = ("kernel", "size", "status", "ii", "utilization",
            "latency_cycles", "energy_nj", "cegar_rounds")
    return [{k: r.get(k) for k in keys} for r in doc["points"]]


def test_chaos_killed_sweep_resumes_to_the_uninterrupted_rows(tmp_path):
    """``tests/test_resilience.py``'s crash-resume path on the port: a
    chaotic sweep hard-exits after two durable points, ``--resume``
    completes it, and the rows equal a fault-free sweep's."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    env.pop(ENV_KEY, None)
    args = [sys.executable, "-m", "repro_torch", "sweep",
            "--kernels", "bitcount,reversebits", "--sizes", "2x2,2x3",
            "--backend", "cdcl", "--jobs", "2", "--timeout", "10"]
    base = tmp_path / "base.json"
    p = subprocess.run(args + ["--cache-dir", str(tmp_path / "cache_base"),
                               "--out", str(base), "--no-journal"],
                       env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    out = tmp_path / "dse.json"
    args += ["--cache-dir", str(tmp_path / "cache"), "--out", str(out)]
    p = subprocess.run(args, env={**env, ENV_KEY: json.dumps(
        {"seed": 3, "rate": 0.3, "abort_after_points": 2})},
        capture_output=True, text=True, timeout=120)
    assert p.returncode == ABORT_EXIT_CODE == 23, (p.returncode, p.stderr)
    assert not out.exists()
    journal = tmp_path / ".sweep_journal.jsonl"
    assert len(journal.read_text().splitlines()) == 3
    p = subprocess.run(args + ["--resume"], env={
        **env, ENV_KEY: json.dumps({"seed": 3, "rate": 0.3})},
        capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    doc = json.loads(out.read_text())
    assert doc["resumed_points"] == 2 and doc["errors"] == 0
    assert _projection(doc) == _projection(json.loads(base.read_text()))


def _results_listing():
    return sorted((p.relative_to(ROOT).as_posix(), p.stat().st_mtime_ns)
                  for p in (ROOT / "results").rglob("*"))


def test_sweep_verb_smoke_writes_only_where_told(tmp_path):
    before = _results_listing()
    out = tmp_path / "d.json"
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch", "sweep", "--smoke", "--jobs",
         "2", "--out", str(out), "--cache-dir", str(tmp_path / "dc")],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert _results_listing() == before
    doc = json.loads(out.read_text())
    assert doc["repeat_check"]["cache_hits_second_run"] == 12
    assert doc["repeat_check"]["pareto_identical"] is True
    assert cli.pareto_bytes(doc) == \
        cli.pareto_bytes(json.loads(COMMITTED.read_text()))
    assert (tmp_path / "d.md").read_text() == markdown_report(doc)


def test_sweep_defaults_never_name_the_committed_baseline(tmp_path,
                                                          monkeypatch):
    """With no ``--out``, the smoke lands under ``results/torch/``; the
    JAX package's ``results/BENCH_dse.json`` is never a default."""
    monkeypatch.chdir(tmp_path)
    assert cli.main(["--smoke", "--jobs", "2"]) == 0
    written = sorted(p.relative_to(tmp_path).as_posix()
                     for p in (tmp_path / "results").rglob("*.*")
                     if "dse_cache" not in p.parts)
    assert written == ["results/torch/BENCH_dse.json",
                       "results/torch/BENCH_dse.md"]
    assert cli.DEFAULT_OUT.startswith("results/torch/")
