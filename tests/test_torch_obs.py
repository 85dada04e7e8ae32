"""The port's metrics registry, trace reports and ``trace`` verb against
the JAX package's: ``MetricsRegistry`` snapshots after the same
observations, ``validate``/``attribution``/``render_report``/``to_chrome``
over one trace that the port recorded and one that the JAX package
recorded (each package reads the other's shards), and ``python -m
repro_torch trace {report,export --chrome,check}`` with the exit codes and
output of ``python -m repro trace``.  Every comparison is exact.
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

from repro.obs import metrics as jax_metrics  # noqa: E402
from repro.obs import report as jax_report  # noqa: E402
from repro.obs import trace as jax_trace  # noqa: E402
from repro_torch.obs import SCHEMA_VERSION, MetricsRegistry  # noqa: E402
from repro_torch.obs import report  # noqa: E402
from repro_torch.obs.metrics import Histogram  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}


def _run(*argv, cwd=None):
    return subprocess.run([sys.executable, "-m", *argv], capture_output=True,
                          text=True, timeout=120, env=ENV, cwd=cwd)


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """One gsm@2x2 CDCL compile (CEGAR active) traced by each package."""
    root = tmp_path_factory.mktemp("traces")
    out = {}
    for pkg in ("repro_torch", "repro"):
        d = root / pkg
        proc = _run(pkg, "map", "gsm", "--grid", "2x2", "--backend", "cdcl",
                    "--trace", str(d), "--json")
        assert proc.returncode == 0, proc.stderr
        out[pkg] = str(d)
    return out


def test_schema_version_is_the_jax_one():
    assert SCHEMA_VERSION == jax_trace.SCHEMA_VERSION


def _observe(reg, rng):
    for _ in range(3000):
        reg.observe(rng.choice(("lat_s", "queue_s", "map_s")),
                    rng.random() * rng.choice((1.0, 1e-3, 1e3)))
        if rng.random() < 0.3:
            reg.inc(rng.choice(("hits", "misses")), rng.randint(1, 5))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_snapshot_equals_jax(seed):
    """Over 3000 observations the 2048-sample ring wraps, so the
    percentiles come from the same window in both packages."""
    got, want = MetricsRegistry(), jax_metrics.MetricsRegistry()
    _observe(got, random.Random(seed))
    _observe(want, random.Random(seed))
    assert got.snapshot() == want.snapshot()
    assert got.counter("hits").value == want.counter("hits").value
    assert MetricsRegistry().snapshot() == jax_metrics.MetricsRegistry(
    ).snapshot()


def test_histogram_window_and_percentiles_equal_jax():
    got, want = Histogram("h", window=8), jax_metrics.Histogram("h", window=8)
    assert got.snapshot() == want.snapshot() == {"count": 0}
    for v in range(1, 1001):
        got.observe(v * 0.37)
        want.observe(v * 0.37)
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert got.percentile(q) == want.percentile(q)
    assert got.snapshot(digits=3) == want.snapshot(digits=3)


@pytest.mark.parametrize("recorder", ["repro_torch", "repro"])
def test_reports_equal_jax_on_a_recorded_trace(traces, recorder):
    records = report.load(traces[recorder])
    assert records == jax_report.load(traces[recorder])
    assert {r["v"] for r in records} == {SCHEMA_VERSION}
    assert report.validate(records) == jax_report.validate(records) == []
    att = report.attribution(records)
    assert att == jax_report.attribution(records)
    assert att["attributed"] >= 0.95
    assert report.attribution(records, root_name="stage.map") == \
        jax_report.attribution(records, root_name="stage.map")
    for floor in (None, 0.95, 0.999):
        assert report.render_report(records, min_attribution=floor) == \
            jax_report.render_report(records, min_attribution=floor)
    assert report.to_chrome(records) == jax_report.to_chrome(records)


def test_validate_equals_jax_on_malformed_traces():
    span = {"v": 1, "k": "span", "trace": "t", "span": "a", "parent": None,
            "name": "x", "pid": 1, "tid": 1, "ts": 0.0, "dur": 0.1,
            "attrs": {}}
    cases = [
        [dict(span, parent="missing")],
        [{"v": 99, "k": "span"}],
        [{"v": 1, "k": "wat"}],
        [dict(span, dur=-1.0, attrs=[]), dict(span)],
        [dict(span, span="a", parent="b"), dict(span, span="b", parent="a")],
        [{"v": 1, "k": "event", "trace": "t", "span": "gone", "name": "e",
          "pid": 1, "tid": 1, "ts": 0.0, "attrs": {}}],
        [{k: v for k, v in span.items() if k != "dur"}],
    ]
    for records in cases:
        assert report.validate(records) == jax_report.validate(records)
        assert report.validate(records)


@pytest.mark.parametrize("args", [
    ["report"], ["report", "--json"], ["report", "--min-attribution", "0.95"],
    ["check"], ["check", "--min-attribution", "0.95"],
    ["check", "--min-attribution", "1.01"], ["export"],
    ["export", "--chrome"]],
    ids=lambda a: "-".join(x.strip("-") for x in a))
def test_trace_verb_equals_jax(traces, args):
    path = traces["repro_torch"]
    verb, rest = args[0], args[1:]
    got = _run("repro_torch", "trace", verb, path, *rest)
    want = _run("repro", "trace", verb, path, *rest)
    assert (got.returncode, got.stdout, got.stderr) == \
        (want.returncode, want.stdout, want.stderr)


def test_trace_export_file_and_missing_trace_equal_jax(traces, tmp_path):
    outs = {}
    for pkg in ("repro_torch", "repro"):
        out = tmp_path / f"{pkg}.json"
        proc = _run(pkg, "trace", "export", traces["repro"], "--chrome",
                    "-o", str(out))
        assert proc.returncode == 0
        outs[pkg] = (proc.stdout.replace(str(out), "OUT"),
                     json.loads(out.read_text()))
    assert outs["repro_torch"] == outs["repro"]
    missing = str(tmp_path / "nope")
    got = _run("repro_torch", "trace", "report", missing)
    want = _run("repro", "trace", "report", missing)
    assert (got.returncode, got.stdout, got.stderr) == \
        (want.returncode, want.stdout, want.stderr)
    assert got.returncode == 1
