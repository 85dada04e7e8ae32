"""The port's resilient compile fleet against the JAX package's: chaos
decisions and backoff for the same seeds, failure records and exit-code
classification, then real worker fleets (crash healing, a hung worker
killed at its deadline, fleet equal to inline, the degradation ladder and
its typed terminal failure, cache-poisoning protection, quarantine
attribution, ``points=``/``on_result``), and ``compile_many`` rows equal
to the JAX package's on the same points under the same ``REPRO_CHAOS``
campaign.  Everything solves with CDCL on 2x2/2x3 grids with short
deadlines, as ``tests/test_resilience.py`` does.
"""
import signal
import time

import numpy as np
import pytest

pytest.importorskip("torch", reason="optional extra: pip install .[torch]")
pytest.importorskip("jax", reason="optional extra: pip install .[jax]")

from repro.core import MapperConfig as JaxConfig  # noqa: E402
from repro.toolchain import ResilienceConfig as JaxResilience  # noqa: E402
from repro.toolchain import Toolchain as JaxToolchain  # noqa: E402
from repro.toolchain import chaos as jax_chaos  # noqa: E402
from repro.toolchain import resilience as jax_resilience  # noqa: E402
from repro_torch.core import MapperConfig  # noqa: E402
from repro_torch.toolchain import (FailureKind, ResilienceConfig,  # noqa: E402
                                   Toolchain)
from repro_torch.toolchain import chaos, resilience  # noqa: E402
from repro_torch.toolchain.chaos import ENV_KEY, ChaosSpec  # noqa: E402

CDCL = dict(backend="cdcl", per_ii_timeout_s=10.0, total_timeout_s=30.0)
#: retries and rungs without waiting: the ladder, not the backoff, is
#: under test
FAST = dict(backoff_base_s=0.01, backoff_cap_s=0.05)


def _arm(monkeypatch, **kw):
    spec = ChaosSpec(**kw)
    monkeypatch.setenv(ENV_KEY, spec.to_json())
    return spec


# ---------------------------------------------------------------------------
# chaos decisions, backoff, failure records: equal to the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,rate,kinds,attempts", [
    (0, 0.0, chaos.KINDS, (0,)),
    (1, 0.3, chaos.KINDS, (0,)),
    (7, 0.5, ("crash", "hang"), (0, 1)),
    (11, 1.0, ("solver-error",), (0, 1, 2)),
    (3, 0.2, chaos.KINDS, tuple(range(4)))])
def test_chaos_decisions_match_jax(seed, rate, kinds, attempts):
    spec = ChaosSpec(seed=seed, rate=rate, kinds=kinds, attempts=attempts,
                     hang_s=12.5)
    j_spec = jax_chaos.ChaosSpec.from_json(spec.to_json())
    assert spec.to_json() == j_spec.to_json()
    assert ChaosSpec.from_json(spec.to_json()) == spec
    points = [(f"k{i}", arch, a) for i in range(60)
              for arch in ("2x2", "4x4#ab12") for a in range(5)]
    port = [spec.decide(*p) for p in points]
    assert port == [j_spec.decide(*p) for p in points]
    if rate > 0:
        assert any(port)


def test_chaos_spec_rejects_what_jax_rejects():
    for text in ('{"rte": 0.5}', '{"kinds": ["segfault"]}'):
        with pytest.raises(ValueError) as port:
            ChaosSpec.from_json(text)
        with pytest.raises(ValueError) as want:
            jax_chaos.ChaosSpec.from_json(text)
        assert str(port.value) == str(want.value)
    assert chaos.ENV_KEY == jax_chaos.ENV_KEY == "REPRO_CHAOS"


def test_backoff_matches_jax():
    for kw in ({}, dict(backoff_base_s=0.1, backoff_cap_s=0.4, jitter=0.5,
                        seed=3)):
        rcfg, j_rcfg = ResilienceConfig(**kw), JaxResilience(**kw)
        for key in ("point", "('gsm', 0)", "other"):
            series = [rcfg.backoff_s(key, r) for r in range(8)]
            assert series == [j_rcfg.backoff_s(key, r) for r in range(8)]
            assert max(series) <= rcfg.backoff_cap_s * (1 + rcfg.jitter)
        for budget in (None, 2.0, 30.0):
            assert rcfg.point_deadline_s(budget) == \
                j_rcfg.point_deadline_s(budget)


def test_failure_record_and_text_match_jax():
    try:
        raise ValueError("boom")
    except ValueError as e:
        rec = resilience.failure_record(FailureKind.SOLVER_ERROR, "map", e,
                                        attempt=2)
        want = jax_resilience.failure_record("solver-error", "map", e,
                                             attempt=2)
    assert rec == want
    assert resilience.failure_text(rec) == "ValueError: boom"
    assert resilience.failure_text(None) is None
    note = resilience.failure_record(FailureKind.CACHE_CORRUPT, "cache",
                                     message="torn")
    assert note == jax_resilience.failure_record("cache-corrupt", "cache",
                                                 message="torn")
    assert resilience.classify_exception(MemoryError()) == FailureKind.OOM
    assert FailureKind.ALL == jax_resilience.FailureKind.ALL
    assert resilience.DEGRADATION_RUNGS == jax_resilience.DEGRADATION_RUNGS


def test_exitcode_classification_matches_jax():
    for code in (-signal.SIGKILL, -signal.SIGSEGV, 1, 139, 0, None):
        assert resilience._classify_exitcode(code) == \
            jax_resilience._classify_exitcode(code)
    assert resilience._classify_exitcode(-signal.SIGKILL) == FailureKind.OOM
    assert resilience._classify_exitcode(139) == FailureKind.WORKER_CRASH


# ---------------------------------------------------------------------------
# supervision: real worker processes
# ---------------------------------------------------------------------------


def test_worker_crash_is_healed_and_retried(monkeypatch):
    _arm(monkeypatch, rate=1.0, kinds=("crash",), attempts=(0,))
    tc = Toolchain((2, 2), MapperConfig(**CDCL))
    res = tc.compile_many(["bitcount", "reversebits"], grids=[(2, 2)],
                          jobs=2)
    for cr in res:
        assert cr.status == "ok"
        assert cr.retries == 1
        assert cr.failure_kind == FailureKind.WORKER_CRASH
        assert cr.failure["message"] == "worker exited with code 139"


def test_hung_worker_is_killed_within_deadline(monkeypatch):
    """The parent SIGKILLs a wedged worker at its deadline and recycles
    the slot; the injected hang would otherwise sleep for 60 s."""
    budget = 2.0
    _arm(monkeypatch, rate=1.0, kinds=("hang",), attempts=(0,), hang_s=60.0)
    rcfg = ResilienceConfig(deadline_factor=1.0, deadline_slack_s=0.5,
                            max_retries=1)
    tc = Toolchain((2, 2), MapperConfig(backend="cdcl", per_ii_timeout_s=1.0,
                                        total_timeout_s=budget))
    t0 = time.monotonic()
    res = tc.compile_many(["bitcount", "reversebits"], grids=[(2, 2)],
                          jobs=2, resilience=rcfg)
    elapsed = time.monotonic() - t0
    for cr in res:
        assert cr.status == "ok"
        assert cr.retries == 1
        assert cr.failure_kind == FailureKind.DEADLINE
        assert "deadline" in cr.failure["message"]
    assert elapsed < 2 * budget + 3.0


def test_fleet_matches_inline_results(monkeypatch):
    monkeypatch.delenv(ENV_KEY, raising=False)
    kernels = ["bitcount", "reversebits"]
    tc = Toolchain((2, 2), MapperConfig(**CDCL))
    inline = tc.compile_many(kernels, grids=[(2, 2), (2, 3)], jobs=1)
    fleet = tc.compile_many(kernels, grids=[(2, 2), (2, 3)], jobs=2)
    assert [(c.kernel, c.size, c.status, c.ii) for c in inline] == \
        [(c.kernel, c.size, c.status, c.ii) for c in fleet]
    assert [c.map_result.mapping.to_dict() for c in inline] == \
        [c.map_result.mapping.to_dict() for c in fleet]
    assert all(c.retries == 0 and c.failure is None for c in fleet)


# ---------------------------------------------------------------------------
# the retry/degradation ladder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("jobs", [1, 2])
def test_persistent_fault_degrades_down_the_ladder(monkeypatch, jobs):
    """Solver errors on attempts 0 and 1 exhaust ``max_retries=1``; with
    the backend flip left out of the ladder (so the test does not depend
    on z3 being installed) the point lands on ``oracle-off``."""
    _arm(monkeypatch, rate=1.0, kinds=("solver-error",), attempts=(0, 1))
    rcfg = ResilienceConfig(max_retries=1, degradation=("oracle-off",
                                                        "ii-capped"), **FAST)
    tc = Toolchain((2, 2), MapperConfig(**CDCL))
    (cr,) = tc.compile_many(["bitcount"], grids=[(2, 2)], jobs=jobs,
                            resilience=rcfg)
    assert cr.status == "ok"
    assert cr.degraded == "oracle-off"
    assert cr.retries == 2
    assert cr.failure_kind == FailureKind.SOLVER_ERROR


@pytest.mark.parametrize("jobs", [1, 2])
def test_exhausted_ladder_yields_typed_failed_row(monkeypatch, jobs):
    _arm(monkeypatch, rate=1.0, kinds=("solver-error",),
         attempts=tuple(range(12)))
    rcfg = ResilienceConfig(max_retries=1, **FAST)
    tc = Toolchain((2, 2), MapperConfig(**CDCL))
    (cr,) = tc.compile_many(["bitcount"], grids=[(2, 2)], jobs=jobs,
                            resilience=rcfg)
    assert cr.status == "failed"
    assert cr.stage == "map"
    assert cr.failure_kind == FailureKind.SOLVER_ERROR
    assert cr.failure["type"] == "ChaosError"
    assert "traceback" in cr.failure
    assert cr.error and "ChaosError" in cr.error


def test_degraded_results_are_not_cached(tmp_path, monkeypatch):
    _arm(monkeypatch, rate=1.0, kinds=("solver-error",), attempts=(0, 1))
    rcfg = ResilienceConfig(max_retries=1, degradation=("oracle-off",),
                            **FAST)
    tc = Toolchain((2, 2), MapperConfig(**CDCL), cache=str(tmp_path / "c"))
    (cr,) = tc.compile_many(["bitcount"], grids=[(2, 2)], jobs=1,
                            resilience=rcfg)
    assert cr.status == "ok" and cr.degraded == "oracle-off"
    assert len(tc.cache) == 0


def test_transient_failure_is_not_cached_and_retried_next_sweep(
        tmp_path, monkeypatch):
    _arm(monkeypatch, rate=1.0, kinds=("solver-error",),
         attempts=tuple(range(12)))
    rcfg = ResilienceConfig(max_retries=0, degradation=())
    tc = Toolchain((2, 2), MapperConfig(**CDCL), cache=str(tmp_path / "c"))
    (cr,) = tc.compile_many(["bitcount"], grids=[(2, 2)], jobs=1,
                            resilience=rcfg)
    assert cr.status == "failed"
    assert len(tc.cache) == 0
    monkeypatch.delenv(ENV_KEY)
    (cr2,) = tc.compile_many(["bitcount"], grids=[(2, 2)], jobs=1,
                             resilience=rcfg)
    assert cr2.status == "ok" and not cr2.cache_hit
    assert len(tc.cache) == 1
    (cr3,) = tc.compile_many(["bitcount"], grids=[(2, 2)], jobs=1)
    assert cr3.status == "ok" and cr3.cache_hit


def test_corrupted_cache_entry_is_quarantined_and_attributed(
        tmp_path, monkeypatch):
    _arm(monkeypatch, rate=1.0, kinds=("cache-corrupt",), attempts=(0,))
    tc = Toolchain((2, 2), MapperConfig(**CDCL), cache=str(tmp_path / "c"))
    (cr,) = tc.compile_many(["bitcount"], grids=[(2, 2)], jobs=1)
    assert cr.status == "ok"
    (cr2,) = tc.compile_many(["bitcount"], grids=[(2, 2)], jobs=1)
    assert cr2.status == "ok" and not cr2.cache_hit
    assert cr2.failure_kind == FailureKind.CACHE_CORRUPT
    assert tc.cache.stats()["corrupt"] == 1
    qdir = tmp_path / "c" / "quarantine"
    assert qdir.is_dir() and len(list(qdir.iterdir())) == 1


def test_compile_many_points_subset_and_on_result(monkeypatch):
    monkeypatch.delenv(ENV_KEY, raising=False)
    tc = Toolchain((2, 2), MapperConfig(**CDCL))
    seen = []
    res = tc.compile_many(["bitcount", "reversebits"],
                          grids=[(2, 2), (2, 3)], jobs=1,
                          points=[("bitcount", 1), ("reversebits", 0)],
                          on_result=lambda pt, cr: seen.append(pt))
    assert [(c.kernel, c.size) for c in res] == \
        [("bitcount", "2x3"), ("reversebits", "2x2")]
    assert sorted(seen) == [("bitcount", 1), ("reversebits", 0)]
    with pytest.raises(ValueError, match="outside the kernels x grids"):
        tc.compile_many(["bitcount"], grids=[(2, 2)], points=[("nope", 0)])


# ---------------------------------------------------------------------------
# compile_many rows equal to the JAX package's
# ---------------------------------------------------------------------------


def _row(cr):
    failure = cr.failure or {}
    return (cr.kernel, cr.size, cr.arch, cr.status, cr.stage, cr.ii,
            cr.map_result.mapping.to_dict() if cr.map_result is not None
            and cr.map_result.mapping is not None else None,
            cr.retries, cr.degraded, failure.get("kind"),
            failure.get("type"), failure.get("message"), cr.cache_hit,
            cr.metrics.to_dict() if cr.metrics is not None else None)


@pytest.mark.parametrize("jobs,spec", [
    (2, dict(seed=5, rate=0.5, kinds=("crash", "solver-error"))),
    (1, dict(seed=2, rate=0.6, kinds=("solver-error",), attempts=(0, 1))),
])
def test_compile_many_rows_match_jax(tmp_path, monkeypatch, jobs, spec):
    """The same points under the same chaos campaign: every row (status,
    II, mapping, retries, rung, failure kind and message, metrics) equals
    the JAX package's, and so does a second, cached pass."""
    _arm(monkeypatch, **spec)
    kernels, grids = ["bitcount", "reversebits", "gsm"], [(2, 2), (2, 3)]
    rcfg = dict(max_retries=1, degradation=("oracle-off", "ii-capped"),
                **FAST)
    rows = {}
    for name, tc_cls, cfg_cls, r_cls in (
            ("port", Toolchain, MapperConfig, ResilienceConfig),
            ("jax", JaxToolchain, JaxConfig, JaxResilience)):
        tc = tc_cls((2, 2), cfg_cls(**CDCL), cache=str(tmp_path / name))
        first = tc.compile_many(kernels, grids=grids, jobs=jobs,
                                resilience=r_cls(**rcfg))
        second = tc.compile_many(kernels, grids=grids, jobs=jobs,
                                 resilience=r_cls(**rcfg))
        rows[name] = ([_row(c) for c in first], [_row(c) for c in second],
                      len(tc.cache))
    assert rows["port"] == rows["jax"]
    first = rows["port"][0]
    assert len(first) == 6 and any(r[7] for r in first)   # it struck
    # every point got a map verdict (a gsm point degraded to oracle-off
    # maps, then fails to assemble, as in the JAX package)
    assert all(r[3] != "failed" for r in first)


def test_seeded_chaos_campaign_over_many_points_matches_jax():
    """The ladder's decisions alone, without solving: the per-point fault
    sequence of a campaign walked by ``_advance`` ends on the same rung,
    attempt and terminal state in both packages."""
    spec = ChaosSpec(seed=9, rate=0.7, kinds=("crash", "solver-error"),
                     attempts=tuple(range(6)))
    j_spec = jax_chaos.ChaosSpec.from_json(spec.to_json())
    rcfg, j_rcfg = ResilienceConfig(max_retries=1), JaxResilience(
        max_retries=1)
    rng = np.random.RandomState(0)
    for i in range(40):
        cfg = {"backend": "cdcl", "ii_max": int(rng.randint(4, 40))}
        tasks = [mod.MapTask(key=(f"k{i}", 0), kernel=f"k{i}", grid=None,
                             cfg=dict(cfg), oracle="assembler")
                 for mod in (resilience, jax_resilience)]
        trail = []
        for task, sp, rc, mod in zip(tasks, (spec, j_spec), (rcfg, j_rcfg),
                                     (resilience, jax_resilience)):
            steps = []
            while sp.decide(task.kernel, "2x2", task.attempt):
                fail = mod.failure_record("solver-error", "map",
                                          attempt=task.attempt)
                if not mod._advance(task, fail, rc, 0.0):
                    steps.append("exhausted")
                    break
                steps.append((task.attempt, task.rung_label, task.oracle,
                              task.cfg, round(task.not_before, 12)))
            trail.append(steps)
        assert trail[0] == trail[1]
