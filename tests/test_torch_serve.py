"""The port's compile server (``repro_torch.serve``) against the JAX
package's (``repro.serve``) on the same inputs: wire frames byte for byte,
requests and their config merge, the golden wire fixtures, the server-side
bookkeeping under one script of calls, the serving lane's smoke workload
through an inline server of each package, coalescing, cache replay, tenant
admission, typed errors, bare DFGs, the ``serve``/``submit`` verbs, and
clients and servers of the two packages talking to each other in both
directions over one cache directory.

Everything maps on the CPU with the CDCL backend; the server touches no
device.  Results are compared exactly, apart from wall-clock fields.
"""
import asyncio
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch",
                            reason="optional extra: pip install .[torch]")
pytest.importorskip("jax", reason="optional extra: pip install .[jax]")

import repro.serve as jax_serve  # noqa: E402
from repro.core import MapperConfig as JaxConfig  # noqa: E402
from repro.core.dfg import running_example as jax_running_example  # noqa: E402
from repro.frontend.kernels import TRACED_KERNELS as JAX_TRACED  # noqa: E402
from repro.cgra.programs import BENCHMARKS as JAX_BENCHMARKS  # noqa: E402
from repro.serve import protocol as jax_protocol  # noqa: E402
from repro.toolchain import Toolchain as JaxToolchain  # noqa: E402
from repro.toolchain.artifacts import CompileResult as JaxResult  # noqa: E402
from repro.toolchain.artifacts import WireMapResult as JaxWireMapResult  # noqa: E402
from repro_torch import serve  # noqa: E402
from repro_torch.cgra.programs import BENCHMARKS  # noqa: E402
from repro_torch.core import MapperConfig  # noqa: E402
from repro_torch.core.dfg import running_example  # noqa: E402
from repro_torch.frontend import TRACED_KERNELS  # noqa: E402
from repro_torch.serve import (CompileRequest, CompileServer,  # noqa: E402
                               InflightCompiles, ProtocolError, ServeClient,
                               ServeError, ServeStats, TenantBudgets,
                               request_sync, wire_source)
from repro_torch.serve.protocol import decode, encode  # noqa: E402
from repro_torch.toolchain import CompileResult, Toolchain  # noqa: E402
from repro_torch.toolchain.artifacts import (WireMapResult,  # noqa: E402
                                             WireMapping)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures"
CDCL = dict(backend="cdcl", per_ii_timeout_s=10.0, total_timeout_s=30.0)
PORT = SimpleNamespace(server=CompileServer, client=ServeClient,
                       config=MapperConfig(**CDCL))
JAX = SimpleNamespace(server=jax_serve.CompileServer,
                      client=jax_serve.ServeClient, config=JaxConfig(**CDCL))
#: summary keys that differ between service paths or runs
VOLATILE = ("stage_times_s", "cache_hit", "cancelled_after_s")
#: lane keys that are timings, or the cache/coalesced split, which
#: depends on arrival times
LANE_TIMED = ("served", "throughput_rps", "p50_ms", "p99_ms", "wall_time_s")


def _projection(summary):
    return {k: v for k, v in summary.items() if k not in VOLATILE}


def _canon(doc):
    return json.dumps(doc, sort_keys=True, separators=(",", ":"))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


async def _with_server(body, server_pkg=PORT, client_pkg=None, **kw):
    kw.setdefault("inline", True)
    server = server_pkg.server("2x2", server_pkg.config, **kw)
    try:
        host, port = await server.start()
        client = await (client_pkg or server_pkg).client.connect(host, port)
        try:
            return await body(server, client)
        finally:
            await client.close()
    finally:
        server.close()


# ---------------------------------------------------------------------------
# the wire: frames, sources, requests, golden fixtures
# ---------------------------------------------------------------------------


def test_frames_encode_to_the_jax_bytes():
    msgs = [{"type": "compile", "request_id": "r1", "b": [1, None]},
            {"type": "hello", "v": 1, "server": "repro-serve", "jobs": 2},
            {"z": {"y": 1.5, "x": "é"}, "a": True}]
    for msg in msgs:
        assert encode(msg) == jax_protocol.encode(msg)
        assert decode(encode(msg)) == jax_protocol.decode(encode(msg)) == msg
        assert decode(encode(msg).decode()) == msg
    for bad in (b"not json\n", b"[1, 2]\n"):
        with pytest.raises(ProtocolError):
            decode(bad)
        with pytest.raises(jax_protocol.ProtocolError):
            jax_protocol.decode(bad)


@pytest.mark.parametrize("kind", ["name", "dfg", "dfg_dict", "builder",
                                  "traced"])
def test_wire_source_lowers_as_in_jax(kind):
    port, ref = {
        "name": ("bitcount", "bitcount"),
        "dfg": (running_example(), jax_running_example()),
        "dfg_dict": (running_example().to_dict(),
                     jax_running_example().to_dict()),
        "builder": (BENCHMARKS["gsm"](), JAX_BENCHMARKS["gsm"]()),
        "traced": (TRACED_KERNELS["dotprod"], JAX_TRACED["dotprod"]),
    }[kind]
    assert _canon(wire_source(port)) == _canon(jax_serve.wire_source(ref))


def test_wire_source_rejects_what_it_cannot_lower():
    with pytest.raises(ProtocolError, match="unsupported kernel source"):
        wire_source(42)


def test_compile_request_round_trips_across_packages():
    kw = dict(source="bitcount", arch="2x2", config={"ii_max": 8},
              strategy=None, priority=3, tenant="alice", request_id="r9")
    req, ref = CompileRequest(**kw), jax_serve.CompileRequest(**kw)
    assert encode(req.to_dict()) == jax_protocol.encode(ref.to_dict())
    assert CompileRequest.from_dict(ref.to_dict()) == req
    assert jax_serve.CompileRequest.from_dict(req.to_dict()) == ref
    dfg_req = CompileRequest(source=running_example().to_dict())
    assert dfg_req.resolved_source().to_dict() == running_example().to_dict()
    for bad, match in ((dict(req.to_dict(), v=99), "version"),
                       (dict(req.to_dict(), source=""), "source"),
                       (dict(req.to_dict(), source=7), "source")):
        with pytest.raises(ProtocolError, match=match):
            CompileRequest.from_dict(bad)
        with pytest.raises(jax_protocol.ProtocolError, match=match):
            jax_serve.CompileRequest.from_dict(bad)


@pytest.mark.parametrize("config,strategy", [
    (None, None), ({"ii_max": 8}, None),
    ({"total_timeout_s": 5.0, "per_ii_timeout_s": 2.5}, None),
    (None, "portfolio:cdcl-seq+cdcl-pair"), ({"ii_max": 4}, "cdcl-seq")])
def test_config_merge_as_in_jax(config, strategy):
    base, jax_base = MapperConfig(backend="cdcl", ii_max=32), \
        JaxConfig(backend="cdcl", ii_max=32)
    cfg = CompileRequest(source="bitcount", config=config,
                         strategy=strategy).mapper_config(base)
    want = jax_serve.CompileRequest(source="bitcount", config=config,
                                    strategy=strategy).mapper_config(jax_base)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    if strategy is not None:
        assert (cfg.strategy, cfg.backend, cfg.amo) == (strategy, "auto",
                                                        None)


def test_config_merge_rejects_unknown_keys():
    with pytest.raises(ProtocolError, match=r"unknown MapperConfig keys: "
                                            r"\['nope'\]"):
        CompileRequest(source="bitcount",
                       config={"nope": 1}).mapper_config(MapperConfig())


def test_golden_request_fixture_parses_in_the_port():
    fixture = json.loads((FIXTURES / "wire_compile_request.json").read_text())
    req = CompileRequest.from_dict(fixture)
    assert _canon(req.to_dict()) == _canon(fixture)
    assert req == CompileRequest(**{k: fixture[k] for k in (
        "source", "arch", "config", "strategy", "priority", "tenant",
        "request_id")})


def test_golden_result_fixture_parses_in_the_port():
    fixture = json.loads((FIXTURES / "wire_compile_result.json").read_text())
    cr = CompileResult.from_dict(fixture["result"])
    assert _canon(cr.to_dict()) == _canon(fixture["result"])
    assert cr.summary() == fixture["summary"]
    assert isinstance(cr.map_result, WireMapResult)
    assert isinstance(cr.mapping, WireMapping)
    assert cr.mapping.utilization == fixture["summary"]["utilization"]
    want = JaxResult.from_dict(fixture["result"])
    for name in ("status", "mii", "backend", "cegar_rounds", "ii",
                 "encodings_built", "incremental_solves", "total_time_s",
                 "attempts", "validation_errors", "strategies_raced",
                 "winner", "cancelled_after_s", "unsat_iis", "facts_used"):
        assert getattr(cr.map_result, name) == \
            getattr(want.map_result, name), name
    assert cr.mapping.to_dict() == want.mapping.to_dict()
    assert WireMapping(fixture["result"]["map_result"]["mapping"]) \
        .placements == want.mapping.placements


def test_golden_result_revives_with_a_dfg_and_grid():
    """With the kernel's DFG and grid on this side, the wire document
    revives into a live ``MapResult`` whose mapping validates and equals
    a fresh compile's."""
    from repro_torch.cgra.arch import make_grid
    from repro_torch.core import validate_mapping

    fixture = json.loads((FIXTURES / "wire_compile_result.json").read_text())
    tc = Toolchain("2x2", MapperConfig(**CDCL))
    prog = tc.program("bitcount")
    grid = make_grid(2, 2)
    cr = CompileResult.from_dict(fixture["result"], grid=grid, program=prog)
    assert not isinstance(cr.map_result, WireMapResult)
    assert cr.program is prog and validate_mapping(cr.mapping) == []
    assert _canon(cr.to_dict()) == _canon(fixture["result"])
    fresh = tc.compile(prog)
    assert _projection(fresh.summary()) == _projection(fixture["summary"])
    revived = WireMapResult(fixture["result"]["map_result"]).revive(
        prog.dfg, grid)
    assert revived.mapping.to_dict() == cr.mapping.to_dict()


def test_stats_schema_2_is_additive_over_the_v1_golden():
    golden = json.loads((FIXTURES / "wire_stats_v1.json").read_text())
    golden.pop("_comment")

    async def body(server, client):
        cr, served = await client.compile("bitcount")
        assert cr.ok and served == "compiled"
        return await client.stats()

    stats = asyncio.run(_with_server(body))

    def additive(g, s, path="stats"):
        for key, val in g.items():
            assert type(s.get(key)) is type(val), f"{path}.{key}"
            if isinstance(val, dict):
                additive(val, s[key], f"{path}.{key}")

    additive(golden, stats)
    assert stats["v"] == 1 and stats["serving"]["compiled"] == 1
    assert stats["stats_schema"] == CompileServer.STATS_SCHEMA == \
        jax_serve.CompileServer.STATS_SCHEMA == 2
    assert stats["queue"] == {"pool_pending": 0, "inflight_keys": 0}
    assert stats["metrics"]["counters"]["serve.served.compiled"] == 1
    lat = stats["metrics"]["histograms"]["serve.request_s"]
    assert lat["count"] == 1 and {"p50", "p90", "p99"} <= set(lat)
    assert {"serve.stage.map_s", "serve.stage.assemble_s",
            "serve.stage.metrics_s"} <= set(stats["metrics"]["histograms"])


# ---------------------------------------------------------------------------
# server-side bookkeeping, one script of calls on both packages
# ---------------------------------------------------------------------------


def _inflight_script(inflight):
    return [inflight.join("k1", "a"), inflight.join("k1", "b"),
            inflight.join("k2", "c"), inflight.depth("k1"), len(inflight),
            inflight.pop("k1"), inflight.pop("k1"), inflight.depth("k1"),
            len(inflight), inflight.join("k1", "d"), inflight.pop("k2")]


def _budget_script(budgets):
    out = [budgets.admit("a"), budgets.admit("a"), budgets.admit("a"),
           budgets.admit("b"), budgets.snapshot()]
    budgets.release("a")
    budgets.release("b")
    budgets.release("zzz")
    out += [budgets.snapshot(), budgets.admit("a"), budgets.snapshot(),
            budgets.max_inflight]
    return out


def _stats_script(stats):
    out = [stats.snapshot()]
    stats.received += 7
    stats.compiled += 3
    stats.cache_hits += 1
    stats.coalesced += 2
    stats.rejected += 1
    out.append(stats.snapshot())
    return out


@pytest.mark.parametrize("script,make,make_ref", [
    (_inflight_script, InflightCompiles, jax_serve.InflightCompiles),
    (_budget_script, lambda: TenantBudgets(2),
     lambda: jax_serve.TenantBudgets(2)),
    (_budget_script, lambda: TenantBudgets(None),
     lambda: jax_serve.TenantBudgets(None)),
    (_stats_script, ServeStats, jax_serve.ServeStats)],
    ids=["inflight", "budgets", "unlimited", "stats"])
def test_queue_objects_follow_jax(script, make, make_ref):
    assert script(make()) == script(make_ref())


# ---------------------------------------------------------------------------
# the serving lane's smoke workload: port server against JAX server
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke_lanes(tmp_path_factory):
    """The lane's smoke workload (20 requests over dotprod, fir4 and
    relu_clamp x 4x4/bordermem-4x4) through an inline port server, driven
    by ``chip_smoke.serve_lane``, and through an inline JAX server, driven
    by ``benchmarks/serving.py`` itself."""
    smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
    lane = _load("serving_lane", ROOT / "benchmarks" / "serving.py")
    port, slowest = smoke.serve_lane(
        lane.SMOKE_KERNELS, lane.SMOKE_ARCHES, 20, "smoke",
        str(tmp_path_factory.mktemp("lane")), jobs=2, concurrency=4,
        inline=True)
    assert len(slowest) == 5
    assert round(slowest[0][0] * 1e3, 2) >= port["p99_ms"]
    ref = lane.run(lane.SMOKE_KERNELS, lane.SMOKE_ARCHES, n=20, seed=7,
                   zipf_s=1.1, config=smoke.MAP_CONFIG, jobs=2,
                   concurrency=4, mode="smoke")
    return port, ref, smoke, lane


@pytest.mark.parametrize("side", ["port", "jax"])
def test_smoke_lane_equals_the_committed_lane(smoke_lanes, side):
    doc = smoke_lanes[0] if side == "port" else smoke_lanes[1]
    committed = json.loads(
        (ROOT / "results" / "serving_smoke.json").read_text())
    assert sorted(doc) == sorted(committed)
    assert {k: v for k, v in doc.items() if k not in LANE_TIMED} == \
        {k: v for k, v in committed.items() if k not in LANE_TIMED}
    served = doc["served"]
    assert served["compiled"] == doc["compiles"] == 5
    assert served["cache"] + served["coalesced"] == doc["duplicates"] == 15


def test_smoke_lane_port_equals_jax(smoke_lanes):
    port, ref = smoke_lanes[:2]
    assert {k: v for k, v in port.items() if k not in LANE_TIMED} == \
        {k: v for k, v in ref.items() if k not in LANE_TIMED}


def test_chip_smoke_copies_the_lane(smoke_lanes):
    """``chip_smoke.py`` cannot import ``benchmarks``: its copy of the
    lane's workload and settings equals the lane's."""
    _, _, smoke, lane = smoke_lanes
    from repro.cgra.registry import kernel_names

    for kernels, arches, n in ((kernel_names(), lane.ARCHES, 320),
                               (lane.SMOKE_KERNELS, lane.SMOKE_ARCHES, 20)):
        assert smoke.build_workload(kernels, list(arches), n, 7, 1.1) == \
            lane.build_workload(kernels, list(arches), n, 7, 1.1)
    assert list(smoke.SERVE_ARCHES) == lane.ARCHES
    assert smoke.SERVE_KERNEL_ARCHES == lane.KERNEL_ARCHES
    assert smoke.SERVE_KERNEL_CONFIG == lane.KERNEL_CONFIG
    assert list(smoke.SERVE_PRIORITIES) == lane.PRIORITIES
    assert list(smoke.SERVE_TENANTS) == lane.TENANTS
    assert smoke.SERVE_VOLATILE_KEYS == lane.VOLATILE_KEYS == VOLATILE
    assert smoke.MAP_CONFIG == {"backend": "cdcl", "per_ii_timeout_s": 60.0,
                                "total_timeout_s": 120.0, "ii_max": 32}


# ---------------------------------------------------------------------------
# the server end to end (in-process TCP)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("server_side,client_side", [
    ("port", "port"), ("port", "jax"), ("jax", "port")])
def test_served_result_equals_a_direct_compile(server_side, client_side):
    """Either package's client against either package's server: the
    served result equals a direct compile of either package, and the
    client revives it through its own wire view."""
    pkgs = {"port": PORT, "jax": JAX}

    async def body(server, client):
        cr, served = await client.compile("bitcount", arch="2x2")
        assert served == "compiled"
        return cr

    cr = asyncio.run(_with_server(body, pkgs[server_side],
                                  pkgs[client_side]))
    assert isinstance(cr.map_result, WireMapResult if client_side == "port"
                      else JaxWireMapResult)
    direct = Toolchain("2x2", PORT.config).compile("bitcount")
    ref = JaxToolchain("2x2", JAX.config).compile("bitcount")
    assert cr.ok and cr.ii == direct.ii == ref.ii
    assert _projection(cr.summary()) == _projection(direct.summary()) == \
        _projection(ref.summary())


def test_serving_needs_no_device(monkeypatch, tmp_path):
    """A compile and a cache replay with CUDA reported absent: nothing on
    the server's path reaches for the card."""
    asked = []
    monkeypatch.setattr(torch.cuda, "is_available",
                        lambda: asked.append(1) or False)

    async def body(server, client):
        first, s1 = await client.compile("gsm")
        second, s2 = await client.compile("gsm")
        return first, s1, second, s2

    first, s1, second, s2 = asyncio.run(
        _with_server(body, cache=str(tmp_path / "cache")))
    assert (s1, s2) == ("compiled", "cache")
    assert first.ok and second.ok and asked == []


def test_concurrent_identical_requests_coalesce(monkeypatch):
    """N identical concurrent requests, one mapper invocation: the counted
    solver blocks until every request has joined the in-flight group."""
    from repro_torch.toolchain import resilience

    real = resilience._run_map_payload
    calls, release = [], threading.Event()

    def counting(payload, inline=False, cancel=None):
        calls.append(payload["kernel"])
        release.wait(timeout=30)
        return real(payload, inline=inline, cancel=cancel)

    monkeypatch.setattr(resilience, "_run_map_payload", counting)
    n = 5

    async def body(server, client):
        tasks = [asyncio.ensure_future(client.compile("bitcount"))
                 for _ in range(n)]
        for _ in range(500):
            if len(server.inflight) == 1 and server.inflight.depth(
                    next(iter(server.inflight._waiters))) == n:
                break
            await asyncio.sleep(0.01)
        else:
            pytest.fail("requests never coalesced onto one key")
        release.set()
        out = await asyncio.gather(*tasks)
        assert server.mapper_invocations == 1
        assert sorted(s for _, s in out) == \
            ["coalesced"] * (n - 1) + ["compiled"]
        assert len({_canon(_projection(cr.summary())) for cr, _ in out}) == 1
        stats = await client.stats()
        assert (stats["serving"]["received"], stats["serving"]["compiled"],
                stats["serving"]["coalesced"]) == (n, 1, n - 1)

    asyncio.run(_with_server(body, jobs=2))
    assert calls == ["bitcount"]


def test_high_priority_jumps_the_low_priority_flood(monkeypatch):
    from repro_torch.toolchain import resilience

    real = resilience._run_map_payload
    calls, gate = [], threading.Semaphore(0)

    def gated(payload, inline=False, cancel=None):
        calls.append(payload["cfg"]["ii_max"])
        gate.acquire()
        return real(payload, inline=inline, cancel=cancel)

    monkeypatch.setattr(resilience, "_run_map_payload", gated)
    lows, high = [8, 9, 10, 11], 30

    async def body(server, client):
        tasks = [asyncio.ensure_future(client.compile(
            "bitcount", config={"ii_max": m}, priority=0)) for m in lows]
        for _ in range(500):
            if calls:
                break
            await asyncio.sleep(0.01)
        assert calls == [lows[0]]
        tasks.append(asyncio.ensure_future(client.compile(
            "bitcount", config={"ii_max": high}, priority=5)))
        for _ in range(500):
            if server.inflight.depth(
                    next(iter(reversed(server.inflight._waiters)))):
                break
            await asyncio.sleep(0.01)
        for _ in range(len(lows) + 1):
            gate.release()
        out = await asyncio.gather(*tasks)
        assert all(cr.ok for cr, _ in out)

    asyncio.run(_with_server(body, jobs=1))
    assert calls[0] == lows[0] and calls[1] == high
    assert sorted(calls[2:]) == sorted(lows[1:])


def test_duplicate_after_completion_is_served_from_cache(tmp_path):
    async def body(server, client):
        first, served1 = await client.compile("bitcount")
        second, served2 = await client.compile("bitcount")
        assert (served1, served2) == ("compiled", "cache")
        assert server.mapper_invocations == 1
        assert second.cache_hit and not first.cache_hit
        assert _projection(second.summary()) == _projection(first.summary())
        stats = await client.stats()
        assert stats["serving"]["cache_hits"] == stats["cache"]["hits"] == 1

    asyncio.run(_with_server(body, cache=str(tmp_path / "cache")))


def test_corrupt_cache_entry_is_noted_and_resolved(tmp_path):
    """A torn cache entry is quarantined, re-solved, and the result
    carries the ``cache_corrupt`` note, as in the JAX package."""
    cache_dir = tmp_path / "cache"
    notes = []
    for pkg in (PORT, JAX):
        async def body(server, client):
            await client.compile("bitcount")
            (entry,) = [p for p in cache_dir.rglob("*.json")
                        if "quarantine" not in p.parts]
            entry.write_text("{torn")
            cr, served = await client.compile("bitcount")
            assert served == "compiled" and cr.ok
            return cr.failure

        for p in cache_dir.rglob("*"):
            if p.is_file():
                p.unlink()
        notes.append(asyncio.run(_with_server(body, pkg,
                                              cache=str(cache_dir))))
    assert notes[0]["kind"] == "cache-corrupt"
    assert notes[0] == notes[1]


def test_tenant_budget_rejects_excess_inflight(monkeypatch):
    from repro_torch.toolchain import resilience

    real = resilience._run_map_payload
    release = threading.Event()

    def blocking(payload, inline=False, cancel=None):
        release.wait(timeout=30)
        return real(payload, inline=inline, cancel=cancel)

    monkeypatch.setattr(resilience, "_run_map_payload", blocking)

    async def body(server, client):
        first = asyncio.ensure_future(
            client.compile("bitcount", tenant="alice"))
        for _ in range(500):
            if len(server.inflight):
                break
            await asyncio.sleep(0.01)
        with pytest.raises(ServeError, match="admission budget") as err:
            await client.compile("reversebits", tenant="alice")
        assert err.value.response["type"] == "rejected"
        other = asyncio.ensure_future(
            client.compile("reversebits", tenant="bob"))
        release.set()
        (cr1, _), (cr2, _) = await asyncio.gather(first, other)
        assert cr1.ok and cr2.ok
        assert (await client.stats())["serving"]["rejected"] == 1
        cr3, served = await client.compile("bitcount", tenant="alice")
        assert cr3.ok and served == "compiled"

    asyncio.run(_with_server(body, tenant_budget=1))


def test_unknown_kernel_is_the_jax_typed_error():
    async def body(server, client):
        with pytest.raises((ServeError, jax_serve.ServeError),
                           match="unknown kernel"):
            await client.compile("no_such_kernel")
        resp = await client.submit("no_such_kernel")
        assert resp["type"] == "error"
        assert (await client.stats())["serving"]["errors"] == 2
        cr, _ = await client.compile("bitcount")
        assert cr.ok
        return resp["error"]

    port = asyncio.run(_with_server(body))
    ref = asyncio.run(_with_server(body, JAX))
    assert port == ref


def test_bare_dfg_request_keeps_toolchain_semantics():
    async def body(server, client):
        cr, served = await client.compile(running_example(), arch="2x2")
        assert served == "compiled"
        return cr

    cr = asyncio.run(_with_server(body))
    direct = Toolchain("2x2", PORT.config).compile(running_example())
    ref = JaxToolchain("2x2", JAX.config).compile(jax_running_example())
    assert cr.status == "error" and cr.stage == "assemble"
    assert cr.map_result.status == "mapped"
    assert cr.ii == direct.ii == ref.ii
    assert _projection(cr.summary()) == _projection(direct.summary()) == \
        _projection(ref.summary())


def _serve_in_thread(pkg, cache_dir):
    """A server of ``pkg`` on a free port in a daemon thread, serving until
    a client sends ``shutdown``; returns (thread, host, port)."""
    started, info = threading.Event(), {}

    def run():
        async def go():
            server = pkg.server("2x2", pkg.config, inline=True,
                                cache=cache_dir)
            try:
                info["host"], info["port"] = await server.start()
                started.set()
                await server.wait_closed()
            finally:
                server.close()

        asyncio.run(go())

    t = threading.Thread(target=run, daemon=True)
    t.start()
    assert started.wait(20)
    return t, info["host"], info["port"]


def test_request_sync_and_server_shutdown(tmp_path):
    t, host, port = _serve_in_thread(PORT, str(tmp_path / "cache"))
    resp = request_sync("bitcount", host, port)
    assert resp["type"] == "result" and resp["served"] == "compiled"
    assert CompileResult.from_dict(resp["result"]).ok
    stats = request_sync(None, host, port)
    assert stats["type"] == "stats"
    assert stats["stats"]["serving"]["compiled"] == 1
    resp2 = request_sync("bitcount", host, port, shutdown=True)
    assert resp2["served"] == "cache"
    t.join(timeout=20)
    assert not t.is_alive()


def test_jax_server_cache_replays_in_the_port_server(tmp_path):
    """One cache directory: the JAX server writes it, the port server
    replays from it (and back)."""
    cache_dir = str(tmp_path / "cache")

    async def compile_two(server, client):
        return [await client.compile(k) for k in ("bitcount", "gsm")]

    written = asyncio.run(_with_server(compile_two, JAX, cache=cache_dir))
    replayed = asyncio.run(_with_server(compile_two, PORT, cache=cache_dir))
    assert [s for _, s in written] == ["compiled"] * 2
    assert [s for _, s in replayed] == ["cache"] * 2

    async def reversebits(server, client):
        return await client.compile("reversebits")

    assert asyncio.run(_with_server(reversebits, PORT,
                                    cache=cache_dir))[1] == "compiled"
    assert asyncio.run(_with_server(reversebits, JAX,
                                    cache=cache_dir))[1] == "cache"
    for (cr, _), (ref, _) in zip(replayed, written):
        assert cr.cache_hit and cr.ok
        assert _projection(cr.summary()) == _projection(ref.summary())


# ---------------------------------------------------------------------------
# the verbs: serve --stdio, submit --json against the JAX package's
# ---------------------------------------------------------------------------


def test_serve_stdio_subprocess_end_to_end():
    async def go():
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "repro_torch", "serve", "--stdio",
            "--arch", "2x2", "--backend", "cdcl", "--inline", "--jobs", "1",
            "--timeout", "30", stdin=asyncio.subprocess.PIPE,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.DEVNULL, env=_env())
        try:
            client = await ServeClient.over_streams(proc.stdout, proc.stdin)
            assert client.hello == {"type": "hello", "v": 1,
                                    "server": "repro-serve", "arch": "2x2",
                                    "jobs": 1}
            cr, served = await client.compile("bitcount", arch="2x2")
            assert cr.ok and served == "compiled"
            await client.shutdown()
            await client.close()
            await asyncio.wait_for(proc.wait(), timeout=30)
            assert proc.returncode == 0
        finally:
            if proc.returncode is None:
                proc.kill()
                await proc.wait()

    asyncio.run(asyncio.wait_for(go(), timeout=120))


def test_submit_json_equals_the_jax_submit(tmp_path):
    """``python -m repro_torch submit --json`` prints ``python -m repro
    submit --json``'s document for the same answer, apart from timings;
    ``--shutdown`` stops the server."""
    t, host, port = _serve_in_thread(PORT, str(tmp_path / "cache"))

    def submit(package, *extra):
        proc = subprocess.run(
            [sys.executable, "-m", package, "submit", "bitcount", "--grid",
             "2x2", "--backend", "cdcl", "--timeout", "30", "--host", host,
             "--port", str(port), "--json", *extra],
            capture_output=True, text=True, env=_env(), timeout=120)
        assert proc.returncode == 0, proc.stderr
        doc = json.loads(proc.stdout)
        doc.pop("stage_times_s")
        return doc

    first = submit("repro_torch")
    port_doc, jax_doc = submit("repro_torch"), submit("repro")
    assert first["served"] == "compiled" and port_doc["served"] == "cache"
    assert port_doc == jax_doc
    assert dict(first, served="cache", cache_hit=True) == port_doc
    out = tmp_path / "digest.json"
    assert submit("repro_torch", "--shutdown", "--out", str(out)) == \
        port_doc
    assert json.loads(out.read_text())["served"] == "cache"
    t.join(timeout=20)
    assert not t.is_alive()


def test_submit_reports_a_rejection_and_exits_1(tmp_path):
    t, host, port = _serve_in_thread(PORT, str(tmp_path / "cache"))
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch", "submit", "no_such_kernel",
             "--port", str(port)], capture_output=True, text=True,
            env=_env(), timeout=120)
        assert proc.returncode == 1 and proc.stdout == ""
        assert json.loads(proc.stderr)["type"] == "error"
        assert "unknown kernel" in json.loads(proc.stderr)["error"]
    finally:
        request_sync(None, host, port, shutdown=True)
        t.join(timeout=20)
    assert not t.is_alive()


def test_serve_exports_the_jax_names():
    assert serve.__all__ == jax_serve.__all__
    assert (serve.WIRE_VERSION, serve.DEFAULT_PORT) == \
        (jax_serve.WIRE_VERSION, jax_serve.DEFAULT_PORT)
