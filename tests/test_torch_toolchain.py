"""The port's single-point ``Toolchain`` and ``map`` verb against the JAX
package's: compile results, map results and metrics (capability-annotated
architectures included), the archspec presets, simulate/verify on fresh
mappings, the ``StageError`` of a bare DFG, and the parts that are not
ported yet, which must raise rather than fall back.  Everything runs on the
CPU; every comparison is exact, wall-clock timings aside.
"""
import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("torch", reason="optional extra: pip install .[torch]")
pytest.importorskip("jax", reason="optional extra: pip install .[jax]")

from repro.archspec import PRESETS, parse_arch as jax_parse_arch  # noqa: E402
from repro.cgra import energy as jax_energy  # noqa: E402
from repro.cgra import simulator as jax_sim  # noqa: E402
from repro.cgra.arch import make_grid as jax_make_grid  # noqa: E402
from repro.cgra.programs import synthetic_dfg as jax_synthetic  # noqa: E402
from repro.core.mapper import MapperConfig as JaxConfig  # noqa: E402
from repro.toolchain import cli as jax_cli  # noqa: E402
from repro.toolchain.session import Toolchain as JaxToolchain  # noqa: E402
from repro_torch.archspec import parse_arch  # noqa: E402
from repro_torch.cgra import energy  # noqa: E402
from repro_torch.cgra.arch import Grid, make_grid, neighbor_table  # noqa: E402
from repro_torch.cgra.artifact import Artifact, load_artifact  # noqa: E402
from repro_torch.cgra.programs import benchmark_mem, synthetic_dfg  # noqa: E402
from repro_torch.cgra.registry import kernel_names  # noqa: E402
from repro_torch.cgra.simulator import (map_for_execution, simulate,  # noqa: E402
                                        verify)
from repro_torch.core.mapper import MapperConfig  # noqa: E402
from repro_torch.fuzz import cli as fuzz_cli  # noqa: E402
from repro_torch.toolchain import StageError, Toolchain  # noqa: E402
from repro_torch.toolchain import cli  # noqa: E402
from torch_parity import SHIPPED  # noqa: E402

#: (kernel, arch): CEGAR at 2x2, other grids, capability tables (the
#: arch_area branch of the metrics stage) and a mesh
COMPILE_CASES = [("gsm", "2x2"), ("sqrt", "3x3"), ("dotprod", "4x4"),
                 ("bitcount", "bordermem-4x4"), ("saxpy", "fewmul-4x4"),
                 ("relu_clamp", "adres-4x4"),
                 ("reversebits", "mesh-3x3:regs=8")]
#: MapResult fields measured on the wall clock
_TIMED = ("total_time_s", "time_s", "encode_time_s")


def _untimed(doc):
    if isinstance(doc, dict):
        return {k: _untimed(v) for k, v in doc.items() if k not in _TIMED}
    if isinstance(doc, list):
        return [_untimed(v) for v in doc]
    return doc


def _config(cls):
    return cls(per_ii_timeout_s=30.0, total_timeout_s=60.0, ii_max=32)


@pytest.mark.parametrize("name,arch", COMPILE_CASES)
def test_compile_matches_jax(name, arch):
    tc = Toolchain(arch, _config(MapperConfig))
    j_tc = JaxToolchain(arch, _config(JaxConfig))
    cr, want = tc.compile(name), j_tc.compile(name)
    assert cr.ok and want.ok
    assert tc.arch == j_tc.arch
    assert (cr.status, cr.stage, cr.error, cr.ii, cr.mii) == \
        (want.status, want.stage, want.error, want.ii, want.mii)
    assert cr.metrics.to_dict() == want.metrics.to_dict()
    assert dataclasses.asdict(cr.metrics) == dataclasses.asdict(want.metrics)
    assert _untimed(cr.map_result.to_dict()) == \
        _untimed(want.map_result.to_dict())
    summary = cr.summary()
    j_summary = want.summary()
    assert summary.keys() == j_summary.keys()
    summary.pop("stage_times_s")
    j_summary.pop("stage_times_s")
    assert summary == j_summary
    assert set(cr.timings) == {"source", "map", "assemble", "metrics"}
    # the energy model's one-call path and the area objective
    assert dataclasses.asdict(energy.metrics_for_mapping(
        cr.program.builder, cr.mapping)) == dataclasses.asdict(
        jax_energy.metrics_for_mapping(want.program.builder, want.mapping))
    assert energy.arch_area(tc.grid) == jax_energy.arch_area(j_tc.grid)


def test_simulate_and_verify_on_a_fresh_mapping_match_jax():
    grid, j_grid = make_grid(2, 2), jax_make_grid(2, 2)
    tc, j_tc = Toolchain(grid), JaxToolchain(j_grid)
    prog, j_prog = tc.program("gsm"), j_tc.program("gsm")
    res = map_for_execution(prog.builder, grid,
                            MapperConfig(total_timeout_s=60))
    j_res = jax_sim.map_for_execution(j_prog.builder, j_grid,
                                      JaxConfig(total_timeout_s=60))
    assert res.cegar_rounds == j_res.cegar_rounds >= 1
    mem = benchmark_mem("gsm", 3)
    sim = tc.simulate(prog, res.mapping, mem, batch=2, device="cpu")
    want = j_tc.simulate(j_prog, j_res.mapping, mem, batch=2, backend="ref")
    assert sim.total_rows == want.total_rows
    np.testing.assert_array_equal(sim.final_mem, want.final_mem)
    assert sim.node_values.keys() == want.node_values.keys()
    for n, vals in sim.node_values.items():
        np.testing.assert_array_equal(vals, want.node_values[n])
    assert verify(prog.builder, res.mapping, mem, device="cpu") == \
        jax_sim.verify(j_prog.builder, j_res.mapping, mem) == []
    art = Artifact.from_mapping(prog.builder, res.mapping)
    again = simulate(art, mem, batch=2, device="cpu")
    np.testing.assert_array_equal(again.final_mem, sim.final_mem)


def test_bare_dfg_stops_after_map():
    dfg, j_dfg = synthetic_dfg("nw", 3), jax_synthetic("nw", 3)
    tc, j_tc = Toolchain("4x4"), JaxToolchain("4x4")
    cr, want = tc.compile(dfg), j_tc.compile(j_dfg)
    assert (cr.status, cr.stage, cr.error, cr.ii) == \
        (want.status, want.stage, want.error, want.ii)
    assert (cr.status, cr.stage) == ("error", "assemble")
    for stage, call in (
            ("assemble", lambda: tc.assemble(dfg, cr.mapping)),
            ("simulate", lambda: tc.simulate(dfg, cr.mapping, [0] * 128,
                                             device="cpu"))):
        with pytest.raises(StageError) as err:
            call()
        assert err.value.stage == stage
    with pytest.raises(StageError) as err:
        tc.program(3.5)
    assert err.value.stage == "source"


@pytest.mark.parametrize("strategy", ["portfolio:cdcl-seq+cdcl-pair",
                                      "portfolio:cdcl-seq,spec_ii=2",
                                      "portfolio:auto"])
def test_racing_strategy_raises(strategy):
    """A racing strategy raised while the racer was not ported; now the
    in-process race (``jobs=1``) maps as the JAX package's does, and only
    a strategy that conflicts with the backend still raises."""
    tc = Toolchain("2x2", MapperConfig(strategy=strategy))
    res = tc.map("bitcount", jobs=1)
    want = JaxToolchain("2x2", JaxConfig(strategy=strategy)).map(
        "bitcount", jobs=1)
    assert res.status == want.status == "mapped"
    assert _untimed(res.to_dict()) == _untimed(want.to_dict())
    cr = tc.compile("bitcount", jobs=1)
    assert (cr.status, cr.stage, cr.ii) == ("ok", None, want.ii)
    with pytest.raises(ValueError, match="conflicts"):
        Toolchain("2x2", MapperConfig(strategy=strategy,
                                      backend="cdcl")).map("bitcount")


def test_single_strategies_map_as_the_legacy_pair():
    for strategy in ("cdcl-pair", "cdcl-seq"):
        cr = Toolchain("2x2", MapperConfig(strategy=strategy)).compile("gsm")
        want = JaxToolchain("2x2", JaxConfig(strategy=strategy)).compile(
            "gsm")
        assert cr.ii == want.ii
        assert _untimed(cr.map_result.to_dict()) == \
            _untimed(want.map_result.to_dict())


def test_unported_session_parts_raise(tmp_path):
    """No session part is left unported: the cache, the fact store,
    ``jobs=`` and ``compile_many`` build what the JAX package's do, and the
    sweep, the heuristic baseline, the compile server and the ``sweep``/
    ``trace``/``arch``/``serve``/``submit`` verbs are there, so nothing
    raises: each module imports and each verb answers ``--help``."""
    import importlib
    import subprocess
    import sys

    from repro_torch.core.facts import FactStore
    from repro_torch.dse import MappingCache

    tc = Toolchain("2x2", cache=str(tmp_path / "c"), facts=True)
    assert isinstance(tc.cache, MappingCache)
    assert isinstance(tc.facts, FactStore)
    assert Toolchain("2x2", facts="session").facts is not tc.facts
    (cr,) = tc.compile_many(["bitcount"], [(2, 2)], jobs=1)
    assert cr.ok and cr.failure is None and len(tc.cache) == 1
    assert tc.map("bitcount", jobs=2).status == "mapped"
    assert tc.last_cache_hit
    assert tc.compile("bitcount", jobs=2).cache_hit
    for module in ("repro_torch.dse.sweep", "repro_torch.dse.space",
                   "repro_torch.core.baseline_ims", "repro_torch.obs.report",
                   "repro_torch.serve", "repro_torch.serve.server"):
        importlib.import_module(module)
    for verb in ("sweep", "trace", "arch", "serve", "submit"):
        proc = subprocess.run([sys.executable, "-m", "repro_torch", verb,
                               "--help"], capture_output=True, text=True,
                              timeout=60)
        assert proc.returncode == 0 and "usage" in proc.stdout


@pytest.mark.parametrize("spec", sorted(PRESETS) + [
    "4x4", "mesh-4x4:mem=col0,regs=8,ports=1/row", "torus-3x5:mul=row1"])
def test_archspec_resolves_as_in_jax(spec):
    port, want = parse_arch(spec), jax_parse_arch(spec)
    assert port.to_compact() == want.to_compact()
    assert port.label() == want.label()
    assert port.arch_hash() == want.arch_hash()
    grid, j_grid = port.grid(), want.grid()
    assert grid.num_pes == j_grid.num_pes
    assert [sorted(grid.neighbors(p)) for p in range(grid.num_pes)] == \
        [sorted(j_grid.neighbors(p)) for p in range(j_grid.num_pes)]
    assert (grid.caps.to_dict() if grid.caps else None) == \
        (j_grid.caps.to_dict() if j_grid.caps else None)
    assert grid.arch_fingerprint() == j_grid.arch_fingerprint()
    assert grid.assemblable == j_grid.assemblable
    assert grid.is_vertex_transitive() == j_grid.is_vertex_transitive()
    assert [energy.pe_area(grid, p) for p in range(grid.num_pes)] == \
        [jax_energy.pe_area(j_grid, p) for p in range(j_grid.num_pes)]
    if grid.assemblable:
        assert neighbor_table(grid) == jax_sim.neighbor_table(j_grid)


@pytest.mark.parametrize("argv", [["list"]] + [
    ["show", spec] for spec in sorted(PRESETS) + [
        "4x4", "mesh-4x4:mem=col0,regs=8,ports=1/row", "torus-3x5:mul=row1"]])
def test_arch_verb_prints_as_in_jax(argv, capsys):
    assert cli.arch_main(argv) == 0
    port = capsys.readouterr().out
    assert jax_cli.main(["arch", *argv]) == 0
    assert port == capsys.readouterr().out


def test_artifact_grid_is_the_mapper_grid():
    assert Grid(4, 4) == make_grid(4, 4) == parse_arch("4x4").grid()
    assert Grid(3, 3, "mesh") == make_grid(3, 3, torus=False)
    assert Grid(4, 4) != parse_arch("openedge-4x4").grid()
    with pytest.raises(ValueError):
        Grid(4, 4, "diagonal")


@pytest.mark.parametrize("arch,kernel", SHIPPED)
def test_artifact_to_dict_inverts_from_dict(arch, kernel):
    art = load_artifact(arch, kernel)
    again = Artifact.from_dict(art.to_dict())
    assert again.to_dict() == art.to_dict()
    assert again.grid == art.grid


@pytest.mark.parametrize("argv", [["gsm", "--grid", "2x2"],
                                  ["dotprod", "--arch", "bordermem-4x4",
                                   "--no-oracle"],
                                  ["sqrt", "--grid", "3x3", "--ii-max", "2"]])
def test_map_verb_digest_matches_jax(argv, capsys, tmp_path):
    out = tmp_path / "digest.json"
    rc = cli.main([*argv, "--json", "--out", str(out)])
    port = json.loads(capsys.readouterr().out)
    assert json.loads(out.read_text()) == port
    assert rc == jax_cli.main(["map", *argv, "--json"])
    want = json.loads(capsys.readouterr().out)
    for doc in (port, want):
        doc.pop("wall_time_s")
        doc.pop("stage_times_s")
    assert port == want


def _spans(trace_dir):
    """Every record of a trace directory as (kind, name, attributes)."""
    return sorted(
        json.dumps([rec["k"], rec["name"], rec.get("attrs")], sort_keys=True)
        for shard in sorted(trace_dir.glob("*.jsonl"))
        for rec in map(json.loads, shard.read_text().splitlines()))


def test_map_verb_trace_records_the_jax_spans(tmp_path, capsys):
    from repro.obs import trace as jax_trace
    from repro_torch.obs import trace

    try:
        assert cli.main(["gsm", "--grid", "2x2", "--trace",
                         str(tmp_path / "port")]) == 0
        assert jax_cli.main(["map", "gsm", "--grid", "2x2", "--trace",
                             str(tmp_path / "jax")]) == 0
    finally:
        trace.disable()
        jax_trace.disable()
    capsys.readouterr()
    port = _spans(tmp_path / "port")
    assert port and port == _spans(tmp_path / "jax")
    assert any('"solver.solve"' in rec for rec in port)


def test_map_verb_prints_a_summary(capsys):
    assert cli.main(["gsm", "--grid", "2x2"]) == 0
    printed = capsys.readouterr().out
    assert printed.startswith("gsm @ 2x2: II=5 (mII=5) backend=cdcl")


def test_fuzz_all_means_every_registry_kernel():
    assert fuzz_cli._resolve_kernels("all") == kernel_names()
    with pytest.raises(SystemExit):
        fuzz_cli._resolve_kernels("gsm,nosuchkernel")
