"""The 8x8 ADRES-template configuration of the benchmark on the port's fuzz
path, on the CPU: ``portbench/data/adres-8x8/`` holds one frozen artifact
a kernel, mapped on ``mesh-8x8:mem=row0,ports=1/row`` (a mesh, load-store
units in row 0 only, one memory port a row; P = 64).

At the cell's batch every frozen program takes the uniform layout at four
PEs a warp and runs from the two-slot program ring; fuzzed on the CPU, by
the plain versions, every frozen program passes.  The card's side is in
``portbench/tests/test_portbench_adres.py``.
"""
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch",
                            reason="optional extra: pip install .[torch]")

from repro_torch.cgra.artifact import Artifact  # noqa: E402
from repro_torch.fuzz import engine  # noqa: E402
from repro_torch.fuzz.corpus import make_corpus  # noqa: E402
from repro_torch.kernels import pe_array  # noqa: E402
from repro_torch.obs import report  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "portbench" / "configs" / "adres-8x8.json")
                    .read_text())
KERNELS = CONFIG["kernels"]
#: the cell's batch and image (``portbench/traffic/fuzz-b16384.json``)
CELL_B, M = 16384, 128


def _artifact(kernel: str) -> Artifact:
    path = ROOT / CONFIG["data"] / f"{kernel}.json"
    return Artifact.from_dict(json.loads(path.read_text()))


@pytest.mark.parametrize("kernel", KERNELS)
def test_the_cell_runs_every_program_from_the_ring(kernel):
    """Four PEs a warp, and fewer program rows a slot than the program
    has: every launch of the cell takes the ring."""
    art = _artifact(kernel)
    T, P = art.asm.words().shape
    assert (P, art.grid.topology) == (64, "mesh")
    geom = pe_array.run_cycles_geometry(CELL_B, P, M, T=T)
    assert geom.layout == pe_array.UNIFORM_LAYOUT
    assert pe_array.pes_per_warp(P) == geom.warp_pes(P) == 4
    assert geom.threads == 32 * 16
    assert geom.chunk_rows < T


def test_the_4x4_cell_stages_every_program_whole():
    """The other cell on the same traffic, P = 16: one PE a warp and no
    launch from the ring."""
    four = json.loads((ROOT / "portbench" / "configs" / "cgra-4x4.json")
                      .read_text())
    for kernel in four["kernels"]:
        doc = json.loads((ROOT / four["data"] / f"{kernel}.json")
                         .read_text())
        T = len(doc["words"])
        geom = pe_array.run_cycles_geometry(CELL_B, 16, M, T=T)
        assert (geom.layout, geom.chunk_rows) == (pe_array.UNIFORM_LAYOUT,
                                                  T), kernel


@pytest.mark.parametrize("kernel", KERNELS)
def test_every_frozen_program_fuzzes_clean_on_the_cpu(kernel):
    art = _artifact(kernel)
    mems = make_corpus(art, 64, seed=2 ** 31 + 3)
    rep = engine.fuzz_program(art, mems, batch=32, device="cpu")
    assert (rep.status, rep.failing, rep.memories) == ("ok", [], 64)
    assert rep.activity is not None
    assert rep.ring_launches == 0          # nothing is launched on the CPU


def test_a_lane_launch_holds_every_pe_of_a_row_in_one_warp():
    geom = pe_array.run_cycles_geometry(1024, 16, M, T=34)
    assert geom.layout == pe_array.LANE_LAYOUT
    assert geom.warp_pes(16) == 16


def _execs(path):
    return [r for r in report.load(path)
            if r["k"] == "span" and r["name"] == "fuzz.execute"]


def test_a_launch_names_its_shape_on_the_execute_span(tmp_path,
                                                      monkeypatch):
    """Where ``fuzz.execute`` makes a launch, the span carries the shape
    that ``run_cycles`` kept of it (a launch stood in for on the CPU)."""
    art = _artifact("bitcount")
    geom = pe_array.run_cycles_geometry(CELL_B, 64, M, T=art.asm.total_rows)
    real = engine.execute_asm

    def launched(*args, **kwargs):
        got = real(*args, **kwargs)
        pe_array.run_cycles.launches += 1
        pe_array.run_cycles.last_geometry = geom
        return got

    monkeypatch.setattr(engine, "execute_asm", launched)
    monkeypatch.setattr(pe_array.run_cycles, "launches",
                        pe_array.run_cycles.launches)
    monkeypatch.setattr(pe_array.run_cycles, "last_geometry", None)
    obs_trace.enable(str(tmp_path / "trace"))
    try:
        engine.fuzz_program(art, make_corpus(art, 32, seed=1), batch=16,
                            device="cpu")
    finally:
        obs_trace.disable()
    assert [r["attrs"] for r in _execs(str(tmp_path / "trace"))] == [
        {"pes_per_warp": 4, "chunk_rows": geom.chunk_rows}] * 2


def test_no_launch_no_launch_attributes(tmp_path):
    """On the CPU ``fuzz.execute`` makes no launch and carries none of a
    launch's attributes."""
    art = _artifact("bitcount")
    obs_trace.enable(str(tmp_path / "trace"))
    try:
        engine.fuzz_program(art, make_corpus(art, 32, seed=1), batch=16,
                            device="cpu")
    finally:
        obs_trace.disable()
    execs = _execs(str(tmp_path / "trace"))
    assert len(execs) == 2
    assert all(not r.get("attrs") for r in execs)
