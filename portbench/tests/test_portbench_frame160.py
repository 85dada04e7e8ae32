"""The configuration ``cgra-4x4-frame160`` (the paper's 4x4 torus with its
loops at one GSM 06.10 frame a call: trip 160 over 512-word images) and its
cell: its frozen data and the plain reference on the CPU; on the card
(``-m cuda``) the uniform layout at P = 16 running the long programs from
the two-slot ring, bit-exact against the plain PyTorch version, and a
short traced run of the cell."""
import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from portbench.harness import memgen, reference, spec, window

ROOT = Path(__file__).resolve().parents[2]
CONFIG = json.loads((ROOT / "portbench" / "configs"
                     / "cgra-4x4-frame160.json").read_text())
KERNELS = CONFIG["kernels"]
CELL = "fuzz-4x4-frame160-b16384"
M = CONFIG["memory_words"]


def _doc(kernel):
    return json.loads((ROOT / CONFIG["data"] / f"{kernel}.json").read_text())


def _mems(doc, n, seed):
    return memgen.memories(doc["regions"], doc["wide_product"], n,
                           memgen.rng_for(seed, doc["kernel"]), M)


def test_the_configuration_holds_its_frozen_data():
    assert (CONFIG["arch"], CONFIG["rows"], CONFIG["cols"],
            CONFIG["num_pes"], CONFIG["topology"], M, CONFIG["trip"]) == (
        "4x4", 4, 4, 16, "torus", 512, 160)
    for k in KERNELS:
        doc = _doc(k)
        assert (doc["kernel"], doc["arch"], doc["num_pes"], doc["trip"],
                doc["mem_words"]) == (k, "4x4", 16, 160, 512)
        assert doc["ii"] == CONFIG["ii_beside_cgra_4x4"][k]["ii"]
        assert len(doc["words"]) == CONFIG["ii_beside_cgra_4x4"][k]["rows"]
        for base, length, _, _ in doc["regions"]:
            assert 0 <= base and base + length <= M
    rows = sorted(len(_doc(k)["words"]) for k in KERNELS)
    assert (rows[0], rows[-1]) == (162, 1120)
    assert sorted(p.stem for p in (ROOT / CONFIG["data"]).glob("*.json")) \
        == sorted(KERNELS)


def test_the_cell_is_found_by_name():
    cell = spec.load_cell(CELL, ROOT)
    assert cell.chips == 1 and cell.config["name"] == "cgra-4x4-frame160"
    assert [d["kernel"] for d in cell.docs] == KERNELS
    assert int(cell.config["memory_words"]) == 512
    assert {m["name"] for m in cell.end_to_end} == {"mem_per_s", "setup_s"}
    assert {"pe_array_ms_per_kmem", "run_cycles_roofline",
            "activity_setup_ms_per_kmem"} <= {m["name"]
                                              for m in cell.per_layer}


@pytest.mark.parametrize("kernel", KERNELS)
def test_each_frozen_bitstream_computes_its_cil_program(kernel):
    """At every cell of every iteration and in the final image, over
    512-word images."""
    doc = _doc(kernel)
    mems = _mems(doc, 100, 2 ** 31 + 11)
    assert mems.shape == (100, 512)
    run = reference.simulate(doc, mems)
    every, final = reference.interpret(doc["program"], mems,
                                       every_iteration=True)
    assert np.array_equal(run.final_mem, final)
    assert len(every) == len(doc["program"]["nodes"]) * 160
    assert set(every) <= set(run.cells)
    for key, v in every.items():
        assert np.array_equal(run.cells[key], v), key
    assert reference.fuzz_verdicts(doc, mems).failing == []


def _plain(doc, mems, device="cpu"):
    """The program's inputs for ``doc`` over ``mems``: (fields, preset
    state, neighbour table) on ``device``."""
    import torch

    from repro_torch.cgra.arch import neighbor_table
    from repro_torch.cgra.artifact import Artifact
    from repro_torch.cgra.simulator import preset_state
    from repro_torch.kernels.ops import decode_fields

    art = Artifact.from_dict(doc)
    fields = decode_fields(art.asm.words(), device)
    state = preset_state(art.asm, 16, mems, len(mems), device)
    nbrs = torch.as_tensor(np.asarray(neighbor_table(art.grid), np.int32),
                           device=device)
    return fields, state, nbrs


@pytest.mark.parametrize("kernel", ["gsm_f160", "stencil3_f160"])
def test_the_plain_version_equals_the_reference(kernel):
    """``run_cycles_ref`` (plain torch, no kernel) against the numpy
    reference at B = 16: every named cell and the final image."""
    from repro_torch.kernels.ref import run_cycles_ref

    doc = _doc(kernel)
    mems = _mems(doc, 16, 2 ** 32 + 5)
    final, outs = run_cycles_ref(*_plain(doc, mems))
    run = reference.simulate(doc, mems)
    for (t, pe, n, j) in doc["node_of_cell"]:
        assert np.array_equal(outs[t, :, pe].numpy(), run.cells[(n, j)])
    assert np.array_equal(final.mem.numpy().astype(np.int64), run.final_mem)


def _window(reports):
    cell = spec.load_cell(CELL, ROOT)
    calls = [window.Call(kernel="k", index=0, doc={}, memories=None,
                         launches=[r.memories], report=r) for r in reports]
    return window.Window(cell=cell, seed=1, window_s=1.0, calls=calls)


def test_activity_setup_ms_per_kmem_reads_the_set_up_time():
    """Σ ``activity_setup_s`` per 1000 memories; nothing to read from a
    program whose reports lack the time."""
    read = spec.reader(ROOT, "activity_setup_ms_per_kmem")
    reps = [types.SimpleNamespace(memories=1000, activity_setup_s=0.002),
            types.SimpleNamespace(memories=3000, activity_setup_s=0.006)]
    assert read(_window(reps)) == pytest.approx(8.0 / 4.0)
    assert read(_window([types.SimpleNamespace(memories=1000)])) is None
    assert read(_window([])) is None


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the PE-array kernels run on the "
                    "card)")


def _same(got, want):
    import torch

    return all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("B,layout", [(1024, "uniform"), (1024, "lanes"),
                                      (16384, "uniform")])
@pytest.mark.parametrize("kernel", ["gsm_f160", "stencil3_f160"])
def test_run_cycles_at_p16_from_the_ring_is_bit_exact(cuda, kernel, B,
                                                      layout):
    """The uniform layout runs the long programs from the ring at both
    batches (at B = 1024 the lane layout, which ``fuzz_program`` takes
    there, stages them whole)."""
    from repro_torch.kernels import pe_array
    from repro_torch.kernels.ref import run_cycles_ref

    doc = _doc(kernel)
    fields, state, nbrs = _plain(doc, _mems(doc, B, 2 ** 31 + B), "cuda")
    T = fields.op.shape[0]
    which = (pe_array.UNIFORM_LAYOUT if layout == "uniform"
             else pe_array.LANE_LAYOUT)
    geom = pe_array.run_cycles_geometry(B, 16, M, 1, T, layout=which)
    assert (geom.chunk_rows < T) == (layout == "uniform")
    rings = pe_array.run_cycles.ring_launches
    final, outs = pe_array.run_cycles(fields, state, nbrs, layout=which)
    assert pe_array.run_cycles.ring_launches == rings + (
        layout == "uniform")
    want_final, want_outs = run_cycles_ref(fields, state, nbrs)
    assert _same((outs, *final), (want_outs, *want_final))


@pytest.mark.cuda
def test_the_fuzz_path_counts_its_ring_launches_and_names_the_program(
        cuda, tmp_path):
    """``fuzz_program`` on the card at the cell's batch: one ring launch a
    chunk, ``fuzz.program`` names the rows and the image's words, and the
    verdicts are the reference's."""
    from repro_torch.cgra.artifact import Artifact
    from repro_torch.fuzz import engine
    from repro_torch.obs import report
    from repro_torch.obs import trace as obs_trace

    doc = _doc("stencil3_f160")
    mems = _mems(doc, 32768, 7)
    obs_trace.enable(str(tmp_path / "trace"))
    try:
        rep = engine.fuzz_program(Artifact.from_dict(doc), mems,
                                  batch=16384, device="cuda")
    finally:
        obs_trace.disable()
    assert (rep.status, rep.ring_launches) == ("ok", 2)
    assert rep.failing == reference.fuzz_verdicts(doc, mems).failing == []
    spans = [r for r in report.load(str(tmp_path / "trace"))
             if r["k"] == "span"]
    (prog,) = [r for r in spans if r["name"] == "fuzz.program"]
    assert (prog["attrs"]["rows"], prog["attrs"]["mem_words"]) == (1120, 512)
    execs = [r["attrs"] for r in spans if r["name"] == "fuzz.execute"]
    assert execs == [{"pes_per_warp": 1, "chunk_rows": 63}] * 2
    assert 0 < rep.activity_setup_s <= rep.activity_time_s


@pytest.mark.cuda
def test_a_short_traced_run_of_the_cell(cuda):
    """One traced run of the cell in a process of its own, as the benchmark
    makes it (a profiler that has recorded windows before in a process can
    lose events): correct, and every per-layer metric of the cell read,
    which the PE-array ones are only where the profiled launches match the
    chunks sent."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         CELL, "--seed", str(2 ** 31 + 160), "--seconds", "1", "--trace",
         "1"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0
    assert all(v["value"] == 0 for v in line["checks"].values())
    metrics = {k: v["value"] for k, v in line["metrics"].items()}
    cell = spec.load_cell(CELL, ROOT)
    assert set(metrics) == {m["name"] for m in cell.per_layer}
    assert metrics["activity_setup_ms_per_kmem"] > 0
    assert 0 < metrics["run_cycles_roofline"] <= 105
