"""The configuration ``adres-8x8`` (an 8x8 ADRES-template mesh, memory
through row 0, P = 64) and its cell: its frozen data and the plain
reference on the CPU; on the card (``-m cuda``) the uniform layout at
four PEs a warp, running every frozen program from the two-slot ring,
bit-exact against the plain PyTorch version."""
import json
import types
from pathlib import Path

import numpy as np
import pytest

from portbench.harness import memgen, reference, spec, window

ROOT = Path(__file__).resolve().parents[2]
CONFIG = json.loads((ROOT / "portbench" / "configs" / "adres-8x8.json")
                    .read_text())
KERNELS = CONFIG["kernels"]
CELL = "fuzz-adres8x8-b16384"


def _doc(kernel):
    return json.loads((ROOT / CONFIG["data"] / f"{kernel}.json").read_text())


def _mems(doc, n, seed):
    return memgen.memories(doc["regions"], doc["wide_product"], n,
                           memgen.rng_for(seed, doc["kernel"]))


def test_the_configuration_holds_its_frozen_data():
    assert (CONFIG["rows"], CONFIG["cols"], CONFIG["num_pes"],
            CONFIG["topology"]) == (8, 8, 64, "mesh")
    for k in KERNELS:
        doc = _doc(k)
        assert (doc["kernel"], doc["arch"], doc["rows"], doc["cols"],
                doc["topology"], doc["num_pes"]) == (
            k, CONFIG["arch_label"], 8, 8, "mesh", 64)
        assert np.asarray(doc["words"]).shape[1] == 64
    assert set(CONFIG["source_kernels"]) - set(KERNELS) == set(CONFIG["cut"])
    four = json.loads((ROOT / "portbench" / "configs" / "cgra-4x4.json")
                      .read_text())
    assert KERNELS == [k for k in four["kernels"] if k in KERNELS]
    assert CONFIG["mapper"] == four["mapper"]
    assert sorted(p.stem for p in (ROOT / CONFIG["data"]).glob("*.json")) \
        == sorted(KERNELS)


def test_the_cell_is_found_by_name():
    cell = spec.load_cell(CELL, ROOT)
    assert cell.chips == 1 and cell.config["name"] == "adres-8x8"
    assert [d["kernel"] for d in cell.docs] == KERNELS
    assert {m["name"] for m in cell.end_to_end} == {"mem_per_s", "setup_s"}
    assert {"pe_array_ms_per_kmem", "run_cycles_roofline"} \
        <= {m["name"] for m in cell.per_layer}


@pytest.mark.parametrize("kernel", KERNELS)
def test_each_frozen_bitstream_computes_its_cil_program(kernel):
    """At every cell of every iteration and in the final image, with the
    mesh's border neighbours pointing at the PE itself."""
    doc = _doc(kernel)
    mems = _mems(doc, 200, 2 ** 31 + 11)
    run = reference.simulate(doc, mems)
    every, final = reference.interpret(doc["program"], mems,
                                       every_iteration=True)
    assert np.array_equal(run.final_mem, final)
    assert set(every) <= set(run.cells)
    for key, v in every.items():
        assert np.array_equal(run.cells[key], v), key
    assert reference.fuzz_verdicts(doc, mems).failing == []


def _every_cell(doc):
    """``doc`` with every (row, PE) cell named, so that the reference's
    ``cells`` is the whole out trace: cell (t, p) is node t * P + p."""
    T, P = np.asarray(doc["words"]).shape
    return dict(doc, node_of_cell=[[t, p, t * P + p, 0]
                                   for t in range(T) for p in range(P)])


def _plain(doc, mems, device="cpu"):
    """The program's inputs for ``doc`` over ``mems``: (fields, preset
    state, neighbour table) on ``device``."""
    import torch

    from repro_torch.cgra.artifact import Artifact
    from repro_torch.cgra.arch import neighbor_table
    from repro_torch.cgra.simulator import preset_state
    from repro_torch.kernels.ops import decode_fields

    art = Artifact.from_dict(doc)
    fields = decode_fields(art.asm.words(), device)
    state = preset_state(art.asm, 64, mems, len(mems), device)
    nbrs = torch.as_tensor(np.asarray(neighbor_table(art.grid), np.int32),
                           device=device)
    return fields, state, nbrs


@pytest.mark.parametrize("kernel", KERNELS)
def test_the_plain_version_equals_the_reference(kernel):
    """``run_cycles_ref`` (plain torch, no kernel) against the numpy
    reference at B = 64: the whole out trace and the final image."""
    from repro_torch.kernels.ref import run_cycles_ref

    doc = _doc(kernel)
    mems = _mems(doc, 64, 2 ** 32 + 5)
    final, outs = run_cycles_ref(*_plain(doc, mems))
    T, P = np.asarray(doc["words"]).shape
    run = reference.simulate(_every_cell(doc), mems)
    want = np.stack([np.stack([run.cells[(t * P + p, 0)] for p in range(P)],
                              axis=1) for t in range(T)])
    assert np.array_equal(outs.numpy().astype(np.int64), want)
    assert np.array_equal(final.mem.numpy().astype(np.int64), run.final_mem)


def _report(memories):
    return types.SimpleNamespace(memories=memories)


def _window(reports, launches, ops=None):
    cell = spec.load_cell(CELL, ROOT)
    calls = [window.Call(kernel="k", index=0, doc={}, memories=None,
                         launches=list(ls), report=r)
             for r, ls in zip(reports, launches)]
    trace = None if ops is None else types.SimpleNamespace(ops=ops)
    return window.Window(cell=cell, seed=1, window_s=1.0, calls=calls,
                         trace=trace)


def test_pe_array_ms_per_kmem_sums_the_matched_launches():
    read = spec.reader(ROOT, "pe_array_ms_per_kmem")
    ops = [("run_cycles_kernel<false, 4>", 0.0, 0.002),
           ("oracle_kernel<true>", 0.0, 1.0),
           ("run_cycles_kernel<false, 4>", 0.0, 0.003)]
    win = _window([_report(2000)], [[1000, 1000]], ops)
    assert read(win) == pytest.approx(5.0 / 2.0)       # 5 ms over 2 kmem
    assert read(_window([_report(2000)], [[1000, 1000]])) is None
    assert read(_window([_report(2000)], [[1000, 1000, 1]], ops)) is None


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
@pytest.mark.parametrize("B", [1024, 16384])
@pytest.mark.parametrize("kernel", KERNELS)
def test_run_cycles_at_p64_from_the_ring_is_bit_exact(cuda, kernel, B):
    from repro_torch.kernels import pe_array
    from repro_torch.kernels.ref import run_cycles_ref

    doc = _doc(kernel)
    fields, state, nbrs = _plain(doc, _mems(doc, B, 2 ** 31 + B), "cuda")
    T = fields.op.shape[0]
    geom = pe_array.run_cycles_geometry(B, 64, 128, 1, T)
    assert geom.chunk_rows < T and geom.threads == 512
    launches = pe_array.run_cycles.launches
    rings = pe_array.run_cycles.ring_launches
    final, outs = pe_array.run_cycles(fields, state, nbrs)
    assert pe_array.run_cycles.launches == launches + 1
    assert pe_array.run_cycles.ring_launches == rings + 1
    want_final, want_outs = run_cycles_ref(fields, state, nbrs)
    assert _same((outs, *final), (want_outs, *want_final))


@pytest.mark.cuda
def test_a_stack_of_the_8x8_programs_is_bit_exact(cuda):
    """K = 10: every frozen program, NOP-padded to the longest, in one
    launch, against the plain version of the stack on the card."""
    from repro_torch.cgra.artifact import Artifact
    from repro_torch.fuzz import engine
    from repro_torch.kernels import pe_array

    docs = [_doc(k) for k in KERNELS]
    arts = [Artifact.from_dict(d) for d in docs]
    mems = np.stack([_mems(d, 512, 2 ** 33 + 1) for d in docs])
    launches = pe_array.run_cycles.launches
    final, outs = engine.run_stacked(arts, mems, device="cuda")
    assert pe_array.run_cycles.launches == launches + 1
    want_final, want_outs = engine.run_stacked(arts, mems, device="cpu")
    assert outs.shape == (10, 112, 512, 64)
    assert _same((outs, *final), (want_outs, *want_final))


@pytest.mark.cuda
def test_the_fuzz_path_counts_and_names_its_ring_launches(cuda, tmp_path):
    """``fuzz_program`` on the card: one ring launch a chunk in the
    report, and ``fuzz.execute`` carries the launch's shape."""
    from repro_torch.cgra.artifact import Artifact
    from repro_torch.fuzz import engine
    from repro_torch.obs import report
    from repro_torch.obs import trace as obs_trace

    doc = _doc("xorshift32")
    mems = _mems(doc, 4096, 7)
    obs_trace.enable(str(tmp_path / "trace"))
    try:
        rep = engine.fuzz_program(Artifact.from_dict(doc), mems, batch=1024,
                                  device="cuda")
    finally:
        obs_trace.disable()
    assert (rep.status, rep.ring_launches) == ("ok", 4)
    assert rep.failing == reference.fuzz_verdicts(doc, mems).failing == []
    execs = [r["attrs"] for r in report.load(str(tmp_path / "trace"))
             if r["k"] == "span" and r["name"] == "fuzz.execute"]
    assert execs == [{"pes_per_warp": 4, "chunk_rows": 15}] * 4


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", [CELL, "fuzz-4x4-b16384"])
def test_a_short_traced_run_of_the_cell(cuda, cell_name):
    """A traced window of the cell, read as its result line is: correct,
    and ``ring_launches`` on every report equal to the chunks the call
    sent in the 8x8 cell and 0 in the 4x4 one, as many PE-array launches
    as the profiler saw."""
    from portbench.harness import check
    from portbench.harness.roofline import PE_ARRAY_KERNELS

    cell = spec.load_cell(cell_name, ROOT)
    win = window.run(cell, 2 ** 31 + 43, 1.0, True, "cuda")
    assert check.correct(check.judge(win))
    assert all(c.report is not None for c in win.calls)
    sent = [len(c.launches) for c in win.calls]
    rings = [c.report.ring_launches for c in win.calls]
    assert rings == (sent if cell_name == CELL else [0] * len(sent))
    ran = [n for n, _, _ in win.trace.ops
           if any(k in n for k in PE_ARRAY_KERNELS)]
    assert len(ran) == sum(sent)
    metrics = {m["name"]: spec.reader(ROOT, m["name"])(win)
               for m in cell.per_layer}
    assert metrics["pe_array_ms_per_kmem"] > 0
    assert 0 < metrics["run_cycles_roofline"] <= 105
