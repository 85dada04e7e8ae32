"""The frame suite on the port's fuzz path, on the CPU: the paper's loops at
one GSM 06.10 speech frame a call (160 iterations over a 512-word image,
``repro_torch.cgra.registry.FRAME160``), registered under their own names
(``gsm_f160``) beside the default suite, which stays the JAX package's.

``portbench/data/cgra-4x4-frame160/artifacts/`` holds one frozen artifact a
kernel, mapped on the 4x4 torus; each says its image size.  Fuzzed on the
CPU by the plain versions, every frozen program passes, with the verdicts
and the activity report of the benchmark's plain reference.  At the
cell's batch every program runs from the program ring at P = 16.  The
card's side is in ``portbench/tests/test_portbench_frame160.py``.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch",
                            reason="optional extra: pip install .[torch]")

from repro.cgra import registry as jax_registry  # noqa: E402
from repro.frontend import kernels as jax_kernels  # noqa: E402
from repro_torch.cgra import registry  # noqa: E402
from repro_torch.cgra.artifact import ARTIFACT_ROOT, Artifact  # noqa: E402
from repro_torch.core.mapper import MapperConfig  # noqa: E402
from repro_torch.frontend import kernels  # noqa: E402
from repro_torch.fuzz import cli, engine  # noqa: E402
from repro_torch.fuzz.corpus import make_corpus  # noqa: E402
from repro_torch.kernels import pe_array  # noqa: E402
from repro_torch.obs import report  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.toolchain import Toolchain  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from portbench.harness import reference  # noqa: E402

CONFIG = json.loads((ROOT / "portbench" / "configs"
                     / "cgra-4x4-frame160.json").read_text())
KERNELS = CONFIG["kernels"]
FRAME = registry.FRAME160
#: the cell's batch (``portbench/traffic/fuzz-b16384.json``)
CELL_B = 16384
#: cgra-4x4's mapper block
BUDGET = dict(backend="cdcl", per_ii_timeout_s=60.0, total_timeout_s=120.0,
              ii_max=32)


def _doc(kernel: str) -> dict:
    return json.loads((ROOT / CONFIG["data"] / f"{kernel}.json").read_text())


def test_the_configuration_holds_the_frame_suite():
    assert (FRAME.trip, FRAME.second, FRAME.out, FRAME.mem_words) == (
        CONFIG["trip"], 168, 336, CONFIG["memory_words"]) == (160, 168, 336,
                                                              512)
    assert sorted(KERNELS) == sorted(registry.kernel_names(suite=FRAME.name))
    assert sorted(p.stem for p in (ROOT / CONFIG["data"]).glob("*.json")) \
        == sorted(KERNELS)
    assert set(CONFIG["source_kernels"]) - {
        k[:-len(FRAME.suffix)] for k in KERNELS} == set(CONFIG["cut"])
    four = json.loads((ROOT / "portbench" / "configs" / "cgra-4x4.json")
                      .read_text())
    assert CONFIG["mapper"] == four["mapper"]


def test_the_default_suite_stays_the_jax_packages():
    """The frame suite is outside every list the parity tests compare."""
    assert registry.kernel_names() == jax_registry.kernel_names()
    for origin in registry.ORIGINS:
        assert (registry.kernel_names(origin)
                == jax_registry.kernel_names(origin))
    assert list(kernels.TRACED_KERNELS) == list(jax_kernels.TRACED_KERNELS)
    frame = registry.kernel_names(suite=FRAME.name)
    assert frame == [FRAME.kernel(k) for k in
                     ["gsm", *jax_kernels.TRACED_KERNELS]]
    assert not set(frame) & set(registry.kernel_names())
    assert all(registry.is_registered(k) for k in frame)
    assert list(kernels.TRACED_SUITES[FRAME.name]) == frame[1:]


@pytest.mark.parametrize("kernel", KERNELS)
def test_a_frame_loop_is_its_default_loop_at_another_length(kernel):
    """The same data-flow graph as the default suite's loop (so the same
    II); only the trip count and the immediates that place the data
    differ."""
    base = kernel[:-len(FRAME.suffix)]
    frame, short = (registry.kernel_program(k) for k in (kernel, base))
    assert (frame.name, frame.trip, short.trip) == (kernel, 160, 16)
    got, want = frame.build_dfg(), short.build_dfg()
    assert [(n.id, n.op) for n in got.nodes.values()] == [
        (n.id, n.op) for n in want.nodes.values()]
    assert ([(e.src, e.dst, e.distance, e.kind) for e in got.edges]
            == [(e.src, e.dst, e.distance, e.kind) for e in want.edges])
    doc, four = _doc(kernel), json.loads(
        (ROOT / "portbench" / "data" / "cgra-4x4" / f"{base}.json")
        .read_text())
    assert doc["ii"] == four["ii"] == CONFIG["ii_beside_cgra_4x4"][kernel][
        "ii"]
    assert len(doc["words"]) == len(four["words"]) + doc["ii"] * 144


@pytest.mark.parametrize("kernel", KERNELS)
def test_each_frozen_program_fuzzes_clean_as_the_reference_says(kernel):
    """On the CPU, over the port's corpus of the kernel's own image size:
    no failing memory, and the verdicts and the activity report of the
    benchmark's plain reference."""
    doc = _doc(kernel)
    art = Artifact.from_dict(doc)
    mems = make_corpus(art, 40, seed=2 ** 31 + 160)
    assert mems.shape == (40, 512)
    rep = engine.fuzz_program(art, mems, batch=40, device="cpu")
    want = reference.fuzz_verdicts(doc, mems)
    assert (rep.status, rep.failing, want.failing) == ("ok", [], [])
    assert rep.activity == want.activity
    assert 0 < rep.activity_setup_s <= rep.activity_time_s


@pytest.mark.parametrize("kernel", KERNELS)
def test_the_cell_runs_every_frozen_program_from_the_ring(kernel):
    """At the cell's batch, P = 16 and M = 512, the uniform layout at one
    PE a warp stages fewer rows a slot than the program has."""
    T, P = np.asarray(_doc(kernel)["words"]).shape
    assert (P, 162 <= T <= 1120) == (16, True)
    geom = pe_array.run_cycles_geometry(CELL_B, P, FRAME.mem_words, T=T)
    assert geom.layout == pe_array.UNIFORM_LAYOUT
    assert geom.warp_pes(P) == 1 and geom.threads == 512
    assert geom.chunk_rows < T


def test_the_artifact_says_its_image_size_only_where_it_is_not_128():
    doc = _doc(FRAME.kernel("gsm"))
    art = Artifact.from_dict(doc)
    assert art.mem_words == doc["mem_words"] == 512
    assert list(art.to_dict()) == list(doc) and art.to_dict() == doc
    assert list(doc)[-1] == "mem_words"
    plain = {k: v for k, v in doc.items() if k != "mem_words"}
    assert Artifact.from_dict(plain).mem_words == 128
    assert "mem_words" not in Artifact.from_dict(plain).to_dict()


@pytest.mark.parametrize("tree", ["artifacts", "cgra-4x4", "adres-8x8",
                                  "cgra-6x6"])
def test_every_committed_artifact_is_unchanged_key_for_key(tree):
    root = (ARTIFACT_ROOT if tree == "artifacts"
            else ROOT / "portbench" / "data" / tree)
    paths = sorted(root.glob("*/*.json" if tree == "artifacts"
                             else "*.json"))
    assert paths
    for path in paths:
        doc = json.loads(path.read_text())
        assert "mem_words" not in doc, path
        art = Artifact.from_dict(doc)
        assert art.mem_words == 128
        got = art.to_dict()
        assert list(got) == list(doc) and got == doc, path


@pytest.mark.parametrize("kernel", [FRAME.kernel("dotprod"),
                                    FRAME.kernel("xorshift32")])
def test_a_fresh_map_reproduces_the_frozen_file(kernel):
    """The two quickest solves of the suite, under cgra-4x4's mapper
    block."""
    tc = Toolchain("4x4", MapperConfig(**BUDGET))
    prog = tc.program(kernel)
    res = tc.map(prog, jobs=1)
    assert res.status == "mapped"
    got = Artifact.from_mapping(prog.builder, res.mapping, arch="4x4")
    assert got.to_dict() == _doc(kernel)


def test_the_corpus_of_a_frame_kernel_fills_its_own_image():
    name = FRAME.kernel("gsm")
    by_name = make_corpus(name, 10, seed=3)
    assert by_name.shape == (10, 512)
    assert np.array_equal(by_name, make_corpus(Artifact.from_dict(
        _doc(name)), 10, seed=3))
    assert not by_name[:, 160:168].any() and not by_name[:, 328:].any()
    assert registry.make_mem(name, 1).shape == (512,)
    assert make_corpus("gsm", 10, seed=3).shape == (10, 128)


def test_fuzz_kernel_maps_and_fuzzes_a_frame_kernel_on_512_words(tmp_path):
    """The engine's corpus path: the span of the run names the program's
    rows and the image's words; the harvest's set-up its cells."""
    obs_trace.enable(str(tmp_path / "trace"))
    try:
        rep = engine.fuzz_kernel(FRAME.kernel("dotprod"), "4x4", memories=20,
                                 batch=20, seed=4,
                                 config=MapperConfig(**BUDGET), device="cpu")
    finally:
        obs_trace.disable()
    assert (rep.status, rep.ii, rep.memories) == ("ok", 1, 20)
    spans = [r for r in report.load(str(tmp_path / "trace"))
             if r["k"] == "span"]
    (prog,) = [r for r in spans if r["name"] == "fuzz.program"]
    assert (prog["attrs"]["rows"], prog["attrs"]["mem_words"]) == (162, 512)
    (setup,) = [r for r in spans if r["name"] == "fuzz.activity"
                and r["attrs"].get("part") == "setup"]
    words = np.asarray(_doc(FRAME.kernel("dotprod"))["words"], np.int64)
    assert setup["attrs"]["cells"] == int((((words >> 27) & 0x1F) != 0).sum())


def test_the_fuzz_cli_takes_a_frame_kernel_by_name(capsys):
    argv = ["--kernels", FRAME.kernel("xorshift32"), "--memories", "10",
            "--batch", "10", "--device", "cpu", "--json"]
    assert cli.main(argv) == 0
    doc = json.loads(capsys.readouterr().out)
    (row,) = doc["results"]
    assert (row["kernel"], row["status"], row["ii"]) == (
        FRAME.kernel("xorshift32"), "ok", 6)
    with pytest.raises(SystemExit, match="unknown kernel"):
        cli.main(["--kernels", "gsm_f16", "--device", "cpu"])
