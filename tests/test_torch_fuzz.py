"""repro_torch.fuzz against repro.fuzz: corpora byte for byte, the batched
oracle, fuzz verdicts, mismatch strings and switching activity (also under
an injected fault), ``fuzz_kernel`` mapping live (mapped and unmapped
kernels), and the CLI digest with activity and energy, also with
``--shrink``.  Everything runs on the CPU with exact equality.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch", reason="optional extra: pip install .[torch]")
pytest.importorskip("jax", reason="optional extra: pip install .[jax]")

from repro.cgra.registry import kernel_program  # noqa: E402
from repro.fuzz import cli as jax_cli  # noqa: E402
from repro.fuzz import corpus as jax_corpus  # noqa: E402
from repro.fuzz import engine as jax_engine  # noqa: E402
from repro.fuzz.triage import inject_fault, triage_failure  # noqa: E402
from repro_torch.cgra import artifact as port_artifact  # noqa: E402
from repro_torch.cgra.artifact import load_artifact  # noqa: E402
from repro_torch.convert import artifact_from_parts  # noqa: E402
from repro_torch.fuzz import cli, corpus, engine  # noqa: E402
from torch_parity import SHIPPED, jax_asm, jax_grid  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
VERDICT_KERNELS = [("4x4", "gsm"), ("4x4", "stringsearch"),
                   ("4x4", "ema_fxp"), ("4x4", "fir4"), ("3x3", "sqrt")]


@pytest.mark.parametrize("arch,kernel", SHIPPED)
def test_corpus_matches_jax_byte_for_byte(arch, kernel):
    art = load_artifact(arch, kernel)
    for seed in (0, 3):
        port = corpus.make_corpus(art, 25, seed=seed)
        want = jax_corpus.make_corpus(kernel, 25, seed=seed)
        assert port.dtype == want.dtype
        assert port.tobytes() == want.tobytes()
    sparse = corpus.make_corpus(art, 4, strategies=("sparse", "overflow"))
    assert sparse.tobytes() == jax_corpus.make_corpus(
        kernel, 4, strategies=("sparse", "overflow")).tobytes()


@pytest.mark.parametrize("arch,kernel", SHIPPED)
def test_batched_oracle_matches_jax(arch, kernel):
    art = load_artifact(arch, kernel)
    mems = corpus.make_corpus(art, 40, seed=1)
    vals, final = engine.batched_oracle(art.program, mems)
    j_vals, j_final = jax_engine.batched_oracle(kernel_program(kernel), mems)
    assert vals.keys() == j_vals.keys()
    for n in vals:
        np.testing.assert_array_equal(vals[n], j_vals[n], err_msg=str(n))
    np.testing.assert_array_equal(final, j_final)


@pytest.mark.parametrize("arch,kernel", [("4x4", "gsm"), ("3x3", "sqrt")])
def test_batched_oracle_iterations_match_jax(arch, kernel):
    art = load_artifact(arch, kernel)
    mems = corpus.make_corpus(art, 12)
    port = engine.batched_oracle_iterations(art.program, mems)
    want = jax_engine.batched_oracle_iterations(kernel_program(kernel), mems)
    assert len(port) == len(want) == art.program.trip
    for it, (a, b) in enumerate(zip(port, want)):
        assert a.keys() == b.keys(), it
        for n in a:
            np.testing.assert_array_equal(a[n], b[n], err_msg=f"{it}/{n}")


def _jax_fuzz(art, mems, asm=None):
    mapping = SimpleNamespace(grid=jax_grid(art))   # only the grid is read
    return jax_engine.fuzz_program(
        kernel_program(art.kernel), mapping, mems, batch=32,
        asm=asm or jax_asm(art.asm), kernel=art.kernel, arch=art.arch)


def _verdict(rep):
    return rep.status, rep.failing, rep.mismatches, rep.activity


@pytest.mark.parametrize("arch,kernel", VERDICT_KERNELS)
def test_fuzz_program_verdicts_match_jax(arch, kernel):
    art = load_artifact(arch, kernel)
    mems = corpus.make_corpus(art, 64)
    rep = engine.fuzz_program(art, mems, batch=32, device="cpu")
    assert rep.backend == "ref" and rep.activity is not None
    assert _verdict(rep) == _verdict(_jax_fuzz(art, mems))
    assert rep.status == "ok"


def test_injected_fault_reports_match_jax():
    art = load_artifact("4x4", "gsm")
    mutated, _, _ = inject_fault(jax_asm(art.asm))
    faulty = dataclasses.replace(art, asm=artifact_from_parts(
        mutated.name, mutated.ii, mutated.trip, mutated.words(),
        mutated.presets_out, mutated.presets_reg, mutated.node_of_cell))
    assert (faulty.asm.words() != art.asm.words()).sum() == 1
    mems = corpus.make_corpus(art, 64)
    rep = engine.fuzz_program(faulty, mems, batch=32, device="cpu")
    want = _jax_fuzz(art, mems, asm=mutated)
    assert rep.status == "mismatch" and rep.failing
    assert _verdict(rep) == _verdict(want)


#: digest fields that differ by design: the backend name and wall-clock
#: timings
_VARIES = ("backend", "map_time_s", "exec_time_s", "oracle_time_s",
           "mem_rate")


def _comparable(doc):
    doc = {k: v for k, v in doc.items() if k not in _VARIES}
    doc["results"] = [{k: v for k, v in r.items() if k not in _VARIES}
                      for r in doc["results"]]
    return doc


def test_cli_digest_matches_jax(capsys):
    argv = ["--kernels", "bitcount", "--memories", "32", "--json"]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "fuzz", "--device", "cpu",
         *argv], capture_output=True, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=120)
    assert proc.returncode == 0, proc.stderr
    port = json.loads(proc.stdout)
    assert jax_cli.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert port["backend"] == "ref"
    assert _comparable(port) == _comparable(want)


def test_cli_shrink_writes_the_jax_reproducer(tmp_path, monkeypatch, capsys):
    art = load_artifact("4x4", "gsm")
    mutated, _, _ = inject_fault(jax_asm(art.asm))
    faulty = dataclasses.replace(art, asm=artifact_from_parts(
        mutated.name, mutated.ii, mutated.trip, mutated.words(),
        mutated.presets_out, mutated.presets_reg, mutated.node_of_cell))
    # fuzz_kernel maps gsm live: its fresh artifact assembles to the
    # faulty words
    monkeypatch.setattr(port_artifact, "assemble",
                        lambda program, mapping: faulty.asm)
    digest = tmp_path / "digest.json"
    rc = cli.main(["--device", "cpu", "--kernels", "gsm", "--memories",
                   "64", "--batch", "32", "--shrink", "--failures-dir",
                   str(tmp_path / "port"), "--out", str(digest)])
    printed = capsys.readouterr().out
    assert rc == 1
    rep = json.loads(digest.read_text())["results"][0]
    assert rep["status"] == "mismatch" and rep["energy"] is not None
    assert rep["reproducer"].startswith(str(tmp_path / "port"))
    assert f"reproducer: {rep['reproducer']}" in printed
    assert "first divergence: cycle" in printed
    assert "dynamic energy: static" in printed

    mems = corpus.make_corpus(art, 64)
    want = _jax_fuzz(art, mems, asm=mutated)
    triage_failure(kernel_program("gsm"), SimpleNamespace(grid=jax_grid(art)),
                   mems, want, out_dir=str(tmp_path / "jax"), asm=mutated)
    assert (rep["failing"], rep["activity"], rep["divergence"]) == \
        (want.failing, want.activity, want.divergence)
    port = json.loads(Path(rep["reproducer"]).read_text())
    assert port == json.loads(Path(want.reproducer).read_text())


@pytest.mark.parametrize("kernel,arch", [("gsm", "4x4"), ("sqrt", "3x3"),
                                         ("dotprod", "4x4")])
def test_fuzz_kernel_maps_live_as_jax_does(kernel, arch):
    """Both packages map the registry kernel themselves, then fuzz it."""
    rep = engine.fuzz_kernel(kernel, arch, memories=48, batch=32, seed=1,
                             device="cpu")
    want = jax_engine.fuzz_kernel(kernel, arch, memories=48, batch=32,
                                  seed=1, backend="ref")
    assert rep.map_time_s > 0
    assert (rep.kernel, rep.arch, rep.status, rep.ii, rep.memories,
            rep.batch, rep.backend) == (want.kernel, want.arch, want.status,
                                        want.ii, want.memories, want.batch,
                                        want.backend)
    assert _verdict(rep) == _verdict(want)
    assert rep.energy == want.energy is not None


def test_fuzz_kernel_reports_an_unmapped_kernel_as_jax_does():
    from repro.core.mapper import MapperConfig as JaxConfig
    from repro_torch.core.mapper import MapperConfig

    rep = engine.fuzz_kernel("sha", "2x2", config=MapperConfig(ii_max=4),
                             device="cpu")
    want = jax_engine.fuzz_kernel("sha", "2x2", config=JaxConfig(ii_max=4))
    got, want = rep.to_dict(), want.to_dict()
    assert got.pop("map_time_s") < 1.0 and want.pop("map_time_s") < 1.0
    assert got == want
    assert rep.status == "unmapped"
