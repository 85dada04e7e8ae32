"""repro_torch.fuzz against repro.fuzz: corpora byte for byte, the batched
oracle, fuzz verdicts, mismatch strings and switching activity (also under
an injected fault), ``fuzz_kernel`` mapping live (mapped and unmapped
kernels), and the CLI digest with activity and energy, also with
``--shrink``; and the verdict step (its gather, its verdict and the card's
form of it, and the mismatch lines from the failing rows alone), on CPU
tensors, against the full-batch path.
Everything runs on the CPU with exact equality.
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

torch = pytest.importorskip("torch",
                            reason="optional extra: pip install .[torch]")
pytest.importorskip("jax", reason="optional extra: pip install .[jax]")

from repro.cgra.registry import kernel_program  # noqa: E402
from repro.fuzz import cli as jax_cli  # noqa: E402
from repro.fuzz import corpus as jax_corpus  # noqa: E402
from repro.fuzz import engine as jax_engine  # noqa: E402
from repro.fuzz.triage import inject_fault, triage_failure  # noqa: E402
from repro_torch.cgra import artifact as port_artifact  # noqa: E402
from repro_torch.cgra.artifact import load_artifact  # noqa: E402
from repro_torch.convert import artifact_from_parts  # noqa: E402
from repro_torch.cgra.simulator import execute_asm  # noqa: E402
from repro_torch.fuzz import cli, corpus, engine  # noqa: E402
from repro_torch.fuzz.triage import inject_fault as port_inject  # noqa: E402
from repro_torch.kernels.oracle import oracle_verdict_ref  # noqa: E402
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


@pytest.mark.parametrize("B,M", [(1, 128), (1023, 128), (1024, 128),
                                 (1025, 128), (3000, 128), (5, 200_000)])
def test_compare_batch_matches_jax_across_row_blocks(B, M):
    """The port compares the images in blocks of rows
    (``engine.COMPARE_WORDS``); the JAX package compares the whole batch.
    Mismatches at the blocks' first and last rows, in node values only,
    and in the high 32 bits only (which the contract ignores)."""
    rng = np.random.default_rng(B * 7 + M)
    sim_mem = rng.integers(-2**31, 2**31, (B, M), dtype=np.int64).astype(
        np.int32)
    want_mem = sim_mem.astype(np.int64)
    rows = max(1, engine.COMPARE_WORDS // M)
    for r in {0, rows - 1, rows, B - 1, B // 2}:
        if 0 <= r < B:
            want_mem[r, (r * 31) % M] ^= 1 << (r % 32)
    want_mem[B // 3] += 1 << 40
    sim_vals = {3: rng.integers(-2**31, 2**31, B).astype(np.int32),
                5: rng.integers(-2**31, 2**31, B).astype(np.int32)}
    want_vals = {n: v.astype(np.int64) for n, v in sim_vals.items()}
    want_vals[5][B - 1] += 7
    want_vals[9] = np.zeros(B, np.int64)
    got = engine.compare_batch(sim_vals, sim_mem, want_vals, want_mem)
    np.testing.assert_array_equal(
        got, jax_engine.compare_batch(sim_vals, sim_mem, want_vals, want_mem))
    assert got.any() and got.dtype == bool


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
#: timings (the port's phase timings have no JAX counterpart)
_VARIES = ("backend", "map_time_s", "exec_time_s", "oracle_time_s",
           "mem_rate", "readback_time_s", "compare_time_s",
           "activity_time_s", "activity_setup_s")


def _without_ring_launches(doc):
    """``doc`` without the port's ``ring_launches``, which has no JAX
    counterpart: 0 on the CPU, where nothing is launched."""
    assert doc.pop("ring_launches") == 0
    return doc


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
    port["results"] = [_without_ring_launches(r) for r in port["results"]]
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
    got, want = _without_ring_launches(rep.to_dict()), want.to_dict()
    assert got.pop("map_time_s") < 1.0 and want.pop("map_time_s") < 1.0
    for key in ("readback_time_s", "compare_time_s", "activity_time_s",
                "activity_setup_s"):
        assert got.pop(key) == 0.0 and key not in want
    assert got == want
    assert rep.status == "unmapped"


@pytest.mark.parametrize("fault", [False, True], ids=["clean", "fault"])
@pytest.mark.parametrize("arch,kernel", VERDICT_KERNELS)
@pytest.mark.parametrize("lo,before", [(0, 0), (4096, 5)])
def test_failing_rows_give_the_full_batch_mismatch_lines(arch, kernel, fault,
                                                         lo, before):
    """The verdict step on CPU tensors, with its own verdict and with
    ``oracle_verdict_ref``'s (the card's form, at the table's slots, which
    the step's slots equal): each mask equals ``compare_batch`` over every
    last-iteration node, and the mismatch lines built from the failing
    rows alone equal the full-batch path's, for a chunk at corpus index
    ``lo`` and a sample that already holds ``before`` lines; at most the
    sample's cap of rows comes back."""
    art = load_artifact(arch, kernel)
    if fault:
        art = dataclasses.replace(art, asm=port_inject(art.asm)[0])
    mems = corpus.make_corpus(art, 200, seed=6)
    final, outs, _ = execute_asm(art.asm, art.grid, mems, batch=200,
                                 device="cpu")
    program = art.program
    sim_vals = engine.node_values_from_outs(art.asm, outs, program.trip)
    sim_mem = final.mem.numpy()
    ov, om = engine.batched_oracle(program, mems)
    bad = engine.compare_batch(sim_vals, sim_mem, ov, om)
    want = ["earlier line"] * before
    for i in np.nonzero(bad)[0]:
        if len(want) < engine._MISMATCH_SAMPLE_CAP:
            want.extend(engine.mismatch_strings(
                program, sim_vals, sim_mem, ov, om, int(i), label=lo + int(i)
            )[:engine._MISMATCH_SAMPLE_CAP])

    step = engine._VerdictStep(art, torch.device("cpu"))
    table = art.oracle_table
    assert step.slots == tuple(table.node_ids.index(n) for n in step.nodes)
    sim = step.gather(outs)
    for verdict in (step.judge(torch.as_tensor(mems), final.mem, sim),
                    oracle_verdict_ref(table, torch.as_tensor(mems),
                                       final.mem, sim, step.slots)):
        np.testing.assert_array_equal(verdict.bad, bad)
        got = ["earlier line"] * before
        back = step.mismatches(sim, final.mem, verdict,
                               np.nonzero(verdict.bad)[0], lo, got)
        assert got == want
        assert back <= engine._MISMATCH_SAMPLE_CAP - before
        assert (back > 0) == fault
    assert bad.any() == fault


@pytest.mark.parametrize("fault", [False, True], ids=["clean", "fault"])
def test_each_chunk_is_judged_on_the_image_its_run_started_from(
        monkeypatch, tmp_path, fault):
    """``fuzz_program`` makes one image tensor a chunk: the run starts from
    it and ``judge`` takes that very tensor, which still holds the chunk
    sent after the run; a chunk copies nothing to a card on the CPU
    (``upload_bytes`` 0 on ``fuzz.chunk``).  The verdicts are the JAX
    package's."""
    from repro_torch.obs import report
    from repro_torch.obs import trace as obs_trace

    art = load_artifact("4x4", "gsm")
    if fault:
        art = dataclasses.replace(art, asm=port_inject(art.asm)[0])
    mems = corpus.make_corpus(art, 50, seed=3)
    started, judged = [], []
    real_execute, real_judge = engine.execute_asm, engine._VerdictStep.judge

    def execute(asm, grid, mem, batch=1, device="cuda"):
        started.append(mem)
        return real_execute(asm, grid, mem, batch=batch, device=device)

    def judge(step, image, sim_mem, sim_vals):
        assert isinstance(image, torch.Tensor)
        judged.append((image, image.numpy().copy()))
        return real_judge(step, image, sim_mem, sim_vals)

    monkeypatch.setattr(engine, "execute_asm", execute)
    monkeypatch.setattr(engine._VerdictStep, "judge", judge)
    obs_trace.enable(str(tmp_path / "trace"))
    try:
        rep = engine.fuzz_program(art, mems, batch=20, device="cpu")
    finally:
        obs_trace.disable()
    assert len(started) == len(judged) == 3
    for lo, mem, (image, seen) in zip((0, 20, 40), started, judged):
        assert mem is image
        np.testing.assert_array_equal(seen, mems[lo:lo + 20])
    chunks = [r["attrs"] for r in report.load(str(tmp_path / "trace"))
              if r["k"] == "span" and r["name"] == "fuzz.chunk"]
    assert chunks == [{"lo": lo, "rows": rows, "upload_bytes": 0}
                      for lo, rows in ((0, 20), (20, 20), (40, 10))]
    assert _verdict(rep)[:3] == _verdict(_jax_fuzz(art, mems))[:3]
    assert (rep.status == "mismatch") == fault


def test_last_cells_keep_the_dict_order_of_the_trace_gather():
    """One cell a node, in the order and with the values of
    ``node_values_from_outs``'s dict, also where a node holds two cells;
    the verdict step gathers the same values in that order."""
    art = load_artifact("4x4", "gsm")
    asm = dataclasses.replace(art.asm, node_of_cell=dict(
        art.asm.node_of_cell))
    n0, j0 = next(v for v in asm.node_of_cell.values()
                  if v[1] == art.program.trip - 1)
    spare = next((t, p) for t in range(asm.total_rows)
                 for p in range(art.grid.num_pes)
                 if (t, p) not in asm.node_of_cell)
    asm.node_of_cell[spare] = (n0, j0)         # n0 held twice, later here
    outs = torch.arange(asm.total_rows * 3 * art.grid.num_pes,
                        dtype=torch.int32).view(asm.total_rows, 3, -1)
    nodes, ts, pes = engine.last_cells(asm, art.program.trip)
    vals = engine.node_values_from_outs(asm, outs, art.program.trip)
    assert list(vals) == list(nodes)
    assert (ts[nodes.index(n0)], pes[nodes.index(n0)]) == spare
    for n, t, pe in zip(nodes, ts, pes):
        np.testing.assert_array_equal(vals[n], outs[t, :, pe].numpy())
    step = engine._VerdictStep(dataclasses.replace(art, asm=asm),
                               torch.device("cpu"))
    assert step.nodes == nodes
    gathered = step.gather(outs)
    assert tuple(gathered.shape) == (len(nodes), 3)
    for k, n in enumerate(nodes):
        np.testing.assert_array_equal(gathered[k].numpy(), vals[n])
    kept = engine.last_cells(asm, art.program.trip, keep={n0})
    assert kept == ((n0,), (spare[0],), (spare[1],))
