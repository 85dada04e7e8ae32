"""repro_torch.fuzz.activity and repro_torch.cgra.energy against the JAX
package: the activity report of ``ActivityAccumulator`` (streamed over
chunks, also on traces that depart from the schedule), the latency/energy
model and the energy delta of ``fuzz_kernel``.  Everything runs on the
CPU with exact equality: the sums are integers, and the energy floats come
from the same arithmetic in the same order.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch", reason="optional extra: pip install .[torch]")
pytest.importorskip("jax", reason="optional extra: pip install .[jax]")
import torch  # noqa: E402

import repro.cgra.bitstream as jax_bitstream  # noqa: E402
from repro.cgra import energy as jax_energy  # noqa: E402
from repro.cgra.registry import kernel_program  # noqa: E402
from repro.fuzz import activity as jax_activity  # noqa: E402
from repro.fuzz import engine as jax_engine  # noqa: E402
from repro_torch.cgra import energy  # noqa: E402
from repro_torch.cgra.artifact import load_artifact  # noqa: E402
from repro_torch.cgra.simulator import execute_asm  # noqa: E402
from repro_torch.fuzz import activity, engine  # noqa: E402
from repro_torch.fuzz.corpus import make_corpus  # noqa: E402
from repro_torch.fuzz.triage import inject_fault  # noqa: E402
from torch_parity import SHIPPED, jax_asm, jax_grid  # noqa: E402

HARVESTED = [("4x4", "gsm"), ("4x4", "fir4"), ("4x4", "bitcount"),
             ("4x4", "ema_fxp"), ("4x4", "stencil3"), ("4x4", "argmax"),
             ("3x3", "sqrt")]


def _chunks(art, n=40, split=23, seed=2):
    mems = make_corpus(art, n, seed=seed)
    return [execute_asm(art.asm, art.grid, part, batch=len(part),
                        device="cpu")[1]
            for part in (mems[:split], mems[split:])]


def _accumulators(art):
    return (activity.ActivityAccumulator(art.asm, art.grid),
            jax_activity.ActivityAccumulator(jax_asm(art.asm), jax_grid(art)))


@pytest.mark.parametrize("arch,kernel", HARVESTED)
def test_accumulator_over_two_chunks_matches_jax(arch, kernel):
    art = load_artifact(arch, kernel)
    acc, want = _accumulators(art)
    for outs in _chunks(art):
        acc.update(outs)
        want.update(outs.numpy())
    report = acc.report()
    assert report.to_dict() == want.report().to_dict()
    assert report.memories == 40 and report.cycles == art.asm.total_rows
    assert report.op_exec == {op: c * 40
                              for op, c in art.asm.op_counts().items()}


@pytest.mark.parametrize("arch,kernel", HARVESTED)
def test_accumulator_on_a_trace_off_the_schedule_matches_jax(arch, kernel):
    art = load_artifact(arch, kernel)
    rng = np.random.RandomState(len(kernel))
    T, P = art.asm.total_rows, art.asm.num_pes
    acc, want = _accumulators(art)
    faulty, _, _ = inject_fault(art.asm)
    traces = [rng.randint(-2**31, 2**31, size=(T, 7, P), dtype=np.int64)
              .astype(np.int32),
              execute_asm(faulty, art.grid, make_corpus(art, 9), batch=9,
                          device="cpu")[1].numpy()]
    for outs in traces:
        acc.update(torch.as_tensor(outs))
        want.update(outs)
    assert acc.report().to_dict() == want.report().to_dict()


def test_harvest_activity_matches_jax_and_rejects_other_schedules():
    art = load_artifact("4x4", "gsm")
    outs = _chunks(art)[0]
    got = activity.harvest_activity(art.asm, art.grid, outs)
    want = jax_activity.harvest_activity(jax_asm(art.asm), jax_grid(art),
                                         outs.numpy())
    assert got.to_dict() == want.to_dict()
    acc = activity.ActivityAccumulator(art.asm, art.grid)
    with pytest.raises(ValueError, match="does not match the schedule"):
        acc.update(outs[:-1])
    with pytest.raises(ValueError, match="int32"):
        acc.update(outs.long())
    empty = acc.report()
    assert empty.memories == 0 and empty.result_toggle == {}


def test_popcount32_counts_the_low_32_bits():
    rng = np.random.RandomState(0)
    x = rng.randint(-2**40, 2**40, size=4096, dtype=np.int64)
    x[:4] = (0, -1, 2**31 - 1, -2**31)
    want = [bin(v & 0xFFFFFFFF).count("1") for v in x.tolist()]
    assert activity.popcount32(torch.as_tensor(x)).tolist() == want


def test_popcount_u32_equals_the_reference_and_the_device_popcount():
    rng = np.random.RandomState(1)
    x = rng.randint(0, 2**32, size=(64, 33), dtype=np.uint64).astype(
        np.uint32)
    x[0, :3] = (0, 2**32 - 1, 2**31)
    got = activity.popcount_u32(x)
    assert got.dtype == np.int64 and got.shape == x.shape
    assert np.array_equal(got, jax_activity.popcount_u32(x))
    assert got.tolist() == activity.popcount32(
        torch.as_tensor(x.astype(np.int64))).tolist()


@pytest.mark.parametrize("arch,kernel", SHIPPED)
def test_runtime_metrics_match_jax(arch, kernel):
    art = load_artifact(arch, kernel)
    j_asm = jax_asm(art.asm)
    for row, j_row in zip(art.asm.rows, j_asm.rows, strict=True):
        assert energy.row_latency(row, art.grid.cols) == \
            jax_energy.row_latency(j_row, art.grid.cols)
    report = activity.harvest_activity(art.asm, art.grid,
                                       _chunks(art, 12, 12)[0])
    for act in (None, report, report.to_dict()):
        got = energy.runtime_metrics(art.asm, art.grid.cols, 0.25,
                                     activity=act)
        want = jax_energy.runtime_metrics(j_asm, art.grid.cols, 0.25,
                                          activity=act)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.to_dict() == want.to_dict()


@pytest.mark.parametrize("arch,kernel", [("4x4", "gsm"), ("3x3", "sqrt")])
def test_energy_delta_matches_jax(arch, kernel, monkeypatch):
    art = load_artifact(arch, kernel)
    report = activity.harvest_activity(art.asm, art.grid,
                                       _chunks(art, 20, 20)[0]).to_dict()
    # the JAX package assembles the mapping: hand it the same bitstream
    monkeypatch.setattr(jax_bitstream, "assemble",
                        lambda program, mapping: jax_asm(art.asm))
    mapping = SimpleNamespace(grid=jax_grid(art), utilization=0.5)
    want = jax_engine._energy_delta(kernel_program(kernel), mapping, report)
    assert engine._energy_delta(art, report) == want


def test_fuzz_program_activity_matches_jax():
    art = load_artifact("4x4", "fir4")
    mems = make_corpus(art, 48)
    rep = engine.fuzz_program(art, mems, batch=32, device="cpu")
    want = jax_engine.fuzz_program(
        kernel_program("fir4"), SimpleNamespace(grid=jax_grid(art)), mems,
        batch=32, asm=jax_asm(art.asm), kernel="fir4", arch="4x4")
    assert rep.activity == want.activity is not None
    off = engine.fuzz_program(art, mems, batch=32, device="cpu",
                              collect_activity=False)
    assert off.activity is None and off.failing == rep.failing
