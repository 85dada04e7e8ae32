"""repro_torch.fuzz.triage against repro.fuzz.triage: fault injection,
shrinking, the first-divergence replay, the full triage pipeline and its
reproducer JSON.  Everything runs on the CPU, where both backends are
named ``ref``; the tolerance is exact equality.
"""
import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch", reason="optional extra: pip install .[torch]")
pytest.importorskip("jax", reason="optional extra: pip install .[jax]")

from repro.cgra.registry import kernel_program  # noqa: E402
from repro.fuzz import engine as jax_engine  # noqa: E402
from repro.fuzz import triage as jax_triage  # noqa: E402
from repro_torch.cgra.artifact import load_artifact  # noqa: E402
from repro_torch.cgra.isa import NOP  # noqa: E402
from repro_torch.fuzz import engine, triage  # noqa: E402
from repro_torch.fuzz.corpus import make_corpus  # noqa: E402
from torch_parity import SHIPPED, jax_asm, jax_grid  # noqa: E402

TRIAGED = [("4x4", "gsm"), ("4x4", "fir4"), ("3x3", "sqrt")]


@pytest.mark.parametrize("arch,kernel", SHIPPED)
def test_inject_fault_matches_jax(arch, kernel):
    art = load_artifact(arch, kernel)
    want = jax_triage.inject_fault(jax_asm(art.asm))
    mutated, cell, label = triage.inject_fault(art.asm)
    assert (cell, label) == want[1:]
    np.testing.assert_array_equal(mutated.words(), want[0].words())
    assert (mutated.words() != art.asm.words()).sum() == 1
    t, pe = cell
    assert dataclasses.astuple(mutated.rows[t][pe]) == \
        dataclasses.astuple(want[0].rows[t][pe])
    assert art.asm.rows[cell[0]][cell[1]].op == label.split("->")[0]


def test_inject_fault_raises_without_a_mutable_instruction_as_jax_does():
    asm = load_artifact("4x4", "gsm").asm
    nops = dataclasses.replace(
        asm, bitstream=np.full_like(asm.words(), NOP.encode()))
    for inject, a in ((triage.inject_fault, nops),
                      (jax_triage.inject_fault, jax_asm(nops))):
        with pytest.raises(ValueError, match="no mutable instruction"):
            inject(a)


def _membership_check(targets):
    def check(mems):
        return np.isin(np.asarray(mems)[:, 0], targets)
    return check


def _ramp(n):
    mems = np.zeros((n, 4), np.int32)
    mems[:, 0] = np.arange(n)
    return mems


@pytest.mark.parametrize("n,targets,indices", [
    (64, [37], None), (100, [3, 50, 99], None), (33, [32], None),
    (1, [0], None), (20, [7, 12], range(100, 120))])
def test_shrink_matches_jax(n, targets, indices):
    mems = _ramp(n)
    mem, idx, probes = triage.shrink(mems, _membership_check(targets),
                                     indices=indices)
    j_mem, j_idx, j_probes = jax_triage.shrink(
        mems, _membership_check(targets), indices=indices)
    np.testing.assert_array_equal(mem, j_mem)
    assert (idx, probes) == (j_idx, j_probes)


def test_shrink_raises_without_a_failure_as_jax_does():
    for shrink in (triage.shrink, jax_triage.shrink):
        with pytest.raises(ValueError, match="vanished"):
            shrink(_ramp(16), _membership_check([]))
        with pytest.raises(ValueError, match="empty batch"):
            shrink(_ramp(0), _membership_check([]))


def test_shrink_raises_on_a_batch_coupled_failure_as_jax_does():
    def coupled(mems):          # fails only in batches of more than one
        return np.full(len(mems), len(mems) > 1)
    for shrink in (triage.shrink, jax_triage.shrink):
        with pytest.raises(ValueError, match="batch size 1"):
            shrink(_ramp(8), coupled)


def _faulty(arch, kernel):
    art = load_artifact(arch, kernel)
    mutated, _, _ = triage.inject_fault(art.asm)
    j_mutated = jax_triage.inject_fault(jax_asm(art.asm))[0]
    mapping = SimpleNamespace(grid=jax_grid(art))
    return dataclasses.replace(art, asm=mutated), j_mutated, mapping


@pytest.mark.parametrize("arch,kernel", TRIAGED)
def test_engine_check_and_first_divergence_match_jax(arch, kernel):
    art, j_asm, mapping = _faulty(arch, kernel)
    program = kernel_program(kernel)
    mems = make_corpus(art, 24)
    mask = triage.engine_check(art, device="cpu")(mems)
    want = jax_triage.engine_check(program, mapping, asm=j_asm)(mems)
    np.testing.assert_array_equal(mask, want)
    assert mask.any()
    # the first failing memory, and the first passing one where there is one
    for i in sorted({int(np.argmax(mask)), int(np.argmin(mask))}):
        div = triage.first_divergence(art, mems[i], device="cpu")
        j_div = jax_triage.first_divergence(program, mapping, mems[i],
                                            asm=j_asm)
        assert (div and div.to_dict()) == (j_div and j_div.to_dict())


@pytest.mark.parametrize("arch,kernel", TRIAGED)
def test_triage_failure_and_reproducer_match_jax(arch, kernel, tmp_path):
    art, j_asm, mapping = _faulty(arch, kernel)
    mems = make_corpus(art, 48)
    rep = engine.fuzz_program(art, mems, batch=16, device="cpu",
                              collect_activity=False)
    j_rep = jax_engine.fuzz_program(
        kernel_program(kernel), mapping, mems, batch=16,
        collect_activity=False, asm=j_asm, kernel=kernel, arch=arch)
    assert rep.status == j_rep.status == "mismatch"
    assert rep.failing == j_rep.failing
    triage.triage_failure(art, mems, rep, device="cpu",
                          out_dir=str(tmp_path / "port"))
    jax_triage.triage_failure(kernel_program(kernel), mapping, mems, j_rep,
                              out_dir=str(tmp_path / "jax"), asm=j_asm)
    assert rep.divergence == j_rep.divergence is not None
    port = json.loads(open(rep.reproducer).read())
    want = json.loads(open(j_rep.reproducer).read())
    assert rep.reproducer.endswith(j_rep.reproducer.split("/jax/")[1])
    assert port.pop("backend") == "ref" and want.pop("backend") == "ref"
    assert port == want
    assert port["mismatches"] and port["corpus_index"] in rep.failing


def test_divergence_string_matches_jax():
    d = triage.Divergence(cycle=3, pe=5, node=7, iteration=1, got=0x10,
                          expected=0xFFFFFFFF)
    j = jax_triage.Divergence(**d.to_dict())
    assert str(d) == str(j)
