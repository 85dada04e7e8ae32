"""Stacked K-kernel execution of repro_torch against the JAX package's
``run_stacked``/``fuzz_stacked`` (its ``jax.vmap`` over kernels), the plain
stacked version against single runs, and the stacked launch geometry.
Everything runs on the CPU, where the wrapper takes its plain version;
the tolerance is exact equality, every value is int32.  The CUDA launch
itself is held against this plain version in ``tests/test_torch_cuda.py``.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch", reason="optional extra: pip install .[torch]")
pytest.importorskip("jax", reason="optional extra: pip install .[jax]")
import torch  # noqa: E402

from repro.cgra.registry import kernel_program  # noqa: E402
from repro.fuzz import engine as jax_engine  # noqa: E402
from repro.fuzz.triage import inject_fault as jax_inject_fault  # noqa: E402
from repro_torch.cgra.arch import Grid, neighbor_table  # noqa: E402
from repro_torch.cgra.artifact import load_artifact  # noqa: E402
from repro_torch.cgra.simulator import execute_asm  # noqa: E402
from repro_torch.fuzz import engine  # noqa: E402
from repro_torch.fuzz.corpus import make_corpus  # noqa: E402
from repro_torch.fuzz.triage import inject_fault  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.pe_array import (  # noqa: E402
    MAX_PROGRAMS, run_cycles, run_cycles_geometry)
from repro_torch.kernels.sample import random_fields, random_state  # noqa: E402
from torch_parity import jax_asm, jax_grid  # noqa: E402

#: four 4x4 kernels of different schedule lengths (T = 18 to 112)
STACK = ("dotprod", "gsm", "stencil3", "bitcount")
STATE = ("regs", "out", "sf", "zf", "mem")
FIELDS = ("op", "dst", "sa", "sb", "imm")


@pytest.fixture(scope="module")
def stack():
    arts = [load_artifact("4x4", k) for k in STACK]
    rng = np.random.RandomState(13)
    mems = np.stack([make_corpus(a, 32, seed=int(rng.randint(1000)))
                     for a in arts])
    return arts, mems


def test_stack_has_programs_of_different_lengths(stack):
    arts, _ = stack
    assert len({a.asm.total_rows for a in arts}) == len(arts)


def test_run_stacked_matches_jax(stack):
    arts, mems = stack
    final, outs = engine.run_stacked(arts, mems, device="cpu")
    j_final, j_outs = jax_engine.run_stacked(
        [jax_asm(a.asm) for a in arts], jax_grid(arts[0]), mems,
        backend="ref")
    t_max = max(a.asm.total_rows for a in arts)
    assert tuple(outs.shape) == (len(arts), t_max, 32, 16)
    np.testing.assert_array_equal(outs.numpy(), j_outs)
    for name, a, b in zip(STATE, final, j_final):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)


def test_run_stacked_equals_single_runs_and_pads_with_nops(stack):
    arts, mems = stack
    final, outs = engine.run_stacked(arts, mems, device="cpu")
    for k, art in enumerate(arts):
        T = art.asm.total_rows
        s_final, s_outs, _ = execute_asm(art.asm, art.grid, mems[k],
                                         batch=32, device="cpu")
        assert torch.equal(outs[k, :T], s_outs)
        # NOP rows past the schedule hold every PE's OUT
        assert torch.equal(outs[k, T:],
                           s_outs[-1:].expand_as(outs[k, T:]))
        for name, a, b in zip(STATE, final, s_final):
            assert torch.equal(a[k], b), f"{art.kernel}: {name}"


def test_run_stacked_shares_one_corpus_and_rejects_mismatches(stack):
    arts, mems = stack
    _, shared = engine.run_stacked(arts[:2], mems[0], device="cpu")
    _, apart = engine.run_stacked(arts[:2], np.stack([mems[0]] * 2),
                                  device="cpu")
    assert torch.equal(shared, apart)
    with pytest.raises(ValueError, match="memory groups"):
        engine.run_stacked(arts[:2], mems, device="cpu")
    sqrt = load_artifact("3x3", "sqrt")
    with pytest.raises(ValueError, match="cannot stack sqrt"):
        engine.run_stacked([arts[0], sqrt], mems[0], device="cpu")


def _verdicts(reports):
    return [(r.kernel, r.status, r.ii, r.memories, r.batch, r.failing,
             r.mismatches, r.activity, r.energy) for r in reports]


def test_fuzz_stacked_reports_match_jax_with_a_faulty_kernel(stack,
                                                             monkeypatch):
    arts, mems = stack
    faulty, _, _ = inject_fault(arts[1].asm)
    arts = list(arts)
    arts[1] = dataclasses.replace(arts[1], asm=faulty)
    reports = engine.fuzz_stacked(arts, mems, device="cpu")
    # the JAX package assembles each mapping: hand it the same bitstreams
    j_asms = [jax_asm(a.asm) for a in arts]
    j_asms[1] = jax_inject_fault(jax_asm(stack[0][1].asm))[0]
    monkeypatch.setattr(jax_engine, "assemble", lambda p, m: m.asm)
    maps = [SimpleNamespace(grid=jax_grid(a), asm=j)
            for a, j in zip(arts, j_asms)]
    want = jax_engine.fuzz_stacked([kernel_program(k) for k in STACK], maps,
                                   mems, arch="4x4")
    assert [r.status for r in reports] == ["ok", "mismatch", "ok", "ok"]
    assert _verdicts(reports) == _verdicts(want)
    assert all(r.backend == "ref" and r.arch == "4x4" for r in reports)


def test_fuzz_stacked_verdicts_equal_single_kernel_runs(stack):
    arts, mems = stack
    reports = engine.fuzz_stacked(arts, mems, device="cpu")
    for art, m, rep in zip(arts, mems, reports):
        single = engine.fuzz_program(art, m, batch=32, device="cpu",
                                     collect_activity=False)
        assert (rep.status, rep.failing, rep.mismatches) == \
            (single.status, single.failing, single.mismatches)


def test_plain_stacked_version_is_a_loop_of_single_runs():
    rng = np.random.RandomState(5)
    K, T, B, P, M = 3, 6, 4, 9, 64
    parts = [(random_fields(rng, T, P, M), random_state(rng, B, P, M))
             for _ in range(K)]
    fields = ref.InstrRow(*(torch.as_tensor(np.stack([f[n] for f, _ in parts]))
                            for n in FIELDS))
    state = ref.PEState(*(torch.as_tensor(np.stack([s[n] for _, s in parts]))
                          for n in STATE))
    nbr = torch.as_tensor(np.asarray(neighbor_table(Grid(3, 3)), np.int32))
    final, outs = ref.run_stacked_ref(fields, state, nbr)
    assert tuple(outs.shape) == (K, T, B, P)
    for k in range(K):
        s_final, s_outs = ref.run_cycles_ref(
            ref.InstrRow(*(f[k] for f in fields)),
            ref.PEState(*(t[k] for t in state)), nbr)
        assert torch.equal(outs[k], s_outs)
        for name, a, b in zip(STATE, final, s_final):
            assert torch.equal(a[k], b), name
    untraced, none = ref.run_stacked_ref(fields, state, nbr, trace=False)
    assert none is None
    for a, b in zip(untraced, final):
        assert torch.equal(a, b)


def test_cpu_wrapper_takes_the_plain_stacked_version(stack):
    arts, mems = stack
    before = run_cycles.launches
    final, outs = engine.run_stacked(arts, mems, device="cpu")
    assert run_cycles.launches == before
    assert final.out.device.type == outs.device.type == "cpu"


@pytest.mark.parametrize("K", [1, 2, 15, MAX_PROGRAMS])
def test_stacked_geometry_counts_blocks_per_program(K):
    one = run_cycles_geometry(2048, 16, 128)
    geom = run_cycles_geometry(2048, 16, 128, K)
    assert geom.programs == K
    assert geom[:4] == one[:4]         # a program's blocks do not change
    assert (geom.blocks - 1) * geom.rows_per_block < 2048 \
        <= geom.blocks * geom.rows_per_block


@pytest.mark.parametrize("K", [0, -1, MAX_PROGRAMS + 1])
def test_stacked_geometry_raises_outside_the_second_grid_axis(K):
    with pytest.raises(ValueError, match="programs"):
        run_cycles_geometry(64, 16, 128, K)


def test_geometry_of_the_main_stacked_launch():
    # the smoke's stacked main path: 15 4x4 kernels x 2048 memories
    geom = run_cycles_geometry(2048, 16, 128, 15)
    assert geom.blocks * geom.programs >= 132 * 8
    assert geom.shared_bytes == geom.rows_per_block * (128 + 32) * 4
