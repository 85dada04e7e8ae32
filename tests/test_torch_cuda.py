"""The CUDA kernels (cycle step and whole-program run) against their plain
PyTorch versions, on the card.  These need an NVIDIA GPU with nvcc (the
kernels have no CPU mode):
they carry the ``cuda`` marker and skip elsewhere.  They import nothing of
JAX, so they run where only the port is installed::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: exact equality, every value is int32.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch",
                            reason="optional extra: pip install .[torch]")

from repro_torch.cgra.arch import Grid, neighbor_table  # noqa: E402
from repro_torch.cgra.artifact import load_artifact  # noqa: E402
from repro_torch.cgra.simulator import execute_asm  # noqa: E402
from repro_torch.convert import fields_from_numpy, state_from_numpy  # noqa: E402
from repro_torch.fuzz.corpus import make_corpus  # noqa: E402
from repro_torch.fuzz.engine import fuzz_program  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.cgra.isa import OPCODE  # noqa: E402
from repro_torch.kernels.pe_array import cycle_step, run_cycles  # noqa: E402
from repro_torch.kernels.sample import random_fields, random_state  # noqa: E402

pytestmark = pytest.mark.cuda

STATE = ("regs", "out", "sf", "zf", "mem")
FIELDS = ("op", "dst", "sa", "sb", "imm")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _case(side, batch, M, T):
    rng = np.random.RandomState(side * 1000 + batch * 10 + M)
    P = side * side
    f = random_fields(rng, T, P, M, full_encoding=True)
    s = random_state(rng, batch, P, M)
    nbrs = neighbor_table(Grid(side, side))
    return f, s, nbrs


@pytest.mark.parametrize("side,batch,M", [
    (2, 1, 64), (2, 8, 128), (3, 37, 128), (4, 1000, 256), (5, 3, 128),
    (6, 4096, 128)])
def test_kernel_matches_plain_version_every_step(cuda, side, batch, M):
    f, s, nbrs = _case(side, batch, M, 16)
    nbr = torch.as_tensor(np.asarray(nbrs, np.int32), device=cuda)
    kern = plain = state_from_numpy(*(s[k] for k in STATE), device=cuda)
    before = cycle_step.launches
    for t in range(16):
        row = fields_from_numpy(*(f[k][t] for k in FIELDS), device=cuda)
        kern = cycle_step(kern, row, nbr)
        plain = ref.cycle_step_ref(plain, row, nbr)
        for name, a, b in zip(STATE, kern, plain):
            assert torch.equal(a, b), f"{name} after step {t}"
    torch.cuda.synchronize()
    assert cycle_step.launches == before + 16


def test_run_program_on_the_card_matches_the_cpu(cuda):
    f, s, nbrs = _case(4, 1000, 128, 24)
    results = [ops.run_program(
        fields_from_numpy(*(f[k] for k in FIELDS), device=d),
        state_from_numpy(*(s[k] for k in STATE), device=d), nbrs, device=d)
        for d in ("cpu", cuda)]
    (c_final, c_outs), (g_final, g_outs) = results
    assert torch.equal(c_outs, g_outs.cpu())
    for a, b in zip(c_final, g_final):
        assert torch.equal(a, b.cpu())


@pytest.mark.parametrize("arch,kernel", [("4x4", "gsm"), ("3x3", "sqrt"),
                                         ("4x4", "ema_fxp")])
def test_artifact_runs_equal_on_card_and_cpu(cuda, arch, kernel):
    art = load_artifact(arch, kernel)
    mems = make_corpus(art, 300)
    runs = [execute_asm(art.asm, art.grid, mems, batch=300, device=d)
            for d in ("cpu", cuda)]
    (c_final, c_outs, _), (g_final, g_outs, _) = runs
    assert torch.equal(c_outs, g_outs.cpu())
    assert torch.equal(c_final.mem, g_final.mem.cpu())
    rep = fuzz_program(art, mems, batch=128, device=cuda)
    assert rep.status == "ok" and rep.backend == "cuda"


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    f, s, nbrs = _case(2, 4, 64, 1)
    nbr = torch.as_tensor(np.asarray(nbrs, np.int32), device=cuda)
    state = state_from_numpy(*(s[k] for k in STATE), device=cuda)
    row = fields_from_numpy(*(f[k][0] for k in FIELDS), device=cuda)
    with pytest.raises(ValueError, match="int32"):
        cycle_step(state._replace(out=state.out.long()), row, nbr)
    with pytest.raises(ValueError, match="contiguous"):
        cycle_step(state._replace(regs=state.regs.transpose(0, 1)), row, nbr)
    with pytest.raises(ValueError, match="alias"):
        cycle_step(state, row, nbr, out=state)


@pytest.mark.parametrize("T,nop", [(16, False), (0, False), (1, False),
                                   (8, True)])
@pytest.mark.parametrize("side,batch,M", [
    (2, 1, 64), (2, 8, 128), (3, 37, 128), (4, 1000, 256), (5, 3, 128),
    (6, 4096, 128)])
def test_run_cycles_matches_plain_version_and_step_chain(cuda, side, batch,
                                                         M, T, nop):
    f, s, nbrs = _case(side, batch, M, T)
    if nop:
        f["op"][:] = OPCODE["NOP"]
    nbr = torch.as_tensor(np.asarray(nbrs, np.int32), device=cuda)
    fields = fields_from_numpy(*(f[k] for k in FIELDS), device=cuda)
    state = state_from_numpy(*(s[k] for k in STATE), device=cuda)
    before = run_cycles.launches
    final, outs = run_cycles(fields, state, nbr)
    torch.cuda.synchronize()
    assert run_cycles.launches == before + (T > 0)
    plain, plain_outs = ref.run_cycles_ref(fields, state, nbr)
    assert outs.shape == (T, batch, side * side)
    assert torch.equal(outs, plain_outs)
    chain = state
    for t in range(T):
        chain = cycle_step(chain, ref.InstrRow(*(x[t] for x in fields)), nbr)
        assert torch.equal(outs[t], chain.out), f"out after step {t}"
    for name, a, b, c in zip(STATE, final, plain, chain):
        assert torch.equal(a, b) and torch.equal(a, c), name
    untraced, none = run_cycles(fields, state, nbr, trace=False)
    assert none is None
    for a, b in zip(untraced, final):
        assert torch.equal(a, b)


def test_run_cycles_rejects_what_the_kernel_does_not_take(cuda):
    f, s, nbrs = _case(2, 4, 64, 3)
    nbr = torch.as_tensor(np.asarray(nbrs, np.int32), device=cuda)
    state = state_from_numpy(*(s[k] for k in STATE), device=cuda)
    fields = fields_from_numpy(*(f[k] for k in FIELDS), device=cuda)
    with pytest.raises(ValueError, match="int32"):
        run_cycles(fields._replace(op=fields.op.long()), state, nbr)
    with pytest.raises(ValueError, match="int32"):
        run_cycles(fields, state._replace(mem=state.mem.long()), nbr)
    with pytest.raises(ValueError, match="contiguous"):
        run_cycles(fields, state._replace(regs=state.regs.transpose(0, 1)),
                   nbr)
    with pytest.raises(ValueError, match="contiguous"):
        run_cycles(fields._replace(imm=fields.imm[:, :2]), state, nbr)
    with pytest.raises(ValueError, match="contiguous"):
        run_cycles(fields, state, nbr[:3])
    with pytest.raises(ValueError, match="program"):
        run_cycles(ref.InstrRow(*(x[0] for x in fields)), state, nbr)


@pytest.mark.parametrize("arch,kernel", [("4x4", "gsm"), ("3x3", "sqrt"),
                                         ("4x4", "ema_fxp")])
def test_fuzz_program_launches_run_cycles_once_per_chunk(cuda, arch, kernel):
    art = load_artifact(arch, kernel)
    mems = make_corpus(art, 300)
    steps, runs = cycle_step.launches, run_cycles.launches
    rep = fuzz_program(art, mems, batch=128, device=cuda)
    assert rep.status == "ok"
    assert run_cycles.launches - runs == 3
    assert cycle_step.launches == steps
