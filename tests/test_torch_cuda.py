"""The CUDA kernels (cycle step and whole-program run, single and stacked)
against their plain PyTorch versions, and the fuzz path's stacked run,
activity harvest and triage, a kernel the port mapped itself, and the
traced front-end's co-simulation, swept points of the size ladder, a
heuristic-baseline mapping and a mapping the compile server served,
against the CPU path, on the card.
These need an NVIDIA GPU with nvcc (the kernels have no CPU mode): they
carry the ``cuda`` marker and skip elsewhere.  They import nothing of
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
from repro_torch.core.mapper import MapperConfig  # noqa: E402
from repro_torch.fuzz.corpus import make_corpus  # noqa: E402
from repro_torch.fuzz.activity import ActivityAccumulator  # noqa: E402
from repro_torch.fuzz.engine import (fuzz_kernel, fuzz_program,  # noqa: E402
                                     fuzz_stacked, run_stacked)
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.cgra.isa import OPCODE  # noqa: E402
from repro_torch.kernels.pe_array import (  # noqa: E402
    LANE_LAYOUT, UNIFORM_LAYOUT, cycle_step, lanes_fit, run_cycles)
from repro_torch.kernels.sample import (  # noqa: E402
    HAZARDS, hazard_fields, random_fields, random_state)

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


def _hold_run_cycles(fields, state, nbr, chain=True, layout=None):
    """One launch (in ``layout``, or the one chosen for the shape) against
    the plain version and (``chain``) a chain of cycle-step launches:
    trace and final state bit-equal, traced or not."""
    T = fields.op.shape[0]
    before = run_cycles.launches
    final, outs = run_cycles(fields, state, nbr, layout=layout)
    torch.cuda.synchronize()
    assert run_cycles.launches == before + 1
    plain, plain_outs = ref.run_cycles_ref(fields, state, nbr)
    assert torch.equal(outs, plain_outs)
    for name, a, b in zip(STATE, final, plain):
        assert torch.equal(a, b), name
    if chain:
        step = state
        for t in range(T):
            step = cycle_step(step, ref.InstrRow(*(x[t] for x in fields)),
                              nbr)
            assert torch.equal(outs[t], step.out), f"out after step {t}"
        for name, a, b in zip(STATE, final, step):
            assert torch.equal(a, b), name
    untraced, none = run_cycles(fields, state, nbr, trace=False,
                                layout=layout)
    assert none is None
    for a, b in zip(untraced, final):
        assert torch.equal(a, b)


#: the two layouts of run_cycles, each held on the hazard programs
LAYOUTS = (UNIFORM_LAYOUT, LANE_LAYOUT)

#: (grid side, batch, M, rows): P from 4 to 144 (a warp runs 1 to 8 PEs),
#: batches that are not a multiple of the block's rows
HAZARD_SHAPES = [(2, 37, 64, 64), (3, 1001, 128, 64), (4, 1000, 128, 84),
                 (5, 4097, 256, 64), (6, 37, 128, 64), (8, 1001, 128, 64),
                 (12, 9, 256, 64)]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kind", HAZARDS)
@pytest.mark.parametrize("side,batch,M,T", HAZARD_SHAPES)
def test_hazard_programs_on_the_card(cuda, side, batch, M, T, kind, layout):
    """Each hazard program in each layout; where the lane layout does not
    take the shape (P > 32), asking for it raises."""
    rng = np.random.RandomState(side * 1000 + batch + M + T)
    P = side * side
    f = hazard_fields(rng, kind, T, P, M)
    s = random_state(rng, batch, P, M)
    nbr = torch.as_tensor(np.asarray(neighbor_table(Grid(side, side)),
                                     np.int32), device=cuda)
    fields = fields_from_numpy(*(f[k] for k in FIELDS), device=cuda)
    state = state_from_numpy(*(s[k] for k in STATE), device=cuda)
    if layout == LANE_LAYOUT and not lanes_fit(P, M):
        with pytest.raises(ValueError, match="lane layout"):
            run_cycles(fields, state, nbr, layout=layout)
        return
    _hold_run_cycles(fields, state, nbr, chain=batch < 4000, layout=layout)


@pytest.mark.parametrize("side,batch,M,T", [
    (4, 1000, 128, 300), (6, 37, 128, 400), (2, 3, 58_000, 16),
    (4, 8, 58_080, 16)])
def test_run_cycles_from_a_ring_or_with_the_image_in_device_memory(
        cuda, side, batch, M, T):
    """Programs above the shared budget run from a ring of two chunks; an
    image too large for shared memory at one row a block stays in device
    memory (the last shape)."""
    from repro_torch.kernels.pe_array import run_cycles_geometry

    P = side * side
    geom = run_cycles_geometry(batch, P, M, T=T, layout=UNIFORM_LAYOUT)
    assert geom.chunk_rows < T or not geom.memory_in_shared
    rng = np.random.RandomState(side + batch + M + T)
    f = random_fields(rng, T, P, M, full_encoding=True)
    f["op"][T // 2:T // 2 + 40] = OPCODE["NOP"]
    s = random_state(rng, batch, P, M)
    nbr = torch.as_tensor(np.asarray(neighbor_table(Grid(side, side)),
                                     np.int32), device=cuda)
    _hold_run_cycles(fields_from_numpy(*(f[k] for k in FIELDS), device=cuda),
                     state_from_numpy(*(s[k] for k in STATE), device=cuda),
                     nbr, chain=False, layout=UNIFORM_LAYOUT)


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


@pytest.mark.parametrize("side,batch,lane", [(4, 1024, True),
                                             (4, 16384, False),
                                             (6, 1024, False)])
def test_run_cycles_counts_its_lane_layout_launches(cuda, side, batch, lane):
    """Every launch adds one to ``launches``; one in the lane layout (the
    main path's B = 1024 at P <= 32) adds one to ``lane_launches`` too."""
    f, s, nbrs = _case(side, batch, 128, 8)
    nbr = torch.as_tensor(np.asarray(nbrs, np.int32), device=cuda)
    fields = fields_from_numpy(*(f[k] for k in FIELDS), device=cuda)
    state = state_from_numpy(*(s[k] for k in STATE), device=cuda)
    runs, lanes = run_cycles.launches, run_cycles.lane_launches
    run_cycles(fields, state, nbr)
    assert run_cycles.launches == runs + 1
    assert run_cycles.lane_launches == lanes + lane


def _stack(K, T, side, batch, M, seed):
    """K random programs of T rows on one grid, with K states."""
    rng = np.random.RandomState(seed)
    P = side * side
    parts = [(random_fields(rng, T, P, M, full_encoding=True),
              random_state(rng, batch, P, M)) for _ in range(K)]
    f = {k: np.stack([p[0][k] for p in parts]) for k in FIELDS}
    s = {k: np.stack([p[1][k] for p in parts]) for k in STATE}
    return f, s, neighbor_table(Grid(side, side))


@pytest.mark.parametrize("K,T,side,batch,M", [
    (1, 16, 4, 37, 128), (2, 16, 3, 1000, 128), (5, 24, 4, 1, 64),
    (5, 12, 4, 1000, 256), (3, 0, 3, 8, 64)])
def test_stacked_launch_matches_plain_version_and_single_launches(
        cuda, K, T, side, batch, M):
    f, s, nbrs = _stack(K, T, side, batch, M, seed=K * 100 + T + batch)
    nbr = torch.as_tensor(np.asarray(nbrs, np.int32), device=cuda)
    fields = fields_from_numpy(*(f[k] for k in FIELDS), device=cuda)
    state = state_from_numpy(*(s[k] for k in STATE), device=cuda)
    before = run_cycles.launches
    final, outs = run_cycles(fields, state, nbr)
    torch.cuda.synchronize()
    assert run_cycles.launches == before + (T > 0)
    assert outs.shape == (K, T, batch, side * side)
    plain, plain_outs = ref.run_stacked_ref(fields, state, nbr)
    assert torch.equal(outs, plain_outs)
    for name, a, b in zip(STATE, final, plain):
        assert torch.equal(a, b), name
    for k in range(K):
        single, single_outs = run_cycles(ref.InstrRow(*(x[k] for x in fields)),
                                         ref.PEState(*(t[k] for t in state)),
                                         nbr)
        assert torch.equal(outs[k], single_outs), f"trace of program {k}"
        for name, a, b in zip(STATE, final, single):
            assert torch.equal(a[k], b), f"{name} of program {k}"


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("side,batch", [(3, 37), (4, 1001), (6, 9),
                                        (8, 130)])
def test_hazard_stack_on_the_card(cuda, side, batch, layout):
    """Hazard programs of lengths 0 to T_max, NOP-padded as the fuzz engine
    pads them, in one stacked launch in each layout that takes the shape:
    equal to the plain version and to a single launch of each unpadded
    program, padding rows included."""
    from repro_torch.fuzz.engine import _pad_fields

    T_max, M, P = 48, 128, side * side
    rng = np.random.RandomState(side * 100 + batch)
    lengths = [0, 1, 2, T_max // 3, T_max // 2, T_max - 1, T_max]
    singles = []
    for k, n in enumerate(lengths):
        f = hazard_fields(rng, HAZARDS[k % len(HAZARDS)], T_max, P, M)
        singles.append(fields_from_numpy(*(f[x][:n] for x in FIELDS),
                                         device=cuda))
    states = [random_state(rng, batch, P, M) for _ in lengths]
    fields = ref.InstrRow(*(torch.stack(fs) for fs in zip(
        *(_pad_fields(f, T_max) for f in singles))))
    state = state_from_numpy(*(np.stack([s[k] for s in states])
                               for k in STATE), device=cuda)
    nbr = torch.as_tensor(np.asarray(neighbor_table(Grid(side, side)),
                                     np.int32), device=cuda)
    if layout == LANE_LAYOUT and not lanes_fit(P, M):
        with pytest.raises(ValueError, match="lane layout"):
            run_cycles(fields, state, nbr, layout=layout)
        return
    before = run_cycles.launches
    final, outs = run_cycles(fields, state, nbr, layout=layout)
    torch.cuda.synchronize()
    assert run_cycles.launches == before + 1
    plain, plain_outs = ref.run_stacked_ref(fields, state, nbr)
    assert torch.equal(outs, plain_outs)
    for name, a, b in zip(STATE, final, plain):
        assert torch.equal(a, b), name
    for k, single in enumerate(singles):
        n = lengths[k]
        one = ref.PEState(*(t[k] for t in state))
        if n == 0:
            s_final, s_outs = one, one.out[None][:0]
        else:
            s_final, s_outs = run_cycles(single, one, nbr)
        assert torch.equal(outs[k, :n], s_outs), f"program {k}"
        last = s_outs[-1] if n else one.out
        assert torch.equal(outs[k, n:], last.expand(T_max - n, batch, P))
        for name, a, b in zip(STATE, final, s_final):
            assert torch.equal(a[k], b), f"{name} of program {k}"


def test_stacked_launch_rejects_what_the_kernel_does_not_take(cuda):
    f, s, nbrs = _stack(3, 4, 2, 4, 64, seed=1)
    nbr = torch.as_tensor(np.asarray(nbrs, np.int32), device=cuda)
    fields = fields_from_numpy(*(f[k] for k in FIELDS), device=cuda)
    state = state_from_numpy(*(s[k] for k in STATE), device=cuda)
    with pytest.raises(ValueError, match="3 programs but 2 states"):
        run_cycles(fields, ref.PEState(*(t[:2] for t in state)), nbr)
    with pytest.raises(ValueError, match="contiguous"):     # P != the grid's
        run_cycles(ref.InstrRow(*(x[:, :, :3].contiguous() for x in fields)),
                   state, nbr)
    with pytest.raises(ValueError, match="contiguous"):
        run_cycles(fields, state, nbr[:3])
    with pytest.raises(ValueError, match="program"):
        run_cycles(ref.InstrRow(*(x[None] for x in fields)), state, nbr)


def test_fuzz_stacked_is_one_launch_with_the_single_kernel_verdicts(cuda):
    arts = [load_artifact("4x4", k) for k in ("dotprod", "gsm", "stencil3")]
    mems = np.stack([make_corpus(a, 300) for a in arts])
    before = run_cycles.launches
    reports = fuzz_stacked(arts, mems, device=cuda)
    assert run_cycles.launches == before + 1
    for art, m, rep in zip(arts, mems, reports):
        single = fuzz_program(art, m, batch=300, device="cpu",
                              collect_activity=False)
        assert rep.backend == "cuda" and rep.status == "ok"
        assert (rep.failing, rep.mismatches) == \
            (single.failing, single.mismatches)
    (g_final, g_outs), (c_final, c_outs) = (
        run_stacked(arts, mems, device=d) for d in (cuda, "cpu"))
    assert torch.equal(g_outs.cpu(), c_outs)
    assert torch.equal(g_final.mem.cpu(), c_final.mem)


@pytest.mark.parametrize("arch,kernel", [("4x4", "gsm"), ("4x4", "fir4"),
                                         ("3x3", "sqrt")])
def test_activity_on_the_card_equals_the_cpu_path(cuda, arch, kernel):
    art = load_artifact(arch, kernel)
    mems = make_corpus(art, 600)
    # both runs map live: the CDCL backend maps the same way every time,
    # where z3 (what "auto" picks when it is installed) may not
    config = MapperConfig(backend="cdcl")
    reports = [fuzz_kernel(kernel, arch, memories=600, batch=256,
                           config=config, device=d)
               for d in (cuda, "cpu")]
    assert reports[0].activity == reports[1].activity is not None
    assert reports[0].energy == reports[1].energy is not None
    acc = ActivityAccumulator(art.asm, art.grid)
    outs = execute_asm(art.asm, art.grid, mems, batch=600, device=cuda)[1]
    acc.update(outs)
    assert acc._bits.device.type == "cuda"      # the sums stay on the card
    assert acc.report().to_dict()["memories"] == 600


def test_fresh_mapping_runs_equal_on_card_and_cpu(cuda):
    """gsm mapped and assembled by the port itself, run on the card, is
    bit-equal to its plain run on the CPU (trace and final memory)."""
    from repro_torch.cgra.artifact import Artifact
    from repro_torch.toolchain import Toolchain

    tc = Toolchain("4x4")
    prog = tc.program("gsm")
    mapping = tc.map(prog).mapping
    art = Artifact.from_mapping(prog.builder, mapping)
    mems = make_corpus("gsm", 300)
    runs = [execute_asm(art.asm, art.grid, mems, batch=300, device=d)
            for d in (cuda, "cpu")]
    assert torch.equal(runs[0][1].cpu(), runs[1][1])
    assert torch.equal(runs[0][0].mem.cpu(), runs[1][0].mem)
    sims = [tc.simulate(prog, mapping, mems[0], batch=2, device=d)
            for d in (cuda, "cpu")]
    assert np.array_equal(sims[0].final_mem, sims[1].final_mem)
    assert sims[0].node_values.keys() == sims[1].node_values.keys()
    for n, vals in sims[0].node_values.items():
        assert np.array_equal(vals, sims[1].node_values[n])


def test_default_backend_mapping_fuzzes_ok_on_the_card(cuda):
    """``fuzz_kernel`` with the default mapper config: on a host with z3
    "auto" maps through the z3 session (the CDCL one elsewhere), and the
    verdict must still be ``ok``."""
    from repro_torch.core.backends import resolve_backend

    rep = fuzz_kernel("gsm", "4x4", memories=512, batch=256, device=cuda)
    assert rep.status == "ok" and rep.failing == [], rep.mismatches[:2]
    assert rep.ii >= 5 and rep.map_time_s > 0      # mII of gsm on 4x4 is 5
    assert resolve_backend("auto") in ("z3", "cdcl")


def _cosim_doc(rep) -> dict:
    doc = rep.to_dict()
    doc.pop("map_time_s")
    return doc


@pytest.mark.parametrize("kernel", ["dotprod", "argmax"])
def test_cosimulate_on_the_card_equals_the_cpu_run(cuda, kernel):
    """One ``run_cycles`` launch for the 16-seed batch, and the report
    equal to the CPU run's but for the mapping time (CDCL maps the same
    way every time)."""
    from repro_torch.frontend import TRACED_KERNELS, cosimulate

    config = MapperConfig(backend="cdcl", per_ii_timeout_s=60.0,
                          total_timeout_s=120.0, ii_max=32)
    cycle_step.launches = run_cycles.launches = 0
    card = cosimulate(TRACED_KERNELS[kernel], config=config, device=cuda)
    assert (run_cycles.launches, cycle_step.launches) == (1, 0)
    cpu = cosimulate(TRACED_KERNELS[kernel], config=config, device="cpu")
    assert card.status == "ok" and card.seeds == 16, card.mismatches[:2]
    assert _cosim_doc(card) == _cosim_doc(cpu)


def test_default_config_cosim_is_ok_on_the_card(cuda):
    """``DEFAULT_CONFIG`` ("auto": z3 where it is installed) co-simulates
    dotprod bit-exactly."""
    from repro_torch.frontend import TRACED_KERNELS, cosimulate

    rep = cosimulate(TRACED_KERNELS["dotprod"], device=cuda)
    assert rep.status == "ok" and rep.mismatches == []
    assert rep.ii <= rep.ii_bound


def test_cosim_without_the_kernel_library_raises(cuda, monkeypatch):
    """No fallback: when the kernel library cannot be loaded, co-simulation
    on the card fails instead of running the plain loop."""
    from repro_torch.frontend import TRACED_KERNELS, cosimulate
    from repro_torch.kernels import build
    from repro_torch.toolchain import StageError

    def unloadable():
        raise OSError("kernel library unloadable")

    monkeypatch.setattr(build, "library", unloadable)
    run_cycles.launches = 0
    with pytest.raises(StageError, match="kernel library unloadable"):
        cosimulate(TRACED_KERNELS["dotprod"],
                   config=MapperConfig(backend="cdcl"), device=cuda)
    assert run_cycles.launches == 0


# ---------------------------------------------------------------------------
# the mapping cache, the fleet and the racer after CUDA is up: their
# workers fork from a process that has launched kernels, and map on the
# host without touching the device
# ---------------------------------------------------------------------------

CDCL_BUDGET = dict(backend="cdcl", per_ii_timeout_s=60.0,
                   total_timeout_s=120.0, ii_max=32)


def _launch_first(device) -> None:
    """One whole-program launch in this process, before any fork."""
    before = run_cycles.launches
    rep = fuzz_program(load_artifact("4x4", "bitcount"),
                       make_corpus("bitcount", 64), batch=64, device=device)
    torch.cuda.synchronize()
    assert rep.status == "ok" and run_cycles.launches == before + 1


def test_compile_many_fleet_after_a_launch(cuda):
    from repro_torch.toolchain import Toolchain

    _launch_first(cuda)
    kernels = ["gsm", "dotprod", "saxpy", "relu_clamp"]
    res = Toolchain("4x4", MapperConfig(**CDCL_BUDGET)).compile_many(
        kernels, jobs=2)
    assert [cr.kernel for cr in res] == kernels
    for cr in res:
        assert cr.ok and cr.failure is None and cr.retries == 0, cr.error
        assert cr.ii == load_artifact("4x4", cr.kernel).asm.ii


def test_race_after_a_launch_maps_at_the_sequential_ii(cuda):
    """A two-worker race of gsm@4x4 commits the sequential II (the shipped
    artifact's), and its bitstream fuzzes ``ok`` on the card."""
    from repro_torch.cgra.artifact import Artifact
    from repro_torch.toolchain import Toolchain

    _launch_first(cuda)
    tc = Toolchain("4x4", MapperConfig(
        strategy="portfolio:cdcl-seq+cdcl-pair", per_ii_timeout_s=60.0,
        total_timeout_s=120.0, ii_max=32))
    prog = tc.program("gsm")
    res = tc.map(prog, jobs=2)
    assert res.status == "mapped" and res.strategies_raced >= 2
    assert res.ii == load_artifact("4x4", "gsm").asm.ii
    art = Artifact.from_mapping(prog.builder, res.mapping, arch="4x4")
    rep = fuzz_program(art, make_corpus(art, 2048), batch=1024, device=cuda)
    assert rep.status == "ok" and rep.failing == [], rep.mismatches[:2]


def test_fuzz_kernel_cache_cold_then_warm_on_the_card(cuda, tmp_path):
    from repro_torch.dse import MappingCache

    _launch_first(cuda)
    cache = MappingCache(str(tmp_path / "cache"))
    reps = [fuzz_kernel("gsm", "4x4", memories=2048, batch=1024,
                        config=MapperConfig(**CDCL_BUDGET), cache=cache,
                        device=cuda) for _ in range(2)]
    assert cache.stats()["hits"] == 1 and len(cache) == 1
    docs = [r.to_dict() for r in reps]
    for doc in docs:
        for key in ("map_time_s", "exec_time_s", "oracle_time_s",
                    "mem_rate"):
            doc.pop(key)
    assert docs[0] == docs[1]
    assert reps[0].status == "ok" and reps[0].backend == "cuda"


@pytest.mark.parametrize("kernel,size", [("gsm", (2, 3)), ("bitcount", (6, 6))])
def test_swept_point_fuzzes_on_the_card(cuda, tmp_path, kernel, size):
    """A point of the size ladder, swept on two workers forked after a
    launch, runs on the card bit-equal to the CPU (trace and final memory)
    and fuzzes ``ok`` through ``fuzz_kernel`` from the sweep's cache."""
    from repro_torch.cgra.artifact import Artifact
    from repro_torch.dse import MappingCache, SweepConfig, run_sweep
    from repro_torch.toolchain import Toolchain

    _launch_first(cuda)
    label = f"{size[0]}x{size[1]}"
    cfg = SweepConfig(kernels=(kernel,), sizes=(size, (2, 2)),
                      backend="cdcl", jobs=2,
                      cache_dir=str(tmp_path / "cache"))
    row = run_sweep(cfg)["points"][0]
    assert (row["size"], row["status"]) == (label, "mapped")
    cache = MappingCache(cfg.cache_dir)
    tc = Toolchain(label, cfg.mapper_config(), cache=cache)
    prog = tc.program(kernel)
    art = Artifact.from_mapping(prog.builder, tc.map(prog).mapping,
                                arch=label)
    mems = make_corpus(art, 300)
    runs = [execute_asm(art.asm, art.grid, mems, batch=300, device=d)
            for d in (cuda, "cpu")]
    assert torch.equal(runs[0][1].cpu(), runs[1][1])
    assert torch.equal(runs[0][0].mem.cpu(), runs[1][0].mem)
    rep = fuzz_kernel(kernel, label, memories=2048, batch=1024,
                      config=cfg.mapper_config(), cache=cache, device=cuda)
    assert rep.status == "ok" and rep.failing == [], rep.mismatches[:2]
    assert rep.backend == "cuda" and rep.ii == row["ii"]
    stats = cache.stats()
    assert (stats["hits"], stats["misses"]) == (2, 0)


def test_routing_free_heuristic_mapping_runs_on_the_card(cuda):
    """bitcount@3x3 under the heuristic baseline (seed 1) maps without
    routing nodes and runs on the card with no mismatch, bit-equal to the
    CPU."""
    from repro_torch.cgra.arch import make_grid
    from repro_torch.cgra.artifact import Artifact
    from repro_torch.cgra.programs import BENCHMARKS
    from repro_torch.core import (HeuristicConfig, map_dfg_heuristic,
                                  validate_mapping)

    prog = BENCHMARKS["bitcount"]()
    res = map_dfg_heuristic(prog.build_dfg(), make_grid(3, 3),
                            HeuristicConfig(seed=1))
    assert res.mapping is not None and res.mapping.routing_nodes == 0
    assert validate_mapping(res.mapping) == []
    art = Artifact.from_mapping(prog, res.mapping, arch="3x3")
    mems = make_corpus(art, 2048)
    before = run_cycles.launches
    rep = fuzz_program(art, mems, batch=1024, device=cuda)
    assert rep.status == "ok" and rep.failing == [], rep.mismatches[:2]
    assert run_cycles.launches == before + 2
    cpu = fuzz_program(art, mems[:256], batch=256, device="cpu")
    assert (cpu.status, cpu.failing) == ("ok", [])


def test_served_mapping_fuzzes_from_the_server_cache(cuda, tmp_path):
    """gsm served by the port's compile server (two worker processes
    forked after a launch) fuzzes ``ok`` on the card from the server's
    cache: the map is a hit, at the served II."""
    import asyncio

    from repro_torch.dse import MappingCache
    from repro_torch.serve import CompileServer, ServeClient

    _launch_first(cuda)
    cache_dir = str(tmp_path / "cache")

    async def serve_once():
        server = CompileServer(jobs=2, cache=cache_dir)
        try:
            host, port = await server.start()
            client = await ServeClient.connect(host, port)
            try:
                return await client.compile("gsm", arch="4x4",
                                            config=CDCL_BUDGET)
            finally:
                await client.close()
        finally:
            server.close()

    cr, served = asyncio.run(serve_once())
    assert served == "compiled" and cr.ok
    cache = MappingCache(cache_dir)
    before = run_cycles.launches
    rep = fuzz_kernel("gsm", "4x4", memories=2048, batch=1024,
                      config=MapperConfig(**CDCL_BUDGET), cache=cache,
                      device=cuda)
    assert rep.status == "ok" and rep.failing == [], rep.mismatches[:2]
    assert rep.backend == "cuda" and rep.ii == cr.ii
    assert run_cycles.launches == before + 2
    stats = cache.stats()
    assert (stats["hits"], stats["misses"]) == (1, 0)
