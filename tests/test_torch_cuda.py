"""The CUDA kernels (the whole-program run, single and stacked, the
cycle step, its one-row launch, and the fuzz oracle) against their plain
PyTorch versions (the oracle's images and node values also against the
numpy oracle, its verdict against ``compare_batch``), and
the fuzz path's stacked run, activity harvest and triage (each judged by
one oracle launch a kernel or probe), a kernel the
port mapped itself, and the
traced front-end's co-simulation, swept points of the size ladder, a
heuristic-baseline mapping and a mapping the compile server served,
against the CPU path, on the card.
These need an NVIDIA GPU with nvcc (the kernels have no CPU mode): they
carry the ``cuda`` marker and skip elsewhere.  They import nothing of
JAX, so they run where only the port is installed::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: exact equality, every value is int32.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch",
                            reason="optional extra: pip install .[torch]")

from repro_torch.cgra.arch import Grid, neighbor_table  # noqa: E402
from repro_torch.cgra.artifact import artifact_names, load_artifact  # noqa: E402
from repro_torch.cgra.simulator import execute_asm  # noqa: E402
from repro_torch.convert import fields_from_numpy, state_from_numpy  # noqa: E402
from repro_torch.core.mapper import MapperConfig  # noqa: E402
from repro_torch.fuzz.corpus import make_corpus  # noqa: E402
from repro_torch.fuzz.activity import ActivityAccumulator  # noqa: E402
from repro_torch.fuzz.engine import (  # noqa: E402
    batched_oracle, compare_batch, fuzz_kernel, fuzz_program, fuzz_stacked,
    run_stacked)
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.cgra.isa import OPCODE  # noqa: E402
from repro_torch.kernels.pe_array import (  # noqa: E402
    LANE_LAYOUT, UNIFORM_LAYOUT, cycle_step, lanes_fit, run_cycles)
from repro_torch.kernels.oracle import (  # noqa: E402
    compile_oracle, oracle_ref, oracle_verdict, oracle_verdict_ref)
from repro_torch.kernels.sample import (  # noqa: E402
    HAZARDS, OUT_OF_RANGE, VERDICT_FAULTS, first_error_case, hazard_fields,
    oracle_edge_mems, oracle_edges, out_of_range_program, random_fields,
    random_state, tiled_corpus, verdict_case)

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


#: (grid side, batch, M) of the one-cycle launches: P from 1 to 256 on
#: square tori (M > P), batches not a multiple of a block's rows up to
#: 16,383, and an image of 65,536 words (device memory, uniform layout)
STEP_SHAPES = [(1, 1, 64), (1, 16383, 128), (4, 37, 128), (4, 16383, 128),
               (5, 1001, 128), (6, 9, 128), (6, 4097, 256), (8, 37, 128),
               (8, 1001, 256), (16, 3, 512), (16, 1001, 512),
               (4, 2, 65_536)]
#: the rows a case steps through: random rows in the full encoding
#: (selectors 11-15, opcodes 27-31), and the hazard programs (a load and a
#: store to one address in one cycle, loads of the last cycle's stores,
#: all-NOP rows) where P >= 2
STEP_KINDS = [(shape, kind) for shape in STEP_SHAPES
              for kind in ("random",) + (HAZARDS if shape[0] > 1 else ())]


def _at_allocation_end(x, device):
    """``x`` copied into the last elements of a fresh 2 MB allocation (one
    segment of the caching allocator): a read past the row's P fields
    leaves the allocation."""
    buf = torch.empty(1 << 19, dtype=torch.int32, device=device)
    buf[-len(x):] = torch.as_tensor(x, device=device)
    return buf[-len(x):]


@pytest.mark.parametrize("shape,kind", STEP_KINDS)
def test_cycle_step_is_a_one_row_launch_in_each_layout(cuda, shape, kind):
    """16 cycles: ``cycle_step`` (the layout its shape gets) and a one-row,
    untraced ``run_cycles`` in each layout that takes the shape, each from
    its own previous state, bit-equal to the plain step after every cycle;
    each row's fields sit at the end of an allocation."""
    from repro_torch.kernels.pe_array import run_cycles_geometry

    side, batch, M = shape
    P = side * side
    rng = np.random.RandomState(side * 1000 + batch + M)
    if kind == "random":
        f = random_fields(rng, 16, P, M, full_encoding=True)
    else:
        f = hazard_fields(rng, kind, 16, P, M)
    nbr = torch.as_tensor(np.asarray(neighbor_table(Grid(side, side)),
                                     np.int32), device=cuda)
    state = state_from_numpy(*(random_state(rng, batch, P, M)[k]
                               for k in STATE), device=cuda)
    layouts = (UNIFORM_LAYOUT,) + ((LANE_LAYOUT,) if lanes_fit(P, M) else ())
    assert run_cycles_geometry(batch, P, M, 1, 1).layout == layouts[-1]
    plain, kern = state, state
    forced = {layout: state for layout in layouts}
    steps = cycle_step.launches
    for t in range(16):
        row = ref.InstrRow(*(_at_allocation_end(f[k][t], cuda)
                             for k in FIELDS))
        plain = ref.cycle_step_ref(plain, row, nbr)
        kern = cycle_step(kern, row, nbr)
        for layout in layouts:
            forced[layout], none = run_cycles(
                ref.InstrRow(*(x[None] for x in row)), forced[layout], nbr,
                trace=False, layout=layout)
            assert none is None
        for got, what in [(kern, "cycle_step")] + [
                (forced[lay], f"layout {lay}") for lay in layouts]:
            for name, a, b in zip(STATE, got, plain):
                assert torch.equal(a, b), f"{what}: {name} after step {t}"
    torch.cuda.synchronize()
    assert cycle_step.launches == steps + 16


@pytest.mark.parametrize("side,batch,M,lane", [
    (4, 1024, 128, True), (4, 16384, 128, True), (6, 1024, 128, False),
    (16, 37, 512, False), (4, 2, 65_536, False)])
def test_cycle_step_counts_its_own_launches(cuda, side, batch, M, lane):
    """Each call adds one to ``cycle_step.launches`` and nothing to
    ``run_cycles``'s counts, though it launches ``run_cycles``'s kernels
    (the lane layout wherever it fits, at any B)."""
    from repro_torch.kernels.pe_array import run_cycles_geometry

    f, s, nbrs = _case(side, batch, M, 1)
    assert (run_cycles_geometry(batch, side * side, M, 1, 1).layout
            == LANE_LAYOUT) == lane
    nbr = torch.as_tensor(np.asarray(nbrs, np.int32), device=cuda)
    state = state_from_numpy(*(s[k] for k in STATE), device=cuda)
    row = fields_from_numpy(*(f[k][0] for k in FIELDS), device=cuda)
    out = ref.PEState(*(torch.empty_like(t) for t in state))
    before = (cycle_step.launches, run_cycles.launches,
              run_cycles.lane_launches)
    for i in range(3):
        cycle_step(state, row, nbr, out=out)
        assert (cycle_step.launches, run_cycles.launches,
                run_cycles.lane_launches) == (before[0] + i + 1, *before[1:])
    for a, b in zip(out, ref.cycle_step_ref(state, row, nbr)):
        assert torch.equal(a, b)


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


def _adres_artifact(kernel):
    """A frozen artifact of the benchmark's 8x8 mesh (P = 64)."""
    import json
    from pathlib import Path

    from repro_torch.cgra.artifact import Artifact

    path = (Path(__file__).resolve().parents[1] / "portbench" / "data"
            / "adres-8x8" / f"{kernel}.json")
    return Artifact.from_dict(json.loads(path.read_text()))


@pytest.mark.parametrize("fault", [False, True], ids=["clean", "fault"])
@pytest.mark.parametrize("arch,kernel", [("4x4", "gsm"),
                                         ("adres-8x8", "stencil3")])
def test_fuzz_program_uploads_each_chunk_once(cuda, tmp_path, monkeypatch,
                                              arch, kernel, fault):
    """Three chunks: the device program is built on the first call (the
    faulted artifact builds its own) and not on the second; each
    ``fuzz.chunk`` copies rows x M x 4 bytes, the chunk's image, which
    the oracle reads as it was sent after the launch; failing memories,
    mismatch lines and activity equal the CPU path's."""
    from repro_torch.cgra.simulator import device_program
    from repro_torch.fuzz import engine
    from repro_torch.obs import report
    from repro_torch.obs import trace as obs_trace

    art = (_adres_artifact(kernel) if arch == "adres-8x8"
           else load_artifact(arch, kernel))
    if fault:
        art = _faulty(art)
    mems = make_corpus(art, 600, seed=5)
    cpu = fuzz_program(art, mems, batch=256, device="cpu")
    real, judged = engine._VerdictStep.judge, []

    def judge(step, image, sim_mem, sim_vals):
        verdict = real(step, image, sim_mem, sim_vals)
        judged.append((image.device, image.cpu().numpy()))
        return verdict

    monkeypatch.setattr(engine._VerdictStep, "judge", judge)
    builds = device_program.builds
    obs_trace.enable(str(tmp_path / "trace"))
    try:
        card = fuzz_program(art, mems, batch=256, device=cuda)
    finally:
        obs_trace.disable()
    assert device_program.builds == builds + 1
    again = fuzz_program(art, mems, batch=256, device=cuda)
    assert device_program.builds == builds + 1
    for rep in (card, again):
        assert (rep.status, rep.failing, rep.mismatches, rep.activity) == (
            cpu.status, cpu.failing, cpu.mismatches, cpu.activity)
    assert (card.status == "mismatch") == fault
    M = mems.shape[1]
    chunks = [r["attrs"] for r in report.load(str(tmp_path / "trace"))
              if r["k"] == "span" and r["name"] == "fuzz.chunk"]
    assert [a["upload_bytes"] for a in chunks] == [
        rows * M * 4 for rows in (256, 256, 88)]
    for lo, (device, image) in zip((0, 256, 512), judged[:3]):
        assert device.type == "cuda"
        np.testing.assert_array_equal(image, mems[lo:lo + 256])


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
                    "mem_rate", "readback_time_s", "compare_time_s",
                    "activity_time_s", "activity_setup_s"):
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


# ---------------------------------------------------------------------------
# the fuzz oracle's kernel (csrc/oracle.cu) against its plain version and
# the numpy oracle, and fuzz_program's verdicts with it on the card
# ---------------------------------------------------------------------------

#: (arch, kernel) of every shipped artifact
SHIPPED_ARTIFACTS = [(arch, name) for arch in ("4x4", "3x3")
                     for name in artifact_names(arch)]
ORACLE_BATCHES = (1, 33, 1024, 16384)


def _oracle(table, mems):
    """The oracle kernel's node values and images over ``mems`` (a CUDA
    tensor) as ``oracle_ref`` gives them: one ``oracle_verdict`` launch
    that takes the input images for the simulator's and compares no
    node."""
    got = oracle_verdict(table, mems, mems,
                         torch.zeros((0, mems.shape[0]), dtype=torch.int32,
                                     device=mems.device), [])
    vals = got.vals.cpu().numpy()
    return ({nid: vals[pos] for pos, nid in enumerate(table.node_ids)}
            if table.trip > 0 else {}), got.image.cpu().numpy()


def _oracle_same(got, want, tag):
    (gv, gm), (wv, wm) = got, want
    assert list(gv) == list(wv), tag
    for n in wv:
        assert gv[n].dtype == np.int64, (tag, n)
        np.testing.assert_array_equal(
            gv[n], np.broadcast_to(wv[n], gv[n].shape),
            err_msg=f"{tag} node {n}")
    assert gm.dtype == np.int64
    np.testing.assert_array_equal(gm, wm, err_msg=f"{tag} memory")


@pytest.mark.parametrize("arch,kernel", SHIPPED_ARTIFACTS)
def test_oracle_kernel_matches_plain_version_and_numpy(cuda, arch, kernel):
    art = load_artifact(arch, kernel)
    table = art.oracle_table
    for B in ORACLE_BATCHES:
        mems = tiled_corpus(art, B)
        before = oracle_verdict.launches
        got = _oracle(table, torch.as_tensor(mems, device=cuda))
        assert oracle_verdict.launches == before + 1
        _oracle_same(got, oracle_ref(table, torch.as_tensor(mems)), B)
        _oracle_same(got, batched_oracle(art.program, mems), B)


@pytest.mark.parametrize("trip", [0, 1, 5, 8])
@pytest.mark.parametrize("B,M", [(0, 32), (1, 32), (33, 32), (1024, 32),
                                 (70, 4096)])
def test_oracle_kernel_on_hand_built_edges(cuda, trip, B, M):
    """Wide FXPMUL products, shifts past 31 and negative, SRT of negative
    words, BSFA / BZFA on zero and negative flags; an empty batch; at
    M = 4096 the images stay in device memory."""
    from repro_torch.cgra.programs import LoopBuilder

    program = oracle_edges(LoopBuilder, trip)
    table = compile_oracle(program)
    mems = oracle_edge_mems(B, M, seed=trip * 7 + B)
    got = _oracle(table, torch.as_tensor(mems, device=cuda))
    _oracle_same(got, oracle_ref(table, torch.as_tensor(mems)), (trip, B))
    _oracle_same(got, batched_oracle(program, mems), (trip, B))


@pytest.mark.parametrize("kind", OUT_OF_RANGE)
def test_oracle_kernel_raises_the_numpy_address_error(cuda, kind):
    from repro_torch.cgra.programs import LoopBuilder

    M = 16
    mems = np.tile(np.arange(M, dtype=np.int32) % 8, (6, 1))
    mems[3, 2] = M + 5
    mems[5, 1] = -1
    program = out_of_range_program(LoopBuilder, kind, M)
    with pytest.raises(IndexError) as want:
        batched_oracle(program, mems)
    with pytest.raises(IndexError) as got:
        _oracle(compile_oracle(program), torch.as_tensor(mems, device=cuda))
    assert str(got.value) == str(want.value)


def test_oracle_kernel_names_the_first_bad_access_over_all_memories(cuda):
    from repro_torch.cgra.programs import LoopBuilder

    program, mems, text = first_error_case(LoopBuilder)
    wide = np.concatenate([np.zeros((200, 8), np.int32), mems])
    with pytest.raises(IndexError, match=re.escape(text)):
        _oracle(compile_oracle(program), torch.as_tensor(wide, device=cuda))


def test_oracle_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    table = load_artifact("4x4", "gsm").oracle_table
    mems = torch.zeros((4, 128), dtype=torch.int32, device=cuda)
    none = torch.zeros((0, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        oracle_verdict(table, mems.to(torch.int64), mems, none, [])
    with pytest.raises(ValueError, match="contiguous"):
        oracle_verdict(table, mems.t(), mems, none, [])


def _faulty(art):
    import dataclasses

    from repro_torch.fuzz.triage import inject_fault

    mutated, _, _ = inject_fault(art.asm)
    return dataclasses.replace(art, asm=mutated)


@pytest.mark.parametrize("fault", [False, True], ids=["clean", "fault"])
@pytest.mark.parametrize("arch,kernel", [("4x4", "gsm"), ("4x4", "ema_fxp"),
                                         ("4x4", "stringsearch"),
                                         ("3x3", "sqrt")])
def test_fuzz_program_verdicts_equal_with_the_oracle_kernel(
        cuda, tmp_path, arch, kernel, fault):
    """The same failing memories, mismatch lines and activity as the CPU
    path; one oracle launch a chunk, in a ``fuzz.oracle`` span that names
    the backend."""
    from repro_torch.obs import report
    from repro_torch.obs import trace as obs_trace

    art = load_artifact(arch, kernel)
    if fault:
        art = _faulty(art)
    mems = make_corpus(art, 700, seed=4)
    cpu = fuzz_program(art, mems, batch=256, device="cpu")
    before = oracle_verdict.launches
    obs_trace.enable(str(tmp_path / "trace"))
    try:
        card = fuzz_program(art, mems, batch=256, device=cuda)
    finally:
        obs_trace.disable()
    assert oracle_verdict.launches - before == 3
    assert (card.status, card.failing, card.mismatches, card.activity) == (
        cpu.status, cpu.failing, cpu.mismatches, cpu.activity)
    assert (card.status == "mismatch") == fault
    spans = [r for r in report.load(str(tmp_path / "trace"))
             if r["k"] == "span" and r["name"] == "fuzz.oracle"]
    assert [s["attrs"] for s in spans] == [{"backend": "cuda"}] * 3


def _compare_attrs(trace_dir):
    from repro_torch.obs import report

    return [r["attrs"] for r in report.load(str(trace_dir))
            if r["k"] == "span" and r["name"] == "fuzz.compare"]


# ---------------------------------------------------------------------------
# the oracle kernel's verdict epilogue against compare_batch, and the fuzz
# path that copies back only the verdict and the failing rows
# ---------------------------------------------------------------------------


def _verdict_on_card(cuda, table, mems, vals, sim_mem):
    nodes = [n for n in vals if n in table.node_ids]
    slots = [table.node_ids.index(n) for n in nodes]
    sim = torch.as_tensor(
        np.stack([vals[n] for n in nodes]) if nodes
        else np.zeros((0, len(mems)), np.int32), device=cuda)
    got = oracle_verdict(table, torch.as_tensor(mems, device=cuda),
                         torch.as_tensor(sim_mem, device=cuda), sim, slots)
    ref = oracle_verdict_ref(table, torch.as_tensor(mems),
                             torch.as_tensor(sim_mem), sim.cpu(), slots)
    return got, ref, nodes, slots


@pytest.mark.parametrize("fault", VERDICT_FAULTS)
@pytest.mark.parametrize("B,M", [(1000, 128), (16384, 128), (1000, 2048),
                                 (33, 4096)])
def test_oracle_verdict_matches_compare_batch(cuda, fault, B, M):
    """Differences in image words, node values, both or neither, at the
    edges of a block's 32 rows; M = 128 keeps the images in shared memory,
    M = 2048 and 4096 in device memory; B = 1000 and 33 are no multiple of
    32."""
    from repro_torch.cgra.programs import LoopBuilder

    program = oracle_edges(LoopBuilder)
    table = compile_oracle(program)
    mems = oracle_edge_mems(B, M, seed=B + M)
    ov, om = batched_oracle(program, mems)
    vals, sim_mem = verdict_case(ov, om, fault,
                                 {0, 31, 32, 33, B // 2, B - 2, B - 1})
    before = oracle_verdict.launches
    got, ref, nodes, slots = _verdict_on_card(cuda, table, mems, vals,
                                              sim_mem)
    assert oracle_verdict.launches == before + 1
    np.testing.assert_array_equal(got.bad, compare_batch(vals, sim_mem, ov,
                                                         om))
    np.testing.assert_array_equal(got.bad, ref.bad)
    assert got.bad.any() == (fault != "neither")
    np.testing.assert_array_equal(got.image.cpu().numpy(), om)
    for n, slot in zip(nodes, slots):
        np.testing.assert_array_equal(got.vals[slot].cpu().numpy(), ov[n])


@pytest.mark.parametrize("fault", VERDICT_FAULTS)
@pytest.mark.parametrize("M", [128, 2048])
def test_oracle_verdict_at_trip_0_compares_the_image_only(cuda, fault, M):
    from repro_torch.cgra.programs import LoopBuilder

    program = oracle_edges(LoopBuilder, trip=0)
    table = compile_oracle(program)
    mems = oracle_edge_mems(100, M, seed=M)
    ov, om = batched_oracle(program, mems)
    _, sim_mem = verdict_case(ov, om, fault, range(0, 100, 11))
    sim_vals = {n: np.full(100, 9, np.int32) for n in table.node_ids[:4]}
    got, ref, _, _ = _verdict_on_card(cuda, table, mems, sim_vals, sim_mem)
    np.testing.assert_array_equal(got.bad, compare_batch(sim_vals, sim_mem,
                                                         ov, om))
    np.testing.assert_array_equal(got.bad, ref.bad)
    assert got.bad.any() == (fault in ("image", "both"))


@pytest.mark.parametrize("arch,kernel", SHIPPED_ARTIFACTS)
def test_oracle_verdict_on_every_shipped_artifact(cuda, arch, kernel):
    art = load_artifact(arch, kernel)
    for B in (1000, 16384):
        mems = tiled_corpus(art, B)
        ov, om = batched_oracle(art.program, mems)
        for fault in ("neither", "both"):
            vals, sim_mem = verdict_case(ov, om, fault, range(0, B, 97))
            got, _, _, _ = _verdict_on_card(cuda, art.oracle_table, mems,
                                            vals, sim_mem)
            np.testing.assert_array_equal(
                got.bad, compare_batch(vals, sim_mem, ov, om),
                f"{fault} B={B}")


@pytest.mark.parametrize("kind", OUT_OF_RANGE)
def test_oracle_verdict_raises_the_numpy_address_error(cuda, kind):
    from repro_torch.cgra.programs import LoopBuilder

    M = 16
    mems = np.tile(np.arange(M, dtype=np.int32) % 8, (6, 1))
    mems[3, 2] = M + 5
    mems[5, 1] = -1
    program = out_of_range_program(LoopBuilder, kind, M)
    with pytest.raises(IndexError) as want:
        batched_oracle(program, mems)
    dev = torch.as_tensor(mems, device=cuda)
    with pytest.raises(IndexError) as got:
        oracle_verdict(compile_oracle(program), dev, dev,
                       torch.zeros((0, 6), dtype=torch.int32, device=cuda),
                       [])
    assert str(got.value) == str(want.value)


def test_oracle_verdict_takes_an_empty_batch_and_refuses_bad_operands(cuda):
    table = load_artifact("4x4", "gsm").oracle_table
    empty = torch.zeros((0, 128), dtype=torch.int32, device=cuda)
    before = oracle_verdict.launches
    got = oracle_verdict(table, empty, empty,
                         torch.zeros((1, 0), dtype=torch.int32, device=cuda),
                         [0])
    assert got.bad.shape == (0,) and oracle_verdict.launches == before
    mems = torch.zeros((4, 128), dtype=torch.int32, device=cuda)
    vals = torch.zeros((1, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="sim_image"):
        oracle_verdict(table, mems, mems[:, :64].contiguous(), vals, [0])
    with pytest.raises(ValueError, match="sim_image"):
        oracle_verdict(table, mems, mems.cpu(), vals, [0])
    with pytest.raises(ValueError, match="sim_vals"):
        oracle_verdict(table, mems, mems, vals.to(torch.int64), [0])
    with pytest.raises(ValueError, match="slot outside"):
        oracle_verdict(table, mems, mems, vals, [len(table.node_ids)])


@pytest.mark.parametrize("fault", [False, True], ids=["clean", "fault"])
@pytest.mark.parametrize("arch,kernel", [("4x4", "gsm"), ("4x4", "fir4"),
                                         ("3x3", "sqrt")])
def test_fuzz_program_copies_back_only_the_failing_rows(cuda, tmp_path, arch,
                                                        kernel, fault):
    """Two chunks: one verdict launch each, a ``fuzz.compare`` span each
    with backend ``cuda``; no row copied back when clean, at most the
    sample's cap when faulted; failing memories, mismatch lines and
    activity equal to the CPU path's."""
    from repro_torch.fuzz.engine import _MISMATCH_SAMPLE_CAP
    from repro_torch.obs import trace as obs_trace

    art = load_artifact(arch, kernel)
    if fault:
        art = _faulty(art)
    mems = make_corpus(art, 2048, seed=8)
    cpu = fuzz_program(art, mems, batch=1024, device="cpu")
    before = oracle_verdict.launches
    obs_trace.enable(str(tmp_path / "trace"))
    try:
        card = fuzz_program(art, mems, batch=1024, device=cuda)
    finally:
        obs_trace.disable()
    assert oracle_verdict.launches - before == 2
    assert (card.status, card.failing, card.mismatches, card.activity) == (
        cpu.status, cpu.failing, cpu.mismatches, cpu.activity)
    attrs = _compare_attrs(tmp_path / "trace")
    assert [a["backend"] for a in attrs] == ["cuda"] * 2
    rows_back = sum(a["rows_back"] for a in attrs)
    if fault:
        assert card.failing and 0 < rows_back <= _MISMATCH_SAMPLE_CAP
    else:
        assert not card.failing and rows_back == 0


def test_fuzz_stacked_launches_the_oracle_once_a_kernel(cuda):
    """On the card each kernel of a stack is judged by one oracle launch,
    and the reports equal the CPU's, a faulty kernel among them."""
    arts = [load_artifact("4x4", k) for k in ("dotprod", "gsm", "stencil3")]
    arts[1] = _faulty(arts[1])
    mems = np.stack([make_corpus(a, 300, seed=2) for a in arts])
    before = oracle_verdict.launches
    card = fuzz_stacked(arts, mems, device=cuda)
    assert oracle_verdict.launches - before == len(arts)
    cpu = fuzz_stacked(arts, mems, device="cpu")
    assert [r.status for r in card] == ["ok", "mismatch", "ok"]
    assert [(r.kernel, r.status, r.ii, r.failing, r.mismatches)
            for r in card] == [(r.kernel, r.status, r.ii, r.failing,
                                r.mismatches) for r in cpu]
    assert all(r.backend == "cuda" for r in card)


def test_shrink_on_the_card_launches_the_oracle_once_a_probe(cuda, tmp_path):
    """Triage on the card: ``engine_check`` gives the CPU's mask in one
    oracle launch a probe, ``shrink`` reaches the CPU's memory in as many
    probes, and ``triage_failure`` (those probes and one launch for the
    reproducer's lines) writes the CPU's reproducer but for ``backend``."""
    import json

    from repro_torch.fuzz.triage import engine_check, shrink, triage_failure

    art = _faulty(load_artifact("4x4", "gsm"))
    mems = make_corpus(art, 512, seed=3)
    checks = {"cuda": engine_check(art, device=cuda),
              "ref": engine_check(art, device="cpu")}
    before = oracle_verdict.launches
    mask = checks["cuda"](mems)
    assert oracle_verdict.launches - before == 1
    np.testing.assert_array_equal(mask, checks["ref"](mems))
    failing = np.nonzero(mask)[0]
    assert failing.size
    before = oracle_verdict.launches
    card = shrink(mems[failing], checks["cuda"], indices=failing)
    assert oracle_verdict.launches - before == card[2]
    cpu = shrink(mems[failing], checks["ref"], indices=failing)
    np.testing.assert_array_equal(card[0], cpu[0])
    assert card[1:] == cpu[1:]
    launches, docs = {}, {}
    for name, dev in (("cuda", cuda), ("ref", "cpu")):
        rep = fuzz_program(art, mems, batch=512, device=dev,
                           collect_activity=False)
        assert rep.failing == failing.tolist()
        before = oracle_verdict.launches
        triage_failure(art, mems, rep, device=dev,
                       out_dir=str(tmp_path / name))
        launches[name] = oracle_verdict.launches - before
        docs[name] = json.loads(open(rep.reproducer).read())
    assert launches == {"cuda": card[2] + 1, "ref": 0}
    assert docs["cuda"].pop("backend") == "cuda"
    assert docs["ref"].pop("backend") == "ref"
    assert docs["cuda"] == docs["ref"] and docs["cuda"]["mismatches"]
