"""repro_torch cycle step and run_program against the JAX package.

The same seeded numpy inputs go through ``repro.kernels`` (the jnp ref and
the Pallas kernel in interpret mode) and through ``repro_torch.kernels`` on
the CPU, where the wrapper takes its plain version.  The tolerance is
exact equality: every value is int32.  The CUDA kernel itself runs only on
a card: ``tests/test_torch_cuda.py`` holds it against this plain version.
"""
import numpy as np
import pytest

pytest.importorskip("torch", reason="optional extra: pip install .[torch]")
pytest.importorskip("jax", reason="optional extra: pip install .[jax]")
pytest.importorskip("hypothesis", reason="optional extra: pip install .[test]")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from hypothesis import HealthCheck, given, settings, strategies as st  # noqa: E402

from repro.cgra import make_grid  # noqa: E402
from repro.cgra.isa import OPCODE, OPS, alu_semantics  # noqa: E402
from repro.cgra.simulator import neighbor_table  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.convert import fields_from_numpy, state_from_numpy  # noqa: E402
from repro_torch.kernels import ops, pe_array, ref  # noqa: E402
from repro_torch.kernels.pe_array import (  # noqa: E402
    LANE_LAYOUT, LANE_SHARED_BYTES, LANE_WARPS, LANES_MAX_WARPS,
    MAX_SHARED_BYTES, PROGRAM_SHARED_BYTES, UNIFORM_LAYOUT, cycle_step,
    lanes_fit, pes_per_warp, run_cycles, run_cycles_geometry)
from repro_torch.kernels.sample import (  # noqa: E402
    HAZARDS, hazard_fields, random_fields, random_state)

SWEEP = [((2, 2), 1, 64), ((2, 2), 8, 128), ((3, 3), 4, 128),
         ((4, 4), 2, 256), ((5, 5), 3, 128), ((6, 6), 5, 128)]
STATE = ("regs", "out", "sf", "zf", "mem")
FIELDS = ("op", "dst", "sa", "sb", "imm")
#: the JAX ref step, jitted per shape so a case does not dispatch op by op
JAX_STEP = jax.jit(jax_ref.cycle_step_ref, static_argnums=2)


def _seed(rows_cols, batch, M):
    return rows_cols[0] * 1000 + batch * 10 + M


def _case(rows_cols, batch, M, T, full_encoding=False):
    rng = np.random.RandomState(_seed(rows_cols, batch, M))
    P = rows_cols[0] * rows_cols[1]
    f = random_fields(rng, T, P, M, full_encoding=full_encoding)
    s = random_state(rng, batch, P, M)
    return f, s, neighbor_table(make_grid(*rows_cols))


#: programs for the whole-program run: (rows, all NOPs)
PROGRAMS = {"random": (12, False), "empty": (0, False), "one_row": (1, False),
            "all_nop": (8, True)}


def _program(rows_cols, batch, M, kind):
    T, nop = PROGRAMS[kind]
    f, s, nbrs = _case(rows_cols, batch, M, T)
    if nop:
        f["op"][:] = OPCODE["NOP"]
    return f, s, nbrs


def _jax_state(s):
    return jax_ref.PEState(*(jnp.asarray(s[k]) for k in STATE))


def _jax_fields(f, t=None):
    return jax_ref.InstrRow(*(jnp.asarray(f[k] if t is None else f[k][t])
                              for k in FIELDS))


def _port_row(f, t):
    return fields_from_numpy(*(f[k][t] for k in FIELDS), device="cpu")


def _assert_state_equal(port, jax_state, where=""):
    for name, a, b in zip(STATE, port, jax_state):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"{name} {where}")


@pytest.mark.parametrize("rows_cols,batch,M", SWEEP)
def test_cycle_step_ref_matches_jax_ref(rows_cols, batch, M):
    f, s, nbrs = _case(rows_cols, batch, M, T=10)
    nbr = torch.as_tensor(np.asarray(nbrs, np.int32))
    port = state_from_numpy(*(s[k] for k in STATE), device="cpu")
    jst = _jax_state(s)
    for t in range(10):
        port = ref.cycle_step_ref(port, _port_row(f, t), nbr)
        jst = JAX_STEP(jst, _jax_fields(f, t), nbrs)
        _assert_state_equal(port, jst, f"after step {t}")


@pytest.mark.parametrize("rows_cols,batch,M", SWEEP)
def test_run_program_matches_jax_run_program(rows_cols, batch, M):
    f, s, nbrs = _case(rows_cols, batch, M, T=12)
    final, outs = ops.run_program(fields_from_numpy(*(f[k] for k in FIELDS),
                                                    device="cpu"),
                                  state_from_numpy(*(s[k] for k in STATE),
                                                   device="cpu"),
                                  nbrs, device="cpu")
    j_final, j_outs = jax_ops.run_program(_jax_fields(f), _jax_state(s),
                                          nbrs, backend="ref")
    np.testing.assert_array_equal(outs.numpy(), np.asarray(j_outs))
    _assert_state_equal(final, j_final)
    untraced, none = ops.run_program(
        fields_from_numpy(*(f[k] for k in FIELDS), device="cpu"),
        state_from_numpy(*(s[k] for k in STATE), device="cpu"),
        nbrs, device="cpu", trace=False)
    assert none is None
    _assert_state_equal(untraced, j_final)


@pytest.mark.parametrize("rows_cols,batch,M", SWEEP[:4])
@pytest.mark.parametrize("full_encoding", [False, True])
def test_run_program_matches_pallas_interpret(rows_cols, batch, M,
                                              full_encoding):
    """Pallas defines selectors 11-15 as ZERO and opcodes 27-31 as 0, as
    the port does, so it is the reference for the full encoding."""
    f, s, nbrs = _case(rows_cols, batch, M, T=6, full_encoding=full_encoding)
    final, outs = ops.run_program(fields_from_numpy(*(f[k] for k in FIELDS),
                                                    device="cpu"),
                                  state_from_numpy(*(s[k] for k in STATE),
                                                   device="cpu"),
                                  nbrs, device="cpu")
    j_final, j_outs = jax_ops.run_program(_jax_fields(f), _jax_state(s),
                                          nbrs, backend="pallas",
                                          interpret=True)
    np.testing.assert_array_equal(outs.numpy(), np.asarray(j_outs))
    _assert_state_equal(final, j_final)


#: shapes of the hazard programs: (grid, batch, M, rows), rows enough for
#: ``every_address`` to walk all of M
HAZARD_SHAPES = [((2, 2), 3, 64, 32), ((3, 3), 2, 64, 16)]


def _pallas_run(f, s, nbrs):
    return jax_ops.run_program(_jax_fields(f), _jax_state(s), nbrs,
                               backend="pallas", interpret=True)


@pytest.mark.parametrize("kind", HAZARDS)
@pytest.mark.parametrize("rows_cols,batch,M,T", HAZARD_SHAPES)
def test_hazard_programs_match_pallas_interpret(rows_cols, batch, M, T,
                                                kind):
    """The programs aimed at the fused kernel's row scheme (NOP rows mid
    program and at its tail, a load right after a store, over every
    address): the plain whole-program run equals the Pallas kernel's scan,
    trace and final state."""
    rng = np.random.RandomState(_seed(rows_cols, batch, M) + T)
    P = rows_cols[0] * rows_cols[1]
    f = hazard_fields(rng, kind, T, P, M)
    s = random_state(rng, batch, P, M)
    nbrs = neighbor_table(make_grid(*rows_cols))
    final, outs = ref.run_cycles_ref(
        fields_from_numpy(*(f[k] for k in FIELDS), device="cpu"),
        state_from_numpy(*(s[k] for k in STATE), device="cpu"),
        torch.as_tensor(np.asarray(nbrs, np.int32)))
    j_final, j_outs = _pallas_run(f, s, nbrs)
    np.testing.assert_array_equal(outs.numpy(), np.asarray(j_outs))
    _assert_state_equal(final, j_final)


@pytest.mark.parametrize("rows_cols,batch,M,T", HAZARD_SHAPES)
def test_hazard_stack_matches_pallas_interpret(rows_cols, batch, M, T):
    """A stack of the hazard programs with lengths from 0 to T_max, NOP
    padded as the fuzz engine pads them (op 0, the other fields of the NOP
    word): the plain stacked run equals the Pallas kernel's scan of each
    padded program."""
    from repro_torch.fuzz.engine import _NOP_WORD

    rng = np.random.RandomState(_seed(rows_cols, batch, M) + 7 * T)
    P = rows_cols[0] * rows_cols[1]
    lengths = [0, 1, T // 3, T - 1, T, T // 2]
    kinds = [HAZARDS[k % len(HAZARDS)] for k in range(len(lengths))]
    pad = ops.decode_fields(np.full((1, P), _NOP_WORD, np.uint32),
                            device="cpu")
    progs = []
    for kind, n in zip(kinds, lengths):
        f = hazard_fields(rng, kind, T, P, M)
        for k, field in zip(FIELDS, pad):
            f[k][n:] = field.numpy()
        progs.append(f)
    states = [random_state(rng, batch, P, M) for _ in lengths]
    nbrs = neighbor_table(make_grid(*rows_cols))
    final, outs = ref.run_stacked_ref(
        ref.InstrRow(*(torch.as_tensor(np.stack([f[k] for f in progs]))
                       for k in FIELDS)),
        ref.PEState(*(torch.as_tensor(np.stack([s[k] for s in states]))
                      for k in STATE)),
        torch.as_tensor(np.asarray(nbrs, np.int32)))
    for k, (f, s) in enumerate(zip(progs, states)):
        j_final, j_outs = _pallas_run(f, s, nbrs)
        np.testing.assert_array_equal(outs[k].numpy(), np.asarray(j_outs),
                                      err_msg=f"program {k}")
        _assert_state_equal(ref.PEState(*(t[k] for t in final)), j_final,
                            f"program {k}")


@pytest.mark.parametrize("kind", list(PROGRAMS))
@pytest.mark.parametrize("rows_cols,batch,M", SWEEP)
def test_run_cycles_ref_matches_jax_run_program(rows_cols, batch, M, kind):
    f, s, nbrs = _program(rows_cols, batch, M, kind)
    final, outs = ref.run_cycles_ref(
        fields_from_numpy(*(f[k] for k in FIELDS), device="cpu"),
        state_from_numpy(*(s[k] for k in STATE), device="cpu"),
        torch.as_tensor(np.asarray(nbrs, np.int32)))
    j_final, j_outs = jax_ops.run_program(_jax_fields(f), _jax_state(s),
                                          nbrs, backend="ref")
    assert outs.shape == j_outs.shape
    np.testing.assert_array_equal(outs.numpy(), np.asarray(j_outs))
    _assert_state_equal(final, j_final)


def _alu_expected(op, a, b):
    if op == "FXPMUL":    # the executors wrap the product to int32 first
        return alu_semantics("SMUL", a, b) >> 16
    return alu_semantics(op, a, b)


@pytest.mark.parametrize("op", [o for o in OPS if o not in (
    "NOP", "BSFA", "BZFA", "LWD", "LWI", "SWD", "SWI")])
def test_every_op_matches_alu_semantics(op):
    rng = np.random.RandomState(OPCODE[op])
    wide = rng.randint(-(1 << 31), 1 << 31, size=(2, 64), dtype=np.int64)
    small = rng.randint(-(1 << 12), 1 << 12, size=(2, 64), dtype=np.int64)
    a = np.concatenate([wide[0], small[0], [70000, -1, 0, (1 << 31) - 1]])
    b = np.concatenate([wide[1], small[1], [70000, 31, 33, 1]])
    a32 = torch.as_tensor(a.astype(np.int32))[:, None]
    b32 = torch.as_tensor(b.astype(np.int32))[:, None]
    zero = torch.zeros_like(a32)
    got = ref.alu(torch.tensor([OPCODE[op]], dtype=torch.int32),
                  a32, b32, zero, zero)[:, 0].tolist()
    want = [_alu_expected(op, int(x), int(y))
            for x, y in zip(a.astype(np.int32), b.astype(np.int32))]
    assert got == want


def test_fxpmul_follows_the_jax_ref_width():
    """70000 * 70000 wraps in int32 before the shift: 9232, not the exact
    74768 of isa.alu_semantics."""
    a = np.full((1, 1), 70000, np.int32)
    op = np.array([OPCODE["FXPMUL"]], np.int32)
    zero = np.zeros((1, 1), np.int32)
    port = ref.alu(torch.as_tensor(op), torch.as_tensor(a),
                   torch.as_tensor(a), torch.as_tensor(zero),
                   torch.as_tensor(zero))
    want = jax_ref.alu(jnp.asarray(op), jnp.asarray(a), jnp.asarray(a),
                       jnp.asarray(zero), jnp.asarray(zero))
    assert int(port[0, 0]) == int(want[0, 0]) == 9232
    assert alu_semantics("FXPMUL", 70000, 70000) == 74768


def test_decode_fields_matches_jax():
    f, _, _ = _case((4, 4), 1, 128, T=20)
    from repro.cgra.isa import Instr, encode_program
    rows = [[Instr(OPS[f["op"][t, p]], int(f["dst"][t, p]),
                   int(f["sa"][t, p]), int(f["sb"][t, p]),
                   int(f["imm"][t, p])) for p in range(16)]
            for t in range(20)]
    words = encode_program(rows)
    port = ops.decode_fields(words, device="cpu")
    want = jax_ops.decode_fields(words)
    for name, a, b in zip(FIELDS, port, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def test_cpu_tensors_take_the_plain_version():
    f, s, nbrs = _case((3, 3), 4, 128, T=1)
    nbr = torch.as_tensor(np.asarray(nbrs, np.int32))
    state = state_from_numpy(*(s[k] for k in STATE), device="cpu")
    before = cycle_step.launches
    got = cycle_step(state, _port_row(f, 0), nbr)
    want = ref.cycle_step_ref(state, _port_row(f, 0), nbr)
    assert cycle_step.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_run_cycles_on_cpu_tensors_takes_the_plain_version():
    f, s, nbrs = _case((3, 3), 4, 128, T=5)
    nbr = torch.as_tensor(np.asarray(nbrs, np.int32))
    fields = fields_from_numpy(*(f[k] for k in FIELDS), device="cpu")
    state = state_from_numpy(*(s[k] for k in STATE), device="cpu")
    before = run_cycles.launches, cycle_step.launches
    got, got_outs = run_cycles(fields, state, nbr)
    want, want_outs = ref.run_cycles_ref(fields, state, nbr)
    assert (run_cycles.launches, cycle_step.launches) == before
    assert torch.equal(got_outs, want_outs)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    _, none = run_cycles(fields, state, nbr, trace=False)
    assert none is None


def _shared_words(geom, P, M, T):
    """What the kernel lays out, in int32 words: the image, the lanes'
    register files (4P registers, two OUT buffers, the two flags, a zero
    and a scratch slot), the neighbour table, the program slots and their
    flags, the last live row and the 32-entry ALU table."""
    S = geom.rows_per_block | 1
    slots = 1 if geom.chunk_rows >= T else 2
    return ((M * S if geom.memory_in_shared else 0) + (8 * P + 2) * S
            + 4 * P + slots * (geom.chunk_rows * (8 * P + 1) + 1) + 1 + 32)


def _check_lanes(geom, B, P, M, T):
    """What the lane layout's kernel checks: whole batch rows of P PEs in
    each warp, a block of LANE_WARPS warps and their rows' image (none
    for one row of one program, whose image stays in device memory)."""
    W = 32 // P
    assert geom.layout == LANE_LAYOUT and geom.threads == 32 * LANE_WARPS
    assert geom.rows_per_block == W * LANE_WARPS
    R = geom.rows_per_block
    assert (geom.blocks - 1) * R < B <= geom.blocks * R
    one_row = max(1, T) == 1 and geom.programs == 1
    assert geom.shared_bytes == (0 if one_row else 4 * R * M)
    assert geom.shared_bytes <= LANE_SHARED_BYTES
    assert geom.chunk_rows == max(1, T)
    assert geom.memory_in_shared == (not one_row)


def test_run_cycles_geometry_fills_the_card_at_the_main_path_batch():
    """B = 1024 (latency-bound) takes the lane layout over 128 blocks, one
    warp an SM sub-partition; B = 16384 takes the uniform one, 32 batch
    rows a warp."""
    geom = run_cycles_geometry(1024, 16, 128, T=84)
    assert geom.blocks >= 128          # about one block an SM of the 132
    assert geom.threads <= 1024
    _check_lanes(geom, 1024, 16, 128, 84)
    assert geom.blocks * LANE_WARPS <= LANES_MAX_WARPS
    big = run_cycles_geometry(16384, 16, 128, T=84)
    assert big.layout == UNIFORM_LAYOUT
    assert big.rows_per_block == 32 and big.blocks == 512
    assert big.threads == 16 * 32 <= 1024      # one warp a PE: uniform
    assert big.chunk_rows == 84 and big.memory_in_shared
    assert big.shared_bytes == 4 * _shared_words(big, 16, 128, 84)
    # the layout not chosen stays available at both sizes
    uni = run_cycles_geometry(1024, 16, 128, T=84, layout=UNIFORM_LAYOUT)
    assert uni.blocks >= 128 and uni.rows_per_block == 8
    assert uni.shared_bytes == 4 * _shared_words(uni, 16, 128, 84)
    _check_lanes(run_cycles_geometry(16384, 16, 128, T=84,
                                     layout=LANE_LAYOUT), 16384, 16, 128, 84)


@pytest.mark.parametrize("B", [1, 37, 1000, 4096])
def test_run_cycles_geometry_fits_48kb_on_the_sweep(B):
    """The program's slots take at most 64 KB and the block at most 227 KB
    on every sweep shape, with the whole program staged when it fits; the
    lane layout, where it fits (P <= 32), takes at most 96 KB."""
    for P in (4, 9, 16, 25, 36):
        for M in (64, 128, 256):
            for T in (1, 84, 112, 400):
                lanes = run_cycles_geometry(B, P, M, T=T,
                                            layout=LANE_LAYOUT) \
                    if lanes_fit(P, M) else None
                if lanes is not None:
                    _check_lanes(lanes, B, P, M, T)
                geom = run_cycles_geometry(B, P, M, T=T)
                if geom.layout == LANE_LAYOUT:
                    assert geom == lanes and P <= 32
                    # one-row launches take it at any B
                    assert T == 1 or -(-B // (32 // P)) <= LANES_MAX_WARPS
                    geom = run_cycles_geometry(B, P, M, T=T,
                                               layout=UNIFORM_LAYOUT)
                R, C = geom.rows_per_block, geom.chunk_rows
                words = _shared_words(geom, P, M, T)
                assert geom.shared_bytes == 4 * words <= MAX_SHARED_BYTES
                slots = 1 if C >= T else 2
                assert slots * (C * (8 * P + 1) + 1) * 4 \
                    <= PROGRAM_SHARED_BYTES
                if (T * (8 * P + 1) + 1) * 4 <= PROGRAM_SHARED_BYTES:
                    assert C == T
                assert geom.memory_in_shared
                assert geom.threads <= 1024 and geom.threads % 32 == 0
                assert geom.threads // 32 * pes_per_warp(P) >= P
                assert R & (R - 1) == 0 and R <= 32
                assert (geom.blocks - 1) * R < B <= geom.blocks * R


@pytest.mark.parametrize("B,P,M,K,lane", [
    (1024, 16, 128, 1, True), (2048, 16, 128, 1, True),
    (2049, 16, 128, 1, False), (3072, 9, 256, 1, True),
    (3073, 9, 256, 1, False), (1024, 25, 128, 1, True),
    (1024, 32, 128, 1, True), (1, 33, 64, 1, False),
    (1024, 16, 128, 2, True), (1024, 16, 128, 3, False),
    (8, 16, 3072, 1, True), (8, 16, 3073, 1, False)])
def test_run_cycles_geometry_chooses_the_lane_layout_for_small_launches(
        B, P, M, K, lane):
    """The lane layout takes a launch of at most LANES_MAX_WARPS warps of
    32 // P batch rows, P <= 32 and a block's image in 96 KB;
    every other launch takes the uniform layout."""
    geom = run_cycles_geometry(B, P, M, K, T=64)
    assert (geom.layout == LANE_LAYOUT) == lane
    if lane:
        _check_lanes(geom, B, P, M, 64)
        assert geom.programs == K
    else:
        assert geom == run_cycles_geometry(B, P, M, K, T=64,
                                           layout=UNIFORM_LAYOUT)


def test_run_cycles_geometry_raises_past_227kb(monkeypatch):
    """An image above what a block's 227 KB holds stays in device memory,
    at any M; the lane layout refuses it; only a block that would not fit
    even without the image raises (none does up to P = 256 on this card,
    so the limit is lowered to show it)."""
    M = MAX_SHARED_BYTES // 4          # with 2P words of OUT, one row too big
    near = run_cycles_geometry(8, 16, M - 32)
    assert near.layout == UNIFORM_LAYOUT   # no lane block holds the image
    with pytest.raises(ValueError, match="lane layout"):
        run_cycles_geometry(8, 16, M - 32, layout=LANE_LAYOUT)
    assert not near.memory_in_shared   # the image stays in device memory
    assert near.shared_bytes == 4 * _shared_words(near, 16, M - 32, 1)
    assert near.shared_bytes <= MAX_SHARED_BYTES
    for far_M in (M, 65_536, 4 * M):
        far = run_cycles_geometry(8, 16, far_M)
        assert far.layout == UNIFORM_LAYOUT and not far.memory_in_shared
        assert far.shared_bytes == near.shared_bytes
        with pytest.raises(ValueError, match="lane layout"):
            run_cycles_geometry(8, 16, far_M, layout=LANE_LAYOUT)
    wide = run_cycles_geometry(8, 256, 4 * M)
    assert not wide.memory_in_shared
    monkeypatch.setattr(pe_array, "MAX_SHARED_BYTES",
                        wide.shared_bytes - 4)
    run_cycles_geometry.cache_clear()
    try:
        with pytest.raises(ValueError, match="227 KB"):
            run_cycles_geometry(8, 256, 4 * M)
    finally:
        run_cycles_geometry.cache_clear()


@pytest.mark.parametrize("P", [33, 36, 64, 100, 256])
def test_run_cycles_geometry_gives_warps_several_pes_past_32(P):
    """P > 32 would take more than 1,024 threads at one warp a PE: a warp
    runs 2, 4 or 8 PEs in turn (a block keeps at most 16 warps up to P =
    128, 32 above)."""
    geom = run_cycles_geometry(1024, P, 128, T=64)
    assert geom.layout == UNIFORM_LAYOUT and not lanes_fit(P, 128)
    k = pes_per_warp(P)
    assert k in (2, 4, 8) and geom.threads == 32 * -(-P // k) <= 1024
    assert geom.threads <= 512 or P > 128
    assert geom.shared_bytes == 4 * _shared_words(geom, P, 128, 64)
    assert geom.shared_bytes <= MAX_SHARED_BYTES


def _accepted_by_pe_run_cycles(geom, T, B, P, M, K=1):
    """The checks ``pe_run_cycles`` (csrc/pe_array.cu) makes of a
    geometry before it launches, restated."""
    R, C = geom.rows_per_block, geom.chunk_rows
    blocks_cover = (geom.blocks - 1) * R < B <= geom.blocks * R
    if geom.layout == LANE_LAYOUT:
        warps = geom.threads // 32
        one_row = K == 1 and T == 1
        return (0 < P <= 32 and geom.threads % 32 == 0
                and 0 < warps <= LANE_WARPS and R == 32 // P * warps
                and C == T and geom.memory_in_shared == (not one_row)
                and blocks_cover
                and geom.shared_bytes == (0 if one_row else 4 * R * M)
                and geom.shared_bytes <= LANE_SHARED_BYTES
                and geom.programs == K)
    k = pes_per_warp(P)
    return (geom.layout == UNIFORM_LAYOUT and 0 < P <= 256
            and 0 < R <= 32 and R & (R - 1) == 0 and 0 < C <= T
            and blocks_cover and geom.threads == 32 * -(-P // k)
            and geom.shared_bytes == 4 * _shared_words(geom, P, M, T)
            <= MAX_SHARED_BYTES and geom.programs == K)


@pytest.mark.parametrize("B", [1, 37, 1000, 1024, 16384])
@pytest.mark.parametrize("P", [1, 4, 16, 25, 32, 33, 64, 256])
def test_one_row_geometry_is_one_pe_run_cycles_takes(P, B):
    """``cycle_step``'s launch, one row (T = 1) and no trace: a geometry
    the C entry accepts at every M, in the lane layout exactly where it
    fits (at any B), else the uniform one, whose image stays in device
    memory at M = 65,536; either layout forced, where it fits, is
    accepted too."""
    for M in (64, 128, 4096, 65_536):
        geom = run_cycles_geometry(B, P, M, 1, 1)
        assert _accepted_by_pe_run_cycles(geom, 1, B, P, M), (M, geom)
        assert (geom.layout == LANE_LAYOUT) == lanes_fit(P, M), M
        if M == 65_536:
            assert geom.layout == UNIFORM_LAYOUT
            assert not geom.memory_in_shared
        uni = run_cycles_geometry(B, P, M, 1, 1, layout=UNIFORM_LAYOUT)
        assert _accepted_by_pe_run_cycles(uni, 1, B, P, M), (M, uni)
        if lanes_fit(P, M):
            lane = run_cycles_geometry(B, P, M, 1, 1, layout=LANE_LAYOUT)
            assert lane == geom


@pytest.mark.parametrize("B,K,T,want", [
    (1024, 1, 84, (8, 128, 128, 4096, 1, 84, 1, LANE_LAYOUT)),
    (16384, 1, 84, (32, 512, 512, 77792, 1, 84, 1, UNIFORM_LAYOUT)),
    (2048, 1, 112, (8, 128, 256, 4096, 1, 112, 1, LANE_LAYOUT)),
    (2048, 15, 112, (32, 512, 64, 92240, 15, 112, 1, UNIFORM_LAYOUT)),
    (4096, 1, 64, (32, 512, 128, 67472, 1, 64, 1, UNIFORM_LAYOUT))])
def test_many_row_geometry_is_unchanged_by_the_one_row_rule(B, K, T, want):
    """Launches of more than one row keep the geometry they had before
    one-row launches went to the lane layout at any B (gsm, T = 84, at the
    fuzz path's B = 1024 and at 16384; the K = 15 stack at B = 2048)."""
    geom = run_cycles_geometry(B, 16, 128, K, T)
    assert tuple(geom) == want
    assert _accepted_by_pe_run_cycles(geom, T, B, 16, 128, K)


@given(st.integers(0, 10_000))
@settings(deadline=None, max_examples=10,
          suppress_health_check=[HealthCheck.too_slow])
def test_run_program_matches_jax_property(seed):
    rng = np.random.RandomState(seed)
    f = random_fields(rng, 6, 4, 64)
    s = random_state(rng, 2, 4, 64)
    nbrs = neighbor_table(make_grid(2, 2))
    final, outs = ops.run_program(fields_from_numpy(*(f[k] for k in FIELDS),
                                                    device="cpu"),
                                  state_from_numpy(*(s[k] for k in STATE),
                                                   device="cpu"),
                                  nbrs, device="cpu")
    j_final, j_outs = jax_ops.run_program(_jax_fields(f), _jax_state(s),
                                          nbrs, backend="ref")
    np.testing.assert_array_equal(outs.numpy(), np.asarray(j_outs))
    _assert_state_equal(final, j_final)


def test_isa_op_classes_equal_the_jax_package():
    from repro.cgra import isa as jax_isa
    from repro_torch.cgra import isa

    for name in ("OPS", "OPCODE", "LOAD_OPS", "STORE_OPS", "FLAG_SELECT_OPS",
                 "MUL_OPS"):
        assert getattr(isa, name) == getattr(jax_isa, name), name
