"""The fuzz oracle's compiled table (``repro_torch.kernels.oracle``):
``compile_oracle`` + ``oracle_ref`` against the port's numpy
``batched_oracle`` and the JAX package's, bit for bit, on every shipped
kernel's corpora and on hand-built programs that reach what no shipped
kernel may (wide FXPMUL products, shift amounts past 31 and negative, SRT
of negative words, BSFA / BZFA on zero and negative flags); the address
error's text; the refusal of constants beyond 32 bits; the launch shape;
``fuzz_program``'s oracle span on the CPU; and ``oracle_verdict_ref``
against ``compare_batch`` with differences planted in the images, the
node values, both or neither.  Everything runs on the CPU with exact
equality; the kernel itself is held to ``oracle_ref``,
``oracle_verdict_ref`` and ``compare_batch`` on the card by
``tests/test_torch_cuda.py``.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch",
                            reason="optional extra: pip install .[torch]")
pytest.importorskip("jax", reason="optional extra: pip install .[jax]")

from repro.cgra import programs as jax_programs  # noqa: E402
from repro.cgra.registry import kernel_program as jax_kernel  # noqa: E402
from repro.fuzz import engine as jax_engine  # noqa: E402
from repro_torch.cgra import programs  # noqa: E402
from repro_torch.cgra.artifact import load_artifact  # noqa: E402
from repro_torch.cgra.registry import kernel_names, kernel_program  # noqa: E402
from repro_torch.fuzz import engine  # noqa: E402
from repro_torch.fuzz.corpus import make_corpus  # noqa: E402
from repro_torch.kernels import oracle as ko  # noqa: E402
from repro_torch.kernels.sample import (  # noqa: E402
    OUT_OF_RANGE, VERDICT_FAULTS, first_error_case, oracle_edge_mems,
    oracle_edges, out_of_range_program, verdict_case)
from repro_torch.obs import report  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from torch_parity import SHIPPED  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FROZEN = sorted((ROOT / "portbench" / "data").glob("*/*.json"))
INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


def _ref(program, mems):
    return ko.oracle_ref(ko.compile_oracle(program),
                         torch.as_tensor(np.asarray(mems, np.int32)))


def _assert_same(got, want, tag=""):
    (gv, gm), (wv, wm) = got, want
    assert list(gv) == list(wv), tag
    for n in wv:
        g = np.asarray(gv[n])
        assert g.dtype == np.int64, (tag, n)
        np.testing.assert_array_equal(
            g, np.broadcast_to(wv[n], g.shape), err_msg=f"{tag} node {n}")
    assert gm.dtype == np.int64
    np.testing.assert_array_equal(gm, wm, err_msg=f"{tag} memory")


@pytest.mark.parametrize("arch,kernel", SHIPPED)
def test_table_matches_both_numpy_oracles(arch, kernel):
    art = load_artifact(arch, kernel)
    corpora = [make_corpus(art, 48, seed=2),
               make_corpus(art, 20, seed=9, strategies=("overflow",)),
               make_corpus(art, 20, seed=4, strategies=("sparse",))]
    for i, mems in enumerate(corpora):
        got = _ref(art.program, mems)
        _assert_same(got, engine.batched_oracle(art.program, mems), i)
        _assert_same(got, jax_engine.batched_oracle(jax_kernel(kernel),
                                                    mems), i)


def test_hand_built_edges_match_both_numpy_oracles():
    mems = oracle_edge_mems()
    port = oracle_edges(programs.LoopBuilder)
    jax_prog = oracle_edges(jax_programs.LoopBuilder)
    got = _ref(port, mems)
    _assert_same(got, engine.batched_oracle(port, mems))
    _assert_same(got, jax_engine.batched_oracle(jax_prog, mems))
    table = ko.compile_oracle(port)
    assert {ko.FXPMUL, ko.SHL, ko.SHR_LOGICAL, ko.SHR_ARITH,
            ko.SELECT_SIGN, ko.SELECT_ZERO, ko.ZERO, ko.LOAD,
            ko.STORE} <= set(table.nodes[:, 0].tolist())
    # the wide products and the flags the program was built to reach
    x, y = mems[:, 0].astype(np.int64), mems[:, 8].astype(np.int64)
    assert (np.abs(x * y) > 1 << 47).any()
    assert ((y & 31) != y).any()               # amounts past 31 or negative
    assert ((x < 0) & (y % 32 > 0)).any()      # SRT of negative words


@pytest.mark.parametrize("trip,B", [(0, 9), (1, 9), (2, 9), (5, 0)])
def test_short_trips_and_an_empty_batch_match(trip, B):
    mems = oracle_edge_mems(B=B, seed=trip)
    port = oracle_edges(programs.LoopBuilder, trip=trip)
    _assert_same(_ref(port, mems), engine.batched_oracle(port, mems))


def test_two_carries_on_one_update_node_take_the_last_init():
    """The numpy oracle keys carries by their update node: the later
    carry's init wins for both."""
    p = programs.LoopBuilder("twins", 3)
    a, b = p.carry("a", 5), p.carry("b", 11)
    s = p.op("SADD", a, b)
    p.set_carry(a, s)
    p.set_carry(b, s)
    mems = np.zeros((2, 4), np.int32)
    table = ko.compile_oracle(p)
    assert table.carry_init.tolist() == [11]
    _assert_same(_ref(p, mems), engine.batched_oracle(p, mems))


@pytest.mark.parametrize("kind", OUT_OF_RANGE)
def test_address_error_text_matches_numpy(kind):
    M = 16
    mems = np.tile(np.arange(M, dtype=np.int32) % 8, (6, 1))
    mems[3, 2] = M + 5                         # memory 3, iteration 2
    mems[5, 1] = -1                            # memory 5, iteration 1
    p = out_of_range_program(programs.LoopBuilder, kind, M)
    with pytest.raises(IndexError) as want:
        engine.batched_oracle(p, mems)
    with pytest.raises(IndexError) as got:
        _ref(p, mems)
    assert str(got.value) == str(want.value)
    assert "address outside [0, 16)" in str(got.value)


def test_address_error_names_the_first_access_over_all_memories():
    p, mems, text = first_error_case(programs.LoopBuilder)
    table = ko.compile_oracle(p)
    with pytest.raises(IndexError) as want:
        engine.batched_oracle(p, mems)
    with pytest.raises(IndexError) as got:
        ko.oracle_ref(table, torch.as_tensor(mems))
    assert str(got.value) == str(want.value) == text
    code = 1 * len(table.node_ids) + table.node_ids.index(5)
    assert str(table.address_error(code, mems.shape[1])) == text


@pytest.mark.parametrize("where", ["constant", "immediate", "carry_init",
                                   "negative_constant"])
def test_values_beyond_32_bits_are_refused(where):
    p = programs.LoopBuilder("wide", 2)
    c = p.carry("c", (1 << 31) if where == "carry_init" else 0)
    if where == "constant":
        v = p.op("SADD", c, 1 << 32)
    elif where == "negative_constant":
        v = p.op("SSUB", c, -(1 << 31) - 1)
    elif where == "immediate":
        v = p.op("SADD", c, None, imm=(1 << 31))
    else:
        v = p.op("SADD", c, 1)
    p.set_carry(c, v)
    with pytest.raises(ValueError, match="does not fit in signed 32 bits"):
        ko.compile_oracle(p)


def test_the_32_bit_edges_are_taken():
    p = programs.LoopBuilder("edge", 2)
    c = p.carry("c", INT32_MIN)
    p.set_carry(c, p.op("SADD", c, INT32_MAX, imm=INT32_MIN))
    table = ko.compile_oracle(p)
    mems = np.zeros((3, 4), np.int32)
    _assert_same(ko.oracle_ref(table, torch.as_tensor(mems)),
                 engine.batched_oracle(p, mems))


def test_programs_the_table_cannot_hold_are_refused():
    p = programs.LoopBuilder("no_alu", 1)
    p.op("FOO")
    with pytest.raises(ValueError, match="no ALU semantics for FOO"):
        ko.compile_oracle(p)
    q = programs.LoopBuilder("no_flag", 1)
    q.op("BSFA", 1, 2)
    with pytest.raises(ValueError, match="no flag producer"):
        ko.compile_oracle(q)
    r = programs.LoopBuilder("unset", 1)
    r.carry("c", 0)
    r.op("SADD", 1, 2)
    with pytest.raises(ValueError, match="carry c never set"):
        ko.compile_oracle(r)


def _magnitudes(table):
    kinds = table.nodes[:, [1, 3]]
    args = table.nodes[:, [2, 4]][kinds == ko.INT]
    return np.abs(np.concatenate([args, table.nodes[:, 5],
                                  table.carry_init]).astype(np.int64))


@pytest.mark.parametrize("name", sorted(kernel_names()))
def test_every_registry_program_compiles(name):
    program = kernel_program(name)
    table = ko.compile_oracle(program)
    assert table.node_ids == tuple(program.build_dfg().topo_order())
    assert table.nodes.dtype == np.int32 and table.trip == program.trip
    assert _magnitudes(table).max() <= INT32_MAX


@pytest.mark.parametrize("path", FROZEN, ids=lambda p: f"{p.parent.name}/"
                         f"{p.stem}")
def test_every_frozen_benchmark_program_compiles(path):
    program = programs.LoopBuilder.from_dict(
        json.loads(path.read_text())["program"])
    table = ko.compile_oracle(program)
    assert list(table.node_ids) == json.loads(
        path.read_text())["program"]["topo_order"]
    assert _magnitudes(table).max() <= INT32_MAX


def test_artifact_keeps_one_table():
    art = load_artifact("4x4", "gsm")
    assert art.oracle_table is art.oracle_table
    assert art.oracle_table.node_ids == tuple(
        art.program.build_dfg().topo_order())


@pytest.mark.parametrize("N,C,M,threads,image", [
    (13, 2, 128, 32, 1), (304, 8, 128, 32, 1), (8, 3, 1024, 32, 1),
    (8, 3, 1800, 32, 0), (8, 3, 65536, 32, 0), (1, 0, 1, 32, 1)])
def test_launch_shape(N, C, M, threads, image):
    T, shared, img = ko.oracle_geometry(N, C, M)
    assert (T, img) == (threads, image)
    assert shared == 4 * (ko.RECORD * N + 2 * C + (N + C) * T
                          + (M * (T + 1) if img else 0))
    assert shared <= ko.MAX_SHARED_BYTES


def test_launch_shape_refuses_what_no_block_holds():
    with pytest.raises(ValueError, match="227 KB"):
        ko.oracle_geometry(2000, 0, 16)


def test_oracle_refuses_a_cpu_tensor():
    """The kernel's wrapper has no fallback: the CPU takes
    ``oracle_verdict_ref``, ``oracle_ref`` (here equal to the numpy
    oracle) or ``batched_oracle``."""
    art = load_artifact("4x4", "gsm")
    mems = make_corpus(art, 10, seed=3)
    before = ko.oracle_verdict.launches
    cpu = torch.as_tensor(mems)
    with pytest.raises(ValueError, match="oracle_verdict_ref"):
        ko.oracle_verdict(art.oracle_table, cpu, cpu,
                          torch.zeros((0, 10), dtype=torch.int32), [])
    assert ko.oracle_verdict.launches == before
    _assert_same(ko.oracle_ref(art.oracle_table, torch.as_tensor(mems)),
                 engine.batched_oracle(art.program, mems))


def test_table_goes_to_a_device_once():
    table = load_artifact("4x4", "gsm").oracle_table
    cpu = torch.device("cpu")
    first = table.on_device(cpu)
    assert table.on_device(cpu) is first
    assert first.dtype == torch.int32
    np.testing.assert_array_equal(first.numpy(), table.packed())


def test_fuzz_program_oracle_span_names_its_backend(tmp_path):
    art = load_artifact("4x4", "gsm")
    mems = make_corpus(art, 32, seed=1)
    obs_trace.enable(str(tmp_path / "trace"))
    try:
        rep = engine.fuzz_program(art, mems, batch=16, device="cpu")
    finally:
        obs_trace.disable()
    assert rep.status == "ok"
    spans = [r for r in report.load(str(tmp_path / "trace"))
             if r["k"] == "span" and r["name"] == "fuzz.oracle"]
    assert [s["attrs"] for s in spans] == [{"backend": "numpy"}] * 2


def _verdict_operands(table, vals):
    """(nodes, slots, (K, B) tensor) of a simulator's {nid: (B,)}."""
    nodes = [n for n in vals if n in table.node_ids]
    slots = [table.node_ids.index(n) for n in nodes]
    sim = (np.stack([vals[n] for n in nodes]) if nodes
           else np.zeros((0, len(next(iter(vals.values()), []))), np.int32))
    return nodes, slots, torch.as_tensor(sim)


def _edge_rows(B, M):
    """Rows at the edges of a block of 32 and of ``compare_batch``'s row
    blocks, and the middle one."""
    rows = max(1, engine.COMPARE_WORDS // M)
    return {0, 31, 32, rows - 1, rows, 2 * rows, B // 2, B - 1}


@pytest.mark.parametrize("fault", VERDICT_FAULTS)
@pytest.mark.parametrize("B,M", [(1000, 32), (1025, 128), (2100, 128),
                                 (5, 200_000)])
def test_verdict_ref_matches_compare_batch(fault, B, M):
    """Differences at the edges of 32-row blocks and of ``compare_batch``'s
    1 MB row blocks; B = 1000 is no multiple of 32; at M = 200,000 every
    row is a block of its own."""
    program = oracle_edges(programs.LoopBuilder)
    table = ko.compile_oracle(program)
    mems = oracle_edge_mems(B, M, seed=B + M)
    ov, om = engine.batched_oracle(program, mems)
    vals, sim_mem = verdict_case(ov, om, fault, _edge_rows(B, M))
    nodes, slots, sim = _verdict_operands(table, vals)
    got = ko.oracle_verdict_ref(table, torch.as_tensor(mems),
                                torch.as_tensor(sim_mem), sim, slots)
    want = engine.compare_batch(vals, sim_mem, ov, om)
    np.testing.assert_array_equal(got.bad, want)
    assert got.bad.any() == (fault != "neither")
    assert got.bad.dtype == bool and got.bad.shape == (B,)
    np.testing.assert_array_equal(got.image.numpy(), om)
    for n, slot in zip(nodes, slots):
        np.testing.assert_array_equal(got.vals[slot].numpy(), ov[n])


@pytest.mark.parametrize("fault", VERDICT_FAULTS)
def test_verdict_ref_compares_only_the_image_at_trip_0(fault):
    """At trip 0 the oracle has no node values: the simulator's are not
    compared, as ``compare_batch`` skips a node the oracle lacks."""
    program = oracle_edges(programs.LoopBuilder, trip=0)
    table = ko.compile_oracle(program)
    mems = oracle_edge_mems(70, 32, seed=3)
    ov, om = engine.batched_oracle(program, mems)
    assert ov == {}
    sim_vals = {n: np.full(70, 7, np.int32) for n in table.node_ids[:3]}
    _, sim_mem = verdict_case({}, om, fault, range(0, 70, 9))
    sim = torch.as_tensor(np.stack(list(sim_vals.values())))
    got = ko.oracle_verdict_ref(table, torch.as_tensor(mems),
                                torch.as_tensor(sim_mem), sim, [0, 1, 2])
    want = engine.compare_batch(sim_vals, sim_mem, ov, om)
    np.testing.assert_array_equal(got.bad, want)
    assert got.bad.any() == (fault in ("image", "both"))


@pytest.mark.parametrize("arch,kernel", [("4x4", "gsm"), ("4x4", "fir4"),
                                         ("3x3", "sqrt")])
def test_verdict_ref_on_shipped_kernels(arch, kernel):
    art = load_artifact(arch, kernel)
    table = art.oracle_table
    mems = make_corpus(art, 100, seed=5)
    ov, om = engine.batched_oracle(art.program, mems)
    for fault in VERDICT_FAULTS:
        vals, sim_mem = verdict_case(ov, om, fault, range(0, 100, 7))
        _, slots, sim = _verdict_operands(table, vals)
        got = ko.oracle_verdict_ref(table, torch.as_tensor(mems),
                                    torch.as_tensor(sim_mem), sim, slots)
        np.testing.assert_array_equal(
            got.bad, engine.compare_batch(vals, sim_mem, ov, om), fault)


def test_verdict_ref_raises_the_address_error():
    p, mems, text = first_error_case(programs.LoopBuilder)
    table = ko.compile_oracle(p)
    with pytest.raises(IndexError) as got:
        ko.oracle_verdict_ref(table, torch.as_tensor(mems),
                              torch.as_tensor(mems),
                              torch.zeros((0, 6), dtype=torch.int32), [])
    assert str(got.value) == text


def test_verdict_operands_are_checked():
    table = load_artifact("4x4", "gsm").oracle_table
    mems = torch.zeros((4, 128), dtype=torch.int32)
    vals = torch.zeros((2, 4), dtype=torch.int32)
    N = len(table.node_ids)
    with pytest.raises(ValueError, match="slot outside"):
        ko.oracle_verdict_ref(table, mems, mems, vals, [0, N])
    with pytest.raises(ValueError, match=r"expected \(1, B\)"):
        ko.oracle_verdict_ref(table, mems, mems, vals, [0])
    before = ko.oracle_verdict.launches
    with pytest.raises(ValueError, match="oracle_verdict_ref"):
        ko.oracle_verdict(table, mems, mems, vals, [0, 1])
    assert ko.oracle_verdict.launches == before
