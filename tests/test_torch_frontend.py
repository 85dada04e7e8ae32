"""The port's traced front-end (``repro_torch.frontend``) against the JAX
package's (``repro.frontend``): the same loop bodies go through both, and
the traces, the legalized programs (``LoopBuilder.to_dict()``), the input
memories, the references, the errors and the co-simulation reports must be
equal.  Mirrors the unit tests of ``tests/test_frontend.py``; everything
runs on the CPU (the port with ``device="cpu"``, the JAX package on its
``ref`` backend).  Tolerance: exact, every value is int32.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch",
                            reason="optional extra: pip install .[torch]")

import repro.frontend as J  # noqa: E402
from repro.core.mapper import MapperConfig as JaxConfig  # noqa: E402
from repro.frontend import ir as jax_ir  # noqa: E402
from repro.frontend.tracer import batched_reference as jax_batched  # noqa: E402
from repro.frontend.verify import main as jax_cosim_main  # noqa: E402
from repro.toolchain.cli import main as jax_cli  # noqa: E402
import repro_torch.frontend as T  # noqa: E402
from repro_torch.cgra import registry  # noqa: E402
from repro_torch.core.mapper import MapperConfig  # noqa: E402
from repro_torch.frontend import ir as port_ir  # noqa: E402
from repro_torch.frontend.tracer import batched_reference  # noqa: E402
from repro_torch.frontend.verify import main as cosim_main  # noqa: E402
from repro_torch.toolchain.cli import list_main  # noqa: E402
from test_torch_artifacts import builder_dict  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MASK = (1 << 32) - 1
ALL_TRACED = sorted(J.TRACED_KERNELS)
#: the mapping budget of ``tests/test_frontend.py``, CDCL on both sides
CFG = dict(backend="cdcl", per_ii_timeout_s=60, total_timeout_s=90,
           ii_max=32)


def spec_of(F, name="t", trip=4, carries=None, **kw):
    return F.LoopSpec(name=name, trip=trip,
                      carries=carries or {"i": 0, "x": 7}, **kw)


def trace_form(tr):
    """A ``Trace`` of either package as plain values."""
    return (tr.name, tr.trip,
            [(n.id, n.op, n.args, n.value) for n in tr.nodes],
            [(c.name, c.init, c.leaf, c.update) for c in tr.carries],
            list(tr.stores), dict(tr.results))


def same_front_end(make_body, mem=None, **spec_kw):
    """Trace and legalize ``make_body(F)`` through both front-ends and hold
    the trace and the program equal; with ``mem``, also the concrete
    references, and the port's program oracle against its reference.
    Returns the port's (trace, program)."""
    out = []
    for F in (J, T):
        spec = spec_of(F, **spec_kw)
        body = make_body(F)
        tr = F.trace_kernel(spec, body)
        ref = None if mem is None else F.python_reference(spec, body, mem)
        out.append((tr, F.legalize(tr, spec), ref))
    (jtr, jprog, jref), (tr, prog, ref) = out
    assert trace_form(tr) == trace_form(jtr)
    assert prog.to_dict() == builder_dict(jprog)
    if mem is not None:
        assert ref == jref
        oracle_mem = [int(v) for v in mem]
        got = prog.run_oracle(oracle_mem)
        for k, exp in ref[0].items():
            assert (got[k] & MASK) == (exp & MASK), k
        assert [v & MASK for v in oracle_mem] == [v & MASK for v in ref[1]]
    return tr, prog


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------


def test_trace_records_ssa_and_carry_updates():
    def make(F):
        def body(s, mem):
            s.x = s.x + mem[s.i] * 3
            s.i = s.i + 1
        return body

    tr, _ = same_front_end(make, mem=np.arange(16, dtype=np.int32))
    ops = tr.op_histogram()
    assert ops.get("load") == 1 and ops.get("mul") == 1
    assert ops.get("add") == 2 and ops.get("carry") == 2
    by_name = {c.name: c for c in tr.carries}
    assert by_name["x"].update is not None
    assert by_name["i"].update != by_name["i"].leaf


def test_read_after_write_sees_new_value():
    def make(F):
        def body(s, mem):
            s.x = s.x + 1
            s.i = s.x * 2
        return body

    same_front_end(make, mem=np.zeros(16, np.int32),
                   carries={"i": 0, "x": 10}, trip=1)
    spec = spec_of(T, carries={"i": 0, "x": 10}, trip=1)
    vals, _ = T.python_reference(spec, make(T), np.zeros(16, np.int32))
    assert vals["x"] == 11 and vals["i"] == 22


def test_constant_folding_and_cse():
    def make(F):
        def body(s, mem):
            a = mem[s.i] + mem[s.i]
            b = s.x * 1
            c = b & -1
            s.x = a + c
            s.i = s.i + 1
        return body

    tr, _ = same_front_end(make, mem=np.arange(16, dtype=np.int32))
    ops = tr.op_histogram()
    assert ops.get("load", 0) == 1
    assert "mul" not in ops and "and" not in ops
    assert ops.get("add") == 3


def _branchy(F):
    def body(s, mem):
        if s.x > 0:  # noqa: data-dependent branch must raise
            s.x = s.x - 1
    return body


def _floaty(F):
    def body(s, mem):
        s.x = s.x + 1.5
    return body


def _divides(F):
    def body(s, mem):
        s.x = s.x / 2
    return body


def _undeclared(F):
    def body(s, mem):
        s.y = 1
    return body


def _cond_as_data(F):
    def body(s, mem):
        s.x = (s.x < 3) + 1
    return body


def _where_on_data(F):
    def body(s, mem):
        s.x = F.where(s.x, 1, 0)
    return body


def _index_with_traced(F):
    def body(s, mem):
        s.x = [1, 2, 3][s.i]
    return body


def _mixed_sessions(F):
    other = F.tracer.SymValue(F.tracer.GraphSession(), 0)

    def body(s, mem):
        s.x = s.x + other
    return body


@pytest.mark.parametrize("make,match", [
    (_branchy, "control flow"), (_floaty, "integers"),
    (_divides, "divider"), (_undeclared, "undeclared carry"),
    (_cond_as_data, "comparison"), (_where_on_data, "comparison"),
    (_index_with_traced, "index"), (_mixed_sessions, "sessions")],
    ids=["branch", "float", "divide", "undeclared", "cond-as-data",
         "where-on-data", "index", "sessions"])
def test_untraceable_constructs_raise_the_same_error(make, match):
    errors = []
    for F in (J, T):
        with pytest.raises(F.TraceError, match=match) as err:
            F.trace_kernel(spec_of(F), make(F))
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_reference_rejects_out_of_range_addresses_alike():
    def make(F):
        def body(s, mem):
            s.x = mem[s.i + 14]
            s.i = s.i + 1
        return body

    errors = []
    for F in (J, T):
        spec = spec_of(F)
        for run in (F.python_reference, F.tracer.batched_reference):
            with pytest.raises(F.TraceError, match="outside") as err:
                run(spec, make(F), np.zeros((16,), np.int32))
            errors.append(str(err.value))
    assert errors[:2] == errors[2:]


# ---------------------------------------------------------------------------
# legalizer
# ---------------------------------------------------------------------------


def test_immediates_fold_into_the_consumer():
    def make(F):
        def body(s, mem):
            s.x = s.x + 5
            s.i = s.i + 1
        return body

    _, prog = same_front_end(make, mem=np.zeros(16, np.int32))
    adds = [n for n in prog.nodes if n.op == "SADD"]
    assert any(prog.node_imm[n.id] == 5 for n in adds)
    assert not any(c.name.startswith("_const_") for c in prog.carries)


def test_wide_constants_materialize_as_const_carries():
    def make(F):
        def body(s, mem):
            s.x = (s.x & 0x55555555) ^ 0x33333333
            s.i = s.i + 1
        return body

    _, prog = same_front_end(make, mem=np.zeros(16, np.int32),
                             carries={"i": 0, "x": -123456789})
    consts = [c for c in prog.carries if c.name.startswith("_const_")]
    assert sorted(c.init for c in consts) == [0x33333333, 0x55555555]


@pytest.mark.parametrize("cmp_name", ["lt", "le", "gt", "ge", "eq", "ne"])
def test_select_lowering_every_comparison(cmp_name):
    cmp_fn = {
        "lt": lambda a, b: a < b, "le": lambda a, b: a <= b,
        "gt": lambda a, b: a > b, "ge": lambda a, b: a >= b,
        "eq": lambda a, b: a == b, "ne": lambda a, b: a != b,
    }[cmp_name]

    def make(F):
        def body(s, mem):
            a = mem[s.i]
            b = mem[s.i + 8]
            s.x = F.where(cmp_fn(a, b), a - b, b - a)
            s.i = s.i + 1
        return body

    rng = np.random.RandomState(3)
    mem = np.zeros(32, np.int32)
    mem[:16] = rng.randint(-100, 100, 16)
    mem[4] = mem[12]
    _, prog = same_front_end(make, mem=mem, trip=8)
    assert any(n.op in ("BSFA", "BZFA") for n in prog.nodes)


def test_flag_producer_duplicated_per_select():
    def make(F):
        def body(s, mem):
            c = s.x > 0
            s.x = F.where(c, s.x - 1, s.x)
            s.i = F.where(c, s.i + 1, s.i)
        return body

    _, prog = same_front_end(make, mem=np.zeros(16, np.int32),
                             carries={"i": 0, "x": 5})
    flags = [e for e in prog.build_dfg().edges if e.kind == "flag"]
    assert len(flags) == 2 and len({e.src for e in flags}) == 2


def test_neg_invert_and_logical_shift():
    def make(F):
        def body(s, mem):
            v = mem[s.i]
            s.x = (-v ^ ~v) + v.lshr(3)
            s.i = s.i + 1
        return body

    rng = np.random.RandomState(11)
    mem = np.zeros(32, np.int32)
    mem[:8] = rng.randint(-(2**30), 2**30, 8)
    same_front_end(make, mem=mem, trip=8)


def test_const_address_load_and_store():
    def make(F):
        def body(s, mem):
            s.x = s.x + mem[5]
            mem[40] = s.x
            mem[41] = 0
            s.i = s.i + 1
        return body

    mem = np.zeros(64, np.int32)
    mem[5] = 1234
    _, prog = same_front_end(make, mem=mem)
    lwis = [n for n in prog.nodes if n.op == "LWI"]
    assert len(lwis) == 1
    assert prog.node_srcs[lwis[0].id][0] is None
    assert prog.node_imm[lwis[0].id] == 5


def test_wide_and_computed_addresses():
    """The other address forms: a wide constant (LWD/SWD through a
    materialized carry), ``k + base``, ``base - k`` and a computed base."""

    def make(F):
        def body(s, mem):
            s.x = mem[70000] + mem[3 + s.i] + mem[s.i - 1] + mem[s.x & 7]
            mem[70001] = s.x
            mem[s.i * 2] = 40000
            s.i = s.i + 1
        return body

    _, prog = same_front_end(make, carries={"i": 1, "x": 7})
    ops = [n.op for n in prog.nodes]
    assert "LWD" in ops and "SWD" in ops and "LWI" in ops


def test_loop_control_appends_exit_branch():
    def make(F):
        def body(s, mem):
            s.x = s.x + 1
            s.i = s.i + 1
        return body

    _, prog = same_front_end(make, mem=np.zeros(16, np.int32), trip=6,
                             index="i", loop_control=True)
    bne = next(n for n in prog.nodes if n.op == "BNE")
    assert prog.node_imm[bne.id] == 6
    assert "JUMP" in [n.op for n in prog.nodes]


def test_loop_invariant_carry_becomes_constant():
    def make(F):
        def body(s, mem):
            s.acc = s.acc + s.k
            s.i = s.i + 1
        return body

    _, prog = same_front_end(make, mem=np.zeros(8, np.int32),
                             carries={"i": 0, "acc": 0, "k": 0x12345678},
                             results=("acc",))
    dfg = prog.build_dfg()
    mov_ids = {n.id for n in prog.nodes if n.op == "MOV"}
    self_loops = {e.src for e in dfg.edges
                  if e.src == e.dst and e.distance == 1}
    assert mov_ids & self_loops


def test_shared_update_and_constant_updates_split():
    """Two carries updated by one node get a MOV each; constant updates
    (narrow and wide) become LOR-immediate and MOV-of-constant nodes."""

    def make(F):
        def body(s, mem):
            v = s.x + s.i
            s.x = v
            s.i = v
            s.a = 3
            s.b = 0x12345678
        return body

    same_front_end(make, mem=np.zeros(8, np.int32),
                   carries={"i": 0, "x": 1, "a": 0, "b": 0})


def _trace(F, nodes, carries, results):
    ir = F.ir
    return ir.Trace(name="hand", trip=4,
                    nodes=[ir.TNode(i, op, args, value)
                           for i, (op, args, value) in enumerate(nodes)],
                    carries=[ir.CarryDef(*c) for c in carries],
                    results=results)


#: hand-built traces the tracer cannot produce, each one a LegalizeError
BAD_TRACES = {
    "cmp-as-data": ([("carry", (), None), ("const", (), 1),
                     ("lt", (0, 1), None), ("add", (2, 1), None)],
                    [("x", 0, 0, 3)]),
    "unknown-op": ([("carry", (), None), ("div", (0, 0), None)],
                   [("x", 0, 0, 1)]),
    "select-on-data": ([("carry", (), None), ("const", (), 1),
                        ("select", (0, 1, 0), None)], [("x", 0, 0, 2)]),
}


@pytest.mark.parametrize("case", ["cmp-as-data", "unknown-op",
                                  "select-on-data", "no-index",
                                  "long-trip"])
def test_legalize_errors_match(case):
    errors = []
    for F in (J, T):
        if case in BAD_TRACES:
            nodes, carries = BAD_TRACES[case]
            run = (lambda F=F: F.legalize(_trace(F, nodes, carries, {})))
        else:
            spec = spec_of(F, loop_control=True,
                           index=None if case == "no-index" else "i",
                           trip=4 if case == "no-index" else 40000)

            def body(s, mem):
                s.i = s.i + 1

            run = (lambda F=F, spec=spec, body=body:
                   F.legalize(F.trace_kernel(spec, body), spec))
        with pytest.raises(F.LegalizeError) as err:
            run()
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert issubclass(T.LegalizeError, T.TraceError)


def test_ir_semantics_match():
    rng = np.random.RandomState(5)
    vals = [0, 1, -1, 31, 32, 2**31 - 1, -(2**31), 65536, -65537] + [
        int(v) for v in rng.randint(-(2**31), 2**31, 40, dtype=np.int64)]
    for a in vals:
        assert port_ir.s32(a) == jax_ir.s32(a)
        for b in vals[:20]:
            for op in port_ir.BIN_OPS:
                assert port_ir.eval_binop(op, a, b) == \
                    jax_ir.eval_binop(op, a, b), (op, a, b)
            for op in port_ir.CMP_OPS:
                assert port_ir.eval_cmp(op, a, b) == \
                    jax_ir.eval_cmp(op, a, b), (op, a, b)
    for F in (jax_ir, port_ir):
        with pytest.raises(ValueError, match="unknown"):
            F.eval_binop("div", 1, 1)


# ---------------------------------------------------------------------------
# the 11 shipped traced kernels
# ---------------------------------------------------------------------------


def test_traced_kernels_register_in_the_jax_order():
    assert list(T.TRACED_KERNELS) == list(J.TRACED_KERNELS)
    assert registry.kernel_names("traced") == list(J.TRACED_KERNELS)
    for name, tk in T.TRACED_KERNELS.items():
        spec = registry.get_kernel(name)
        assert spec.origin == "traced" and spec.tags == ("frontend",)
        assert T.TracedKernel is type(tk)


@pytest.mark.parametrize("name", ALL_TRACED)
def test_traced_kernel_program_and_inputs_match_jax(name):
    jtk, tk = J.TRACED_KERNELS[name], T.TRACED_KERNELS[name]
    assert trace_form(tk.trace()) == trace_form(jtk.trace())
    want = builder_dict(jtk.build())
    assert tk.build().to_dict() == want
    assert registry.kernel_program(name).to_dict() == want
    assert ([tuple(vars(r).values()) for r in tk.spec.mem_regions]
            == [tuple(vars(r).values()) for r in jtk.spec.mem_regions])
    for seed in (0, 1, 7):
        assert tk.make_mem(seed).tobytes() == jtk.make_mem(seed).tobytes()
        assert (registry.make_mem(name, seed).tobytes()
                == jtk.make_mem(seed).tobytes())


@pytest.mark.parametrize("name", ALL_TRACED)
def test_traced_kernel_references_match_jax(name):
    jtk, tk = J.TRACED_KERNELS[name], T.TRACED_KERNELS[name]
    prog = tk.build()
    mems = np.stack([tk.make_mem(seed) for seed in range(16)])
    for mem in mems:
        ref = tk.reference([int(v) for v in mem])
        assert ref == jtk.reference([int(v) for v in mem])
        oracle_mem = [int(v) for v in mem]
        got = prog.run_oracle(oracle_mem)
        for k, exp in ref[0].items():
            assert (got[k] & MASK) == (exp & MASK), k
        assert [v & MASK for v in oracle_mem] == [v & MASK for v in ref[1]]
    vals, final = batched_reference(tk.spec, tk.body, mems)
    jvals, jfinal = jax_batched(jtk.spec, jtk.body, mems)
    assert vals.keys() == jvals.keys()
    for k in vals:
        assert np.array_equal(vals[k], jvals[k])
    assert np.array_equal(final, jfinal)


# ---------------------------------------------------------------------------
# co-simulation
# ---------------------------------------------------------------------------


def report_doc(rep) -> dict:
    """A ``CoSimReport`` as a dict without its one timing field."""
    doc = rep.to_dict()
    doc.pop("map_time_s")
    return doc


@pytest.mark.parametrize("name", ["dotprod", "xorshift32", "saxpy"])
def test_cosimulate_matches_jax(name):
    jrep = J.cosimulate(J.TRACED_KERNELS[name], seeds=16,
                        config=JaxConfig(**CFG), backend="ref")
    rep = T.cosimulate(T.TRACED_KERNELS[name], seeds=16,
                       config=MapperConfig(**CFG), device="cpu")
    assert report_doc(rep) == report_doc(jrep)
    assert rep.status == "ok" and rep.seeds == 16 and rep.ii <= rep.ii_bound


def _wide_fxpmul(F):
    """A body whose FXPMUL operands overflow int32: the PE array wraps the
    product where the reference keeps it exact."""
    spec = F.LoopSpec(
        name="fxp_wide", trip=8, carries={"i": 0, "acc": 0},
        results=("acc",),
        mem_regions=(F.MemRegion(0, 8, -(2**20), 2**20),
                     F.MemRegion(32, 8, -(2**20), 2**20)))

    def body(s, mem):
        s.acc = s.acc + F.fxpmul(mem[s.i], mem[s.i + 32])
        mem[s.i + 64] = s.acc
        s.i = s.i + 1

    return F.TracedKernel(spec, body)


def test_cosimulate_mismatch_strings_match_jax():
    jrep = J.cosimulate(_wide_fxpmul(J), seeds=4, config=JaxConfig(**CFG),
                        backend="ref")
    rep = T.cosimulate(_wide_fxpmul(T), seeds=4,
                       config=MapperConfig(**CFG), device="cpu")
    assert rep.status == "mismatch" and rep.mismatches
    assert any("mem[" in m for m in rep.mismatches)
    assert report_doc(rep) == report_doc(jrep)


def test_run_all_map_only_matches_jax():
    docs = [F.run_all(kernels=["dotprod", "xorshift32"], execute=False,
                      config=C(**CFG))
            for F, C in ((J, JaxConfig), (T, MapperConfig))]
    for doc in docs:
        doc.pop("wall_time_s")
        for rep in doc["kernels"]:
            rep.pop("map_time_s")
    assert docs[0] == docs[1]
    assert [r["status"] for r in docs[1]["kernels"]] == ["mapped", "mapped"]
    with pytest.raises(KeyError, match="unknown traced kernels"):
        T.run_all(kernels=["gsm"], execute=False)


def test_cosim_verb_writes_the_jax_document(tmp_path):
    args = ["--kernels", "dotprod", "--seeds", "4"]
    assert jax_cosim_main(args + ["--out", str(tmp_path / "j.json")]) == 0
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "cosim", "--device", "cpu",
         *args, "--out", str(tmp_path / "c.json")],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    assert "1/1 ok, 0 failed" in proc.stdout
    docs = [json.loads((tmp_path / f).read_text())
            for f in ("j.json", "c.json")]
    for doc in docs:
        doc.pop("wall_time_s")
        doc["kernels"][0].pop("map_time_s")
    assert docs[0] == docs[1]


def test_cosim_asks_for_the_card_and_raises_without_one(monkeypatch,
                                                        tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.cosimulate(T.TRACED_KERNELS["dotprod"], seeds=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cosim_main(["--kernels", "dotprod", "--seeds", "2",
                    "--out", str(tmp_path / "c.json")])
    assert not (tmp_path / "c.json").exists()


def test_toolchain_takes_a_traced_kernel():
    from repro_torch.toolchain import StageError, Toolchain

    tc = Toolchain("4x4", MapperConfig(**CFG))
    prog = tc.program(T.TRACED_KERNELS["sad"])
    assert (prog.name, prog.origin) == ("sad", "traced")
    assert prog.builder.to_dict() == builder_dict(J.TRACED_KERNELS["sad"]
                                                  .build())
    assert prog.make_mem(3).tobytes() == J.make_mem(
        J.TRACED_KERNELS["sad"].spec, 3).tobytes()
    with pytest.raises(StageError, match="TracedKernel"):
        tc.program(3.5)


# ---------------------------------------------------------------------------
# the list verb
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("origin", [None, "handwritten", "traced"])
def test_list_verb_matches_jax(origin, capsys):
    args = [] if origin is None else ["--origin", origin]
    assert jax_cli(["list", *args]) == 0
    want = capsys.readouterr().out
    assert list_main(args) == 0
    assert capsys.readouterr().out == want


def test_list_verb_runs_from_the_command_line(capsys):
    assert jax_cli(["list"]) == 0
    want = capsys.readouterr().out
    proc = subprocess.run([sys.executable, "-m", "repro_torch", "list"],
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == want
