"""Property parity: random loop bodies through both front-ends.

The random-body generator of ``tests/test_frontend_property.py`` feeds the
JAX package's front-end as it is, and a copy of its body builder that takes
the front-end module feeds the port's (``where`` and ``fxpmul`` are module
functions, so each front-end needs its own).  The traces, the legalized
programs, the input memories and both references must be equal, and the
port's program oracle must agree with its reference.  The three fixed
``PIPELINE_CASES`` run the whole pipeline on the CPU (map on a 3x3 CGRA,
execute, compare) in both packages, with equal reports.

``derandomize=True`` and a fixed ``max_examples`` keep the test count and
the inputs the same from one run to the next.  Tolerance: exact.
"""
import numpy as np
import pytest

pytest.importorskip("torch", reason="optional extra: pip install .[torch]")
pytest.importorskip("hypothesis", reason="optional extra: pip install .[test]")

from hypothesis import HealthCheck, given, settings  # noqa: E402

import repro.frontend as J  # noqa: E402
from repro.core.mapper import MapperConfig as JaxConfig  # noqa: E402
import repro_torch.frontend as T  # noqa: E402
from repro_torch.core.mapper import MapperConfig  # noqa: E402
from test_frontend_property import (PIPELINE_CASES,  # noqa: E402
                                    make_body as jax_make_body,
                                    make_spec as jax_make_spec,
                                    program_strategy)
from test_torch_artifacts import builder_dict  # noqa: E402
from test_torch_frontend import report_doc, trace_form  # noqa: E402

MASK = (1 << 32) - 1
#: the pipeline budget of ``tests/test_frontend_property.py``, CDCL on
#: both sides
PIPELINE_CFG = dict(backend="cdcl", per_ii_timeout_s=30,
                    total_timeout_s=60, ii_max=32)


def make_body(descr, F):
    """``make_body`` of ``tests/test_frontend_property.py`` over the
    front-end module ``F``."""

    def body(s, mem):
        pool = [s.a, s.b, s.i, mem[s.i]]
        for op, i1, i2, k in descr:
            x = pool[i1 % len(pool)]
            y = pool[i2 % len(pool)]
            if op == "add":
                v = x + y
            elif op == "sub":
                v = x - y
            elif op == "mul":
                v = x * y
            elif op == "and":
                v = x & y
            elif op == "or":
                v = x | y
            elif op == "xor":
                v = x ^ y
            elif op == "shl_imm":
                v = x << (k % 8)
            elif op == "lshr_imm":
                v = x.lshr(k % 16)
            elif op == "ashr_imm":
                v = x >> (k % 16)
            elif op == "add_imm":
                v = x + k
            elif op == "xor_imm":
                v = x ^ k
            elif op == "select_lt":
                v = F.where(x < y, x, y)
            elif op == "select_eq":
                v = F.where(x == y, x + 1, y)
            elif op == "load":
                v = mem[s.i + (k % 32)]
            elif op == "neg":
                v = -x
            elif op == "inv":
                v = ~x
            elif op == "fxpmul":
                v = F.fxpmul(x, y)
            elif op == "min_like":
                v = F.where(x < k, x, k)
            else:  # abs_like
                v = F.where(x < 0, -x, x)
            pool.append(v)
        s.a = pool[-1]
        s.b = pool[-2] if len(pool) >= 2 else s.b
        mem[s.i + 64] = pool[-1]
        s.i = s.i + 1

    return body


def make_spec(init_a, init_b, name="prop"):
    """``make_spec`` of ``tests/test_frontend_property.py`` on the port."""
    return T.LoopSpec(
        name=name, trip=4, carries={"i": 0, "a": init_a, "b": init_b},
        results=("a", "b"),
        mem_regions=(T.MemRegion(0, 48, -(2**28), 2**28),))


def both(descr, init_a, init_b, name="prop"):
    """((JAX spec, body), (port spec, body)) of one descriptor."""
    return ((jax_make_spec(init_a, init_b, name=name), jax_make_body(descr)),
            (make_spec(init_a, init_b, name=name), make_body(descr, T)))


@settings(max_examples=200, derandomize=True, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(program_strategy)
def test_random_bodies_give_equal_programs_and_references(program):
    descr, init_a, init_b = program
    (jspec, jbody), (spec, body) = both(descr, init_a, init_b)
    jtr, tr = J.trace_kernel(jspec, jbody), T.trace_kernel(spec, body)
    assert trace_form(tr) == trace_form(jtr), descr
    prog = T.legalize(tr, spec)
    assert prog.to_dict() == builder_dict(J.legalize(jtr, jspec)), descr
    mems = np.stack([T.make_mem(spec, seed) for seed in range(3)])
    assert mems.tobytes() == np.stack(
        [J.make_mem(jspec, seed) for seed in range(3)]).tobytes()
    for mem in mems:
        ref = T.python_reference(spec, body, mem)
        assert ref == J.python_reference(jspec, jbody, mem), descr
        oracle_mem = [int(v) for v in mem]
        got = prog.run_oracle(oracle_mem)
        for k, exp in ref[0].items():
            assert (got[k] & MASK) == (exp & MASK), (descr, k)
        assert [v & MASK for v in oracle_mem] == [v & MASK for v in ref[1]]
    vals, final = T.tracer.batched_reference(spec, body, mems)
    jvals, jfinal = J.tracer.batched_reference(jspec, jbody, mems)
    assert vals.keys() == jvals.keys()
    for k in jvals:
        assert np.array_equal(vals[k], jvals[k]), (descr, k)
    assert np.array_equal(final, jfinal), descr


@pytest.mark.parametrize("case", range(len(PIPELINE_CASES)))
def test_pipeline_cases_cosimulate_alike(case):
    descr, init_a, init_b = PIPELINE_CASES[case]
    (jspec, jbody), (spec, body) = both(descr, init_a, init_b,
                                        name=f"prop{case}")
    jrep = J.cosimulate(J.TracedKernel(jspec, jbody), rows=3, cols=3,
                        seeds=4, config=JaxConfig(**PIPELINE_CFG),
                        backend="ref")
    rep = T.cosimulate(T.TracedKernel(spec, body), rows=3, cols=3, seeds=4,
                       config=MapperConfig(**PIPELINE_CFG), device="cpu")
    assert rep.status == "ok", (rep.status, rep.mismatches[:4])
    assert report_doc(rep) == report_doc(jrep)
