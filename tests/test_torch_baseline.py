"""The port's heuristic baseline (``repro_torch.core.map_dfg_heuristic``)
against the JAX package's on the same DFGs: status, II, mII, placements,
routing nodes (with the MOV nodes and edges they add), handoffs and the
untimed II attempts.  The cases are the five handwritten kernels the
paper's Fig. 7 maps (sha and sha2 aside), its synthetic Table-3 DFGs, and
four random DFGs on which the reference's SAT mapper proves an II unsat
that the heuristic then maps; the port must reproduce that too, so no
test here asserts SAT II <= heuristic II.  Every comparison is exact.
"""
import random

import pytest

pytest.importorskip("torch", reason="optional extra: pip install .[torch]")
pytest.importorskip("jax", reason="optional extra: pip install .[jax]")

from repro import core as jax_core  # noqa: E402
from repro.cgra import programs as jax_programs  # noqa: E402
from repro.cgra.arch import make_grid as jax_make_grid  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.cgra import programs  # noqa: E402
from repro_torch.cgra.arch import make_grid  # noqa: E402
from repro_torch.cgra.simulator import verify  # noqa: E402

#: the handwritten kernels of ``benchmarks/fig7_table4.py`` that map under
#: the pure-Python CDCL (sha and sha2 do not, within a test's budget)
HANDWRITTEN = ("reversebits", "bitcount", "sqrt", "stringsearch", "gsm")
#: ``benchmarks/fig7_table4.py:33-34``
SYNTHETIC = ("gsm_t3", "stringsearch_t3", "nw", "basicmath", "srand")
#: seeds where ``map_dfg`` proves an II unsat and the heuristic maps it
#: (ROADMAP §3, ``test_sat_never_worse_than_heuristic``)
SAT_WORSE_SEEDS = (155, 976, 7427, 9945)
#: ``benchmarks/fig7_table4.py``'s heuristic settings
FIG7 = dict(seed=0, tries_per_ii=10, ii_max=40)


def random_dfg(pkg, seed: int, max_nodes: int = 12):
    """``tests/test_core_properties.py::random_dfg``, built from ``pkg``'s
    ``Node``/``Edge``/``DFG``."""
    rng = random.Random(seed)
    n = rng.randint(2, max_nodes)
    nodes = [pkg.Node(i) for i in range(1, n + 1)]
    edges = []
    seen = set()
    for dst in range(2, n + 1):
        for _ in range(rng.randint(0, 2)):
            src = rng.randint(1, dst - 1)
            if (src, dst) not in seen:
                seen.add((src, dst))
                edges.append(pkg.Edge(src, dst, 0))
    for _ in range(rng.randint(0, 2)):
        src = rng.randint(2, n)
        dst = rng.randint(1, src)
        if src != dst and (src, dst) not in seen:
            seen.add((src, dst))
            edges.append(pkg.Edge(src, dst, rng.randint(1, 2)))
    return pkg.DFG(nodes, edges, name=f"rand{seed}")


def _dfg_doc(dfg):
    return ([(n.id, n.op, tuple(n.operands)) for n in dfg.nodes.values()],
            [(e.src, e.dst, e.distance, e.kind) for e in dfg.edges])


def _result_doc(res):
    doc = {"status": res.status, "mii": res.mii,
           "attempts": [(a.ii, a.status) for a in res.attempts]}
    m = res.mapping
    if m is not None:
        doc.update(mapping=m.to_dict(), dfg=_dfg_doc(m.dfg),
                   handoffs=sorted(m.handoffs.items()),
                   utilization=m.utilization)
    return doc


def _both(port_dfg, jax_dfg, rows, cols, **cfg):
    got = core.map_dfg_heuristic(port_dfg, make_grid(rows, cols),
                                 core.HeuristicConfig(**cfg))
    want = jax_core.map_dfg_heuristic(jax_dfg, jax_make_grid(rows, cols),
                                      jax_core.HeuristicConfig(**cfg))
    assert _result_doc(got) == _result_doc(want)
    return got


@pytest.mark.parametrize("size", [(2, 2), (3, 3)], ids=["2x2", "3x3"])
@pytest.mark.parametrize("kernel", HANDWRITTEN)
def test_heuristic_maps_handwritten_kernels_as_jax(kernel, size):
    got = _both(programs.BENCHMARKS[kernel]().build_dfg(),
                jax_programs.BENCHMARKS[kernel]().build_dfg(), *size, **FIG7)
    if got.mapping is not None:
        assert core.validate_mapping(got.mapping) == []


@pytest.mark.parametrize("name", SYNTHETIC)
def test_heuristic_maps_synthetic_dfgs_as_jax(name):
    _both(programs.synthetic_dfg(name), jax_programs.synthetic_dfg(name),
          4, 4, **FIG7)


@pytest.mark.parametrize("seed", SAT_WORSE_SEEDS)
def test_heuristic_beats_sat_where_jax_does(seed):
    """On these seeds, with the property test's settings, the reference's
    heuristic finds a mapping at an II its SAT mapper proved unsat; the
    port reproduces both halves."""
    got = _both(random_dfg(core, seed, 9), random_dfg(jax_core, seed, 9),
                2, 2, seed=seed, tries_per_ii=6, ii_max=12)
    assert got.status == "mapped"
    assert core.validate_mapping(got.mapping) == []
    sat = core.map_dfg(random_dfg(core, seed, 9), make_grid(2, 2),
                       core.MapperConfig(backend="cdcl", per_ii_timeout_s=20,
                                         ii_max=12))
    want = jax_core.map_dfg(random_dfg(jax_core, seed, 9),
                            jax_make_grid(2, 2),
                            jax_core.MapperConfig(backend="cdcl",
                                                  per_ii_timeout_s=20,
                                                  ii_max=12))
    assert (sat.status, sat.mapping.ii) == (want.status, want.mapping.ii)
    assert sat.mapping.ii > got.mapping.ii


def test_routing_free_heuristic_mapping_executes():
    """``tests/test_cgra_end_to_end.py::test_heuristic_mapping_also_executes``
    on the port: bitcount at 3x3, seed 1, maps without routing nodes and
    runs bit-exact against the oracle on the CPU."""
    prog = programs.BENCHMARKS["bitcount"]()
    res = _both(prog.build_dfg(),
                jax_programs.BENCHMARKS["bitcount"]().build_dfg(), 3, 3,
                seed=1)
    assert res.mapping is not None and res.mapping.routing_nodes == 0
    assert verify(prog, res.mapping, programs.benchmark_mem("bitcount"),
                  device="cpu") == []


def test_heuristic_timeout_and_cap_follow_jax():
    """A zero budget times out before the first try; a cap below mII
    returns ``unsat-capped`` with no attempts, in both packages."""
    gsm = programs.BENCHMARKS["gsm"]().build_dfg()
    j_gsm = jax_programs.BENCHMARKS["gsm"]().build_dfg()
    got = _both(gsm, j_gsm, 2, 2, total_timeout_s=-1.0)
    assert got.status == "timeout" and got.mapping is None
    got = _both(gsm, j_gsm, 2, 2, ii_max=1)
    assert got.status == "unsat-capped" and got.attempts == []
