"""The port's mapping side against the JAX package's: the kernel registry,
the mobility schedule, KMS and mII, the CNF of the SAT encoding, the CDCL
solver, the assembler on carried-over mappings, and fresh map + assemble
against every shipped artifact.  Inputs are the 18 registry kernels, 20
seeded Table-3 synthetic DFGs and 20 seeded random 3-SAT instances.
Everything runs on the CPU; every comparison is exact.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch", reason="optional extra: pip install .[torch]")

from repro.cgra import programs as jax_programs  # noqa: E402
from repro.cgra import registry as jax_registry  # noqa: E402
from repro.cgra.arch import make_grid as jax_make_grid  # noqa: E402
from repro.cgra.bitstream import PrologueClobber as JaxClobber  # noqa: E402
from repro.cgra.bitstream import assemble as jax_assemble  # noqa: E402
from repro.core import backends as jax_backends  # noqa: E402
from repro.core import mii as jax_mii  # noqa: E402
from repro.core import schedule as jax_schedule  # noqa: E402
from repro.core.mapper import MapperConfig as JaxConfig  # noqa: E402
from repro.core.regalloc import allocate_registers as jax_allocate  # noqa: E402
from repro.core.sat_encoding import KMSEncoding as JaxEncoding  # noqa: E402
from repro.fuzz import corpus as jax_corpus  # noqa: E402
from repro.sat.cdcl import CDCLSolver as JaxSolver  # noqa: E402
from repro.sat.cnf import CNF as JaxCNF  # noqa: E402
from repro.toolchain.session import Toolchain as JaxToolchain  # noqa: E402
from repro_torch.cgra import programs, registry  # noqa: E402
from repro_torch.cgra.arch import make_grid  # noqa: E402
from repro_torch.cgra.artifact import (ARTIFACT_ROOT, Artifact,  # noqa: E402
                                      load_artifact)
from repro_torch.cgra.bitstream import PrologueClobber, assemble  # noqa: E402
from repro_torch.convert import mapping_from_parts  # noqa: E402
from repro_torch.core import backends, mii, schedule  # noqa: E402
from repro_torch.core.mapper import MapperConfig  # noqa: E402
from repro_torch.core.mapping import validate_mapping  # noqa: E402
from repro_torch.core.regalloc import allocate_registers  # noqa: E402
from repro_torch.core.sat_encoding import KMSEncoding  # noqa: E402
from repro_torch.fuzz import corpus  # noqa: E402
from repro_torch.sat.cdcl import CDCLSolver  # noqa: E402
from repro_torch.sat.cnf import CNF  # noqa: E402
from repro_torch.toolchain import Toolchain  # noqa: E402
from test_torch_artifacts import (KERNEL_ARCHES, MAPPER_CONFIG,  # noqa: E402
                                  program_dict)

ROOT = Path(__file__).resolve().parents[1]
KERNELS = jax_registry.kernel_names()


def _synthetic_cases():
    """20 seeded (name, seed) draws over the Table-3 graphs of at most 26
    nodes (the larger ones cost seconds a CNF in pure Python)."""
    rng = np.random.RandomState(14)
    names = sorted(n for n, (nodes, _) in jax_programs.TABLE3.items()
                   if nodes <= 26)
    return [(names[rng.randint(len(names))], int(rng.randint(1000)))
            for _ in range(20)]


SYNTHETIC = _synthetic_cases()
DFG_CASES = ([("registry", k) for k in KERNELS]
             + [("synthetic", f"{n}/{s}") for n, s in SYNTHETIC])


def _dfgs(kind, name):
    """(JAX DFG, port DFG) of one registry kernel or synthetic graph."""
    if kind == "registry":
        return (jax_registry.kernel_program(name).build_dfg(),
                registry.kernel_program(name).build_dfg())
    base, seed = name.split("/")
    return (jax_programs.synthetic_dfg(base, int(seed)),
            programs.synthetic_dfg(base, int(seed)))


def plain(x):
    """A hashable, class-free form of a dataclass/container tree, so
    objects of the two packages compare by value."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            plain(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, dict):
        return tuple((plain(k), plain(v)) for k, v in x.items())
    if isinstance(x, (set, frozenset)):
        return tuple(sorted(plain(v) for v in x))
    if isinstance(x, (list, tuple)):
        return tuple(plain(v) for v in x)
    return x


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def test_registry_names_the_jax_kernels_in_order():
    assert registry.kernel_names() == KERNELS
    for origin in ("handwritten", "traced"):
        assert (registry.kernel_names(origin)
                == jax_registry.kernel_names(origin))


@pytest.mark.parametrize("name", KERNELS)
def test_registry_program_and_inputs_match_jax(name):
    port = registry.kernel_program(name)
    want = program_dict(name)
    assert port.to_dict() == want["program"]
    assert programs.LoopBuilder.from_dict(want["program"]).to_dict() \
        == want["program"]
    regions = [[r.base, r.length, r.lo, r.hi]
               for r in corpus.kernel_regions(name)]
    assert regions == want["regions"]
    assert corpus.uses_wide_product(name) == want["wide_product"]
    for seed in (0, 1, 7):
        assert (registry.make_mem(name, seed).tobytes()
                == jax_registry.make_mem(name, seed).tobytes())
    by_name = corpus.make_corpus(name, 10, seed=2)
    assert by_name.tobytes() == jax_corpus.make_corpus(name, 10,
                                                       seed=2).tobytes()
    if name in KERNEL_ARCHES:
        shipped = load_artifact(KERNEL_ARCHES[name], name)
        assert corpus.make_corpus(shipped, 10, seed=2).tobytes() == \
            by_name.tobytes()


def test_benchmark_mem_matches_jax():
    for name in programs.BENCHMARKS:
        for seed in (0, 5):
            assert (programs.benchmark_mem(name, seed).tobytes()
                    == jax_programs.benchmark_mem(name, seed).tobytes())


# ---------------------------------------------------------------------------
# mobility schedule, KMS, mII, encoding, CDCL
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,name", DFG_CASES)
def test_schedule_kms_and_mii_match_jax(kind, name):
    j_dfg, dfg = _dfgs(kind, name)
    assert dfg.to_dict() == j_dfg.to_dict()
    assert dfg.topo_order() == j_dfg.topo_order()
    ms, j_ms = schedule.asap_alap(dfg), jax_schedule.asap_alap(j_dfg)
    assert plain(ms) == plain(j_ms)
    assert plain(ms.rows()) == plain(j_ms.rows())
    for pes in (4, 9, 16):
        assert mii.min_ii(dfg, pes) == jax_mii.min_ii(j_dfg, pes)
        assert mii.res_ii(dfg, pes) == jax_mii.res_ii(j_dfg, pes)
        assert (schedule.kms_ii_upper_bound(dfg, pes)
                == jax_schedule.kms_ii_upper_bound(j_dfg, pes))
    assert mii.rec_ii(dfg) == jax_mii.rec_ii(j_dfg)
    low = mii.min_ii(dfg, 16)
    for ii in range(low, low + 3):
        assert (plain(schedule.fold_kms(ms, ii))
                == plain(jax_schedule.fold_kms(j_ms, ii)))


def _encodings(kind, name, side):
    j_dfg, dfg = _dfgs(kind, name)
    grid, j_grid = make_grid(side, side), jax_make_grid(side, side)
    ii = mii.min_ii(dfg, grid.num_pes)
    enc = KMSEncoding(dfg, schedule.fold_kms(schedule.asap_alap(dfg), ii),
                      grid)
    j_enc = JaxEncoding(j_dfg, jax_schedule.fold_kms(
        jax_schedule.asap_alap(j_dfg), ii), j_grid)
    return enc, j_enc


def _search(solver):
    """The solver's search statistics (its wall times differ by design)."""
    st = solver.stats
    return (st.decisions, st.propagations, st.conflicts, st.restarts,
            st.learned, st.solve_calls)


@pytest.mark.parametrize("kind,name", DFG_CASES)
def test_encoding_cnf_and_cdcl_match_jax(kind, name):
    """The CNF of C1/C2/C3 at mII on a 2x2 torus, clause for clause under
    both at-most-one encodings, then a bounded CDCL run on it: status,
    model and search statistics."""
    enc, j_enc = _encodings(kind, name, 2)
    assert plain(enc.var_of) == plain(j_enc.var_of)
    assert plain(enc.stats) == plain(j_enc.stats)
    for amo in ("pairwise", "sequential"):
        cnf = backends.encoding_to_cnf(enc, amo)
        j_cnf = jax_backends.encoding_to_cnf(j_enc, amo)
        assert cnf.num_vars == j_cnf.num_vars
        assert cnf.clauses == j_cnf.clauses
    solver, j_solver = CDCLSolver(cnf, seed=0), JaxSolver(j_cnf, seed=0)
    status = solver.solve(max_conflicts=100)
    assert status == j_solver.solve(max_conflicts=100)
    if status == "sat":
        assert solver.model() == j_solver.model()
        assert plain(enc.decode_model(solver.model())) == \
            plain(j_enc.decode_model(j_solver.model()))
    assert _search(solver) == _search(j_solver)


@pytest.mark.parametrize("name", [k for k in KERNELS
                                  if k not in ("sha", "sha2")])
def test_encoding_cnf_on_4x4_matches_jax(name):
    enc, j_enc = _encodings("registry", name, 4)
    cnf = backends.encoding_to_cnf(enc, "sequential")
    assert cnf.clauses == jax_backends.encoding_to_cnf(
        j_enc, "sequential").clauses


@pytest.mark.parametrize("seed", range(20))
def test_cdcl_matches_jax_on_random_3sat(seed):
    rng = np.random.RandomState(seed)
    nvars = int(rng.randint(20, 70))
    nclauses = int(nvars * rng.uniform(3.6, 5.0))
    clauses = []
    for _ in range(nclauses):
        vs = rng.choice(np.arange(1, nvars + 1), 3, replace=False)
        signs = rng.choice([-1, 1], 3)
        clauses.append([int(v * s) for v, s in zip(vs, signs)])
    cnf, j_cnf = CNF(), JaxCNF()
    cnf.extend(clauses)
    j_cnf.extend(clauses)
    solver, j_solver = CDCLSolver(cnf, seed=0), JaxSolver(j_cnf, seed=0)
    status = solver.solve()
    assert status == j_solver.solve() and status in ("sat", "unsat")
    if status == "sat":
        model = solver.model()
        assert model == j_solver.model()
        assert all(any(model[abs(lit)] == (lit > 0) for lit in clause)
                   for clause in clauses)
    assert _search(solver) == _search(j_solver)


# ---------------------------------------------------------------------------
# the assembler on mappings carried over from the JAX mapper
# ---------------------------------------------------------------------------

CARRIED = [("gsm", "2x2"), ("bitcount", "4x4"), ("sqrt", "3x3"),
           ("stringsearch", "4x4"), ("argmax", "4x4"),
           ("relu_clamp", "mesh-4x4"), ("dotprod", "bordermem-4x4")]


def _carry(j_mapping, port_program, grid):
    return mapping_from_parts(
        port_program.build_dfg(), grid, j_mapping.ii, j_mapping.num_folds,
        [(p.node, p.pe, (p.slot.c, p.slot.it))
         for p in j_mapping.placements.values()],
        j_mapping.handoffs)


@pytest.mark.parametrize("name,arch", CARRIED)
def test_assembler_matches_jax_on_the_same_mapping(name, arch):
    j_tc = JaxToolchain(arch, JaxConfig(total_timeout_s=60))
    j_prog = j_tc.program(name)
    j_mapping = j_tc.map(j_prog).mapping
    tc = Toolchain(arch)
    program = registry.kernel_program(name)
    mapping = _carry(j_mapping, program, tc.grid)
    assert validate_mapping(mapping) == []
    assert plain(allocate_registers(mapping)) == \
        plain(jax_allocate(j_mapping))
    asm, j_asm = assemble(program, mapping), jax_assemble(j_prog.builder,
                                                          j_mapping)
    np.testing.assert_array_equal(asm.words(), j_asm.words())
    for part in ("rows", "prologue", "kernel", "epilogue"):
        assert plain(getattr(asm, part)) == plain(getattr(j_asm, part)), part
    if j_asm.kernel:
        np.testing.assert_array_equal(asm.kernel_words(),
                                      j_asm.kernel_words())
    assert asm.presets_out == j_asm.presets_out
    assert asm.presets_reg == j_asm.presets_reg
    assert asm.node_of_cell == j_asm.node_of_cell
    assert asm.op_counts() == j_asm.op_counts()


def test_prologue_clobber_matches_jax():
    """gsm at 2x2 without the CEGAR oracle: the solver's first mapping
    clobbers a carry's preset, and both assemblers name the same
    placement triples."""
    j_tc = JaxToolchain("2x2", JaxConfig(total_timeout_s=60), oracle=None)
    j_prog = j_tc.program("gsm")
    j_mapping = j_tc.map(j_prog).mapping
    with pytest.raises(JaxClobber) as j_err:
        jax_assemble(j_prog.builder, j_mapping)
    program = registry.kernel_program("gsm")
    mapping = _carry(j_mapping, program, make_grid(2, 2))
    with pytest.raises(PrologueClobber) as err:
        assemble(program, mapping)
    assert str(err.value) == str(j_err.value)
    assert plain(err.value.triples) == plain(j_err.value.triples)


# ---------------------------------------------------------------------------
# fresh map + assemble against the shipped artifacts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(set(KERNEL_ARCHES) - {"fir4"}))
def test_fresh_mapping_reproduces_the_shipped_artifact(name):
    """fir4 (the slowest solve) is left out here as in
    ``test_torch_artifacts``; ``chip_smoke.py`` maps it too."""
    arch = KERNEL_ARCHES[name]
    tc = Toolchain(arch, MapperConfig(**MAPPER_CONFIG))
    prog = tc.program(name)
    res = tc.map(prog)
    assert res.status == "mapped"
    got = Artifact.from_mapping(prog.builder, res.mapping, arch=arch)
    want = json.loads((ARTIFACT_ROOT / arch / f"{name}.json").read_text())
    assert got.to_dict() == want
    assert Artifact.from_dict(want).to_dict() == want


@pytest.mark.parametrize("name,ii_max", [("sha", 4), ("sha2", 32)])
def test_sha_kernels_are_unmapped_at_2x2(name, ii_max):
    """The two ``unsat-capped`` rows of ``results/BENCH_fuzz.json``."""
    bench = json.loads((ROOT / "results" / "BENCH_fuzz.json").read_text())
    row = next(r for r in bench["rows"] if r["kernel"] == name)
    assert (row["arch"], row["status"]) == ("2x2", "unsat-capped")
    tc = Toolchain("2x2", MapperConfig(per_ii_timeout_s=60.0,
                                       total_timeout_s=120.0, ii_max=ii_max))
    res = tc.map(name)
    assert res.status == "unsat-capped" and res.mapping is None
    j_dfg = jax_registry.kernel_program(name).build_dfg()
    assert res.mii == jax_mii.min_ii(j_dfg, 4)
    assert all(a.status == "unsat" for a in res.attempts)
