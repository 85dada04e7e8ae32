"""The port's cross-point fact store against the JAX package's: the lifting
condition and combo re-indexing over a matrix of grids, seeded
publish/lift sequences whose seeds and counters must equal the JAX
package's fact for fact, the seed's JSON round trip, an end-to-end lift
from mesh-2x2 to mesh-3x3, and the rule that a fact-seeded result never
enters the mapping cache.  Everything runs on the CPU with the CDCL
backend.
"""
import itertools
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch", reason="optional extra: pip install .[torch]")
pytest.importorskip("jax", reason="optional extra: pip install .[jax]")

from repro.archspec import parse_arch as jax_parse_arch  # noqa: E402
from repro.core import MapperConfig as JaxConfig  # noqa: E402
from repro.core import facts as jax_facts  # noqa: E402
from repro.core.dfg import running_example as jax_running_example  # noqa: E402
from repro.core.schedule import Slot as JaxSlot  # noqa: E402
from repro.toolchain import Toolchain as JaxToolchain  # noqa: E402
from repro_torch.archspec import parse_arch  # noqa: E402
from repro_torch.core import MapperConfig, facts  # noqa: E402
from repro_torch.core.dfg import running_example  # noqa: E402
from repro_torch.core.schedule import Slot  # noqa: E402
from repro_torch.dse import MappingCache  # noqa: E402
from repro_torch.toolchain import Toolchain  # noqa: E402

CDCL = dict(backend="cdcl", per_ii_timeout_s=10.0, total_timeout_s=30.0)
#: grids of every lifting case: mesh growth in rows, columns and both,
#: torus, a register-file change and a capability table
GRIDS = ["mesh-2x2", "mesh-2x3", "mesh-3x2", "mesh-3x3", "2x2", "3x3",
         "mesh-3x3:regs=8", "bordermem-4x4", "mesh-4x4"]


def test_grid_meta_and_embeds_in_matrix_match_jax():
    port = [facts.grid_meta(parse_arch(s).grid()) for s in GRIDS]
    want = [jax_facts.grid_meta(jax_parse_arch(s).grid()) for s in GRIDS]
    assert port == want
    matrix = [[facts.embeds_in(a, b) for b in port] for a in port]
    assert matrix == [[jax_facts.embeds_in(a, b) for b in want]
                      for a in want]
    # the cases of the lifting condition, spelled out
    idx = {s: i for i, s in enumerate(GRIDS)}
    assert matrix[idx["mesh-2x2"]][idx["mesh-3x3"]]
    assert not matrix[idx["mesh-3x3"]][idx["mesh-2x3"]]
    assert not matrix[idx["2x2"]][idx["3x3"]]
    assert not matrix[idx["mesh-2x2"]][idx["mesh-3x3:regs=8"]]
    assert not matrix[idx["bordermem-4x4"]][idx["mesh-4x4"]]
    assert matrix[idx["bordermem-4x4"]][idx["bordermem-4x4"]]


@pytest.mark.parametrize("src_cols,dst_cols",
                         list(itertools.product((1, 2, 3, 4), repeat=2)))
def test_remap_combo_matches_jax(src_cols, dst_cols):
    rng = np.random.RandomState(src_cols * 10 + dst_cols)
    combo = [(int(n), int(p), (int(c), int(it))) for n, p, c, it in
             rng.randint(0, 4 * src_cols, size=(6, 4))]
    port = facts.remap_combo([(n, p, Slot(*s)) for n, p, s in combo],
                             src_cols, dst_cols)
    want = jax_facts.remap_combo([(n, p, JaxSlot(*s)) for n, p, s in combo],
                                 src_cols, dst_cols)
    assert [(n, p, (s.c, s.it)) for n, p, s in port] == \
        [(n, p, (s.c, s.it)) for n, p, s in want]


def _random_result(rng, slot_cls, num_pes):
    combos = [[(int(rng.randint(0, 8)), int(rng.randint(0, num_pes)),
                slot_cls(int(rng.randint(0, 3)), int(rng.randint(0, 2))))
               for _ in range(int(rng.randint(1, 4)))]
              for _ in range(int(rng.randint(0, 3)))]
    unsat = sorted(set(int(i) for i in rng.randint(1, 5,
                                                   size=rng.randint(0, 3))))
    mapped = bool(rng.randint(0, 2))
    return SimpleNamespace(
        blocked_combos=combos, unsat_iis=unsat,
        status="mapped" if mapped else "unsat-capped",
        mapping=SimpleNamespace(ii=int(rng.randint(2, 7))) if mapped
        else None)


@pytest.mark.parametrize("seed", range(6))
def test_publish_lift_sequences_match_jax(seed):
    """The same random publish sequence over the grid matrix gives the
    same publish counts, lifted seeds (in order) and counters in both
    stores, for two oracle tags."""
    store, j_store = facts.FactStore(), jax_facts.FactStore()
    dfg, j_dfg = running_example(), jax_running_example()
    assert facts.dfg_fact_key(dfg) == jax_facts.dfg_fact_key(j_dfg)
    grids = [parse_arch(s).grid() for s in GRIDS]
    j_grids = [jax_parse_arch(s).grid() for s in GRIDS]
    rng, j_rng = np.random.RandomState(seed), np.random.RandomState(seed)
    for step in range(12):
        gi = int(rng.randint(0, len(GRIDS)))
        assert gi == int(j_rng.randint(0, len(GRIDS)))
        tag = ("", "oracle=bitstream-prologue")[step % 2]
        res = _random_result(rng, Slot, grids[gi].num_pes)
        j_res = _random_result(j_rng, JaxSlot, j_grids[gi].num_pes)
        assert store.publish(dfg, grids[gi], tag, res) == \
            j_store.publish(j_dfg, j_grids[gi], tag, j_res)
        for g, jg in zip(grids, j_grids):
            for t in ("", "oracle=bitstream-prologue"):
                port = facts.seed_to_jsonable(store.lift(dfg, g, t))
                want = jax_facts.seed_to_jsonable(j_store.lift(j_dfg, jg, t))
                assert port == want
    assert store.stats() == j_store.stats()
    assert store.published == j_store.published > 0


def test_fact_seed_json_roundtrip_matches_jax():
    seed = {"blocked": [[(0, 1, Slot(0, 0)), (2, 3, Slot(1, 1))]],
            "unsat_iis": [2, 3], "ii_cap": 4}
    j_seed = {"blocked": [[(0, 1, JaxSlot(0, 0)), (2, 3, JaxSlot(1, 1))]],
              "unsat_iis": [2, 3], "ii_cap": 4}
    text = facts.seed_to_jsonable(seed)
    assert text == jax_facts.seed_to_jsonable(j_seed)
    assert facts.seed_from_jsonable(text) == seed
    assert facts.seed_to_jsonable(None) is None
    assert facts.seed_from_jsonable(None) is None
    assert facts.seed_from_jsonable({}) is None


def test_fact_lifting_end_to_end_mesh2x2_to_3x3():
    """gsm's CEGAR combo and feasible II on mesh-2x2 seed the mesh-3x3
    solve; the seeded result equals the JAX package's seeded result and
    commits the cold run's II."""
    store, j_store = facts.FactStore(), jax_facts.FactStore()
    small = Toolchain("mesh-2x2", MapperConfig(**CDCL), facts=store).map(
        "gsm")
    j_small = JaxToolchain("mesh-2x2", JaxConfig(**CDCL),
                           facts=j_store).map("gsm")
    assert small.status == "mapped" and small.blocked_combos
    assert small.mapping.to_dict() == j_small.mapping.to_dict()
    assert store.stats() == j_store.stats() and store.published >= 2
    seeded = Toolchain("mesh-3x3", MapperConfig(**CDCL), facts=store).map(
        "gsm")
    j_seeded = JaxToolchain("mesh-3x3", JaxConfig(**CDCL),
                            facts=j_store).map("gsm")
    cold = Toolchain("mesh-3x3", MapperConfig(**CDCL)).map("gsm")
    assert seeded.facts_used == j_seeded.facts_used >= 2
    assert cold.facts_used == 0
    assert seeded.status == cold.status == "mapped"
    assert seeded.ii == cold.ii == j_seeded.ii
    assert seeded.mapping.to_dict() == j_seeded.mapping.to_dict()
    assert store.stats() == j_store.stats()
    assert store.lifted >= 1


def test_fact_seeded_results_never_enter_the_cache(tmp_path):
    """The cache key cannot see the seed, so a seeded result is not
    written back, and a store-less session over the same cache misses."""
    store = facts.FactStore()
    cache = MappingCache(str(tmp_path / "cache"))
    Toolchain("mesh-2x2", MapperConfig(**CDCL), facts=store).map("gsm")
    tc = Toolchain("mesh-3x3", MapperConfig(**CDCL), cache=cache,
                   facts=store)
    res = tc.map("gsm")
    assert res.facts_used >= 1 and not tc.last_cache_hit
    assert len(cache) == 0
    plain = Toolchain("mesh-3x3", MapperConfig(**CDCL), cache=cache)
    plain.map("gsm")
    assert not plain.last_cache_hit
    assert len(cache) == 1                  # the unseeded solve is stored
    # a cache hit publishes its facts too (they are proofs like any other)
    again = facts.FactStore()
    Toolchain("mesh-3x3", MapperConfig(**CDCL), cache=cache,
              facts=again).map("gsm")
    assert again.published >= 1
