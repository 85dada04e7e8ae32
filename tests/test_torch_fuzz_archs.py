"""``fuzz_kernel`` off the torus against the JAX package's: a few kernels
on ``mesh-4x4``, ``bordermem-4x4`` and ``adres-4x4`` (the archs of the
JAX nightly fuzz fleet, and one with a capability table that leaves some
kernels unmapped), and on the ADRES template at its 8x8 size
(``mesh-8x8:mem=row0,ports=1/row``, P = 64), 256 memories each, CDCL
pinned.  The port maps cold into a cache directory that the JAX package
then reads, so both fuzz the same mapping; verdicts, failing memories,
mismatches, activity and energy must be equal.  Everything runs on the
CPU.
"""
import pytest

pytest.importorskip("torch", reason="optional extra: pip install .[torch]")
pytest.importorskip("jax", reason="optional extra: pip install .[jax]")

from repro.core import MapperConfig as JaxConfig  # noqa: E402
from repro.dse import MappingCache as JaxCache  # noqa: E402
from repro.fuzz import engine as jax_engine  # noqa: E402
from repro_torch.core import MapperConfig  # noqa: E402
from repro_torch.dse import MappingCache  # noqa: E402
from repro_torch.fuzz import engine  # noqa: E402

BUDGET = dict(backend="cdcl", per_ii_timeout_s=60.0, total_timeout_s=120.0,
              ii_max=32)
#: (arch, kernels): kernels that map within a second or two there, and on
#: the two ADRES-template arrays one (dotprod) that comes out unmapped
CASES = [("mesh-4x4", ("gsm", "saxpy", "relu_clamp", "xorshift32")),
         ("bordermem-4x4", ("gsm", "saxpy", "relu_clamp", "xorshift32")),
         ("adres-4x4", ("bitcount", "saxpy", "xorshift32", "dotprod")),
         ("mesh-8x8:mem=row0,ports=1/row",
          ("bitcount", "saxpy", "xorshift32", "dotprod"))]
_TIMES = ("map_time_s", "exec_time_s", "oracle_time_s", "mem_rate",
          "backend", "readback_time_s", "compare_time_s", "activity_time_s",
          "activity_setup_s")


@pytest.mark.parametrize("arch,kernels", CASES, ids=[a for a, _ in CASES])
def test_fuzz_kernel_off_the_torus_matches_jax(tmp_path, arch, kernels):
    root = str(tmp_path / "shared")
    cache, j_cache = MappingCache(root), JaxCache(root)
    for name in kernels:
        rep = engine.fuzz_kernel(name, arch, memories=256, batch=128,
                                 seed=2, config=MapperConfig(**BUDGET),
                                 cache=cache, device="cpu")
        want = jax_engine.fuzz_kernel(name, arch, memories=256, batch=128,
                                      seed=2, backend="ref",
                                      config=JaxConfig(**BUDGET),
                                      cache=j_cache)
        got, exp = rep.to_dict(), want.to_dict()
        assert got.pop("ring_launches") == 0     # the port's; no launch
        for doc in (got, exp):
            for key in _TIMES:
                doc.pop(key, None)
        assert got == exp, name
        if rep.status == "ok":
            assert rep.activity is not None and rep.energy is not None
            assert rep.activity == want.activity
            assert rep.energy == want.energy
    assert j_cache.stats()["hits"] == len(kernels)   # one mapping each
    assert cache.stats()["hits"] == 0
