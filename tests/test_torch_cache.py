"""The port's content-addressed mapping cache against the JAX package's:
the ``MappingCache`` cases of ``tests/test_dse.py`` run on the port (keys,
hits, corrupt and torn entries, quarantine, concurrent writers), one cache
directory read by both packages in either direction, and
``fuzz_kernel(cache=)`` answering a repeat mapping from disk with the JAX
package's report.  Everything runs on the CPU with the CDCL backend.
"""
import dataclasses
import json
import multiprocessing
import os

import pytest

pytest.importorskip("torch", reason="optional extra: pip install .[torch]")
pytest.importorskip("jax", reason="optional extra: pip install .[jax]")

from repro.cgra import make_grid as jax_make_grid  # noqa: E402
from repro.core import MapperConfig as JaxConfig  # noqa: E402
from repro.core import map_dfg_cached as jax_map_dfg_cached  # noqa: E402
from repro.core import mapping_cache_key as jax_cache_key  # noqa: E402
from repro.core import running_example as jax_running_example  # noqa: E402
from repro.dse import MappingCache as JaxCache  # noqa: E402
from repro.fuzz import engine as jax_engine  # noqa: E402
from repro.toolchain import Toolchain as JaxToolchain  # noqa: E402
from repro_torch.cgra import make_grid  # noqa: E402
from repro_torch.core import (MapperConfig, map_dfg_cached,  # noqa: E402
                              mapping_cache_key, running_example,
                              validate_mapping)
from repro_torch.core.dfg import DFG, Edge, Node  # noqa: E402
from repro_torch.dse import MappingCache  # noqa: E402
from repro_torch.dse.cache import QUARANTINE_DIR, SCHEMA  # noqa: E402
from repro_torch.fuzz import engine  # noqa: E402
from repro_torch.toolchain import Toolchain  # noqa: E402

CDCL = dict(backend="cdcl", per_ii_timeout_s=10.0, total_timeout_s=30.0)
#: MapResult fields measured on the wall clock
_TIMED = ("total_time_s", "time_s", "encode_time_s")


def _untimed(doc):
    if isinstance(doc, dict):
        return {k: _untimed(v) for k, v in doc.items() if k not in _TIMED}
    if isinstance(doc, list):
        return [_untimed(v) for v in doc]
    return doc


def test_cache_key_is_content_addressed_and_equal_to_jax():
    dfg = running_example()
    grid = make_grid(2, 2)
    cfg = MapperConfig(**CDCL)
    k1 = mapping_cache_key(dfg, grid, cfg)
    assert k1 == jax_cache_key(jax_running_example(), jax_make_grid(2, 2),
                               JaxConfig(**CDCL))
    renamed = DFG(list(dfg.nodes.values()), dfg.edges, name="other")
    assert mapping_cache_key(renamed, grid, cfg) == k1
    assert mapping_cache_key(dfg, make_grid(3, 3), cfg) != k1
    assert mapping_cache_key(dfg, grid,
                             dataclasses.replace(cfg, ii_max=7)) != k1
    assert mapping_cache_key(dfg, grid, cfg, extra="oracle=x") != k1
    grown = DFG(list(dfg.nodes.values()) + [Node(99, op="SADD")],
                dfg.edges + [Edge(1, 99, 0)], name=dfg.name)
    assert mapping_cache_key(grown, grid, cfg) != k1


def test_map_dfg_cached_hit_is_deterministic_and_equal_to_jax(tmp_path):
    dfg, grid = running_example(), make_grid(2, 2)
    cfg = MapperConfig(**CDCL)
    cache = MappingCache(str(tmp_path / "c"))
    res1, hit1 = map_dfg_cached(dfg, grid, cfg, cache=cache)
    res2, hit2 = map_dfg_cached(dfg, grid, cfg, cache=cache)
    assert (hit1, hit2) == (False, True)
    assert res1.status == res2.status == "mapped"
    assert json.dumps(res1.to_dict(), sort_keys=True) == \
        json.dumps(res2.to_dict(), sort_keys=True)
    assert validate_mapping(res2.mapping) == []
    _, hit3 = map_dfg_cached(dfg, grid, dataclasses.replace(cfg, ii_max=10),
                             cache=cache)
    assert not hit3
    assert cache.stats() == {"dir": cache.root, "hits": 1, "misses": 2,
                             "corrupt": 0}
    want, _ = jax_map_dfg_cached(jax_running_example(), jax_make_grid(2, 2),
                                 JaxConfig(**CDCL),
                                 cache=JaxCache(str(tmp_path / "j")))
    assert _untimed(res2.to_dict()) == _untimed(want.to_dict())


def test_cache_corrupt_entry_reads_as_miss(tmp_path):
    dfg, grid = running_example(), make_grid(2, 2)
    cfg = MapperConfig(**CDCL)
    cache = MappingCache(str(tmp_path / "c"))
    key = mapping_cache_key(dfg, grid, cfg)
    map_dfg_cached(dfg, grid, cfg, cache=cache)
    path = cache._path(key)
    with open(path, "w") as fh:
        fh.write("{not json")
    assert cache.get(key) is None
    assert not os.path.exists(path)
    res, hit = map_dfg_cached(dfg, grid, cfg, cache=cache)
    assert not hit and res.status == "mapped"
    assert cache.get(key) is not None


@pytest.mark.parametrize("package", ["port", "jax"])
def test_cache_partial_write_is_quarantined_not_remissed(tmp_path, package):
    """Both caches move a torn or stale entry aside alike, whichever
    package wrote it."""
    writer = (MappingCache if package == "port" else JaxCache)(
        str(tmp_path / "c"))
    cache = MappingCache(str(tmp_path / "c"))
    key = "ab" + "0" * 62
    writer.put(key, {"status": "mapped", "ii": 2})
    path = cache._path(key)
    data = open(path).read()
    with open(path, "w") as fh:
        fh.write(data[: len(data) // 2])
    assert cache.lookup(key) == (None, "corrupt")
    assert cache.stats()["corrupt"] == 1
    qdir = os.path.join(cache.root, QUARANTINE_DIR)
    assert os.listdir(qdir) == [key + ".json.corrupt"]
    assert len(cache) == 0
    writer.put(key, {"status": "mapped", "ii": 2})
    entry = json.load(open(path))
    entry["schema"] = 99
    with open(path, "w") as fh:
        json.dump(entry, fh)
    assert cache.lookup(key) == (None, "corrupt")
    writer.put(key, {"status": "mapped", "ii": 3})
    stored, state = cache.lookup(key)
    assert state == "hit" and stored["ii"] == 3
    assert cache.hit_ratio() == 1 / 3


def _cache_race_writer(root, key, result, n):
    cache = MappingCache(root)
    for _ in range(n):
        cache.put(key, result)


def test_cache_concurrent_writers_same_key(tmp_path):
    """Processes racing ``put`` on one key land complete entries: a reader
    interleaved with the race never sees a torn file."""
    root = str(tmp_path / "c")
    key = "cd" + "1" * 62
    result = {"status": "mapped", "ii": 4, "attempts": list(range(50))}
    ctx = multiprocessing.get_context()
    writers = [ctx.Process(target=_cache_race_writer,
                           args=(root, key, result, 40)) for _ in range(4)]
    for w in writers:
        w.start()
    reader = MappingCache(root)
    while any(w.is_alive() for w in writers):
        stored, state = reader.lookup(key)
        assert state != "corrupt"
        if stored is not None:
            assert stored == result
    for w in writers:
        w.join(timeout=60)
        assert w.exitcode == 0
    assert reader.lookup(key) == (result, "hit")
    assert len(reader) == 1
    assert not [f for f in os.listdir(os.path.join(root, key[:2]))
                if f.endswith(".tmp")]


def test_entries_are_the_jax_layout(tmp_path):
    """``{"schema", "key", "result"}`` with sorted keys, sharded by the
    key's first two hex digits: the same bytes as the JAX package's
    ``put`` of the same result."""
    key = "3f" + "7" * 62
    result = {"status": "mapped", "mapping": {"ii": 2}, "mii": 2}
    MappingCache(str(tmp_path / "p")).put(key, result)
    JaxCache(str(tmp_path / "j")).put(key, result)
    port = tmp_path / "p" / "3f" / f"{key}.json"
    want = tmp_path / "j" / "3f" / f"{key}.json"
    assert port.read_bytes() == want.read_bytes()
    assert json.loads(port.read_text()) == {"schema": SCHEMA, "key": key,
                                            "result": result}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_one_cache_directory_serves_both_packages(tmp_path, writer):
    """gsm@2x2 (CEGAR active) written by one package reads as a hit in the
    other, with an equal ``MapResult.to_dict()``, through
    ``map_dfg_cached`` and through ``Toolchain(cache=)``."""
    from repro.cgra.registry import kernel_program as jax_program
    from repro_torch.cgra.registry import kernel_program

    root = str(tmp_path / "shared")
    jax_dfg, dfg = jax_program("gsm").build_dfg(), \
        kernel_program("gsm").build_dfg()
    jax_args = (jax_dfg, jax_make_grid(2, 2), JaxConfig(**CDCL))
    port_args = (dfg, make_grid(2, 2), MapperConfig(**CDCL))
    first, second = ((jax_map_dfg_cached, jax_args, JaxCache),
                     (map_dfg_cached, port_args, MappingCache))
    if writer == "port":
        first, second = second, first
    written, hit = first[0](*first[1], cache=first[2](root))
    assert not hit and written.status == "mapped"
    read, hit = second[0](*second[1], cache=second[2](root))
    assert hit
    assert read.to_dict() == written.to_dict()

    tcs = (JaxToolchain("2x2", JaxConfig(**CDCL), cache=root),
           Toolchain("2x2", MapperConfig(**CDCL), cache=root))
    if writer == "port":
        tcs = tcs[::-1]
    assert tcs[0].cache_key("gsm") == tcs[1].cache_key("gsm")
    w = tcs[0].map("gsm")
    assert not tcs[0].last_cache_hit
    r = tcs[1].map("gsm")
    assert tcs[1].last_cache_hit
    assert r.to_dict() == w.to_dict()
    assert len(MappingCache(root)) == 2     # plain and oracle-tagged keys


def test_fuzz_kernel_cache_hit_gives_the_jax_report(tmp_path):
    """The second ``fuzz_kernel(cache=)`` maps from disk, and both reports
    equal the JAX package's, wall-clock times aside."""
    cache = MappingCache(str(tmp_path / "c"))
    cfg = MapperConfig(per_ii_timeout_s=60.0, total_timeout_s=120.0,
                       ii_max=32, backend="cdcl")
    cold = engine.fuzz_kernel("gsm", "4x4", memories=48, batch=32, seed=1,
                              config=cfg, cache=cache, device="cpu")
    assert cache.stats()["hits"] == 0 and len(cache) == 1
    warm = engine.fuzz_kernel("gsm", "4x4", memories=48, batch=32, seed=1,
                              config=cfg, cache=cache, device="cpu")
    assert cache.stats()["hits"] == 1
    want = jax_engine.fuzz_kernel(
        "gsm", "4x4", memories=48, batch=32, seed=1, backend="ref",
        config=JaxConfig(per_ii_timeout_s=60.0, total_timeout_s=120.0,
                         ii_max=32, backend="cdcl"),
        cache=str(tmp_path / "j"))
    docs = [r.to_dict() for r in (cold, warm, want)]
    for doc in docs[:2]:
        assert doc.pop("ring_launches") == 0     # the port's; no launch
    for doc in docs:
        for k in ("map_time_s", "exec_time_s", "oracle_time_s", "mem_rate"):
            doc.pop(k)
        for k in ("readback_time_s", "compare_time_s", "activity_time_s",
                  "activity_setup_s"):
            doc.pop(k, None)               # the port's phase timings only
    assert docs[0] == docs[1] == docs[2]
    assert cold.status == "ok" and cold.energy is not None
