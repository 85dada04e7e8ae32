"""The frozen data, the plain reference and the counts, on the CPU."""
import json
from pathlib import Path

import numpy as np
import pytest

from portbench.harness import memgen, reference, roofline

ROOT = Path(__file__).resolve().parents[2]
FROZEN = sorted((ROOT / "portbench" / "data").glob("*/*.json"))


def _doc(path):
    return json.loads(Path(path).read_text())


def _mems(doc, n, seed, wide=None):
    return memgen.memories(doc["regions"], doc["wide_product"]
                           if wide is None else wide, n,
                           memgen.rng_for(seed, doc["kernel"]))


def _cells_that_differ(doc, program, mems):
    """(memories where the run of ``doc``'s bitstream differs from
    ``program`` at any cell of any iteration or in the final image,
    (node, iteration) pairs of ``program`` the bitstream never runs,
    cells compared)."""
    run = reference.simulate(doc, mems)
    every, final = reference.interpret(program, mems, every_iteration=True)
    diff = (run.final_mem != final).any(axis=1)
    missing = 0
    for key, v in every.items():
        got = run.cells.get(key)
        if got is None:
            missing += 1
            continue
        diff |= got != v
    return int(diff.sum()), missing, len(every) * len(mems)


@pytest.mark.parametrize("path", FROZEN, ids=lambda p: f"{p.parent.name}/{p.stem}")
def test_frozen_bitstream_computes_its_cil_program(path):
    """On seeded memories the reference's run of the frozen bitstream
    equals its interpretation of the frozen CIL program at every cell of
    every iteration and in the final image, and runs every (node,
    iteration) pair of it."""
    doc = _doc(path)
    mems = _mems(doc, 500, 2 ** 31 + 7)
    assert reference.fuzz_verdicts(doc, mems).failing == []
    nodes, trip = len(doc["program"]["nodes"]), doc["program"]["trip"]
    assert _cells_that_differ(doc, doc["program"], mems) == (
        0, 0, nodes * trip * len(mems))


def test_configurations_hold_their_frozen_data():
    for cfg in ("cgra-4x4", "cgra-6x6"):
        conf = _doc(ROOT / "portbench" / "configs" / f"{cfg}.json")
        for k in conf["kernels"]:
            doc = _doc(ROOT / conf["data"] / f"{k}.json")
            assert (doc["kernel"], doc["rows"], doc["cols"]) == (
                k, conf["rows"], conf["cols"])
            assert doc["num_pes"] == conf["num_pes"]
        assert set(conf["source_kernels"]) - set(conf["kernels"]) \
            == set(conf["cut"])


@pytest.mark.parametrize("mutation", ["smul_to_sadd", "src_b", "imm"])
def test_a_changed_bitstream_is_caught(mutation):
    doc = _doc(ROOT / "portbench" / "data" / "cgra-4x4" / "gsm.json")
    frozen = doc["program"]
    words = np.asarray(doc["words"], np.int64)
    op = (words >> 27) & 0x1F
    t, p = [tuple(x) for x in np.argwhere(op == 3)][0]      # an SMUL
    w = int(words[t, p])
    if mutation == "smul_to_sadd":
        w = (w & ~(0x1F << 27)) | (1 << 27)
    elif mutation == "src_b":
        w = (w & ~(0xF << 16)) | (10 << 16)                   # reads ZERO
    else:
        w = (w & ~((1 << 20) - 1 << 16)) | (9 << 20) | (9 << 16) | 3
    doc["words"][t][p] = w
    mems = _mems(doc, 200, 3, wide=False)
    assert _cells_that_differ(doc, frozen, mems)[0] > 0


@pytest.mark.parametrize("B, want_us", [(1024, 2.24), (16384, 35.7)])
def test_gsm_bound_by_hand(B, want_us):
    """gsm at 4x4: T = 84, P = 16, M = 128, 208 live cells; the bytes bound
    (PERF.md's kernel table: 2.24 and 35.7 µs)."""
    doc = _doc(ROOT / "portbench" / "data" / "cgra-4x4" / "gsm.json")
    T, P, live = roofline.shape(doc)
    assert (T, P, live) == (84, 16, 208)
    by_hand = (8 * B * (7 * 16 + 128) + 4 * 84 * B * 16 + 20 * 84 * 16)
    assert roofline.launch_bytes(T, B, P, 128) == by_hand
    assert roofline.launch_ops(live, B) == 8 * 208 * B
    assert roofline.bound_s(T, B, P, 128, live) * 1e6 == pytest.approx(
        want_us, abs=0.01)
    assert by_hand / roofline.HBM_BYTES_PER_S > \
        roofline.launch_ops(live, B) / roofline.INT32_OPS_PER_S


def test_memories_are_seeded_and_kept_in_their_regions():
    doc = _doc(ROOT / "portbench" / "data" / "cgra-4x4" / "ema_fxp.json")
    assert doc["wide_product"]
    a = memgen.memories(doc["regions"], True, 1000, memgen.rng_for(2 ** 33, "x"))
    b = memgen.memories(doc["regions"], True, 1000, memgen.rng_for(2 ** 33, "x"))
    c = memgen.memories(doc["regions"], True, 1000, memgen.rng_for(2 ** 33, "y"))
    assert a.dtype == np.int32 and a.shape == (1000, 128)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    for base, length, lo, hi in doc["regions"]:
        cells = a[:, base:base + length]
        assert cells.min() >= lo and cells.max() < hi   # FXPMUL: clipped
    inside = np.zeros(128, bool)
    for base, length, _, _ in doc["regions"]:
        inside[base:base + length] = True
    assert not a[:, ~inside].any()


def test_every_strategy_appears_in_a_pool():
    doc = _doc(ROOT / "portbench" / "data" / "cgra-4x4" / "popcount.json")
    (base, length, lo, hi), = doc["regions"]
    m = _mems(doc, 50, 5)
    region = m[:, base:base + length].astype(np.int64)
    fill = region[3::5]
    assert set(np.unique(fill)) <= {0, -1}
    assert (region[2::5] == 0).mean() > 0.6                  # sparse
    overflow = region[4::5]
    assert overflow.min() < -(1 << 30) and overflow.max() > 1 << 30
