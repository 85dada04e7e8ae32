"""The activity harvest's kernel (``repro_torch.kernels.activity``,
``csrc/activity.cu``) on the programs of the benchmark's three
configurations: on the CPU the packed table and the launch geometry, and
that the wrapper refuses a CPU trace before it loads a library; on the card
(``cuda`` marker) the kernel's bins against the plain version's,
``ActivityAccumulator.update_ref``, on the same trace.

These import nothing of JAX; the plain version is held to the JAX package
by ``tests/test_torch_activity.py``.  On the card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_harvest.py

Tolerance: exact equality, every sum is an integer.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch",
                            reason="optional extra: pip install .[torch]")

from repro_torch.cgra.artifact import Artifact  # noqa: E402
from repro_torch.cgra.isa import OPS  # noqa: E402
from repro_torch.cgra.simulator import execute_asm  # noqa: E402
from repro_torch.fuzz.activity import (  # noqa: E402
    ActivityAccumulator, _replay_pairs)
from repro_torch.fuzz.corpus import make_corpus  # noqa: E402
from repro_torch.fuzz.engine import fuzz_program  # noqa: E402
from repro_torch.fuzz.triage import inject_fault  # noqa: E402
from repro_torch.kernels import activity, build  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: the frozen artifacts of the benchmark's configurations
DATA = {"cgra-4x4": ROOT / "portbench" / "data" / "cgra-4x4",
        "adres-8x8": ROOT / "portbench" / "data" / "adres-8x8",
        "cgra-4x4-frame160": ROOT / "portbench" / "data"
        / "cgra-4x4-frame160" / "artifacts"}
PROGRAMS = [(config, path.stem) for config, folder in DATA.items()
            for path in sorted(folder.glob("*.json"))]
SHORT = [case for case in PROGRAMS if case[0] != "cgra-4x4-frame160"]
#: the frame cell's programs with the most pairs, the most rows and the
#: fewest rows
FRAME = [("cgra-4x4-frame160", k)
         for k in ("popcount_f160", "stencil3_f160", "dotprod_f160")]
N_BINS = 2 * len(OPS)


def _artifact(config: str, kernel: str) -> Artifact:
    return Artifact.from_dict(json.loads(
        (DATA[config] / f"{kernel}.json").read_text()))


def _table(art: Artifact) -> activity.HarvestTable:
    lhs, rhs, bins = _replay_pairs(art.asm, art.grid)
    return activity.pack_pairs(lhs, rhs, bins, art.asm.total_rows,
                               art.asm.num_pes, N_BINS)


def _unpack(table: activity.HarvestTable):
    words = table.packed.astype(np.int64)

    def sources(col, flag):
        return [(-1, int(w)) if f & flag else (int(w), 0)
                for w, f in zip(words[:, col], words[:, 2])]

    return (sources(0, activity.LHS_CONST), sources(1, activity.RHS_CONST),
            (words[:, 2] & activity.BIN_MASK).tolist())


def _int32(sources):
    return [(c, int(np.int64(v).astype(np.int32))) for c, v in sources]


@pytest.mark.parametrize("config,kernel", PROGRAMS)
def test_the_packed_table_unpacks_to_the_replay(config, kernel):
    art = _artifact(config, kernel)
    lhs, rhs, bins = _replay_pairs(art.asm, art.grid)
    table = _table(art)
    assert table.packed.dtype == np.int32 and table.packed.flags.c_contiguous
    assert table.packed.shape == (len(bins), 3)
    assert (table.T, table.P, table.bins) == (art.asm.total_rows,
                                              art.asm.num_pes, N_BINS)
    assert _unpack(table) == (_int32(lhs), _int32(rhs), bins)
    for B in (88, 1024, 16384):
        _assert_geometry(B, table.P, table.pairs)


def _assert_geometry(B, P, pairs):
    """What ``harvest_run`` checks of a launch, and no slice empty."""
    threads, slices, size = activity.harvest_geometry(B, P, pairs)
    assert threads % 32 == 0 and 32 <= threads <= activity.MAX_THREADS
    assert threads * P * 4 <= activity.ROW_BYTES
    assert threads * size * 32 <= activity.SUM_LIMIT
    assert (slices - 1) * size < pairs <= slices * size
    return threads, slices, size


@pytest.mark.parametrize("P", (16, 64))
def test_the_geometry_leaves_no_slice_empty_at_any_length(P):
    """Long tables over small and ragged batches, where the slices the SMs
    want and the slice length they give round apart (40,000 pairs at
    B = 160, P = 16 once asked for 396 slices of 102)."""
    for B in (1, 31, 88, 160, 333, 1024, 4096, 16384, 65536):
        for pairs in (*range(1, 400, 7), 9120, 40_000, 99_991, 250_000,
                      1_000_003):
            _assert_geometry(B, P, pairs)
    assert _assert_geometry(160, 16, 40_000)[1:] == (212, 189)


@pytest.mark.parametrize("config,kernel", PROGRAMS)
def test_the_wrapper_refuses_a_cpu_trace_before_loading_a_library(
        config, kernel, monkeypatch):
    def no_library():
        raise AssertionError("the harvest library was loaded")

    monkeypatch.setattr(build, "activity_library", no_library)
    art = _artifact(config, kernel)
    table = _table(art)
    outs = torch.zeros((table.T, 3, table.P), dtype=torch.int32)
    launches = activity.harvest_update.launches
    with pytest.raises(ValueError, match="CUDA device"):
        activity.harvest_update(table, outs, torch.zeros(N_BINS,
                                                         dtype=torch.long))
    assert activity.harvest_update.launches == launches


@pytest.mark.parametrize("config,kernel", SHORT[::4])
def test_off_the_card_the_set_up_packs_nothing(config, kernel):
    """The set-up packs the replay only for a CUDA device; on the CPU the
    accumulator runs the plain version, given the device or not."""
    art = _artifact(config, kernel)
    outs = _trace(art, 5, torch.device("cpu"))
    reports = []
    for device in (None, torch.device("cpu")):
        acc = ActivityAccumulator(art.asm, art.grid, device)
        assert acc._harvest is None and acc._bits is None
        acc.update(outs)
        assert acc._harvest is None
        reports.append(acc.report().to_dict())
    plain = ActivityAccumulator(art.asm, art.grid)
    plain.update_ref(outs)
    assert reports == [plain.report().to_dict()] * 2


def test_pack_pairs_refuses_what_the_kernel_cannot_take():
    ok = ([(0, 0)], [(-1, 5)], [3])
    assert activity.pack_pairs(*ok, 1, 1, 4).packed.tolist() == [
        [0, 5, 3 | activity.RHS_CONST]]
    for lhs, rhs, bins, n_bins, what in (
            ([(2, 0)], [(-1, 0)], [0], 4, "outside the trace"),
            ([(0, 0)], [(-1, 0)], [4], 4, "bin outside"),
            ([(0, 0)], [(-1, 0)], [0], activity.MAX_BINS + 1, "holds"),
            ([(0, 0)], [], [0], 4, "previous values")):
        with pytest.raises(ValueError, match=what):
            activity.pack_pairs(lhs, rhs, bins, 2, 1, n_bins)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _trace(art, B, device, seed=0, asm=None):
    mems = make_corpus(art, B, seed=seed)
    return execute_asm(asm or art.asm, art.grid, mems, batch=B,
                       device=device)[1]


def _both(art, traces):
    """The kernel's accumulator and the plain version's, after each of
    ``traces``; their bins equal after every chunk."""
    kern = ActivityAccumulator(art.asm, art.grid)
    plain = ActivityAccumulator(art.asm, art.grid)
    for outs in traces:
        kern.update(outs)
        plain.update_ref(outs)
        assert torch.equal(kern._bits, plain._bits)
    return kern, plain


@pytest.mark.cuda
@pytest.mark.parametrize("config,kernel,B", [
    *((c, k, B) for c, k in SHORT for B in (1024, 16384, 88)),
    *((c, k, 16384) for c, k in FRAME)])
def test_the_kernel_bins_equal_the_plain_versions(cuda, config, kernel, B):
    art = _artifact(config, kernel)
    launches = activity.harvest_update.launches
    kern, plain = _both(art, [_trace(art, B, cuda)])
    assert activity.harvest_update.launches == launches + 1
    assert kern._bits.device.type == "cuda"
    assert int(kern._bits.sum()) > 0
    assert kern.report().to_dict() == plain.report().to_dict()


@pytest.mark.cuda
@pytest.mark.parametrize("config,kernel", [
    ("cgra-4x4", "gsm"), ("cgra-4x4", "popcount"), ("adres-8x8", "stencil3"),
    ("cgra-4x4-frame160", "gsm_f160")])
def test_several_chunks_with_and_without_a_fault(cuda, config, kernel):
    """Chunks of other sizes into one accumulator: clean traces, the trace
    of a program with a planted fault and a random one, both off the
    schedule the accumulator replays."""
    art = _artifact(config, kernel)
    faulty, _, _ = inject_fault(art.asm)
    rng = np.random.RandomState(len(kernel))
    T, P = art.asm.total_rows, art.asm.num_pes
    noise = torch.as_tensor(rng.randint(-2**31, 2**31, size=(T, 77, P),
                                        dtype=np.int64).astype(np.int32),
                            device=cuda)
    traces = [_trace(art, 1000, cuda, seed=1),
              _trace(art, 333, cuda, seed=2, asm=faulty), noise,
              _trace(art, 1024, cuda, seed=3)]
    kern, plain = _both(art, traces)
    assert kern.report().to_dict() == plain.report().to_dict()
    assert kern.report().memories == 1000 + 333 + 77 + 1024


@pytest.mark.cuda
def test_fuzz_program_launches_the_kernel_once_a_chunk(cuda):
    art = _artifact("cgra-4x4", "gsm")
    mems = make_corpus(art, 2500, seed=4)
    launches = activity.harvest_update.launches
    rep = fuzz_program(art, mems, batch=1024, device=cuda)
    assert activity.harvest_update.launches == launches + 3
    cpu = fuzz_program(art, mems, batch=1024, device="cpu")
    assert rep.activity == cpu.activity is not None
    fuzz_program(art, mems, batch=1024, device=cuda, collect_activity=False)
    assert activity.harvest_update.launches == launches + 3


@pytest.mark.cuda
def test_update_allocates_nothing_after_the_first(cuda):
    art = _artifact("cgra-4x4-frame160", "fir4_f160")
    outs = _trace(art, 4096, cuda)
    acc = ActivityAccumulator(art.asm, art.grid)
    acc.update(outs)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    for _ in range(3):
        acc.update(outs)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before
    assert acc.report().memories == 4 * 4096


@pytest.mark.cuda
def test_given_the_card_the_set_up_packs_and_update_only_enqueues(cuda):
    art = _artifact("cgra-4x4-frame160", "popcount_f160")
    outs = _trace(art, 2048, cuda)
    torch.cuda.synchronize()
    acc = ActivityAccumulator(art.asm, art.grid, cuda)
    assert acc._harvest is not None and acc._bits.device.type == "cuda"
    assert acc._harvest.on_device(cuda).device.type == "cuda"
    before = torch.cuda.memory_allocated()
    acc.update(outs)
    acc.update(outs)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before
    plain = ActivityAccumulator(art.asm, art.grid)
    plain.update_ref(outs)
    plain.update_ref(outs)
    assert acc.report().to_dict() == plain.report().to_dict()


@pytest.mark.cuda
def test_the_wrapper_refuses_a_wrong_dtype_shape_or_device(cuda):
    art = _artifact("cgra-4x4", "fir4")
    table = _table(art)
    outs = _trace(art, 64, cuda)
    bins = torch.zeros(N_BINS, dtype=torch.long, device=cuda)
    launches = activity.harvest_update.launches
    for bad_outs, bad_bins, what in (
            (outs.long(), bins, "outs"),
            (outs[:-1], bins, "outs"),
            (outs[..., :-1], bins, "outs"),
            (outs[None], bins, "outs"),
            (outs.transpose(1, 2).contiguous().transpose(1, 2), bins,
             "outs"),
            (outs, bins.int(), "bins"),
            (outs, bins[:-1], "bins"),
            (outs, bins.cpu(), "bins")):
        with pytest.raises(ValueError, match=what):
            activity.harvest_update(table, bad_outs, bad_bins)
    assert activity.harvest_update.launches == launches
    activity.harvest_update(table, outs, bins)
    assert activity.harvest_update.launches == launches + 1
