"""The readers of the program's phase spans: nothing to read gives None,
and on a CPU run of a throwaway cell the window's ms per 1000 memories
add up: oracle + exec + compare + activity + unattributed is
10**6 / mem_per_s, with readback a part of exec."""
import json
import shutil
import types
from pathlib import Path

import pytest

from portbench.harness import result, spec, window

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
NEW = ("compare_ms_per_kmem", "activity_ms_per_kmem", "readback_ms_per_kmem",
       "unattributed_ms_per_kmem")
#: the readings that split the window between them
PARTS = ("oracle_ms_per_kmem", "exec_ms_per_kmem", "compare_ms_per_kmem",
         "activity_ms_per_kmem", "unattributed_ms_per_kmem")


def _toy(tmp_path: Path) -> Path:
    """A copy of the benchmark with a small cell added as new files and
    entries, its per-layer metrics those of the fuzz cell."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    data = root / "portbench" / "data" / "cgra-toy"
    data.mkdir()
    for k in ("dotprod", "gsm", "fir4"):
        shutil.copy(BENCH / "data" / "cgra-4x4" / f"{k}.json", data)
    conf = json.loads((BENCH / "configs" / "cgra-4x4.json").read_text())
    conf.update(name="cgra-toy", kernels=["dotprod", "gsm", "fir4"],
                data="portbench/data/cgra-toy")
    (root / "portbench" / "configs" / "cgra-toy.json").write_text(
        json.dumps(conf))
    (root / "portbench" / "traffic" / "toy.json").write_text(json.dumps(
        {"memories_per_call": 300, "batch": 128, "check_calls": 2}))
    bench["configs"].append({"name": "cgra-toy", "source": "x",
                             "file": "portbench/configs/cgra-toy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "toy", "config": "cgra-toy",
                               "traffic": "toy", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "fuzz-4x4-b16384" in m.get("workloads", ()):
            m["workloads"].append("toy")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("name", NEW)
def test_a_window_with_no_reports_reads_none(name):
    cell = spec.load_cell("fuzz-4x4-b16384")
    read = spec.reader(ROOT, name)
    empty = window.Window(cell=cell, seed=1, window_s=1.0)
    assert read(empty) is None
    unanswered = window.Window(cell=cell, seed=1, window_s=1.0, calls=[
        window.Call(kernel="gsm", index=1, doc={}, memories=None,
                    launches=[], error="RuntimeError: lost")])
    assert read(unanswered) is None


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_phase_times_reads_none(name):
    """A report with only the two older timers, as the parent's has."""
    cell = spec.load_cell("fuzz-4x4-b16384")
    old = types.SimpleNamespace(memories=64, exec_time_s=0.01,
                                oracle_time_s=0.02)
    win = window.Window(cell=cell, seed=1, window_s=1.0, calls=[
        window.Call(kernel="gsm", index=1, doc={}, memories=None,
                    launches=[64], report=old)])
    assert spec.reader(ROOT, name)(win) is None


def test_the_readings_add_up_to_the_window(tmp_path):
    root = _toy(tmp_path)
    cell = spec.load_cell("toy", root)
    assert set(NEW) <= {m["name"] for m in cell.per_layer}
    win = window.run(cell, 2 ** 31 + 11, 0.0, False, "cpu")
    got = {m: spec.reader(root, m)(win)
           for m in PARTS + ("readback_ms_per_kmem", "mem_per_s")}
    assert all(v is not None and v >= 0 for v in got.values()), got
    assert 0 < got["readback_ms_per_kmem"] < got["exec_ms_per_kmem"]
    assert got["compare_ms_per_kmem"] > 0 and got["activity_ms_per_kmem"] > 0
    assert sum(got[m] for m in PARTS) == pytest.approx(
        1e6 / got["mem_per_s"], rel=1e-9)
    # the phases hold the window: what lies outside them is a sliver
    assert got["unattributed_ms_per_kmem"] < 0.05 * (1e6 / got["mem_per_s"])


def test_a_traced_line_of_the_cell_reports_the_new_metrics(tmp_path):
    root = _toy(tmp_path)
    line, _ = result.run_once(spec.load_cell("toy", root), 2 ** 31 + 12,
                              0.0, True, "cpu")
    assert line["correct"]
    assert set(NEW) <= set(line["metrics"])
    for name in NEW:
        assert line["metrics"][name]["unit"] == "ms/kmem"
