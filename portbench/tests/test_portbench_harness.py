"""The harness without a card: isolation, the refusal to run without one,
cells found by name, and the whole-pass window rule."""
import ast
import json
import shutil
import sys
import types
from pathlib import Path

import pytest

from portbench.harness import result, spec, window

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
#: the plain reference and what it reads: numpy and the standard library
REFERENCE = ("reference.py", "memgen.py", "roofline.py")


def _imports(path: Path):
    """Every module an import statement of ``path`` names (relative
    imports as ``.name``)."""
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append("." * node.level + (node.module or ""))
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_nothing_imports_jax_or_the_jax_package(path):
    """Top-level names compared whole: ``repro_torch`` is the port."""
    tops = {n.split(".")[0] for n in _imports(path) if not n.startswith(".")}
    assert not tops & FORBIDDEN


@pytest.mark.parametrize("name", REFERENCE)
def test_reference_imports_nothing_of_the_port(name):
    for mod in _imports(BENCH / "harness" / name):
        top = mod.split(".")[0]
        assert (mod.startswith(".") or top in ("numpy", "__future__")
                or top in sys.stdlib_module_names), mod
        assert mod.lstrip(".") in ("", "reference", "memgen", "roofline") \
            or not mod.startswith("."), mod


def test_forbidden_modules_are_compared_by_whole_top_level_name(monkeypatch):
    import repro_torch  # noqa: F401

    assert "repro" not in result.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake", types.ModuleType("y"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("z"))
    assert {"repro", "jax"} <= set(result.forbidden_modules())


def test_without_a_card_it_exits_and_prints_no_result(monkeypatch, capsys):
    import torch
    from portbench import run

    for key in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR", "USE_FLAX"):
        monkeypatch.setenv(key, "unset")
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(window, "run", pytest.fail)   # never falls back
    rc = run.main(["--workload", "fuzz-4x4-b16384", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err


def _extend(tmp_path: Path) -> Path:
    """A copy of the benchmark with a throwaway configuration, traffic,
    cell and per-layer metric added as new files and new entries."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    data = root / "portbench" / "data" / "cgra-toy"
    data.mkdir()
    for k in ("dotprod", "gsm"):
        shutil.copy(BENCH / "data" / "cgra-4x4" / f"{k}.json", data)
    conf = json.loads((BENCH / "configs" / "cgra-4x4.json").read_text())
    conf.update(name="cgra-toy", kernels=["dotprod", "gsm"],
                data="portbench/data/cgra-toy")
    (root / "portbench" / "configs" / "cgra-toy.json").write_text(
        json.dumps(conf))
    (root / "portbench" / "traffic" / "toy.json").write_text(json.dumps(
        {"memories_per_call": 24, "batch": 16,
         "check_calls": 2}))
    (root / "portbench" / "metrics" / "calls_per_pass.py").write_text(
        "def read(win):\n    return len(win.calls) / win.passes\n")
    bench["configs"].append({"name": "cgra-toy", "source": "x",
                             "file": "portbench/configs/cgra-toy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "toy", "config": "cgra-toy",
                               "traffic": "toy", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "mem_per_s":
            m["workloads"].append("toy")
    bench["per_layer"].append({"name": "calls_per_pass", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "harness", "moves": "mem_per_s",
                               "workloads": ["toy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_a_new_cell_is_found_by_name_with_no_file_edited(tmp_path):
    root = _extend(tmp_path)
    for path in BENCH.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            copy = root / "portbench" / path.relative_to(BENCH)
            assert copy.read_bytes() == path.read_bytes(), path
    cell = spec.load_cell("toy", root)
    assert [d["kernel"] for d in cell.docs] == ["dotprod", "gsm"]
    assert [m["name"] for m in cell.end_to_end] == ["mem_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["calls_per_pass"]
    line, _ = result.run_once(cell, 2 ** 31 + 3, 0.0, False, "cpu")
    assert line["correct"] and set(line["metrics"]) == {"mem_per_s", "setup_s"}
    line, _ = result.run_once(cell, 2 ** 31 + 3, 0.0, True, "cpu")
    assert line["metrics"] == {"calls_per_pass": {"value": 2.0,
                                                  "unit": "calls"}}


class _Clock:
    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


@pytest.mark.parametrize("seconds, passes", [
    (0.0, 1), (1.0, 1), (6.0, 2), (8.9, 2), (9.0, 3), (10.0, 3), (12.0, 4)])
def test_the_window_holds_whole_passes(monkeypatch, seconds, passes):
    """Each call takes 1 s, a pass of three kernels 3 s: a further pass
    starts only where the passes so far say it ends within the seconds,
    and there is always one."""
    clock = _Clock()
    monkeypatch.setattr(window, "time", clock)

    class Client:
        def __init__(self, cell, pool, device):
            self.cell = cell

        def warm(self):
            clock.now += 5.0

        def call(self, i):
            clock.now += 1.0
            doc = self.cell.docs[i]
            return window.Call(kernel=doc["kernel"], index=i, doc=doc,
                               memories=None, launches=[],
                               report=types.SimpleNamespace(memories=8))

    cell = spec.load_cell("fuzz-4x4-b16384")
    cell.docs = cell.docs[:3]
    cell.traffic = dict(cell.traffic, memories_per_call=4)
    win = window.run(cell, 1, seconds, False, "cpu", client=Client)
    assert win.passes == passes
    assert win.window_s == 3.0 * passes and win.setup_s == 5.0
    assert [c.kernel for c in win.calls] == \
        [d["kernel"] for d in cell.docs] * passes
