"""Runs of the benchmark on the card (``-m cuda``); they skip elsewhere."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the benchmark runs on the card)")


def _run(cwd: Path, workload: str, trace: int, seed: int = 2 ** 31 + 41):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", str(seed), "--seconds", "1", "--trace", str(trace)],
        cwd=cwd, capture_output=True, text=True, timeout=600)


@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_is_correct(cuda, trace):
    proc = _run(ROOT, "fuzz-4x4-b16384", trace)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert list(line)[-1] == "checks"
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")
    if trace:
        assert 0 < line["device"]["busy_s"] < line["device"]["window_s"]
        for name, m in line["metrics"].items():
            if name.endswith("roofline"):
                assert 0 < m["value"] <= 105


def test_the_benchmark_alone_does_not_run(cuda, tmp_path):
    """A directory with only ``BENCHMARK.json`` and ``portbench/``."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path, "fuzz-4x4-b16384", 0)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
