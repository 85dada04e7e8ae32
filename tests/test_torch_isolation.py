"""repro_torch stands alone: no file of the port imports ``jax`` or
``repro``, the package maps (also through the cache, the compile fleet, a
two-worker race, a two-point sweep and the heuristic baseline), runs,
co-simulates a traced kernel and reports on its own trace with both
blocked, and an entry point asked for the card on a host without one
raises instead of using the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch",
                            reason="optional extra: pip install .[torch]")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "repro")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_port_file_imports_jax_or_repro(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"


def test_port_runs_with_jax_and_repro_blocked(tmp_path):
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "from repro_torch.cgra.artifact import load_artifact\n"
        "from repro_torch.cgra.simulator import simulate, verify\n"
        "from repro_torch.fuzz.corpus import make_corpus\n"
        "import repro_torch.convert, repro_torch.fuzz.cli\n"
        "art = load_artifact('4x4', 'bitcount')\n"
        "mem = make_corpus(art, 1)[0]\n"
        "sim = simulate(art, mem, device='cpu')\n"
        "assert verify(art, mem, device='cpu') == []\n"
        "from repro_torch.toolchain import Toolchain\n"
        "tc = Toolchain('4x4')\n"
        "prog = tc.program('bitcount')\n"
        "res = tc.map(prog)\n"
        "assert res.status == 'mapped'\n"
        "assert verify(prog.builder, res.mapping, mem, device='cpu') == []\n"
        "assert tc.simulate(prog, res.mapping, mem, device='cpu')"
        ".total_rows == sim.total_rows\n"
        "from repro_torch.frontend import TRACED_KERNELS, cosimulate\n"
        "rep = cosimulate(TRACED_KERNELS['dotprod'], seeds=2, device='cpu')\n"
        "assert rep.status == 'ok', rep\n"
        "from repro_torch.core import MapperConfig\n"
        "rows = Toolchain('2x2', cache=sys.argv[1]).compile_many(\n"
        "    ['bitcount', 'reversebits'], jobs=2)\n"
        "assert all(r.ok and r.failure is None for r in rows), rows\n"
        "race = Toolchain('2x2', MapperConfig(\n"
        "    strategy='portfolio:cdcl-seq+cdcl-pair')).map('gsm', jobs=2)\n"
        "assert race.status == 'mapped' and race.strategies_raced >= 2\n"
        "from repro_torch.obs import trace as obs_trace\n"
        "from repro_torch.obs.report import attribution, load, validate\n"
        "from repro_torch.dse import SweepConfig, run_sweep\n"
        "obs_trace.enable(sys.argv[1] + '-trace')\n"
        "doc = run_sweep(SweepConfig(\n"
        "    kernels=('bitcount',), sizes=((2, 2), (2, 3)), backend='cdcl',\n"
        "    jobs=2, cache_dir=sys.argv[1] + '-sweep'))\n"
        "obs_trace.disable()\n"
        "assert [r['status'] for r in doc['points']] == ['mapped'] * 2, doc\n"
        "records = load(sys.argv[1] + '-trace')\n"
        "assert validate(records) == []\n"
        "assert attribution(records)['spans'] > 0\n"
        "from repro_torch.cgra.arch import make_grid\n"
        "from repro_torch.core import HeuristicConfig, map_dfg_heuristic\n"
        "heur = map_dfg_heuristic(prog.dfg, make_grid(4, 4), HeuristicConfig())\n"
        "assert heur.status == 'mapped', heur\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok', sim.total_rows)\n")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path / "c")],
                          capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok ")


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.cgra.artifact import load_artifact
    from repro_torch.cgra.simulator import simulate, verify
    from repro_torch.fuzz.engine import fuzz_kernel, fuzz_program
    from repro_torch.kernels.ops import decode_fields

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    art = load_artifact("4x4", "bitcount")
    mem = [0] * 128
    calls = [lambda: simulate(art, mem), lambda: verify(art, mem),
             lambda: fuzz_program(art, [mem]),
             lambda: fuzz_kernel("bitcount", memories=2),
             lambda: decode_fields(art.asm.words())]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Alone in a directory, on a host without CUDA, it prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(lone)], capture_output=True,
                          text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
