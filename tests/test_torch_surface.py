"""The port covers the JAX package's surface: for every module of
``repro.kernels``, ``.cgra``, ``.core``, ``.fuzz``, ``.toolchain``,
``.frontend``, ``.obs``, ``.dse``, ``.serve``, ``.sat`` and ``.archspec``,
every public name *defined* there (a function, a class or a top-level
assignment; not a name it imports, such as ``jnp`` or ``np``) is bound in
the ``repro_torch`` module at the same path.  Both trees are read with
``ast``, so no module is imported or run.

The only exceptions are the Pallas launch of the cycle kernel and its
batch tile, which ``repro_torch.kernels.pe_array.cycle_step`` replaces by
design (a hand-written CUDA kernel takes any batch, without tiles).
"""
import ast
from pathlib import Path

import pytest

pytest.importorskip("torch", reason="optional extra: pip install .[torch]")

SRC = Path(__file__).resolve().parents[1] / "src"
PACKAGES = ("kernels", "cgra", "core", "fuzz", "toolchain", "frontend",
            "obs", "dse", "serve", "sat", "archspec")
#: names of the JAX package with no counterpart, by design
REPLACED = {"kernels/pe_array.py": {"B_TILE", "cycle_step_pallas"}}
MODULES = sorted(path.relative_to(SRC / "repro").as_posix()
                 for pkg in PACKAGES
                 for path in (SRC / "repro" / pkg).rglob("*.py"))


def _defined(path: Path):
    """Public names a module defines at top level."""
    names = set()
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for target in targets:
                for leaf in ast.walk(target):
                    if isinstance(leaf, ast.Name):
                        names.add(leaf.id)
    return {n for n in names if not n.startswith("_")}


def _bound(path: Path):
    """Every name a module binds at top level, imported names included."""
    names = _defined(path)
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((alias.asname or alias.name).split(".")[0]
                         for alias in node.names)
        elif isinstance(node, (ast.If, ast.Try)):
            for inner in ast.walk(node):
                if isinstance(inner, (ast.FunctionDef, ast.ClassDef)):
                    names.add(inner.name)
                elif isinstance(inner, ast.Name) and isinstance(
                        inner.ctx, ast.Store):
                    names.add(inner.id)
    return names


def test_every_package_is_scanned():
    assert len(MODULES) > 60
    assert {m.split("/")[0] for m in MODULES} == set(PACKAGES)


@pytest.mark.parametrize("module", MODULES)
def test_public_names_have_port_counterparts(module):
    ref = SRC / "repro" / module
    port = SRC / "repro_torch" / module
    assert port.exists(), f"repro_torch has no {module}"
    missing = _defined(ref) - _bound(port) - REPLACED.get(module, set())
    assert not missing, f"{module}: no counterpart for {sorted(missing)}"


def test_only_the_pallas_launch_is_replaced():
    """The exceptions name what the JAX module defines and the port's
    lacks, and nothing more: ``cycle_step`` stands in their place."""
    for module, names in REPLACED.items():
        assert names <= _defined(SRC / "repro" / module)
        port = _bound(SRC / "repro_torch" / module)
        assert not names & port and "cycle_step" in port
