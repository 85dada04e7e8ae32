"""Mapped-kernel artifacts shipped with ``repro_torch``: the exporter and
its parity checks against the JAX package's mapper and assembler.

An artifact (``src/repro_torch/artifacts/<arch>/<kernel>.json``) is what
a CGRA compiler hands to the hardware: the assembled bitstream, its
presets and cell map, plus the CIL program the oracle replays.  The port
executes artifacts; it does not map.  Regenerate every artifact with::

    PYTHONPATH=src python tests/test_torch_artifacts.py --write

The tests below hold each committed artifact to what ``repro`` produces
now: the program part to the registry program, and (for every kernel but
fir4, whose 20 s solve is held by the execution parity tests instead) the
bitstream to a fresh map + assemble.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch", reason="optional extra: pip install .[torch]")

from repro.cgra.bitstream import assemble  # noqa: E402
from repro.cgra.programs import Carry, Val  # noqa: E402
from repro.cgra.registry import kernel_program  # noqa: E402
from repro.core.mapper import MapperConfig  # noqa: E402
from repro.fuzz.corpus import kernel_regions, uses_wide_product  # noqa: E402

ARTIFACT_ROOT = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
                 / "artifacts")

#: the kernels ``results/BENCH_fuzz.json`` reports ``ok``, on the arch the
#: fuzz bench lane runs each of them on
#: (``benchmarks/fuzz_throughput.py:KERNEL_ARCHES``)
KERNEL_ARCHES = {
    "reversebits": "4x4", "bitcount": "4x4", "sqrt": "3x3",
    "stringsearch": "4x4", "gsm": "4x4", "dotprod": "4x4", "fir4": "4x4",
    "saxpy": "4x4", "prefix_sum": "4x4", "relu_clamp": "4x4",
    "popcount": "4x4", "stencil3": "4x4", "argmax": "4x4", "sad": "4x4",
    "xorshift32": "4x4", "ema_fxp": "4x4",
}

MAPPER_CONFIG = dict(per_ii_timeout_s=60.0, total_timeout_s=120.0, ii_max=32)

#: the program part of an artifact (everything ``program_dict`` writes)
PROGRAM_KEYS = ("program", "regions", "wide_product")


def _operand(operand):
    if operand is None:
        return ["none", None]
    if isinstance(operand, Val):
        return ["val", operand.node]
    if isinstance(operand, Carry):
        return ["carry", operand.name]
    return ["int", int(operand)]


def program_dict(name: str) -> dict:
    """The registry program of ``name`` plus its corpus layout, as an
    artifact stores them."""
    prog = kernel_program(name)
    names = [c.name for c in prog.carries]
    assert len(set(names)) == len(names), f"{name}: duplicate carry names"
    nodes = []
    for node in prog.nodes:
        a, b = prog.node_srcs[node.id]
        nodes.append({"id": node.id, "op": node.op,
                      "a": _operand(a), "b": _operand(b),
                      "imm": prog.node_imm[node.id],
                      "flag_dep": prog.flag_deps.get(node.id)})
    return {
        "program": {
            "name": prog.name,
            "trip": prog.trip,
            "nodes": nodes,
            "carries": [{"name": c.name, "init": c.init, "update": c.update}
                        for c in prog.carries],
            "result_nodes": dict(prog.result_nodes),
            "topo_order": prog.build_dfg().topo_order(),
        },
        "regions": [[r.base, r.length, r.lo, r.hi]
                    for r in kernel_regions(name)],
        "wide_product": uses_wide_product(name),
    }


def bitstream_dict(name: str, arch: str) -> dict:
    """Map ``name`` on ``arch`` and assemble it: grid, schedule, words,
    presets and the full cell map."""
    from repro.toolchain.session import Toolchain

    tc = Toolchain(arch, MapperConfig(**MAPPER_CONFIG))
    prog = tc.program(name)
    res = tc.map(prog)
    if res.mapping is None:
        raise RuntimeError(f"{name}@{arch}: mapping failed ({res.status})")
    asm = assemble(prog.builder, res.mapping)
    spec = tc.grid.spec
    return {
        "rows": spec.rows,
        "cols": spec.cols,
        "topology": spec.resolved_topology(),
        "ii": asm.ii,
        "trip": asm.trip,
        "num_pes": asm.num_pes,
        "words": asm.words().astype(int).tolist(),
        "presets_out": [[pe, v] for pe, v in asm.presets_out.items()],
        "presets_reg": [[pe, reg, v]
                        for (pe, reg), v in asm.presets_reg.items()],
        "node_of_cell": [[t, pe, n, j]
                         for (t, pe), (n, j) in asm.node_of_cell.items()],
    }


def export(name: str, arch: str) -> dict:
    return {"format": 1, "kernel": name, "arch": arch,
            **bitstream_dict(name, arch), **program_dict(name)}


def dumps(doc: dict) -> str:
    """One top-level key per line, values compact: small, stable diffs."""
    body = ",\n".join(f" {json.dumps(k)}: "
                      f"{json.dumps(v, separators=(',', ':'))}"
                      for k, v in doc.items())
    return "{\n" + body + "\n}\n"


def artifact_path(name: str, arch: str) -> Path:
    return ARTIFACT_ROOT / arch / f"{name}.json"


def committed(name: str) -> dict:
    return json.loads(artifact_path(name, KERNEL_ARCHES[name]).read_text())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="export mapped-kernel artifacts for repro_torch")
    ap.add_argument("--write", action="store_true",
                    help="regenerate every artifact under "
                         "src/repro_torch/artifacts/")
    ap.add_argument("--kernels", default=",".join(KERNEL_ARCHES),
                    help="comma-separated subset (default: all)")
    args = ap.parse_args(argv)
    if not args.write:
        ap.print_help()
        return 2
    for name in args.kernels.split(","):
        arch = KERNEL_ARCHES[name]
        path = artifact_path(name, arch)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(dumps(export(name, arch)))
        print(f"wrote {path}")
    return 0


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


def test_every_artifact_is_shipped_and_named():
    from repro_torch.cgra.artifact import artifact_names

    shipped = {(arch, name) for arch in ("4x4", "3x3")
               for name in artifact_names(arch)}
    assert shipped == {(a, k) for k, a in KERNEL_ARCHES.items()}


@pytest.mark.parametrize("name", sorted(KERNEL_ARCHES))
def test_program_part_matches_registry(name):
    doc = committed(name)
    fresh = program_dict(name)
    for key in PROGRAM_KEYS:
        assert doc[key] == fresh[key], key


@pytest.mark.parametrize("name", sorted(set(KERNEL_ARCHES) - {"fir4"}))
def test_bitstream_matches_fresh_mapping(name):
    doc = committed(name)
    fresh = bitstream_dict(name, KERNEL_ARCHES[name])
    for key, value in fresh.items():
        assert doc[key] == value, key


def test_dumps_round_trips():
    doc = committed("bitcount")
    assert json.loads(dumps(doc)) == doc
    assert dumps(doc) == artifact_path("bitcount", "4x4").read_text()


if __name__ == "__main__":
    sys.exit(main())
