"""Mapped-kernel artifacts: the assembled bitstream of one kernel on one
grid, with the CIL program its oracle replays.

``AssembledCIL`` is the counterpart of ``src/repro/cgra/bitstream.py``'s
class of that name.  It keeps the words and decodes ``rows`` from them on
first use, so a copy with other words (``dataclasses.replace(asm,
bitstream=words)``, as ``fuzz.triage.inject_fault`` makes one) never
carries the rows of the original.  An
artifact is a JSON file under ``repro_torch/artifacts/<arch>/<kernel>.json``
exported from the JAX package's mapper and assembler (see
``tests/test_torch_artifacts.py``); the port executes it and never maps.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from functools import cached_property
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from .arch import Grid
from .isa import OPS, Instr, decode_program
from .program import Program

ARTIFACT_ROOT = Path(__file__).resolve().parents[1] / "artifacts"


@dataclass
class AssembledCIL:
    name: str
    ii: int
    num_pes: int
    trip: int
    bitstream: np.ndarray                    # (T, P) uint32
    presets_out: Dict[int, int]              # pe -> initial OUT value
    presets_reg: Dict[Tuple[int, int], int]  # (pe, reg) -> initial value
    node_of_cell: Dict[Tuple[int, int], Tuple[int, int]]  # (t, pe) -> (node, iter)

    def words(self) -> np.ndarray:
        return self.bitstream

    @cached_property
    def rows(self) -> List[List[Instr]]:
        """The decoded instruction grid, rows x PEs."""
        return decode_program(self.bitstream)

    @property
    def total_rows(self) -> int:
        return int(self.bitstream.shape[0])

    def op_counts(self) -> Dict[str, int]:
        """Executed-op histogram over the unrolled schedule (NOPs included)."""
        ops, counts = np.unique((self.bitstream >> 27) & 0x1F,
                                return_counts=True)
        return {OPS[int(o)]: int(c) for o, c in zip(ops, counts)}


@dataclass
class Artifact:
    kernel: str
    arch: str
    grid: Grid
    asm: AssembledCIL
    program: Program
    regions: Tuple[Tuple[int, int, int, int], ...]  # (base, length, lo, hi)
    wide_product: bool               # the program contains FXPMUL

    @classmethod
    def from_dict(cls, doc: Dict) -> "Artifact":
        if doc.get("format") != 1:
            raise ValueError(f"unsupported artifact format {doc.get('format')!r}")
        asm = AssembledCIL(
            name=doc["kernel"], ii=int(doc["ii"]),
            num_pes=int(doc["num_pes"]), trip=int(doc["trip"]),
            bitstream=np.asarray(doc["words"], np.uint32),
            presets_out={pe: v for pe, v in doc["presets_out"]},
            presets_reg={(pe, reg): v for pe, reg, v in doc["presets_reg"]},
            node_of_cell={(t, pe): (n, j)
                          for t, pe, n, j in doc["node_of_cell"]})
        return cls(kernel=doc["kernel"], arch=doc["arch"],
                   grid=Grid(doc["rows"], doc["cols"], doc["topology"]),
                   asm=asm, program=Program.from_dict(doc["program"]),
                   regions=tuple(tuple(r) for r in doc["regions"]),
                   wide_product=bool(doc["wide_product"]))


def artifact_names(arch: str) -> List[str]:
    """Kernels shipped for ``arch``, sorted."""
    return sorted(p.stem for p in (ARTIFACT_ROOT / arch).glob("*.json"))


def load_artifact(arch: str, kernel: str) -> Artifact:
    path = ARTIFACT_ROOT / arch / f"{kernel}.json"
    if not path.is_file():
        raise KeyError(f"no artifact for {kernel!r} on {arch!r}; shipped: "
                       f"{artifact_names(arch)}")
    return Artifact.from_dict(json.loads(path.read_text()))
