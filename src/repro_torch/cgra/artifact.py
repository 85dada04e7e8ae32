"""Mapped-kernel artifacts: the assembled bitstream of one kernel on one
grid, with the CIL program its oracle replays.

An artifact is what a CGRA compiler hands to the hardware.  It is either
the in-memory result of a fresh mapping (:meth:`Artifact.from_mapping`,
after the port's own mapper and assembler) or a JSON file under
``repro_torch/artifacts/<arch>/<kernel>.json``; :meth:`Artifact.to_dict`
and :meth:`Artifact.from_dict` convert between the two, and the shipped
files are what the port's mapper reproduces key for key
(``tests/test_torch_mapper.py``).
"""
from __future__ import annotations

import functools
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from .arch import Grid, PEGrid
from .bitstream import AssembledCIL, assemble
from .programs import LoopBuilder
from .registry import DEFAULT_SUITE

ARTIFACT_ROOT = Path(__file__).resolve().parents[1] / "artifacts"
#: words of a memory image where an artifact does not say
MEM_WORDS = DEFAULT_SUITE.mem_words

@dataclass
class Artifact:
    kernel: str
    arch: str
    grid: PEGrid
    asm: AssembledCIL
    program: LoopBuilder
    regions: Tuple[Tuple[int, int, int, int], ...]  # (base, length, lo, hi)
    wide_product: bool               # the program contains FXPMUL
    mem_words: int = MEM_WORDS       # words of the kernel's memory image

    @classmethod
    def from_mapping(cls, program: LoopBuilder, mapping,
                     arch: Optional[str] = None) -> "Artifact":
        """The artifact of a fresh mapping of ``program``: its assembled
        words, the corpus regions and image size of the registry kernel of
        that name (none and 128 words for a program the registry does not
        name) and ``arch`` (default ``RxC``)."""
        from ..fuzz.corpus import kernel_regions
        from .registry import get_kernel, is_registered

        grid = mapping.grid
        known = is_registered(program.name)
        regions = (tuple((r.base, r.length, r.lo, r.hi)
                         for r in kernel_regions(program.name))
                   if known else ())
        return cls(kernel=program.name,
                   arch=arch or f"{grid.rows}x{grid.cols}",
                   grid=grid, asm=assemble(program, mapping),
                   program=program, regions=regions,
                   wide_product=any(n.op == "FXPMUL" for n in program.nodes),
                   mem_words=(get_kernel(program.name).mem_words if known
                              else MEM_WORDS))

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
                   asm=asm, program=LoopBuilder.from_dict(doc["program"]),
                   regions=tuple(tuple(r) for r in doc["regions"]),
                   wide_product=bool(doc["wide_product"]),
                   mem_words=int(doc.get("mem_words", MEM_WORDS)))

    @functools.cached_property
    def oracle_table(self):
        """The program compiled for the oracle kernel
        (:func:`repro_torch.kernels.oracle.compile_oracle`), once an
        artifact."""
        from ..kernels.oracle import compile_oracle

        return compile_oracle(self.program)

    def to_dict(self) -> Dict:
        """Inverse of :meth:`from_dict`, keys in the shipped files' order;
        ``mem_words`` last, and only where the image is not 128 words."""
        asm = self.asm
        doc = {
            "format": 1,
            "kernel": self.kernel,
            "arch": self.arch,
            "rows": self.grid.rows,
            "cols": self.grid.cols,
            "topology": self.grid.topology,
            "ii": asm.ii,
            "trip": asm.trip,
            "num_pes": asm.num_pes,
            "words": asm.words().astype(int).tolist(),
            "presets_out": [[pe, v] for pe, v in asm.presets_out.items()],
            "presets_reg": [[pe, reg, v]
                            for (pe, reg), v in asm.presets_reg.items()],
            "node_of_cell": [[t, pe, n, j]
                             for (t, pe), (n, j) in asm.node_of_cell.items()],
            "program": self.program.to_dict(),
            "regions": [list(r) for r in self.regions],
            "wide_product": self.wide_product,
        }
        if self.mem_words != MEM_WORDS:
            doc["mem_words"] = self.mem_words
        return doc


def artifact_names(arch: str) -> List[str]:
    """Kernels shipped for ``arch``, sorted."""
    return sorted(p.stem for p in (ARTIFACT_ROOT / arch).glob("*.json"))


def load_artifact(arch: str, kernel: str) -> Artifact:
    path = ARTIFACT_ROOT / arch / f"{kernel}.json"
    if not path.is_file():
        raise KeyError(f"no artifact for {kernel!r} on {arch!r}; shipped: "
                       f"{artifact_names(arch)}")
    return Artifact.from_dict(json.loads(path.read_text()))
