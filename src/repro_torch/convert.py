"""Carry the JAX package's state across to the port.

The JAX package's ``InstrRow``/``PEState``, ``AssembledCIL`` and
``Mapping`` reach the port as numpy arrays and plain dicts, lists and
tuples (the port imports nothing of ``repro``), so both packages can be
fed identical inputs: the port's assembler, for one, can be held against
the JAX assembler on the same mapping without going through either
solver.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from .cgra.arch import PEGrid
from .cgra.bitstream import AssembledCIL
from .core.dfg import DFG
from .core.mapping import Mapping, Placement
from .core.schedule import Slot
from .device import resolve_device
from .kernels.ref import InstrRow, PEState


def _int32(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x, np.int32), device=dev)


def fields_from_numpy(op, dst, sa, sb, imm, device="cuda") -> InstrRow:
    """Instruction fields ((P,) rows or (T, P) programs) as int32 tensors."""
    dev = resolve_device(device)
    return InstrRow(*(_int32(f, dev) for f in (op, dst, sa, sb, imm)))


def state_from_numpy(regs, out, sf, zf, mem, device="cuda") -> PEState:
    """PE-array state (regs (B, P, 4), out/sf/zf (B, P), mem (B, M))."""
    dev = resolve_device(device)
    return PEState(*(_int32(f, dev) for f in (regs, out, sf, zf, mem)))


def artifact_from_parts(
    name: str, ii: int, trip: int, words,
    presets_out: Dict[int, int],
    presets_reg: Dict[Tuple[int, int], int],
    node_of_cell: Dict[Tuple[int, int], Tuple[int, int]],
) -> AssembledCIL:
    """The port's ``AssembledCIL`` from a (T, P) word grid and the preset
    and cell-map dicts of the JAX package's class of that name."""
    bitstream = np.asarray(words, np.uint32)
    return AssembledCIL(
        name=name, ii=int(ii), num_pes=int(bitstream.shape[1]),
        trip=int(trip), bitstream=bitstream,
        presets_out={int(pe): int(v) for pe, v in presets_out.items()},
        presets_reg={(int(pe), int(r)): int(v)
                     for (pe, r), v in presets_reg.items()},
        node_of_cell={(int(t), int(pe)): (int(n), int(j))
                      for (t, pe), (n, j) in node_of_cell.items()})


def mapping_from_parts(
    dfg: DFG, grid: PEGrid, ii: int, num_folds: int,
    placements: Iterable[Tuple[int, int, Tuple[int, int]]],
    handoffs: Dict[Tuple[int, int, int], str],
) -> Mapping:
    """The port's ``Mapping`` of ``dfg`` on ``grid`` from a JAX mapping's
    parts: ``(node, pe, (time, fold))`` placements (its ``Slot`` as
    ``(c, it)``) and the ``(src, dst, distance) -> kind`` hand-offs."""
    return Mapping(
        dfg=dfg, grid=grid, ii=int(ii), num_folds=int(num_folds),
        placements={int(n): Placement(node=int(n), pe=int(pe),
                                      slot=Slot(c=int(c), it=int(it)))
                    for n, pe, (c, it) in placements},
        handoffs={(int(s), int(d), int(k)): str(kind)
                  for (s, d, k), kind in handoffs.items()})
