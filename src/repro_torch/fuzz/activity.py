"""Switching-activity harvest from batched PE-array runs, on the trace's
device.

Counterpart of ``src/repro/fuzz/activity.py``, with the same report:

* per-op executed-instance counts (cells x memories; NOPs included, so
  they equal ``AssembledCIL.op_counts() x B``),
* result-bus toggle rates: Hamming distance between consecutive OUT
  values of each PE, per executed op, as a fraction of 32 bits,
* operand-bus toggle rates: the same on the A/B port values each executed
  op latched.

The JAX package replays the routing datapath row by row over the trace
in numpy.  The replay is static, so this module resolves it once per
schedule on the host instead: every value the replay compares (a PE's
previous OUT, a register an op reads, the previous A/B operand) is the
trace at the last *executed* cell before it that wrote it, or a preset,
an immediate or zero, whatever the trace holds.  Each chunk is then one
gather from the trace, an XOR, a popcount and one ``index_add_`` into
per-opcode int64 bins, on the trace's device and whatever T is; the trace
never leaves the device.  All sums are integers, so the report equals
the JAX package's exactly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..cgra.arch import Grid, neighbor_table
from ..cgra.bitstream import AssembledCIL
from ..cgra.isa import OPCODE, OPS, SRC_IMM, SRC_OWN
from ..cgra.simulator import preset_arrays

M32 = (1 << 32) - 1

#: a replayed value: (trace cell t * P + q, or -1 for a constant; constant)
_Source = Tuple[int, int]


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of the low 32 bits of an int64 tensor."""
    x = x & M32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


@dataclass
class ActivityReport:
    """Aggregated switching statistics of one assembled kernel."""

    kernel: str
    memories: int                       # total memories harvested
    cycles: int                         # schedule rows (T)
    op_exec: Dict[str, int]             # op -> executed instances (x mems)
    result_toggle: Dict[str, float]     # op -> mean result toggle rate
    operand_toggle: Dict[str, float]    # op -> mean operand toggle rate

    def to_dict(self) -> Dict:
        return {
            "kernel": self.kernel,
            "memories": self.memories,
            "cycles": self.cycles,
            "op_exec": dict(sorted(self.op_exec.items())),
            "result_toggle": {k: round(v, 6) for k, v in
                              sorted(self.result_toggle.items())},
            "operand_toggle": {k: round(v, 6) for k, v in
                               sorted(self.operand_toggle.items())},
        }


def _replay_pairs(asm: AssembledCIL, grid: Grid
                  ) -> Tuple[List[_Source], List[_Source], List[int]]:
    """The (value, previous value, bin) triples the JAX replay compares,
    over the executed cells of ``asm``'s schedule: (result, previous OUT)
    into bin ``op``, (A, previous A) and (B, previous B) into bin
    ``len(OPS) + op``."""
    P = asm.num_pes
    nbr = neighbor_table(grid)
    out0, regs0 = preset_arrays(asm, P)
    out_src: List[_Source] = [(-1, int(v)) for v in out0]
    reg_src = [[(-1, int(v)) for v in regs0[p]] for p in range(P)]
    a_src: List[_Source] = [(-1, 0)] * P
    b_src: List[_Source] = [(-1, 0)] * P
    lhs: List[_Source] = []
    rhs: List[_Source] = []
    bins: List[int] = []

    def select(sel: int, p: int, imm: int) -> _Source:
        if sel < SRC_OWN:
            return reg_src[p][sel]
        if sel == SRC_OWN:
            return out_src[p]
        if sel < SRC_IMM:
            return out_src[nbr[p][sel - SRC_OWN - 1]]
        return (-1, imm if sel == SRC_IMM else 0)

    for t, row in enumerate(asm.rows):
        ab = [(select(ins.src_a, p, ins.imm), select(ins.src_b, p, ins.imm))
              for p, ins in enumerate(row)]
        for p, ins in enumerate(row):
            if ins.op == "NOP":
                continue
            code, cell = OPCODE[ins.op], (t * P + p, 0)
            a, b = ab[p]
            lhs += [cell, a, b]
            rhs += [out_src[p], a_src[p], b_src[p]]
            bins += [code, len(OPS) + code, len(OPS) + code]
            out_src[p], a_src[p], b_src[p] = cell, a, b
            if ins.dst < 4:
                reg_src[p][ins.dst] = cell
    return lhs, rhs, bins


class _Tables:
    """The replay's index tables on one device."""

    def __init__(self, sources: List[_Source], bins: List[int], P: int,
                 device: torch.device):
        cell = np.array([c for c, _ in sources], np.int64).reshape(-1)
        const = np.array([v for _, v in sources], np.int64).reshape(-1)
        index = dict(device=device, dtype=torch.long)
        self.t = torch.as_tensor(np.maximum(cell, 0) // P, **index)
        self.q = torch.as_tensor(np.maximum(cell, 0) % P, **index)
        self.is_const = torch.as_tensor(cell < 0, device=device)[:, None]
        self.const = torch.as_tensor(const.astype(np.int32),
                                     device=device)[:, None]
        self.bins = torch.as_tensor(np.asarray(bins, np.int64), **index)


class ActivityAccumulator:
    """Streams batched out traces into toggle statistics.

    One accumulator per assembled kernel; call :meth:`update` with each
    chunk's out trace (T, B, P) and read :meth:`report` at the end.  The
    sums stay on the trace's device until :meth:`report`.
    """

    def __init__(self, asm: AssembledCIL, grid: Grid):
        self.asm = asm
        self.T, self.P = asm.total_rows, asm.num_pes
        lhs, rhs, bins = _replay_pairs(asm, grid)
        self._sources, self._bins = lhs + rhs, bins
        ops = (asm.bitstream.astype(np.int64) >> 27) & 0x1F
        self._cells_per_op = np.bincount(ops.ravel(), minlength=len(OPS))
        self._tables: Optional[_Tables] = None
        self._bits: Optional[torch.Tensor] = None  # (2 * len(OPS),) int64
        self._memories = 0

    def update(self, outs: torch.Tensor) -> None:
        """Fold one chunk's int32 out trace (T, B, P) into the statistics,
        on the trace's device."""
        T, B, P = outs.shape
        if (T, P) != (self.T, self.P):
            raise ValueError(
                f"trace shape ({T}, ., {P}) does not match the schedule "
                f"({self.T}, ., {self.P})")
        if outs.dtype != torch.int32:
            raise ValueError(f"trace: expected int32, got {outs.dtype}")
        dev = outs.device
        if self._tables is None or self._tables.t.device != dev:
            self._tables = _Tables(self._sources, self._bins, P, dev)
            self._bits = (torch.zeros(2 * len(OPS), dtype=torch.long,
                                      device=dev) if self._bits is None
                          else self._bits.to(dev))
        tab = self._tables
        vals = torch.where(tab.is_const, tab.const, outs[tab.t, :, tab.q])
        n = vals.shape[0] // 2
        flips = popcount32((vals[:n] ^ vals[n:]).long()).sum(dim=1)
        self._bits.index_add_(0, tab.bins, flips)
        self._memories += B

    def report(self) -> ActivityReport:
        bits = (np.zeros(2 * len(OPS), np.int64) if self._bits is None
                else self._bits.cpu().numpy())
        res_bits, opnd_bits = bits[:len(OPS)], bits[len(OPS):]
        op_exec: Dict[str, int] = {}
        result_toggle: Dict[str, float] = {}
        operand_toggle: Dict[str, float] = {}
        for code, name in enumerate(OPS):
            cells = int(self._cells_per_op[code])
            if cells == 0:
                continue
            instances = cells * self._memories
            op_exec[name] = instances
            if name == "NOP" or instances == 0:
                continue
            result_toggle[name] = float(res_bits[code]) / (32.0 * instances)
            operand_toggle[name] = float(opnd_bits[code]) \
                / (64.0 * instances)
        return ActivityReport(
            kernel=self.asm.name, memories=self._memories, cycles=self.T,
            op_exec=op_exec, result_toggle=result_toggle,
            operand_toggle=operand_toggle)


def harvest_activity(asm: AssembledCIL, grid: Grid,
                     outs: torch.Tensor) -> ActivityReport:
    """One-shot harvest of a single batched run's out trace."""
    acc = ActivityAccumulator(asm, grid)
    acc.update(outs)
    return acc.report()
