"""Bitstream generation: Mapping + CIL program -> per-PE control words.

Produces the modulo-scheduled instruction streams (prologue / kernel /
epilogue, paper Fig. 3a) plus the register/output presets that seed
loop-carried values for iteration 0.  Operand sources are resolved from the
mapping's hand-off classification: γ/ζ2 -> neighbor (or own) output register,
ζ1 -> register-file slot assigned by register allocation.

A copy of ``src/repro/cgra/bitstream.py`` whose ``AssembledCIL`` is the
port's one assembled-program class: it stores the words and decodes
``rows`` from them on first use, so a copy with other words
(``dataclasses.replace(asm, bitstream=words)``, as
``fuzz.triage.inject_fault`` makes one) never carries the rows of the
original.  The prologue / kernel / epilogue split is derived from the
rows, II and trip count, which is all the assembler split them by.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.mapping import FLAGDEP, Mapping, OUT, HOLD, REG, classify_handoff
from ..core.regalloc import allocate_registers
from .arch import PEGrid
from .isa import (DST_NONE, OPS, Instr, NOP, SRC_E, SRC_IMM, SRC_N, SRC_OWN,
                  SRC_S, SRC_W, SRC_ZERO, decode_program, encode_program)
from .programs import Carry, LoopBuilder, Val


class PrologueClobber(ValueError):
    """A carry's OUT preset is overwritten before its first read.

    Carries (node, pe, slot) triples for a CEGAR blocking clause: the mapper
    re-solves with this placement combination forbidden (repro.core.mapper).
    """

    def __init__(self, msg, triples):
        super().__init__(msg)
        self.triples = triples


@dataclass
class AssembledCIL:
    name: str
    ii: int
    num_pes: int
    trip: int
    bitstream: np.ndarray                    # (T, P) uint32, fully unrolled
    presets_out: Dict[int, int]              # pe -> initial OUT value
    presets_reg: Dict[Tuple[int, int], int]  # (pe, reg) -> initial value
    node_of_cell: Dict[Tuple[int, int], Tuple[int, int]]  # (t, pe) -> (node, iter)

    def words(self) -> np.ndarray:
        return self.bitstream

    def kernel_words(self) -> np.ndarray:
        return encode_program(self.kernel)

    @cached_property
    def rows(self) -> List[List[Instr]]:
        """The decoded instruction grid, rows x PEs."""
        return decode_program(self.bitstream)

    @property
    def total_rows(self) -> int:
        return int(self.bitstream.shape[0])

    def _steady(self) -> Optional[Tuple[int, int]]:
        """(first steady-state row, first epilogue row), or None when the
        loop is too short for a steady state.  The unrolled schedule has
        ``(trip - 1) * ii + span`` rows, ``span`` the rows one iteration
        covers; steady state starts at ``span`` rounded up to II."""
        total, ii = self.total_rows, self.ii
        steady_start = total - (self.trip - 1) * ii
        steady_start += (-steady_start) % ii
        if self.trip * ii <= steady_start + ii:
            return None
        return steady_start, steady_start + ii * max(
            0, (total - steady_start) // ii - 1)

    @property
    def prologue(self) -> List[List[Instr]]:
        steady = self._steady()
        return self.rows if steady is None else self.rows[:steady[0]]

    @property
    def kernel(self) -> List[List[Instr]]:
        """The II rows of steady state."""
        steady = self._steady()
        return ([] if steady is None
                else self.rows[steady[0]:steady[0] + self.ii])

    @property
    def epilogue(self) -> List[List[Instr]]:
        steady = self._steady()
        return [] if steady is None else self.rows[steady[1]:]

    def op_counts(self) -> Dict[str, int]:
        """Executed-op histogram over the unrolled schedule (NOPs included)
        — the dynamic-energy input for ``repro_torch.cgra.energy``."""
        ops, counts = np.unique((self.bitstream >> 27) & 0x1F,
                                return_counts=True)
        return {OPS[int(o)]: int(c) for o, c in zip(ops, counts)}


def _direction(grid: PEGrid, me: int, neighbor: int) -> int:
    """Source selector for reading ``neighbor``'s OUT from PE ``me``."""
    if me == neighbor:
        return SRC_OWN
    r, c = grid.coords(me)
    rows, cols = grid.spec.rows, grid.spec.cols
    if grid.pe_at(r - 1, c) == neighbor:
        return SRC_N
    if grid.pe_at(r + 1, c) == neighbor:
        return SRC_S
    if grid.pe_at(r, c + 1) == neighbor:
        return SRC_E
    if grid.pe_at(r, c - 1) == neighbor:
        return SRC_W
    raise ValueError(f"PE {neighbor} is not adjacent to {me}")


def assemble(program: LoopBuilder, mapping: Mapping) -> AssembledCIL:
    dfg = mapping.dfg
    grid = mapping.grid
    ii = mapping.ii
    ra = allocate_registers(mapping)
    if not ra.ok:
        raise ValueError("register allocation failed; cannot assemble")

    # per-node register-file destination (for ζ1-consumed values)
    reg_of: Dict[int, int] = dict(ra.colors)

    handoff: Dict[Tuple[int, int, int], str] = {}
    for e in dfg.edges:
        handoff[(e.src, e.dst, e.distance)] = classify_handoff(mapping, e)

    def source_for(consumer: int, operand) -> Tuple[int, Optional[int]]:
        """Returns (src_selector, producer node or None)."""
        if operand is None:
            return SRC_IMM, None  # resolved by caller (imm or zero)
        if isinstance(operand, int):
            return (SRC_ZERO if operand == 0 else SRC_IMM), None
        producer = operand.node if isinstance(operand, Val) else operand.update
        dist = 1 if isinstance(operand, Carry) else 0
        kind = handoff[(producer, consumer, dist)]
        p_c = mapping.placements[consumer].pe
        p_p = mapping.placements[producer].pe
        if kind == REG:
            return reg_of[producer], producer     # register-file slot 0..3
        return _direction(grid, p_c, p_p), producer

    # -- build one Instr per node ------------------------------------------------

    instr_of: Dict[int, Instr] = {}
    for n in dfg.node_ids():
        node = dfg.nodes[n]
        a, b = program.node_srcs[n]
        imm = program.node_imm[n]
        sa, _ = source_for(n, a)
        sb, _ = source_for(n, b)
        if a is None and imm == 0:
            sa = SRC_ZERO
        if b is None and imm == 0:
            sb = SRC_ZERO
        if a is None and node.op in ("LWI", "SWI"):
            sa = SRC_ZERO  # address = 0 + imm
        if isinstance(a, int) and a != 0 and a != imm:
            raise ValueError(f"node {n}: literal {a} != imm {imm}")
        if isinstance(b, int) and b != 0 and b != imm:
            raise ValueError(f"node {n}: literal {b} != imm {imm}")
        dst = reg_of.get(n, DST_NONE)
        instr_of[n] = Instr(op=node.op, dst=dst, src_a=sa, src_b=sb, imm=imm)

    # -- unrolled schedule ----------------------------------------------------------

    pad = 0
    qs = {n: mapping.schedule_time(n) for n in dfg.node_ids()}
    q_min = min(qs.values())
    q_max = max(qs.values())
    trip = program.trip
    total = (trip - 1) * ii + (q_max - q_min) + 1
    P = grid.num_pes
    rows: List[List[Instr]] = [[NOP] * P for _ in range(total)]
    node_of_cell: Dict[Tuple[int, int], Tuple[int, int]] = {}
    for j in range(trip):
        for n, q in qs.items():
            t = j * ii + (q - q_min)
            pe = mapping.placements[n].pe
            if rows[t][pe] is not NOP:
                raise ValueError(f"slot clash at t={t} pe={pe}")
            rows[t][pe] = instr_of[n]
            node_of_cell[(t, pe)] = (n, j)

    # -- presets for loop-carried values at iteration 0 -------------------------------

    presets_out: Dict[int, int] = {}
    presets_reg: Dict[Tuple[int, int], int] = {}
    for c in program.carries:
        producer = c.update
        pe = mapping.placements[producer].pe
        if producer in reg_of:
            presets_reg[(pe, reg_of[producer])] = c.init
        presets_out[pe] = c.init
        # clobber check: another node writing pe's OUT before the first
        # consumer read would corrupt the preset
        first_write = qs[producer] - q_min
        for e in dfg.succs[producer]:
            if e.distance == 0 or e.kind == "flag":
                continue
            if handoff[(producer, e.dst, e.distance)] == REG:
                continue
            first_read = qs[e.dst] - q_min
            for (t, p), (n, j) in node_of_cell.items():
                if p == pe and n != producer and t < min(first_read,
                                                         first_write):
                    triples = [
                        (producer, pe, mapping.placements[producer].slot),
                        (e.dst, mapping.placements[e.dst].pe,
                         mapping.placements[e.dst].slot),
                        (n, pe, mapping.placements[n].slot),
                    ]
                    raise PrologueClobber(
                        f"prologue clobber: node {n} writes PE {pe} OUT at "
                        f"t={t} before carry '{c.name}' is first read",
                        triples)

    return AssembledCIL(
        name=program.name, ii=ii, num_pes=P, trip=trip,
        bitstream=encode_program(rows),
        presets_out=presets_out, presets_reg=presets_reg,
        node_of_cell=node_of_cell)
