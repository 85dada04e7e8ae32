"""OpenEdgeCGRA ISA + 32-bit control-word encoding.

A copy of ``src/repro/cgra/isa.py`` (the port imports nothing from the
JAX package).  Word layout (32 bits)::

  [31:27] opcode    [26:24] dst   [23:20] srcA   [19:16] srcB   [15:0] imm

dst:  0-3 = R0..R3 (also always writes the PE output register), 7 = out only
src:  0-3 = R0..R3, 4 = own OUT, 5/6/7/8 = N/E/S/W neighbor OUT,
      9 = IMM, 10 = ZERO
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

OPS: List[str] = [
    "NOP",                                     # 0
    "SADD", "SSUB", "SMUL", "FXPMUL",          # arithmetic
    "SLT", "SRT", "SRA",                       # shifts (left, right, arith)
    "LAND", "LOR", "LXOR", "LNAND", "LNOR", "LXNOR",   # bit-wise
    "BSFA", "BZFA",                            # flag-based selects
    "LWD", "LWI", "SWD", "SWI",                # loads/stores
    "BEQ", "BNE", "BLT", "BGE", "JUMP",        # branches (flag producers)
    "EXIT",                                    # 26
    "MOV",                                     # routing helper (== SADD a, 0)
]
OPCODE: Dict[str, int] = {name: i for i, name in enumerate(OPS)}

# operand source codes
SRC_R0, SRC_R1, SRC_R2, SRC_R3 = 0, 1, 2, 3
SRC_OWN = 4
SRC_N, SRC_E, SRC_S, SRC_W = 5, 6, 7, 8
SRC_IMM = 9
SRC_ZERO = 10
DST_NONE = 7

FXP_FRAC_BITS = 16  # FXPMUL: (a*b) >> 16

IMM_MIN = -(1 << 15)
IMM_MAX = (1 << 15) - 1


def fits_imm(v: int) -> bool:
    """True when ``v`` fits the 16-bit signed immediate field."""
    return IMM_MIN <= v <= IMM_MAX


LOAD_OPS = ("LWD", "LWI")
STORE_OPS = ("SWD", "SWI")
FLAG_SELECT_OPS = ("BSFA", "BZFA")
MUL_OPS = ("SMUL", "FXPMUL")


@dataclass(frozen=True)
class Instr:
    op: str
    dst: int = DST_NONE          # register-file slot or DST_NONE
    src_a: int = SRC_ZERO
    src_b: int = SRC_ZERO
    imm: int = 0

    def encode(self) -> int:
        if self.op not in OPCODE:
            raise ValueError(f"unknown op {self.op}")
        if not fits_imm(self.imm):
            raise ValueError(f"imm {self.imm} out of 16-bit range")
        return ((OPCODE[self.op] << 27) | (self.dst << 24)
                | (self.src_a << 20) | (self.src_b << 16)
                | (self.imm & 0xFFFF))

    @staticmethod
    def decode(word: int) -> "Instr":
        op = OPS[(word >> 27) & 0x1F]
        dst = (word >> 24) & 0x7
        src_a = (word >> 20) & 0xF
        src_b = (word >> 16) & 0xF
        imm = word & 0xFFFF
        if imm >= 1 << 15:
            imm -= 1 << 16
        return Instr(op=op, dst=dst, src_a=src_a, src_b=src_b, imm=imm)


NOP = Instr(op="NOP")


def encode_program(rows: List[List[Instr]]) -> np.ndarray:
    """rows x PEs instruction grid -> uint32 word grid (the bitstream)."""
    return np.array([[i.encode() for i in row] for row in rows],
                    dtype=np.uint32)


def decode_program(words: np.ndarray) -> List[List[Instr]]:
    return [[Instr.decode(int(w)) for w in row] for row in words]


def alu_semantics(op: str, a: int, b: int) -> int:
    """Scalar int32 reference semantics (used by the Python oracle).

    FXPMUL here is the exact product shifted; the executors wrap the
    product to int32 first (see ``repro_torch.kernels.ref``)."""
    m = (1 << 32) - 1

    def s32(x: int) -> int:
        x &= m
        return x - (1 << 32) if x >= (1 << 31) else x

    if op in ("SADD", "MOV"):
        return s32(a + b)
    if op == "SSUB":
        return s32(a - b)
    if op == "SMUL":
        return s32(a * b)
    if op == "FXPMUL":
        return s32((a * b) >> FXP_FRAC_BITS)
    if op == "SLT":
        return s32(a << (b & 31))
    if op == "SRT":
        return s32((a & m) >> (b & 31))
    if op == "SRA":
        return s32(s32(a) >> (b & 31))
    if op == "LAND":
        return s32(a & b)
    if op == "LOR":
        return s32(a | b)
    if op == "LXOR":
        return s32(a ^ b)
    if op == "LNAND":
        return s32(~(a & b))
    if op == "LNOR":
        return s32(~(a | b))
    if op == "LXNOR":
        return s32(~(a ^ b))
    if op in ("BEQ", "BNE", "BLT", "BGE"):
        return s32(a - b)  # flag producers: result is the comparison value
    if op in ("JUMP", "EXIT", "NOP"):
        return 0
    raise ValueError(f"no ALU semantics for {op}")
