"""The plain reference of both configurations, in numpy alone.

It reads the frozen mapped-kernel files (``portbench/data/<config>/``) as
JSON and the benchmark's memories, and works out from them, again and on
its own, everything the program derives: the decoded instruction fields,
the presets, the neighbour table, the cycle-by-cycle run of the PE array,
the serial loop of the kernel's CIL program, each memory's verdict and the
switching-activity report.  It imports nothing but numpy and the standard
library: no JAX, nothing of the JAX package, nothing of the port.

Semantics (the paper's Table-5 ISA as the PE array executes it):

* every op is int32 with wrap-around; a non-NOP op writes OUT, the sign
  and zero flags, and register ``dst`` when ``dst < 4``;
* operand selectors 0-3 read R0-R3, 4 the PE's own OUT, 5-8 the OUT of
  its N/E/S/W neighbour, 9 the immediate, 10-15 zero;
* every read sees the state before the cycle; stores land after it;
* a load or store address is ``a`` (+ imm for LWI/SWI) wrapped to int32
  and clamped to the image;
* FXPMUL on the array shifts the int32-wrapped product right by 16, and
  in the CIL program the exact product: the memory generator keeps FXPMUL
  kernels' inputs where the two agree.

``how="float32"`` runs the PE array with its arithmetic ops computed
through float32, which breaks the configurations' guarantee of bit-exact
int32 results: the check's control.  The CIL program always runs exact.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

OPS: Tuple[str, ...] = (
    "NOP", "SADD", "SSUB", "SMUL", "FXPMUL", "SLT", "SRT", "SRA",
    "LAND", "LOR", "LXOR", "LNAND", "LNOR", "LXNOR", "BSFA", "BZFA",
    "LWD", "LWI", "SWD", "SWI", "BEQ", "BNE", "BLT", "BGE", "JUMP",
    "EXIT", "MOV")
OPCODE = {name: i for i, name in enumerate(OPS)}
SRC_OWN, SRC_IMM = 4, 9
FXP_FRAC_BITS = 16

_M32 = (1 << 32) - 1
_POP16 = np.array([bin(i).count("1") for i in range(1 << 16)], np.uint8)


def wrap32(x) -> np.ndarray:
    """Any integer array -> int64 holding the signed 32-bit wrap of it."""
    x = np.asarray(x, np.int64) & _M32
    return x - ((x >> 31) << 32)


def popcount_sum(x: np.ndarray) -> int:
    """Sum of the set bits of the low 32 bits of every element."""
    u = np.asarray(x, np.int64) & _M32
    return int(_POP16[u & 0xFFFF].sum(dtype=np.int64)
               + _POP16[u >> 16].sum(dtype=np.int64))


def neighbours(rows: int, cols: int, topology: str) -> np.ndarray:
    """(P, 4) N/E/S/W neighbour of every PE; off a mesh's edge, itself."""
    table = np.zeros((rows * cols, 4), np.int64)
    for p in range(rows * cols):
        r, c = divmod(p, cols)
        for k, (dr, dc) in enumerate(((-1, 0), (0, 1), (1, 0), (0, -1))):
            nr, nc = r + dr, c + dc
            if topology == "torus":
                table[p, k] = (nr % rows) * cols + nc % cols
            elif 0 <= nr < rows and 0 <= nc < cols:
                table[p, k] = nr * cols + nc
            else:
                table[p, k] = p
    return table


def decode(words) -> Tuple[np.ndarray, ...]:
    """(T, P) 32-bit words -> op, dst, sa, sb, imm, each (T, P) int64."""
    w = np.asarray(words, np.int64) & _M32
    imm = w & 0xFFFF
    imm = np.where(imm >= 1 << 15, imm - (1 << 16), imm)
    return (w >> 27) & 0x1F, (w >> 24) & 0x7, (w >> 20) & 0xF, \
        (w >> 16) & 0xF, imm


def _arith(op: str, a: np.ndarray, b: np.ndarray, how: str) -> np.ndarray:
    """SADD/MOV, SSUB and the branch compares, SMUL, FXPMUL; ``a`` and ``b``
    are int64 arrays holding int32 values.  ``exact`` is the ISA's wrap;
    ``float32`` (the control) rounds operands and result through float32."""
    if how == "float32":
        fa, fb = a.astype(np.float32), b.astype(np.float32)
        if op in ("SADD", "MOV"):
            r = fa + fb
        elif op == "SMUL":
            r = fa * fb
        elif op == "FXPMUL":
            r = np.floor(fa * fb / np.float32(1 << FXP_FRAC_BITS))
        else:
            r = fa - fb
        return wrap32(r.astype(np.float64).astype(np.int64))
    if op in ("SADD", "MOV"):
        return wrap32(a + b)
    if op == "SMUL":
        return wrap32(a * b)
    if op == "FXPMUL":
        return wrap32(a * b) >> FXP_FRAC_BITS
    return wrap32(a - b)


def alu(op: str, a: np.ndarray, b: np.ndarray, sf: np.ndarray,
        zf: np.ndarray, how: str = "exact") -> np.ndarray:
    """One PE's result for ``op`` over a batch (loads and stores aside)."""
    if op in ("SADD", "MOV", "SSUB", "SMUL", "FXPMUL",
              "BEQ", "BNE", "BLT", "BGE"):
        return _arith(op, a, b, how)
    s = b & 31
    if op == "SLT":
        return wrap32(a << s)
    if op == "SRT":
        return wrap32((a & _M32) >> s)
    if op == "SRA":
        return a >> s
    if op == "LAND":
        return a & b
    if op == "LOR":
        return a | b
    if op == "LXOR":
        return a ^ b
    if op == "LNAND":
        return ~(a & b)
    if op == "LNOR":
        return ~(a | b)
    if op == "LXNOR":
        return ~(a ^ b)
    if op == "BSFA":
        return np.where(sf, a, b)
    if op == "BZFA":
        return np.where(zf, a, b)
    return np.zeros_like(a)        # JUMP, EXIT and opcodes past the ISA


@dataclass
class Run:
    """What the reference works out for one kernel over a batch."""

    final_mem: np.ndarray                       # (B, M) int64
    cells: Dict[Tuple[int, int], np.ndarray]    # (node, iteration) -> (B,)
    result_bits: np.ndarray                     # (32,) by opcode
    operand_bits: np.ndarray                    # (32,) by opcode


def simulate(doc: Dict, mems: np.ndarray, how: str = "exact",
             iterations: Optional[Sequence[int]] = None) -> Run:
    """Run the mapped kernel ``doc`` (an artifact's JSON) over ``mems``
    (B, M) cycle by cycle.  ``cells`` holds the OUT value of every cell
    that ``node_of_cell`` names, for the iterations listed (all when
    None)."""
    mems = wrap32(np.asarray(mems))
    B, M = mems.shape
    P = int(doc["rows"]) * int(doc["cols"])
    op, dst, sa, sb, imm = decode(doc["words"])
    T = op.shape[0]
    nbr = neighbours(int(doc["rows"]), int(doc["cols"]), doc["topology"])
    zeros = np.zeros(B, np.int64)
    out = [zeros.copy() for _ in range(P)]
    regs = [[zeros.copy() for _ in range(4)] for _ in range(P)]
    for pe, v in doc["presets_out"]:
        out[pe] = np.full(B, v, np.int64)
    for pe, reg, v in doc["presets_reg"]:
        regs[pe][reg] = np.full(B, v, np.int64)
    sf = [np.zeros(B, bool) for _ in range(P)]
    zf = [np.zeros(B, bool) for _ in range(P)]
    last_a = [zeros for _ in range(P)]
    last_b = [zeros for _ in range(P)]
    mem = mems.copy()
    rows = np.arange(B)
    wanted = None if iterations is None else set(iterations)
    named: Dict[int, List[Tuple[int, int, int]]] = {}
    for t, pe, n, j in doc["node_of_cell"]:
        if wanted is None or j in wanted:
            named.setdefault(t, []).append((pe, n, j))
    res_bits = np.zeros(32, np.int64)        # by opcode, 5 bits
    opnd_bits = np.zeros(32, np.int64)
    cells: Dict[Tuple[int, int], np.ndarray] = {}

    def select(sel: int, p: int, value: int) -> np.ndarray:
        if sel < SRC_OWN:
            return regs[p][sel]
        if sel == SRC_OWN:
            return out[p]
        if sel < SRC_IMM:
            return out[nbr[p, sel - SRC_OWN - 1]]
        return np.full(B, value if sel == SRC_IMM else 0, np.int64)

    for t in range(T):
        live = np.nonzero(op[t])[0]
        results, stores = [], []
        for p in live:
            name = OPS[op[t, p]] if op[t, p] < len(OPS) else "EXIT"
            a = select(int(sa[t, p]), p, int(imm[t, p]))
            b = select(int(sb[t, p]), p, int(imm[t, p]))
            if name in ("LWD", "LWI", "SWD", "SWI"):
                offset = int(imm[t, p]) if name in ("LWI", "SWI") else 0
                addr = np.clip(wrap32(a + offset), 0, M - 1)
                if name in ("LWD", "LWI"):
                    r = mem[rows, addr]
                else:
                    r = b
                    stores.append((addr, b))
            else:
                r = alu(name, a, b, sf[p], zf[p], how)
            code = int(op[t, p])
            res_bits[code] += popcount_sum(r ^ out[p])
            opnd_bits[code] += (popcount_sum(a ^ last_a[p])
                                + popcount_sum(b ^ last_b[p]))
            last_a[p], last_b[p] = a, b
            results.append((p, r))
        for p, r in results:
            out[p] = r
            sf[p], zf[p] = r < 0, r == 0
            if dst[t, p] < 4:
                regs[p][int(dst[t, p])] = r
        for addr, value in stores:
            mem[rows, addr] = value
        for pe, n, j in named.get(t, ()):
            cells[(n, j)] = out[pe]
    return Run(final_mem=mem, cells=cells, result_bits=res_bits,
               operand_bits=opnd_bits)


def interpret(program: Dict, mems: np.ndarray, every_iteration: bool = False
              ) -> Tuple[Dict[Tuple[int, int], np.ndarray], np.ndarray]:
    """The kernel's CIL program (an artifact's ``program`` part), run as a
    serial loop over every memory at once.  Returns ({(node, iteration):
    (B,) value} for the last iteration, or for every one, and the final
    memories).  An address outside the image raises: such a memory is not
    valid traffic."""
    mems = wrap32(np.asarray(mems))
    B, M = mems.shape
    nodes = {n["id"]: n for n in program["nodes"]}
    carries = {c["name"]: c for c in program["carries"]}
    carry_vals = {c["update"]: np.full(B, c["init"], np.int64)
                  for c in program["carries"]}
    trip = int(program["trip"])
    rows = np.arange(B)
    values: Dict[Tuple[int, int], np.ndarray] = {}
    for j in range(trip):
        vals: Dict[int, np.ndarray] = {}
        flags: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        for nid in program["topo_order"]:
            node = nodes[nid]
            name, imm = node["op"], int(node["imm"])

            def fetch(tagged, use_imm: bool) -> np.ndarray:
                kind, value = tagged
                if kind == "none":
                    return np.full(B, imm if use_imm else 0, np.int64)
                if kind == "int":
                    return np.full(B, int(value), np.int64)
                if kind == "val":
                    return vals[int(value)]
                return carry_vals[carries[value]["update"]]

            a = fetch(node["a"], name not in ("LWI", "SWI"))
            b = fetch(node["b"], True)
            if name in ("LWD", "LWI", "SWD", "SWI"):
                addr = a + (imm if name in ("LWI", "SWI") else 0)
                if (addr < 0).any() or (addr >= M).any():
                    raise IndexError(f"{program['name']}: node {nid} ({name}) "
                                     f"address outside [0, {M})")
                if name in ("LWD", "LWI"):
                    r = mems[rows, addr]
                else:
                    r = b.copy()
                    mems[rows, addr] = b
            elif name in ("BSFA", "BZFA"):
                sign, zero = flags[int(node["flag_dep"])]
                r = np.where(sign if name == "BSFA" else zero, a, b)
            elif name == "FXPMUL":
                r = wrap32((a * b) >> FXP_FRAC_BITS)
            else:
                r = alu(name, a, b, None, None)
            vals[nid] = r
            flags[nid] = (r < 0, r == 0)
        for c in program["carries"]:
            carry_vals[c["update"]] = vals[c["update"]]
        if every_iteration or j == trip - 1:
            for nid, v in vals.items():
                values[(nid, j)] = v
    return values, mems


@dataclass
class Verdicts:
    """The reference's answer for one fuzz call: what the program must
    report."""

    failing: List[int]                  # memories whose run disagrees
    activity: Dict                      # the activity report
    memories: int


def activity_report(kernel: str, result_bits: np.ndarray,
                    operand_bits: np.ndarray, cells_per_op: np.ndarray,
                    memories: int, rows: int) -> Dict:
    """The activity report as the program gives it (``ActivityReport.
    to_dict``): executed instances per op (NOP cells too), and toggle rates
    of the result bus and the two operand buses per executed op."""
    op_exec, result_toggle, operand_toggle = {}, {}, {}
    for code, name in enumerate(OPS):
        cells = int(cells_per_op[code])
        if cells == 0:
            continue
        instances = cells * memories
        op_exec[name] = instances
        if name == "NOP" or instances == 0:
            continue
        result_toggle[name] = float(result_bits[code]) / (32.0 * instances)
        operand_toggle[name] = float(operand_bits[code]) / (64.0 * instances)
    return {
        "kernel": kernel, "memories": memories, "cycles": rows,
        "op_exec": dict(sorted(op_exec.items())),
        "result_toggle": {k: round(v, 6) for k, v in
                          sorted(result_toggle.items())},
        "operand_toggle": {k: round(v, 6) for k, v in
                           sorted(operand_toggle.items())},
    }


def fuzz_verdicts(doc: Dict, mems: np.ndarray, how: str = "exact",
                  block: int = 16384) -> Verdicts:
    """The verdict of every memory and the activity report of one fuzz
    call of the mapped kernel ``doc`` over ``mems``, in blocks of
    ``block`` memories.  A memory fails when a last-iteration node value
    or its final image differs from the CIL program's, the contract of the
    program's ``verify``."""
    program_doc = doc["program"]
    trip = int(program_doc["trip"])
    failing: List[int] = []
    res_bits = np.zeros(32, np.int64)
    opnd_bits = np.zeros(32, np.int64)
    cells_per_op = np.bincount(decode(doc["words"])[0].ravel(), minlength=32)
    n = len(mems)
    for lo in range(0, n, block):
        chunk = mems[lo:lo + block]
        run = simulate(doc, chunk, how, iterations=(trip - 1,))
        want, want_mem = interpret(program_doc, chunk)
        bad = (run.final_mem != want_mem).any(axis=1)
        for (nid, j), v in run.cells.items():
            if j == trip - 1 and (nid, j) in want:
                bad |= v != want[(nid, j)]
        failing.extend(lo + int(i) for i in np.nonzero(bad)[0])
        res_bits += run.result_bits
        opnd_bits += run.operand_bits
    return Verdicts(failing=failing, memories=n, activity=activity_report(
        doc["kernel"], res_bits, opnd_bits, cells_per_op, n,
        len(doc["words"])))
