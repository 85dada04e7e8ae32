"""Lower a traced SSA graph onto the Table-5 ISA (repro_torch.cgra.isa).

A copy of ``src/repro/frontend/legalize.py``.  The output is the port's
:class:`~repro_torch.cgra.programs.LoopBuilder` — the same form the
hand-written paper benchmarks use — so everything downstream (SAT mapping,
bitstream assembly, the PE-array simulator) works on traced kernels
unchanged, and its ``to_dict()`` equals what the JAX legalizer builds.
Lowering rules:

* binops map 1:1 (``add``→SADD, ``lshr``→SRT, ``ashr``→SRA, ...);
  ``~x`` / ``-x`` arrive pre-decomposed as ``x^-1`` / ``0-x``
* constants that fit the 16-bit signed immediate ride in the consumer's
  ``imm`` slot; wider constants are *materialized* as a constant carry
  (``MOV`` self-loop seeded by the iteration-0 preset), deduplicated by
  value
* a data-dependent ``select`` becomes an SSUB flag producer plus BSFA
  (sign) or BZFA (zero) with a ``flag`` edge — the SAT encoding restricts
  those to same-PE placements with no intervening instruction; the flag
  producer is re-emitted *per select* because the PE-local flag register
  holds only the most recent result
* ``load``/``store`` fold an ``addr = base + const`` into LWI/SWI's
  immediate offset and fall back to LWD/SWD for computed addresses
* loop-carried edges get dependence distance 1 via LoopBuilder carries;
  unwritten carries become loop-invariant constant carries automatically
* with ``LoopSpec.loop_control``, the paper-style exit branch (BNE on the
  induction carry + JUMP) is appended
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

from ..cgra.isa import fits_imm
from ..cgra.programs import Carry, LoopBuilder, Val
from .ir import CMP_OPS, TNode, Trace
from .tracer import LoopSpec, TraceError

# frontend binop -> Table-5 opcode
ISA_BINOP = {
    "add": "SADD",
    "sub": "SSUB",
    "mul": "SMUL",
    "fxpmul": "FXPMUL",
    "and": "LAND",
    "or": "LOR",
    "xor": "LXOR",
    "shl": "SLT",
    "lshr": "SRT",
    "ashr": "SRA",
}

# compare op -> (select opcode, swap data operands)
SELECT_OF = {
    "lt": ("BSFA", False),
    "ge": ("BSFA", True),
    "eq": ("BZFA", False),
    "ne": ("BZFA", True),
}

# descriptor of a lowered operand: a produced value, a loop-carried value,
# or a constant still looking for an immediate slot
_Desc = Tuple[str, Union[Val, Carry, int]]


class LegalizeError(TraceError):
    """The traced graph cannot be expressed in the target ISA."""


def legalize(trace: Trace, spec: Optional[LoopSpec] = None) -> LoopBuilder:
    """Lower ``trace`` to a ready-to-map LoopBuilder program."""
    return _Legalizer(trace, spec).run()


class _Legalizer:
    def __init__(self, trace: Trace, spec: Optional[LoopSpec]):
        self.trace = trace
        self.spec = spec
        self.p = LoopBuilder(trace.name, trace.trip)
        self.carry_of: Dict[int, Carry] = {}
        self.const_pool: Dict[int, Carry] = {}
        self.memo: Dict[int, _Desc] = {}

    # -- operand plumbing -------------------------------------------------------

    def materialize(self, k: int) -> Carry:
        """A constant too wide for an immediate: a carry seeded to ``k``
        whose update is MOV(itself) — worth one PE slot per II."""
        if k not in self.const_pool:
            c = self.p.carry(f"_const_{k & 0xFFFFFFFF:x}", k)
            self.p.set_carry(c, self.p.op("MOV", c))
            self.const_pool[k] = c
        return self.const_pool[k]

    def as_val(self, desc: _Desc) -> Val:
        """Force a descriptor into a produced node (for carry updates)."""
        tag, x = desc
        if tag == "val":
            return x
        if tag == "carry":
            return self.p.op("MOV", x)
        k = x
        if fits_imm(k):
            return self.p.op("LOR", None, None, imm=k)  # imm | imm == imm
        return self.p.op("MOV", self.materialize(k))

    def emit(self, isa_op: str, a: _Desc, b: _Desc,
             flag: Optional[Val] = None) -> Val:
        """Emit one ISA op, placing at most one constant in the immediate
        slot, zeros as the ZERO source, and the rest as materialized
        carries."""
        imm_val: Optional[int] = None

        def place(desc: _Desc):
            nonlocal imm_val
            tag, x = desc
            if tag != "imm":
                return x
            if x == 0:
                return 0  # literal zero -> ZERO operand source
            if imm_val is None and fits_imm(x):
                imm_val = x
                return None
            return self.materialize(x)

        a_op = place(a)
        b_op = place(b)
        return self.p.op(isa_op, a_op, b_op, imm=imm_val, flag=flag)

    # -- node lowering ----------------------------------------------------------

    def lower(self, nid: int) -> _Desc:
        if nid in self.memo:
            return self.memo[nid]
        node = self.trace.node(nid)
        if node.op == "const":
            d: _Desc = ("imm", node.value)
        elif node.op == "carry":
            d = ("carry", self.carry_of[nid])
        elif node.op in ISA_BINOP:
            a = self.lower(node.args[0])
            b = self.lower(node.args[1])
            d = ("val", self.emit(ISA_BINOP[node.op], a, b))
        elif node.op == "select":
            d = ("val", self.lower_select(node))
        elif node.op == "load":
            d = ("val", self.lower_load(node))
        elif node.op in CMP_OPS or node.op == "bconst":
            raise LegalizeError(
                f"comparison node {nid} consumed as data; conditions are "
                "only consumable by where()")
        else:
            raise LegalizeError(f"untranslatable IR op {node.op!r}")
        self.memo[nid] = d
        return d

    def lower_select(self, node: TNode) -> Val:
        cond = self.trace.node(node.args[0])
        if cond.op not in SELECT_OF:
            raise LegalizeError(f"select condition has op {cond.op!r}")
        # fresh flag producer per select: the PE-local flag register holds
        # only the most recent result, so selects cannot share one compare
        diff = self.emit("SSUB", self.lower(cond.args[0]),
                         self.lower(cond.args[1]))
        sel_op, swap = SELECT_OF[cond.op]
        a = self.lower(node.args[1])
        b = self.lower(node.args[2])
        if swap:
            a, b = b, a
        return self.emit(sel_op, a, b, flag=diff)

    def _addr_split(self, addr_id: int) -> Tuple[Optional[_Desc], int]:
        """Decompose an address into (base operand, immediate offset);
        base ``None`` means the offset alone is the address."""
        addr = self.trace.node(addr_id)
        if addr.op == "const":
            if fits_imm(addr.value):
                return None, addr.value
            return ("carry", self.materialize(addr.value)), 0
        if addr.op in ("add", "sub"):
            other = self.trace.node(addr.args[1])
            if other.op == "const":
                k = other.value if addr.op == "add" else -other.value
                if fits_imm(k):
                    return self.lower(addr.args[0]), k
        if addr.op == "add":
            other = self.trace.node(addr.args[0])
            if other.op == "const" and fits_imm(other.value):
                return self.lower(addr.args[1]), other.value
        return self.lower(addr_id), 0

    def lower_load(self, node: TNode) -> Val:
        base, off = self._addr_split(node.args[0])
        if base is not None and base[0] == "imm":  # collapse into the offset
            base, off = None, base[1] + off
        if base is None:
            if not fits_imm(off):
                return self.p.op("LWD", self.materialize(off), None)
            return self.p.op("LWI", None, None, imm=off)  # addr = 0 + imm
        if off:
            return self.p.op("LWI", base[1], None, imm=off)
        return self.p.op("LWD", base[1], None)

    def lower_store(self, node: TNode) -> None:
        base, off = self._addr_split(node.args[0])
        vdesc = self.lower(node.args[1])
        if vdesc[0] == "imm":
            # SWI/SWD immediates address memory; a constant store value
            # needs to be a real operand (zero rides the ZERO source)
            val = 0 if vdesc[1] == 0 else self.materialize(vdesc[1])
        else:
            val = vdesc[1]
        if base is not None and base[0] == "imm":
            base, off = None, base[1] + off
        if base is None:
            if not fits_imm(off):
                self.p.op("SWD", self.materialize(off), val)
            else:
                self.p.op("SWI", None, val, imm=off)
        elif off:
            self.p.op("SWI", base[1], val, imm=off)
        else:
            self.p.op("SWD", base[1], val)

    # -- driver -----------------------------------------------------------------

    def run(self) -> LoopBuilder:
        for cd in self.trace.carries:
            self.carry_of[cd.leaf] = self.p.carry(cd.name, cd.init)
        for sid in self.trace.stores:
            self.lower_store(self.trace.node(sid))
        update_val: Dict[str, Val] = {}
        used_updates = set()
        for cd in self.trace.carries:
            val = self.as_val(self.lower(cd.update))
            if val.node in used_updates:
                # LoopBuilder keys carry state by the producing node, so two
                # carries cannot share one update node; split with a MOV
                val = self.p.op("MOV", val)
            used_updates.add(val.node)
            self.p.set_carry(self.carry_of[cd.leaf], val)
            update_val[cd.name] = val
        if self.spec is not None and self.spec.loop_control:
            idx = self.spec.index
            if idx is None or idx not in update_val:
                raise LegalizeError(
                    "loop_control needs LoopSpec.index naming a carry")
            if not fits_imm(self.trace.trip):
                raise LegalizeError("trip count too large for BNE immediate")
            t = self.p.op("BNE", update_val[idx], None, imm=self.trace.trip)
            self.p.op("JUMP", t)
        by_name = {cd.name: cd for cd in self.trace.carries}
        for name in self.trace.results:
            self.p.result(name, self.carry_of[by_name[name].leaf])
        return self.p
