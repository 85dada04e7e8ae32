"""The CIL program of a mapped kernel, rebuilt from its artifact, and the
serial Python oracle that replays it.

Counterpart of ``LoopBuilder`` in ``src/repro/cgra/programs.py``: the
operand classes, ``run_oracle``/``last_iteration_values`` and the
interpreter are copies of that file's.  The node order is not recomputed:
the artifact stores ``repro.core.dfg.DFG.topo_order()`` as it was, because
loads and stores that no edge orders make memory results depend on it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

from .isa import alu_semantics


@dataclass(frozen=True)
class Val:
    node: int


@dataclass
class Carry:
    name: str
    init: int
    update: Optional[int] = None   # producing node id


Operand = Union[Val, Carry, int, None]


@dataclass
class Program:
    """A loop body: per-node op, operands and immediate, flag producers,
    loop-carried values, named results and the per-iteration node order."""

    name: str
    trip: int
    ops: Dict[int, str]
    node_srcs: Dict[int, Tuple[Operand, Operand]]
    node_imm: Dict[int, int]
    flag_deps: Dict[int, int]        # consumer -> flag producer
    carries: List[Carry]
    result_nodes: Dict[str, int]
    order: List[int]                 # DFG.topo_order() as exported

    @classmethod
    def from_dict(cls, doc: Dict) -> "Program":
        carries = [Carry(c["name"], c["init"], c["update"])
                   for c in doc["carries"]]
        by_name = {c.name: c for c in carries}

        def operand(tagged) -> Operand:
            kind, value = tagged
            if kind == "none":
                return None
            if kind == "int":
                return int(value)
            if kind == "val":
                return Val(int(value))
            if kind == "carry":
                return by_name[value]
            raise ValueError(f"unknown operand kind {kind!r}")

        nodes = doc["nodes"]
        return cls(
            name=doc["name"],
            trip=int(doc["trip"]),
            ops={n["id"]: n["op"] for n in nodes},
            node_srcs={n["id"]: (operand(n["a"]), operand(n["b"]))
                       for n in nodes},
            node_imm={n["id"]: int(n["imm"]) for n in nodes},
            flag_deps={n["id"]: n["flag_dep"] for n in nodes
                       if n["flag_dep"] is not None},
            carries=carries,
            result_nodes=dict(doc["result_nodes"]),
            order=list(doc["topo_order"]),
        )

    # -- oracle -------------------------------------------------------------

    def run_oracle(self, mem: List[int]) -> Dict[str, int]:
        """Executes the loop in plain Python; ``mem`` is updated in place."""
        vals = self._interpret(mem)
        return {name: vals[nid] for name, nid in self.result_nodes.items()}

    def last_iteration_values(self, mem: List[int]) -> Dict[int, int]:
        """Every node's value during the final iteration."""
        return self._interpret(mem)

    def _interpret(self, mem: List[int]) -> Dict[int, int]:
        carry_vals = {c.update: c.init for c in self.carries}
        vals: Dict[int, int] = {}
        for _ in range(self.trip):
            vals = {}
            flags: Dict[int, Tuple[bool, bool]] = {}
            for nid in self.order:
                a, b = self.node_srcs[nid]
                imm = self.node_imm[nid]
                op = self.ops[nid]

                def fetch(operand, use_imm):
                    if operand is None:
                        return imm if use_imm else 0
                    if isinstance(operand, int):
                        return operand
                    if isinstance(operand, Val):
                        return vals[operand.node]
                    return carry_vals[operand.update]

                # an absent first operand reads the immediate, except for
                # LWI/SWI, whose address is 0 + imm
                av = fetch(a, a is None and op not in ("LWI", "SWI"))
                bv = fetch(b, b is None)
                if op in ("LWI", "LWD"):
                    out = mem[av + (imm if op == "LWI" else 0)]
                elif op in ("SWI", "SWD"):
                    mem[av + (imm if op == "SWI" else 0)] = bv
                    out = bv
                elif op in ("BSFA", "BZFA"):
                    sign, zero = flags[self.flag_deps[nid]]
                    out = av if (sign if op == "BSFA" else zero) else bv
                else:
                    out = alu_semantics(op, av, bv)
                vals[nid] = out
                flags[nid] = (out < 0, out == 0)
            for c in self.carries:
                carry_vals[c.update] = vals[c.update]
        return vals
