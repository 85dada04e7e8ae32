"""Data Flow Graph of a Compute-Intensive Loop (paper §3.1).

Nodes are LLVM-IR-level operations; edges are data dependencies.  Loop-carried
dependencies ("back-edges", red in paper Fig. 2c) carry a dependence distance
``>= 1`` (number of loop iterations between producer and consumer); intra-
iteration edges have distance 0.

A copy of ``src/repro/core/dfg.py`` (the port imports nothing of the JAX
package).
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Node:
    """One DFG operation.

    ``op`` is an opcode mnemonic from the target ISA (repro.cgra.isa) or a
    generic placeholder for solver-only experiments.  ``operands`` name the
    producing nodes in position order (may be shorter than 2 when an operand
    is an immediate/live-in); ``imm`` is an optional immediate;
    ``live_in``/``live_out`` mark loop boundary values.
    """

    id: int
    op: str = "op"
    operands: Tuple[int, ...] = ()
    imm: Optional[int] = None
    name: str = ""


@dataclass(frozen=True)
class Edge:
    """src -> dst dependency with loop-carried ``distance`` (0 = same
    iteration).  ``kind``: "data" routes a value (neighbor/register rules);
    "flag" is a BSFA/BZFA flag dependency — consumer must sit on the SAME PE
    as the producer with no other instruction in between (PE-local flag
    register, see repro.cgra.isa)."""

    src: int
    dst: int
    distance: int = 0
    kind: str = "data"

    def __post_init__(self) -> None:
        if self.distance < 0:
            raise ValueError("dependence distance must be >= 0")

    @property
    def is_back(self) -> bool:
        return self.distance >= 1


class DFG:
    """Immutable-ish DFG with forward/backward adjacency."""

    def __init__(self, nodes: Iterable[Node], edges: Iterable[Edge],
                 name: str = "dfg"):
        self.name = name
        self.nodes: Dict[int, Node] = {n.id: n for n in nodes}
        self.edges: List[Edge] = list(edges)
        for e in self.edges:
            if e.src not in self.nodes or e.dst not in self.nodes:
                raise ValueError(f"edge {e} references unknown node")
        self.succs: Dict[int, List[Edge]] = {n: [] for n in self.nodes}
        self.preds: Dict[int, List[Edge]] = {n: [] for n in self.nodes}
        for e in self.edges:
            self.succs[e.src].append(e)
            self.preds[e.dst].append(e)
        self._check_forward_acyclic()
        self._check_flag_edges()

    # -- basic properties ------------------------------------------------------

    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    @property
    def num_edges(self) -> int:
        return len(self.edges)

    def forward_edges(self) -> List[Edge]:
        return [e for e in self.edges if not e.is_back]

    def back_edges(self) -> List[Edge]:
        return [e for e in self.edges if e.is_back]

    def node_ids(self) -> List[int]:
        return sorted(self.nodes)

    # -- graph algorithms -------------------------------------------------------

    def topo_order(self) -> List[int]:
        """Topological order of the forward (distance-0) subgraph."""
        indeg = {n: 0 for n in self.nodes}
        for e in self.forward_edges():
            indeg[e.dst] += 1
        frontier = sorted(n for n, d in indeg.items() if d == 0)
        order: List[int] = []
        while frontier:
            n = frontier.pop()
            order.append(n)
            for e in self.succs[n]:
                if e.is_back:
                    continue
                indeg[e.dst] -= 1
                if indeg[e.dst] == 0:
                    frontier.append(e.dst)
        if len(order) != len(self.nodes):
            raise ValueError("forward subgraph has a cycle (missing distance?)")
        return order

    def _check_forward_acyclic(self) -> None:
        self.topo_order()

    def _check_flag_edges(self) -> None:
        """The PE-local flag register holds one producer's result: a BSFA/
        BZFA consumer with two flag producers is unmappable by construction
        — reject it here so front-ends fail at build, not at solve."""
        for n, preds in self.preds.items():
            flags = [e.src for e in preds if e.kind == "flag"]
            if len(flags) > 1:
                raise ValueError(
                    f"node {n} has {len(flags)} flag producers {flags}; "
                    "the PE flag register admits exactly one")

    def flag_producer(self, n: int) -> Optional[int]:
        """The single flag producer feeding ``n``, or None."""
        for e in self.preds[n]:
            if e.kind == "flag":
                return e.src
        return None

    def op_histogram(self) -> Dict[str, int]:
        """Opcode -> node count (front-end reporting / diagnostics)."""
        return dict(Counter(node.op for node in self.nodes.values()))

    # -- serialization (repro.serve ships bare DFGs over the wire) ---------------

    def to_dict(self) -> Dict:
        """Plain-JSON form; inverse of :meth:`from_dict`.  Adjacency and
        flag/acyclicity validation are rebuilt on load (derived data)."""
        return {
            "name": self.name,
            "nodes": [[n.id, n.op, list(n.operands), n.imm, n.name]
                      for n in (self.nodes[i] for i in self.node_ids())],
            "edges": [[e.src, e.dst, e.distance, e.kind]
                      for e in self.edges],
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "DFG":
        nodes = [Node(int(i), op=op, operands=tuple(operands), imm=imm,
                      name=name)
                 for (i, op, operands, imm, name) in d["nodes"]]
        edges = [Edge(int(s), int(t), int(dist), kind)
                 for (s, t, dist, kind) in d["edges"]]
        return cls(nodes, edges, name=d.get("name", "dfg"))

    # -- convenience constructors ------------------------------------------------

    @staticmethod
    def from_edge_list(n: int, fwd: Sequence[Tuple[int, int]],
                       back: Sequence[Tuple[int, int]] = (),
                       name: str = "dfg",
                       ops: Optional[Dict[int, str]] = None) -> "DFG":
        ops = ops or {}
        nodes = [Node(i, op=ops.get(i, "op")) for i in range(1, n + 1)]
        edges = [Edge(s, d, 0) for (s, d) in fwd]
        edges += [Edge(s, d, 1) for (s, d) in back]
        return DFG(nodes, edges, name=name)

    def to_dot(self) -> str:
        lines = [f'digraph "{self.name}" {{']
        for n in self.node_ids():
            node = self.nodes[n]
            label = f"{n}:{node.op}" if node.op != "op" else str(n)
            lines.append(f'  n{n} [label="{label}"];')
        for e in self.edges:
            style = ' [color=red,style=dashed]' if e.is_back else ""
            lines.append(f"  n{e.src} -> n{e.dst}{style};")
        lines.append("}")
        return "\n".join(lines)


def running_example() -> DFG:
    """The paper's running example (Fig. 2c / Tables 1-2).

    The exact edge list is not printed in the paper; this reconstruction is
    chosen so that ASAP/ALAP/MS reproduce Table 1 *exactly* (verified in
    tests/test_core_schedule.py) and RecII = 2, mII = 3 as computed in §4.1.
    """
    fwd = [(3, 5), (5, 6), (6, 8), (4, 7), (7, 8), (1, 10), (10, 11),
           (2, 9), (8, 9)]
    back = [(11, 10), (9, 2)]
    return DFG.from_edge_list(11, fwd, back, name="running-example")
