"""Mapping result datatypes + an independent validity checker.

The validator deliberately re-derives every legality condition from first
principles (steady-state timing, topology, output-register liveness, register
pressure) without reusing the encoder's candidate machinery, so encoder bugs
cannot self-certify.

A copy of ``src/repro/core/mapping.py`` (the port imports nothing of the JAX
package).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..cgra.arch import MEM_OPS, PEGrid
from ..cgra.isa import MUL_OPS
from .dfg import DFG, Edge
from .schedule import KMS, Slot

# hand-off kinds
OUT = "out"      # γ: one-cycle output-register hand-off
REG = "reg"      # ζ1: same-PE register-file hand-off (needs RA)
HOLD = "hold"    # ζ2: output register held across >1 cycles
FLAGDEP = "flag" # PE-local flag register (BSFA/BZFA)


@dataclass(frozen=True)
class Placement:
    node: int
    pe: int
    slot: Slot


@dataclass
class Mapping:
    dfg: DFG
    grid: PEGrid
    ii: int
    num_folds: int
    placements: Dict[int, Placement]
    handoffs: Dict[Tuple[int, int, int], str] = field(default_factory=dict)
    routing_nodes: int = 0  # heuristic baselines may add move ops

    # -- metrics -----------------------------------------------------------------

    @property
    def utilization(self) -> float:
        """Paper's U: ratio of non-idle PE-slots across the kernel."""
        return len(self.placements) / float(self.ii * self.grid.num_pes)

    def schedule_table(self) -> List[List[Optional[int]]]:
        """rows x PEs table of node ids (kernel window)."""
        table: List[List[Optional[int]]] = [
            [None] * self.grid.num_pes for _ in range(self.ii)]
        for pl in self.placements.values():
            table[pl.slot.c][pl.pe] = pl.node
        return table

    def stage(self, node: int) -> int:
        return self.num_folds - 1 - self.placements[node].slot.it

    def schedule_time(self, node: int) -> int:
        """Time of the node inside one iteration's (padded) schedule."""
        pl = self.placements[node]
        return pl.slot.c + self.stage(node) * self.ii

    # -- serialization -----------------------------------------------------------

    def to_dict(self) -> Dict:
        """JSON-safe dict; handoffs are recomputed on load (derived data)."""
        return {
            "ii": self.ii,
            "num_folds": self.num_folds,
            "placements": [[p.node, p.pe, p.slot.c, p.slot.it]
                           for p in sorted(self.placements.values(),
                                           key=lambda p: p.node)],
            "routing_nodes": self.routing_nodes,
        }

    @classmethod
    def from_dict(cls, dfg: DFG, grid: PEGrid, d: Dict) -> "Mapping":
        placements = {n: Placement(node=n, pe=pe, slot=Slot(c=c, it=it))
                      for n, pe, c, it in d["placements"]}
        mapping = cls(dfg=dfg, grid=grid, ii=d["ii"],
                      num_folds=d["num_folds"], placements=placements,
                      routing_nodes=d.get("routing_nodes", 0))
        for e in dfg.edges:
            if e.src in placements and e.dst in placements:
                mapping.handoffs[(e.src, e.dst, e.distance)] = \
                    classify_handoff(mapping, e)
        return mapping


def classify_handoff(mapping: Mapping, edge: Edge) -> str:
    if edge.kind == "flag":
        return FLAGDEP
    if edge.kind == "colocate":
        return REG
    ps = mapping.placements[edge.src]
    pd = mapping.placements[edge.dst]
    gap = (pd.slot.c - ps.slot.c + mapping.ii) % mapping.ii
    if edge.src == edge.dst or (gap != 1 and ps.pe == pd.pe):
        return REG
    if gap == 1:
        return OUT
    return HOLD


def separation(mapping: Mapping, edge: Edge) -> int:
    ps = mapping.placements[edge.src]
    pd = mapping.placements[edge.dst]
    return ((edge.distance + ps.slot.it - pd.slot.it) * mapping.ii
            + (pd.slot.c - ps.slot.c))


def validate_mapping(mapping: Mapping, kms: Optional[KMS] = None,
                     check_registers: bool = True) -> List[str]:
    """Returns a list of violation strings (empty == valid)."""
    errors: List[str] = []
    dfg, grid, ii = mapping.dfg, mapping.grid, mapping.ii

    # every node placed exactly once, PEs in range
    for n in dfg.node_ids():
        if n not in mapping.placements:
            errors.append(f"node {n} not placed")
    for n, pl in mapping.placements.items():
        if not (0 <= pl.pe < grid.num_pes):
            errors.append(f"node {n} on invalid PE {pl.pe}")
        if not (0 <= pl.slot.c < ii):
            errors.append(f"node {n} at invalid row {pl.slot.c}")
        if not (0 <= pl.slot.it < mapping.num_folds):
            errors.append(f"node {n} with invalid label {pl.slot.it}")
        if kms is not None and pl.slot not in kms.slots.get(n, []):
            errors.append(f"node {n} outside its KMS window: {pl.slot}")

    # C2: PE exclusivity per row
    seen: Dict[Tuple[int, int], int] = {}
    for n, pl in mapping.placements.items():
        key = (pl.pe, pl.slot.c)
        if key in seen:
            errors.append(
                f"PE {pl.pe} row {pl.slot.c}: nodes {seen[key]} and {n}")
        seen[key] = n

    # C4: capability classes + shared-memory-port arbitration (archspec).
    # Re-derived from the grid's capability table — never from the
    # encoder's literal space — so the encoder cannot self-certify.
    caps = grid.caps
    if caps is not None:
        for n in sorted(mapping.placements):
            pl = mapping.placements[n]
            op = dfg.nodes[n].op
            if (op in MEM_OPS and caps.mem_pes is not None
                    and pl.pe not in caps.mem_pes):
                errors.append(
                    f"node {n} ({op}) on PE {pl.pe} without a load-store "
                    f"unit (mem-capable: {sorted(caps.mem_pes)})")
            if (op in MUL_OPS and caps.mul_pes is not None
                    and pl.pe not in caps.mul_pes):
                errors.append(
                    f"node {n} ({op}) on PE {pl.pe} without a multiplier "
                    f"(mul-capable: {sorted(caps.mul_pes)})")
        for label, pes, limit in caps.port_groups:
            for c in range(ii):
                users = sorted(
                    n for n, pl in mapping.placements.items()
                    if pl.pe in pes and pl.slot.c == c
                    and dfg.nodes[n].op in MEM_OPS)
                if len(users) > limit:
                    errors.append(
                        f"port group {label}: {len(users)} memory ops in "
                        f"row {c} exceed {limit} port(s): nodes {users}")

    # C3: per-edge timing + routing legality
    busy_rows: Dict[int, set] = {}
    for n, pl in mapping.placements.items():
        busy_rows.setdefault(pl.pe, set()).add(pl.slot.c)
    for edge in dfg.edges:
        if edge.src not in mapping.placements or edge.dst not in mapping.placements:
            continue
        ps = mapping.placements[edge.src]
        pd = mapping.placements[edge.dst]
        if edge.kind == "colocate":
            # purely spatial: same device, no timing requirement
            if ps.pe != pd.pe:
                errors.append(
                    f"colocate edge {edge.src}->{edge.dst}: PEs differ")
            continue
        s = separation(mapping, edge)
        if edge.src == edge.dst:
            if s < 1:
                errors.append(f"self-edge {edge.src}: separation {s} < 1")
            continue
        if not (1 <= s <= ii):
            errors.append(
                f"edge {edge.src}->{edge.dst} (d={edge.distance}): "
                f"separation {s} outside [1, {ii}]")
            continue
        if edge.kind == "flag":
            if ps.pe != pd.pe:
                errors.append(
                    f"flag edge {edge.src}->{edge.dst}: PEs differ "
                    f"({ps.pe} vs {pd.pe})")
                continue
            for k in range(1, s):
                row = (ps.slot.c + k) % ii
                blocker = seen.get((ps.pe, row))
                if blocker is not None and blocker not in (edge.src, edge.dst):
                    errors.append(
                        f"flag edge {edge.src}->{edge.dst}: node {blocker} "
                        f"clobbers flags at row {row}")
                    break
            continue
        if grid.f_n(ps.pe, pd.pe) == 0:
            errors.append(
                f"edge {edge.src}->{edge.dst}: PEs {ps.pe},{pd.pe} not adjacent")
            continue
        kind = classify_handoff(mapping, edge)
        if kind == HOLD:
            # no other node may execute on the producer PE strictly between
            for k in range(1, s):
                row = (ps.slot.c + k) % ii
                if row in busy_rows.get(ps.pe, set()):
                    blocker = seen.get((ps.pe, row))
                    if blocker not in (edge.src, edge.dst):
                        errors.append(
                            f"edge {edge.src}->{edge.dst}: output register of "
                            f"PE {ps.pe} overwritten by node {blocker} at row "
                            f"{row}")
                        break

    if check_registers and not errors:
        from .regalloc import allocate_registers
        ra = allocate_registers(mapping)
        if not ra.ok:
            errors.append(
                f"register allocation needs {ra.max_colors_used} > "
                f"{grid.spec.num_regs} registers (PE {ra.worst_pe})")
    return errors
