"""The PE grid an artifact was mapped onto, and its neighbour wiring.

Counterpart of ``PEGrid.coords``/``PEGrid.pe_at`` in
``src/repro/cgra/arch.py`` and of ``neighbor_table`` in
``src/repro/cgra/simulator.py``.  PEs are numbered row-major,
``p = r * cols + c``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

#: interconnects the ISA can lower to bitstreams (N/E/S/W selectors only)
TOPOLOGIES = ("torus", "mesh")


@dataclass(frozen=True)
class Grid:
    rows: int
    cols: int
    topology: str = "torus"

    def __post_init__(self) -> None:
        if self.topology not in TOPOLOGIES:
            raise ValueError(f"unknown topology {self.topology!r}; "
                             f"expected one of {TOPOLOGIES}")

    @property
    def num_pes(self) -> int:
        return self.rows * self.cols

    def coords(self, p: int) -> Tuple[int, int]:
        return divmod(p, self.cols)

    def pe_at(self, r: int, c: int) -> int:
        return (r % self.rows) * self.cols + (c % self.cols)


def neighbor_table(grid: Grid) -> Tuple[Tuple[int, int, int, int], ...]:
    """(N, E, S, W) neighbour PE ids per PE.

    Only the torus wraps: on a mesh an edge PE has no neighbour in the
    off-grid direction, so that selector is wired back to the PE itself
    (it reads the PE's own OUT; the assembler never emits such a read).
    """
    wrap = grid.topology == "torus"
    out = []
    for p in range(grid.num_pes):
        r, c = grid.coords(p)
        ids = []
        for dr, dc in ((-1, 0), (0, 1), (1, 0), (0, -1)):   # N, E, S, W
            nr, nc = r + dr, c + dc
            if wrap:
                ids.append(grid.pe_at(nr, nc))
            elif 0 <= nr < grid.rows and 0 <= nc < grid.cols:
                ids.append(nr * grid.cols + nc)
            else:
                ids.append(p)
        out.append(tuple(ids))
    return tuple(out)
