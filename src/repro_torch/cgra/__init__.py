"""CGRA side of the port: ISA, grid, CIL programs and the kernel registry,
the assembler, artifacts, simulate/verify and the latency/energy model."""
from .arch import CGRASpec, Grid, PEGrid, make_grid, neighbor_table

__all__ = ["CGRASpec", "Grid", "PEGrid", "make_grid", "neighbor_table"]
