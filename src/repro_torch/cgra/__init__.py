"""CGRA side of the port: ISA, grid, CIL program, artifacts, simulate/verify."""
