"""A copy of ``src/repro/sat/__init__.py`` (the port imports nothing of the JAX
package)."""
from .cnf import CNF, And, Or, Not, Var, Formula, Tseitin, TRUE, FALSE
from .cdcl import CDCLSolver, solve_cnf, SAT, UNSAT, UNKNOWN
from .dimacs import read_dimacs, write_dimacs

__all__ = [
    "CNF", "And", "Or", "Not", "Var", "Formula", "Tseitin", "TRUE", "FALSE",
    "CDCLSolver", "solve_cnf", "SAT", "UNSAT", "UNKNOWN",
    "read_dimacs", "write_dimacs",
]
