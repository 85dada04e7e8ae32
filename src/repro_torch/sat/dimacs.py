"""DIMACS CNF I/O — lets the mapper interoperate with external solvers.

A copy of ``src/repro/sat/dimacs.py`` (the port imports nothing of the JAX
package).
"""
from __future__ import annotations

from pathlib import Path
from typing import Union

from .cnf import CNF


def write_dimacs(cnf: CNF, path: Union[str, Path]) -> None:
    path = Path(path)
    with path.open("w") as fh:
        fh.write(f"p cnf {cnf.num_vars} {len(cnf.clauses)}\n")
        for clause in cnf.clauses:
            fh.write(" ".join(str(l) for l in clause) + " 0\n")


def read_dimacs(path: Union[str, Path]) -> CNF:
    cnf = CNF()
    with Path(path).open() as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith(("c", "p", "%")):
                continue
            lits = [int(tok) for tok in line.split()]
            if lits and lits[-1] == 0:
                lits = lits[:-1]
            if lits:
                cnf.add_clause(lits)
    return cnf
