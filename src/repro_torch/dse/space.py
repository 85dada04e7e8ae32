"""Design space for the paper's §6-7 exploration.

A *design point* is one (CIL kernel, architecture) cell of the sweep.
Kernels come from the shared registry (``repro_torch.cgra.registry``), which
covers both the hand-written Table-6 benchmarks and the traced front-end
kernels (``repro_torch.frontend.kernels``) — anything registered sweeps without
edits here.

Two axes are available:

* the classic **size ladder** (:data:`DEFAULT_SIZES`, homogeneous torus
  geometries 2x2 → 6x6) — the paper's own walk;
* the widened **architecture space** (:func:`arch_space`): topology ×
  heterogeneity × size cross products of ``repro_torch.archspec`` compact
  strings, which is what turns the sweep into a genuine design-space
  explorer (border-only load-store units, shared memory ports, ALU-only
  interiors, ...).

The smoke subsets are chosen so CI maps every point in seconds on the
pure-Python CDCL backend with no z3/jax extras.

A copy of ``src/repro/dse/space.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Sequence, Tuple

from ..cgra.registry import kernel_names, kernel_program as _kernel_program

# full ladder (paper §7 sweeps square arrays; the rectangles probe the
# per-column memory-port arbitration between them)
DEFAULT_SIZES: Tuple[Tuple[int, int], ...] = (
    (2, 2), (2, 3), (3, 3), (3, 4), (4, 4), (5, 5), (6, 6))
DEFAULT_KERNELS: Tuple[str, ...] = tuple(kernel_names())

# CI smoke: 4 kernels × 3 sizes, each point sub-second under CDCL with no
# extras; gsm@2x2 keeps a CEGAR-active point and sqrt@2x2 an UNSAT one in
# the lane so both paths stay exercised
SMOKE_SIZES: Tuple[Tuple[int, int], ...] = ((2, 2), (2, 3), (3, 3))
SMOKE_KERNELS: Tuple[str, ...] = ("bitcount", "reversebits", "sqrt", "gsm")

# -- the widened architecture axis (repro_torch.archspec) ---------------------

#: interconnects the Table-5 ISA can also assemble (diagonal / one-hop are
#: mappable ablations only — see ``ArchSpec.assemblable``)
DEFAULT_ARCH_TOPOLOGIES: Tuple[str, ...] = ("torus", "mesh")
#: heterogeneity ladder: unconstrained, the reference fabric's real
#: one-port-per-column arbitration, border-only load-store units, and a
#: single memory column ("" = homogeneous)
DEFAULT_ARCH_HETERO: Tuple[str, ...] = (
    "", "ports=1/col", "mem=border,ports=1/col", "mem=col0,ports=1/col")
DEFAULT_ARCH_SIZES: Tuple[Tuple[int, int], ...] = ((3, 3), (4, 4))


def arch_space(topologies: Sequence[str] = DEFAULT_ARCH_TOPOLOGIES,
               hetero: Sequence[str] = DEFAULT_ARCH_HETERO,
               sizes: Iterable[Tuple[int, int]] = DEFAULT_ARCH_SIZES,
               ) -> List[str]:
    """Compact spec strings for a topology × heterogeneity × size walk
    (size-major, deterministic order)."""
    out: List[str] = []
    for (r, c) in sizes:
        for topo in topologies:
            for h in hetero:
                out.append(f"{topo}-{r}x{c}" + (f":{h}" if h else ""))
    return out


@dataclass(frozen=True)
class ArchPoint:
    """One (kernel, architecture) cell of the widened sweep."""

    kernel: str
    arch: str  # archspec compact string or preset name


def build_arch_space(kernels: Sequence[str],
                     archs: Sequence[str]) -> List[ArchPoint]:
    """Cross product in deterministic (kernel-major) order; validates both
    axes eagerly so a typo fails before any solving starts."""
    from ..archspec import parse_arch

    registered = kernel_names()
    unknown = [k for k in kernels if k not in registered]
    if unknown:
        raise ValueError(
            f"unknown kernels {unknown}; registered: {sorted(registered)}")
    for a in archs:
        parse_arch(a)
    return [ArchPoint(kernel=k, arch=a) for k in kernels for a in archs]


@dataclass(frozen=True)
class DesignPoint:
    kernel: str
    rows: int
    cols: int

    @property
    def size(self) -> str:
        return f"{self.rows}x{self.cols}"

    @property
    def num_pes(self) -> int:
        return self.rows * self.cols


def parse_sizes(spec: str) -> List[Tuple[int, int]]:
    """``"2x2,3x3"`` -> ``[(2, 2), (3, 3)]``."""
    out = []
    for tok in spec.split(","):
        tok = tok.strip().lower()
        if not tok:
            continue
        r, _, c = tok.partition("x")
        out.append((int(r), int(c)))
    return out


def build_space(kernels: Sequence[str],
                sizes: Iterable[Tuple[int, int]]) -> List[DesignPoint]:
    """Cross product in deterministic (kernel-major) order."""
    registered = kernel_names()
    unknown = [k for k in kernels if k not in registered]
    if unknown:
        raise ValueError(
            f"unknown kernels {unknown}; registered: {sorted(registered)}")
    return [DesignPoint(kernel=k, rows=r, cols=c)
            for k in kernels for (r, c) in sizes]


def kernel_program(name: str):
    """Instantiate the registered LoopBuilder for ``name``."""
    return _kernel_program(name)
