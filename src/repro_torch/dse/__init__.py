"""Design-space exploration (paper §6-7), copied from ``src/repro/dse``:
parallel kernel × architecture sweeps, a content-addressed mapping cache
(one layout for both packages), and Pareto pruning analysis.  The
classic axis is the homogeneous size ladder; ``arch_space`` /
``build_arch_space`` open the widened topology × heterogeneity × size
walk over ``repro_torch.archspec`` specs."""
from .cache import MappingCache
from .pareto import dominates, kernel_pareto, pareto_analysis, pareto_front
from .space import (DEFAULT_KERNELS, DEFAULT_SIZES, SMOKE_KERNELS,
                    SMOKE_SIZES, ArchPoint, DesignPoint, arch_space,
                    build_arch_space, build_space, kernel_program,
                    parse_sizes)
from .sweep import SweepConfig, run_sweep

__all__ = [
    "MappingCache",
    "dominates", "kernel_pareto", "pareto_analysis", "pareto_front",
    "DEFAULT_KERNELS", "DEFAULT_SIZES", "SMOKE_KERNELS", "SMOKE_SIZES",
    "ArchPoint", "DesignPoint", "arch_space", "build_arch_space",
    "build_space", "kernel_program", "parse_sizes",
    "SweepConfig", "run_sweep",
]
