"""The port's compilation session (copied from ``src/repro/toolchain``):
:class:`Toolchain` runs source -> map -> assemble -> metrics -> simulate,
``compile_many`` fans kernels x grids through the supervised worker
fleet and the content-addressed mapping cache, and ``python -m
repro_torch map`` drives it from the command line."""
from .artifacts import (STAGES, CompileResult, Program, StageError,
                        format_error)
from .oracles import ORACLE_TAG, assembler_oracle, resolve_oracle
from .resilience import DEGRADATION_RUNGS, FailureKind, ResilienceConfig
from .session import Toolchain, arch_label, resolve_arch

__all__ = [
    "STAGES", "CompileResult", "Program", "StageError", "format_error",
    "ORACLE_TAG", "assembler_oracle", "resolve_oracle",
    "DEGRADATION_RUNGS", "FailureKind", "ResilienceConfig",
    "Toolchain", "arch_label", "resolve_arch",
]
