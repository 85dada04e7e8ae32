"""The port's single-point compilation session (copied from
``src/repro/toolchain``): :class:`Toolchain` runs source -> map ->
assemble -> metrics -> simulate, and ``python -m repro_torch map`` drives
it from the command line."""
from .artifacts import CompileResult, Program, StageError, format_error
from .oracles import assembler_oracle, resolve_oracle
from .session import Toolchain, arch_label, resolve_arch

__all__ = [
    "CompileResult", "Program", "StageError", "Toolchain",
    "arch_label", "assembler_oracle", "format_error", "resolve_arch",
    "resolve_oracle",
]
