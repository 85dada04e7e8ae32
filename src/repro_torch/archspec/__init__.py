"""Heterogeneous architecture descriptions: declarative CGRA specs.

Public surface::

    from repro_torch.archspec import ArchSpec, parse_arch, load_arch, PRESETS

    spec = parse_arch("mesh-4x4:mem=col0,regs=8,ports=1/row")
    grid = spec.grid()          # PEGrid + capability/port table
    spec.arch_hash()            # content hash (mapping cache key input)

A copy of ``src/repro/archspec/__init__.py`` (the port imports nothing of the JAX
package).
"""
from .presets import PRESETS, preset_names
from .spec import (ArchSpec, ArchSpecError, PORT_SCOPES, load_arch,
                   parse_arch, resolve_spec)

__all__ = [
    "ArchSpec", "ArchSpecError", "PORT_SCOPES",
    "PRESETS", "preset_names",
    "parse_arch", "load_arch", "resolve_spec",
]
