"""Named architecture presets for the widened design space.

Each preset is an :class:`~repro.archspec.spec.ArchSpec` with a stable
name usable anywhere a spec string is accepted (``--arch openedge-4x4``,
DSE axes, benchmark lanes).  They model the fabric families the paper
and its related work call out:

* ``openedge-NxN`` — the reference OpenEdgeCGRA torus with its *actual*
  arbitration: one shared memory port per column (the constraint
  ``repro.cgra.arch`` used to promise only in a docstring);
* ``bordermem-NxN`` — ADRES-flavoured heterogeneity: load-store units on
  the border PEs only, interior PEs are compute-only; one port per column;
* ``adres-NxN`` — mesh interconnect, memory access through row 0 only
  (the VLIW row of an ADRES-style template), one shared port per row;
* ``fewmul-4x4`` — multipliers on two columns only (the §7.2 observation
  that the ISA is not multiplication-optimized, taken to silicon);
* ``diag-4x4`` / ``onehop-4x4`` — richer interconnect ablations
  (mappable for DSE; not assemblable on the 4-direction Table-5 ISA).

A copy of ``src/repro/archspec/presets.py`` (the port imports nothing of the JAX
package).
"""
from __future__ import annotations

from typing import Dict

from .spec import ArchSpec


def _preset(name: str, spec: ArchSpec) -> ArchSpec:
    return spec.with_name(name)


PRESETS: Dict[str, ArchSpec] = {}

for _n in (2, 3, 4, 5, 6):
    PRESETS[f"openedge-{_n}x{_n}"] = _preset(
        f"openedge-{_n}x{_n}",
        ArchSpec(_n, _n, topology="torus", ports=1, port_scope="col"))
    PRESETS[f"bordermem-{_n}x{_n}"] = _preset(
        f"bordermem-{_n}x{_n}",
        ArchSpec(_n, _n, topology="torus", mem="border", ports=1,
                 port_scope="col"))
    PRESETS[f"adres-{_n}x{_n}"] = _preset(
        f"adres-{_n}x{_n}",
        ArchSpec(_n, _n, topology="mesh", mem="row0", ports=1,
                 port_scope="row"))

PRESETS["fewmul-4x4"] = _preset(
    "fewmul-4x4", ArchSpec(4, 4, topology="torus", mul="col1+col3"))
PRESETS["diag-4x4"] = _preset("diag-4x4", ArchSpec(4, 4, topology="diagonal"))
PRESETS["onehop-4x4"] = _preset("onehop-4x4", ArchSpec(4, 4, topology="one-hop"))


def preset_names() -> list:
    return sorted(PRESETS)
