"""Declarative CGRA architecture descriptions (paper §7 design space).

An :class:`ArchSpec` is a value object naming everything the paper's
"resource-constrained" walk can vary: grid geometry, interconnect
topology (torus / mesh / diagonal / one-hop), per-PE capability classes
(which PEs own a load-store unit or a multiplier), shared memory ports
per column/row/fabric, and register-file size.  Specs are

* **content-hashable** — :meth:`ArchSpec.arch_hash` feeds the mapping
  cache key, so two spellings of the same fabric share cache entries;
* **parseable** — from compact strings like
  ``mesh-4x4:mem=col0,regs=8,ports=1/row`` (:func:`parse_arch`), JSON or
  TOML documents (:func:`load_arch`), or preset names
  (:mod:`repro.archspec.presets`);
* **compilable** — :meth:`ArchSpec.grid` lowers the spec into the runtime
  :class:`~repro.cgra.arch.PEGrid` + :class:`~repro.cgra.arch.ArchCaps`
  pair consumed by the SAT encoder, the independent mapping validator and
  the energy/area model.

Capability selector grammar (for ``mem=`` / ``mul=``): ``all``, ``none``,
``colK`` / ``rowK`` (one column/row), ``border`` (the perimeter),
``peA.B.C`` (explicit ids), and ``+``-unions of those
(``mem=col0+col3``).  Port grammar: ``ports=K/col`` | ``K/row`` |
``K/global`` — at most K memory ops per kernel cycle per column / row /
whole fabric (``0`` or absent = unconstrained, the homogeneous default).

A copy of ``src/repro/archspec/spec.py`` (the port imports nothing of the JAX
package).
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, replace
from typing import Dict, FrozenSet, List, Optional, Tuple

from ..cgra.arch import (ASSEMBLABLE_TOPOLOGIES, ArchCaps, CGRASpec, PEGrid,
                         TOPOLOGIES)

PORT_SCOPES = ("col", "row", "global")

#: spec fields with their defaults, in canonical serialization order
_DEFAULTS = (("topology", "torus"), ("num_regs", 4), ("mem", "all"),
             ("mul", "all"), ("ports", 0), ("port_scope", "col"))


class ArchSpecError(ValueError):
    """Malformed architecture description (string, dict or file)."""


def _parse_selector(sel: str, rows: int, cols: int) -> Optional[FrozenSet[int]]:
    """``all``/``none``/``colK``/``rowK``/``border``/``peA.B``/unions -> PE set
    (``None`` means unrestricted)."""
    sel = sel.strip().lower()
    if sel == "all":
        return None
    if sel == "none":
        return frozenset()
    out: List[int] = []
    for part in sel.split("+"):
        part = part.strip()
        if part == "border":
            out.extend(r * cols + c for r in range(rows) for c in range(cols)
                       if r in (0, rows - 1) or c in (0, cols - 1))
        elif part.startswith("col"):
            c = _int(part[3:], f"column index in {part!r}")
            if not 0 <= c < cols:
                raise ArchSpecError(f"column {c} outside 0..{cols - 1}")
            out.extend(r * cols + c for r in range(rows))
        elif part.startswith("row"):
            r = _int(part[3:], f"row index in {part!r}")
            if not 0 <= r < rows:
                raise ArchSpecError(f"row {r} outside 0..{rows - 1}")
            out.extend(r * cols + c for c in range(cols))
        elif part.startswith("pe"):
            for tok in part[2:].split("."):
                p = _int(tok, f"PE id in {part!r}")
                if not 0 <= p < rows * cols:
                    raise ArchSpecError(f"PE {p} outside 0..{rows * cols - 1}")
                out.append(p)
        else:
            raise ArchSpecError(
                f"unknown capability selector {part!r} (expected all, none, "
                "colK, rowK, border, peA.B.C or a +-union)")
    return frozenset(out)


def _int(text: str, what: str) -> int:
    try:
        return int(text)
    except ValueError:
        raise ArchSpecError(f"expected an integer for {what}, got {text!r}") \
            from None


@dataclass(frozen=True)
class ArchSpec:
    """One declarative CGRA fabric.  Defaults reproduce the homogeneous
    torus exactly (``ArchSpec(4, 4).grid()`` ≡ ``make_grid(4, 4)``)."""

    rows: int
    cols: int
    topology: str = "torus"
    num_regs: int = 4
    mem: str = "all"          # capability selector for LWD/LWI/SWD/SWI
    mul: str = "all"          # capability selector for SMUL/FXPMUL
    ports: int = 0            # max concurrent mem ops per port scope (0 = off)
    port_scope: str = "col"   # "col" | "row" | "global"
    name: str = ""            # preset name; excluded from the content hash

    def __post_init__(self) -> None:
        if self.rows < 1 or self.cols < 1:
            raise ArchSpecError("rows/cols must be >= 1")
        if self.topology not in TOPOLOGIES:
            raise ArchSpecError(f"unknown topology {self.topology!r}; "
                                f"expected one of {TOPOLOGIES}")
        if self.num_regs < 1:
            raise ArchSpecError("num_regs must be >= 1")
        if self.ports < 0:
            raise ArchSpecError("ports must be >= 0")
        if self.port_scope not in PORT_SCOPES:
            raise ArchSpecError(f"unknown port scope {self.port_scope!r}; "
                                f"expected one of {PORT_SCOPES}")
        # validate the selectors eagerly so a bad spec fails at parse time
        self.mem_pes()
        self.mul_pes()

    # -- derived sets ------------------------------------------------------

    @property
    def num_pes(self) -> int:
        return self.rows * self.cols

    def mem_pes(self) -> Optional[FrozenSet[int]]:
        return _parse_selector(self.mem, self.rows, self.cols)

    def mul_pes(self) -> Optional[FrozenSet[int]]:
        return _parse_selector(self.mul, self.rows, self.cols)

    def port_groups(self) -> Tuple[Tuple[str, FrozenSet[int], int], ...]:
        if self.ports <= 0:
            return ()
        if self.port_scope == "global":
            return (("global", frozenset(range(self.num_pes)), self.ports),)
        if self.port_scope == "col":
            return tuple(
                (f"col{c}",
                 frozenset(r * self.cols + c for r in range(self.rows)),
                 self.ports)
                for c in range(self.cols))
        return tuple(
            (f"row{r}",
             frozenset(r * self.cols + c for c in range(self.cols)),
             self.ports)
            for r in range(self.rows))

    @property
    def is_homogeneous(self) -> bool:
        """No capability restriction and no port limit (topology aside)."""
        return (self.mem_pes() is None and self.mul_pes() is None
                and self.ports == 0)

    @property
    def assemblable(self) -> bool:
        """Whether mappings can be lowered to bitstreams: the Table-5 ISA
        only has N/E/S/W neighbor source selectors, so diagonal / one-hop
        links are mappable (DSE ablations) but not yet code-generatable."""
        return self.topology in ASSEMBLABLE_TOPOLOGIES

    # -- serialization -----------------------------------------------------

    def to_dict(self) -> Dict:
        d: Dict = {"rows": self.rows, "cols": self.cols}
        for key, default in _DEFAULTS:
            value = getattr(self, key)
            if value != default:
                d[key] = value
        if self.name:
            d["name"] = self.name
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "ArchSpec":
        known = {"rows", "cols", "name"} | {k for k, _ in _DEFAULTS}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ArchSpecError(f"unknown ArchSpec fields {unknown}; "
                                f"expected a subset of {sorted(known)}")
        try:
            return cls(**d)
        except TypeError as e:
            raise ArchSpecError(str(e)) from None

    def to_compact(self) -> str:
        """Canonical compact string (parse/print round-trips)."""
        head = f"{self.topology}-{self.rows}x{self.cols}"
        opts = []
        if self.mem != "all":
            opts.append(f"mem={self.mem}")
        if self.mul != "all":
            opts.append(f"mul={self.mul}")
        if self.num_regs != 4:
            opts.append(f"regs={self.num_regs}")
        if self.ports:
            opts.append(f"ports={self.ports}/{self.port_scope}")
        return head + (":" + ",".join(opts) if opts else "")

    def label(self) -> str:
        return self.name or self.to_compact()

    def arch_hash(self) -> str:
        """Content hash over everything that affects mapping semantics
        (``name`` excluded: the hash addresses content, not labels)."""
        d = self.to_dict()
        d.pop("name", None)
        blob = json.dumps(d, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]

    # -- compilation -------------------------------------------------------

    def grid(self) -> PEGrid:
        """Lower to the runtime ``PEGrid`` (+ capability/port table).

        Homogeneous torus/mesh specs compile to exactly the grid
        :func:`~repro.cgra.arch.make_grid` builds (``caps=None``, legacy
        ``topology=""`` spelling) so their mapping cache keys — and every
        committed homogeneous BENCH baseline — stay byte-identical.
        """
        legacy = self.topology in ("torus", "mesh")
        spec = CGRASpec(rows=self.rows, cols=self.cols,
                        num_regs=self.num_regs,
                        torus=self.topology == "torus",
                        name=self.name,
                        topology="" if legacy else self.topology)
        caps = None
        if not self.is_homogeneous:
            caps = ArchCaps(mem_pes=self.mem_pes(), mul_pes=self.mul_pes(),
                            port_groups=self.port_groups())
        return PEGrid(spec, caps=caps)

    def with_name(self, name: str) -> "ArchSpec":
        return replace(self, name=name)


def parse_arch(text: str) -> ArchSpec:
    """Parse a preset name, ``RxC`` shorthand, or compact spec string.

    ``"4x4"`` -> the homogeneous torus (today's default architecture);
    ``"mesh-4x4:mem=col0,regs=8,ports=1/row"`` -> full grammar;
    ``"openedge-4x4"`` -> preset lookup (see ``repro.archspec.presets``).
    """
    from .presets import PRESETS  # deferred: presets builds ArchSpecs

    text = text.strip()
    if text in PRESETS:
        return PRESETS[text]
    head, _, opts = text.partition(":")
    topology, _, geom = head.rpartition("-")
    if not topology:
        topology = "torus"  # bare "4x4"
    if topology not in TOPOLOGIES:
        raise ArchSpecError(
            f"unknown topology or preset {head!r}; topologies: "
            f"{TOPOLOGIES}, presets: {sorted(PRESETS)}")
    r, sep, c = geom.lower().partition("x")
    if not sep:
        raise ArchSpecError(f"expected RxC geometry, got {geom!r}")
    fields: Dict = {"rows": _int(r, "rows"), "cols": _int(c, "cols"),
                    "topology": topology}
    if opts:
        for tok in opts.split(","):
            tok = tok.strip()
            if not tok:
                continue
            key, sep, value = tok.partition("=")
            if not sep:
                raise ArchSpecError(f"expected key=value, got {tok!r}")
            key = key.strip().lower()
            value = value.strip()
            if key in ("mem", "mul"):
                fields[key] = value
            elif key == "regs":
                fields["num_regs"] = _int(value, "regs")
            elif key == "ports":
                count, sep, scope = value.partition("/")
                fields["ports"] = _int(count, "ports")
                fields["port_scope"] = scope if sep else "col"
            else:
                raise ArchSpecError(
                    f"unknown option {key!r} (expected mem, mul, regs, "
                    "ports)")
    return ArchSpec(**fields)


def load_arch(path: str) -> ArchSpec:
    """Load a spec from a ``.json`` or ``.toml`` document."""
    if path.endswith(".toml"):
        try:
            import tomllib
        except ImportError:  # Python < 3.11; tomli is not a dependency
            raise ArchSpecError(
                "TOML specs need Python >= 3.11 (tomllib); use JSON or a "
                "compact string on this interpreter") from None
        with open(path, "rb") as fh:
            doc = tomllib.load(fh)
    else:
        with open(path) as fh:
            doc = json.load(fh)
    if not isinstance(doc, dict):
        raise ArchSpecError(f"{path}: expected a table/object at top level")
    return ArchSpec.from_dict(doc)


def resolve_spec(arch) -> ArchSpec:
    """``ArchSpec`` | spec/preset string | ``(rows, cols)`` -> ArchSpec."""
    if isinstance(arch, ArchSpec):
        return arch
    if isinstance(arch, str):
        return parse_arch(arch)
    rows, cols = arch
    return ArchSpec(rows=int(rows), cols=int(cols))
