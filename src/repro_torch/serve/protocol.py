"""The compile server's versioned wire schema (newline-JSON).

Every message is one JSON object per line.  Client -> server messages
carry a ``request_id``; every server response echoes it, so one
connection can multiplex any number of in-flight requests (the client
routes responses back to waiters by id).

Client -> server::

    {"type": "compile", "request": <CompileRequest.to_dict()>}
    {"type": "stats",    "request_id": "..."}
    {"type": "shutdown", "request_id": "..."}

Server -> client::

    {"type": "hello",  "v": 1, "arch": ..., "jobs": N}     (on connect)
    {"type": "result", "request_id": ..., "served": "cache" | "compiled"
                       | "coalesced", "result": <CompileResult.to_dict()>}
    {"type": "rejected", "request_id": ..., "tenant": ..., "reason": ...}
    {"type": "error",  "request_id": ..., "error": "TypeName: msg"}
    {"type": "stats",  "request_id": ..., "stats": {...}}
    {"type": "bye",    "request_id": ...}

:class:`CompileRequest` is the frozen, versioned request surface —
``source`` is a registry kernel name or a serialized bare DFG
(:meth:`repro_torch.core.dfg.DFG.to_dict`; traced bodies are lowered to a DFG
client-side, see :func:`wire_source`) — pinned by golden-fixture tests
so the schema cannot drift silently.  ``v`` is bumped only on an
incompatible change; both ends reject a version they do not speak.

A copy of ``src/repro/serve/protocol.py``: the same frames, byte for byte.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Union

from ..core.dfg import DFG
from ..core.mapper import MapperConfig

#: wire schema version — bump only on an incompatible change
WIRE_VERSION = 1

#: default TCP port of ``python -m repro_torch serve``
#: (unregistered/private range)
DEFAULT_PORT = 7433


class ProtocolError(ValueError):
    """A malformed or version-skewed wire message."""


def wire_source(source) -> Union[str, Dict]:
    """Normalize any client-side kernel source to its wire form: a
    registry name passes through, a DFG (or anything that can produce
    one — LoopBuilder, TracedKernel) serializes to its dict form.  The
    server maps bare DFGs map-only, exactly like ``Toolchain``."""
    if isinstance(source, (str, dict)):
        return source
    if isinstance(source, DFG):
        return source.to_dict()
    if hasattr(source, "spec") and hasattr(source, "build"):
        return source.build().build_dfg().to_dict()  # TracedKernel
    if hasattr(source, "build_dfg"):
        return source.build_dfg().to_dict()  # LoopBuilder
    raise ProtocolError(
        f"unsupported kernel source {type(source).__name__}: expected a "
        "registry name, DFG/DFG-dict, LoopBuilder or TracedKernel")


@dataclasses.dataclass(frozen=True)
class CompileRequest:
    """One typed compile request — the versioned client-facing API.

    ``config`` overrides individual :class:`~repro_torch.core.mapper.MapperConfig`
    fields on top of the server's base config (unknown keys are
    rejected); ``strategy`` is the ``repro_torch.core.backends`` compact
    grammar and, when set, supersedes the base config's
    ``backend``/``amo`` pair.  ``priority`` orders queued work (higher
    first); ``tenant`` is the admission-budget bucket."""

    source: Union[str, Dict]
    arch: str = "4x4"
    config: Optional[Dict[str, Any]] = None
    strategy: Optional[str] = None
    priority: int = 0
    tenant: str = "default"
    request_id: str = ""

    def resolved_source(self):
        """The server-side source: registry name or revived DFG."""
        if isinstance(self.source, str):
            return self.source
        return DFG.from_dict(self.source)

    def mapper_config(self, base: MapperConfig) -> MapperConfig:
        """This request's effective config over the server's ``base``.
        Unknown override keys raise (version-skewed clients fail loudly,
        they do not get silently-defaulted solves)."""
        merged = dataclasses.asdict(base)
        if self.config:
            unknown = sorted(set(self.config) - set(merged))
            if unknown:
                raise ProtocolError(
                    f"unknown MapperConfig keys: {unknown}")
            merged.update(self.config)
        if self.strategy is not None:
            # a strategy spec is authoritative: clear the legacy pair so
            # resolve_portfolio cannot see two masters
            merged["strategy"] = self.strategy
            merged["backend"] = "auto"
            merged["amo"] = None
        return MapperConfig.from_dict(merged)

    def to_dict(self) -> Dict:
        return {
            "v": WIRE_VERSION,
            "source": self.source,
            "arch": self.arch,
            "config": self.config,
            "strategy": self.strategy,
            "priority": self.priority,
            "tenant": self.tenant,
            "request_id": self.request_id,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "CompileRequest":
        v = d.get("v", WIRE_VERSION)
        if v != WIRE_VERSION:
            raise ProtocolError(
                f"wire version {v} not supported (this end speaks "
                f"{WIRE_VERSION})")
        source = d.get("source")
        if not isinstance(source, (str, dict)) or not source:
            raise ProtocolError(
                "CompileRequest.source must be a kernel name or a DFG dict")
        return cls(
            source=source,
            arch=str(d.get("arch", "4x4")),
            config=d.get("config"),
            strategy=d.get("strategy"),
            priority=int(d.get("priority", 0)),
            tenant=str(d.get("tenant", "default")),
            request_id=str(d.get("request_id", "")),
        )


def encode(msg: Dict) -> bytes:
    """One wire frame: compact sorted JSON + newline."""
    return (json.dumps(msg, sort_keys=True, separators=(",", ":"))
            + "\n").encode()


def decode(line: Union[bytes, str]) -> Dict:
    """Inverse of :func:`encode`; raises :class:`ProtocolError` on
    anything that is not one JSON object."""
    if isinstance(line, bytes):
        line = line.decode(errors="replace")
    try:
        msg = json.loads(line)
    except json.JSONDecodeError as e:
        raise ProtocolError(f"bad wire frame: {e}") from e
    if not isinstance(msg, dict):
        raise ProtocolError(
            f"bad wire frame: expected an object, got {type(msg).__name__}")
    return msg
