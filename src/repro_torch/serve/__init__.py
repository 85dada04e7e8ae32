"""Mapping-as-a-service: the asyncio compile server, its versioned wire
protocol, and typed clients.

A copy of ``src/repro/serve``, module for module.  The server maps,
assembles and reports on the host; it touches no device.  Its wire bytes
are the JAX package's, so clients and servers of either package talk to
each other, and one cache directory serves both.

Quickstart::

    $ python -m repro_torch serve --port 7433 --cache-dir build/serve_cache
    $ python -m repro_torch submit dotprod --grid 4x4

or in-process::

    from repro_torch.serve import CompileServer, ServeClient

See :mod:`repro_torch.serve.protocol` for the wire schema; phase
``serve`` of ``chip_smoke.py`` drives the serving lane's workload through
it and runs every served mapping on the card.
"""

from .client import ServeClient, ServeError, request_sync
from .protocol import (
    DEFAULT_PORT,
    WIRE_VERSION,
    CompileRequest,
    ProtocolError,
    wire_source,
)
from .queue import InflightCompiles, ServeStats, TenantBudgets
from .server import CompileServer

__all__ = [
    "CompileServer",
    "CompileRequest",
    "ServeClient",
    "ServeError",
    "request_sync",
    "wire_source",
    "InflightCompiles",
    "TenantBudgets",
    "ServeStats",
    "ProtocolError",
    "WIRE_VERSION",
    "DEFAULT_PORT",
]
