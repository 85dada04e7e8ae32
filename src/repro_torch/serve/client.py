"""Typed clients for the compile server.

:class:`ServeClient` is the asyncio client: one connection, any number
of in-flight requests, responses routed back by ``request_id``.
:func:`request_sync` is the blocking one-shot helper behind ``python -m
repro_torch submit`` (and anything else that just wants an answer).

Results arrive as full ``CompileResult.to_dict()`` documents;
:meth:`ServeClient.compile` revives them through the lossless wire view
(no local DFG/grid needed) so ``result.summary()`` on this side is
byte-identical to the server's.

A copy of ``src/repro/serve/client.py``.
"""

from __future__ import annotations

import asyncio
import itertools
from typing import Any, Dict, Optional, Tuple

from ..toolchain.artifacts import CompileResult
from .protocol import (
    DEFAULT_PORT,
    WIRE_VERSION,
    CompileRequest,
    ProtocolError,
    decode,
    encode,
    wire_source,
)


class ServeError(RuntimeError):
    """The server answered with ``rejected`` or ``error``; ``.response``
    carries the full message."""

    def __init__(self, message: str, response: Dict):
        super().__init__(message)
        self.response = response


class ServeClient:
    """One connection to a :class:`~repro_torch.serve.server.CompileServer`.

    Use :meth:`connect` (TCP) or :meth:`over_streams` (any reader/writer
    pair, e.g. a stdio subprocess).  A background task reads frames and
    resolves the matching waiter, so ``submit``/``compile`` calls from
    many coroutines multiplex freely over the single socket."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, hello: Dict):
        self.reader = reader
        self.writer = writer
        self.hello = hello
        self._ids = itertools.count(1)
        self._pending: Dict[str, asyncio.Future] = {}
        self._reader_task = asyncio.ensure_future(self._read_loop())

    @classmethod
    async def connect(cls, host: str = "127.0.0.1",
                      port: int = DEFAULT_PORT) -> "ServeClient":
        reader, writer = await asyncio.open_connection(host, port)
        return await cls.over_streams(reader, writer)

    @classmethod
    async def over_streams(cls, reader, writer) -> "ServeClient":
        hello = decode(await reader.readline())
        if hello.get("type") != "hello":
            raise ProtocolError(f"expected hello, got {hello.get('type')!r}")
        if hello.get("v") != WIRE_VERSION:
            raise ProtocolError(
                f"server speaks wire version {hello.get('v')}, this client "
                f"speaks {WIRE_VERSION}")
        return cls(reader, writer, hello)

    async def _read_loop(self) -> None:
        err: Optional[BaseException] = None
        try:
            while True:
                line = await self.reader.readline()
                if not line:
                    err = ConnectionError("server closed the connection")
                    break
                msg = decode(line)
                fut = self._pending.pop(str(msg.get("request_id", "")), None)
                if fut is not None and not fut.done():
                    fut.set_result(msg)
        except (ProtocolError, ConnectionError, OSError) as e:
            err = e
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(
                    err or ConnectionError("client connection lost"))
        self._pending.clear()

    async def _request(self, msg: Dict) -> Dict:
        rid = msg["request_id"] if "request_id" in msg else ""
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[str(rid)] = fut
        self.writer.write(encode(msg))
        await self.writer.drain()
        return await fut

    async def submit(
        self,
        source,
        arch: str = "4x4",
        config: Optional[Dict[str, Any]] = None,
        strategy: Optional[str] = None,
        priority: int = 0,
        tenant: str = "default",
    ) -> Dict:
        """Send one compile request; returns the raw response message
        (``result`` / ``rejected`` / ``error``).  ``source`` may be a
        registry name, DFG, DFG dict, LoopBuilder or TracedKernel —
        non-names are lowered to a bare DFG here (map-only on the
        server)."""
        rid = f"r{next(self._ids)}"
        req = CompileRequest(
            source=wire_source(source), arch=arch, config=config,
            strategy=strategy, priority=priority, tenant=tenant,
            request_id=rid)
        return await self._request(
            {"type": "compile", "request": req.to_dict(),
             "request_id": rid})

    async def compile(self, source, **kwargs) -> Tuple[CompileResult, str]:
        """``submit`` + typed revival: ``(CompileResult, served)`` where
        ``served`` is ``"cache"`` / ``"compiled"`` / ``"coalesced"``.
        Raises :class:`ServeError` on a rejection or server-side
        error."""
        resp = await self.submit(source, **kwargs)
        if resp.get("type") != "result":
            detail = resp.get("reason") or resp.get("error") or resp
            raise ServeError(f"{resp.get('type')}: {detail}", resp)
        return CompileResult.from_dict(resp["result"]), resp["served"]

    async def stats(self) -> Dict:
        rid = f"r{next(self._ids)}"
        resp = await self._request({"type": "stats", "request_id": rid})
        return resp["stats"]

    async def shutdown(self) -> None:
        """Ask the server to stop accepting and exit its serve loop."""
        rid = f"r{next(self._ids)}"
        await self._request({"type": "shutdown", "request_id": rid})

    async def close(self) -> None:
        self._reader_task.cancel()
        try:
            await self._reader_task
        except (asyncio.CancelledError, Exception):
            pass
        try:
            self.writer.close()
            await self.writer.wait_closed()
        except (ConnectionError, OSError):
            pass


def request_sync(
    source,
    host: str = "127.0.0.1",
    port: int = DEFAULT_PORT,
    *,
    shutdown: bool = False,
    **kwargs,
) -> Dict:
    """Blocking one-shot: connect, submit, (optionally ask the server to
    shut down,) disconnect.  Returns the raw response message."""

    async def go() -> Dict:
        client = await ServeClient.connect(host, port)
        try:
            if source is None:
                resp = {"type": "stats", "stats": await client.stats()}
            else:
                resp = await client.submit(source, **kwargs)
            if shutdown:
                await client.shutdown()
            return resp
        finally:
            await client.close()

    return asyncio.run(go())
