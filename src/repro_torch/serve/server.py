"""The asyncio compile server: mapping-as-a-service over the toolchain.

One :class:`CompileServer` owns

* a memoized :class:`~repro_torch.toolchain.session.Toolchain` session per
  architecture string — arch parsing and oracle resolution happen once
  per arch, not once per request;
* one persistent :class:`~repro_torch.toolchain.resilience.WorkerPool` — the
  supervised fleet (deadlines, crash healing, retry/degradation
  ladder) kept warm across requests, with request priorities flowing
  into pool scheduling;
* in-flight dedup by the content-addressed mapping cache key
  (:class:`~repro_torch.serve.queue.InflightCompiles`): concurrent identical
  requests coalesce onto one compile, and completed results come
  straight from the shared on-disk cache;
* per-tenant admission budgets
  (:class:`~repro_torch.serve.queue.TenantBudgets`) — a tenant over budget
  gets an immediate typed rejection, not unbounded queueing.

Requests and responses speak the newline-JSON schema of
:mod:`repro_torch.serve.protocol` over TCP (:meth:`CompileServer.start`) or
stdio (:meth:`CompileServer.serve_stdio`).  Results are full
:meth:`~repro_torch.toolchain.artifacts.CompileResult.to_dict` documents —
clients revive them losslessly without any local DFG/grid
(``CompileResult.from_dict``'s wire view).

Sources: a registry kernel name runs the full pipeline
(map/assemble/metrics); a serialized bare DFG is map-only and keeps the
``Toolchain.compile`` semantics for builder-less programs (the mapping
rides on ``map_result`` while ``status``/``stage`` record the assemble
stop).

A copy of ``src/repro/serve/server.py``.  Nothing on its path reaches for
a device: the worker pool maps on the host, as in the JAX package.
"""

from __future__ import annotations

import asyncio
import dataclasses
import sys
import time
from typing import Dict, Optional, Tuple

from ..core.mapper import MapperConfig
from ..obs import MetricsRegistry
from ..obs import trace as obs_trace
from ..toolchain.artifacts import CompileResult, format_error
from ..toolchain.oracles import assembler_oracle
from ..toolchain.resilience import (
    FailureKind,
    MapTask,
    ResilienceConfig,
    WorkerPool,
    failure_record,
)
from ..toolchain.session import Toolchain
from .protocol import WIRE_VERSION, CompileRequest, ProtocolError, decode, encode
from .queue import InflightCompiles, ServeStats, TenantBudgets


class CompileServer:
    """See the module docstring.  ``inline=True`` swaps worker processes
    for in-process worker threads (test harnesses, fork-hostile hosts);
    ``tenant_budget`` caps concurrently-admitted requests per tenant."""

    def __init__(
        self,
        arch: str = "4x4",
        config: Optional[MapperConfig] = None,
        *,
        cache=None,
        jobs: Optional[int] = None,
        tenant_budget: Optional[int] = None,
        resilience: Optional[ResilienceConfig] = None,
        inline: bool = False,
        oracle="assembler",
    ):
        self.default_arch = arch
        self.config = config or MapperConfig()
        if isinstance(cache, str):
            from ..dse.cache import MappingCache

            cache = MappingCache(cache)
        self.cache = cache
        self.oracle = oracle
        self.pool = WorkerPool(jobs=jobs, rcfg=resilience, inline=inline)
        self.pool.start()
        self.jobs = self.pool._jobs
        self.inflight = InflightCompiles()
        self.budgets = TenantBudgets(tenant_budget)
        self.stats = ServeStats()
        #: per-stage latency histograms + farm counters (repro_torch.obs);
        #: surfaced additively through the ``stats`` verb's ``metrics``
        #: field — old clients that only read the v1 fields still parse
        self.metrics = MetricsRegistry()
        self._sessions: Dict[str, Toolchain] = {}
        #: leader-side ``serve.dispatch`` spans by cache key, finished
        #: when the pool outcome settles (brackets queue + worker time)
        self._dispatch_spans: Dict[str, object] = {}
        self._server: Optional[asyncio.base_events.Server] = None
        self._closing: Optional[asyncio.Event] = None
        #: leader submissions to the pool — the "exactly one compile per
        #: coalesced group" instrumentation the dedup tests assert on
        self.mapper_invocations = 0

    # -- sessions ----------------------------------------------------------

    def session(self, arch: str) -> Toolchain:
        """The memoized per-arch toolchain session (warm across
        requests: arch strings parse once, oracle resolution is
        per-session, the mapping cache is shared)."""
        tc = self._sessions.get(arch)
        if tc is None:
            tc = Toolchain(arch, self.config, cache=self.cache,
                           oracle=self.oracle)
            self._sessions[arch] = tc
        return tc

    def _oracle_payload(self, tc: Toolchain, prog):
        """The picklable oracle argument for a worker-side re-resolve
        (mirrors ``compile_many``), gated on applicability so key and
        solve always agree."""
        if not tc._oracle_active(prog):
            return None
        if tc._oracle_factory is assembler_oracle:
            return "assembler"
        return (tc.oracle_tag, tc._oracle_factory)

    # -- the compile path --------------------------------------------------

    async def _compile(self, req: CompileRequest,
                       ) -> Tuple[CompileResult, str]:
        """One admitted request -> ``(result, served)`` where ``served``
        is ``"cache"`` (completed result replayed), ``"compiled"`` (this
        request led the solve) or ``"coalesced"`` (rode a leader's
        in-flight solve)."""
        loop = asyncio.get_running_loop()
        tc = self.session(req.arch)
        source = req.resolved_source()
        cfg = req.mapper_config(self.config)
        prog = tc.program(source)
        key = tc._cache_key(prog, cfg, oracled=tc._oracle_active(prog))
        corrupt_note = None
        if self.cache is not None:
            stored, state = tc._cache_lookup(key)
            if stored is not None:
                self.stats.cache_hits += 1
                return tc.result_from_cache(prog, stored), "cache"
            if state == "corrupt":
                corrupt_note = failure_record(
                    FailureKind.CACHE_CORRUPT, "cache",
                    message=(f"quarantined corrupt cache entry for key "
                             f"{key[:12]}; re-solving"))
        fut: asyncio.Future = loop.create_future()
        if self.inflight.join(key, fut):
            trace_ctx = None
            if obs_trace.enabled():
                dsp = obs_trace.begin("serve.dispatch", kernel=prog.name,
                                      arch=req.arch, priority=req.priority)
                self._dispatch_spans[key] = dsp
                trace_ctx = dsp.ship()
            task = MapTask(
                key=key,
                kernel=source if isinstance(source, str) else prog.dfg,
                grid=tc.grid,
                cfg=dataclasses.asdict(cfg),
                oracle=self._oracle_payload(tc, prog),
                priority=req.priority,
                trace_ctx=trace_ctx,
            )
            self.mapper_invocations += 1

            def on_outcome(_key, outcome, tc=tc, prog=prog, key=key,
                           note=corrupt_note):
                # fires on the pool's multiplexer thread: hop onto the loop
                loop.call_soon_threadsafe(
                    self._settle, key, outcome, tc, prog, note)

            self.pool.submit(task, on_outcome)
            return await fut, "compiled"
        return await fut, "coalesced"

    def _settle(self, key: str, outcome: Dict, tc: Toolchain, prog,
                corrupt_note) -> None:
        """Pool outcome -> one finished result, fanned out to the whole
        coalesced group (runs on the event loop)."""
        dsp = self._dispatch_spans.pop(key, None)
        waiters = self.inflight.pop(key)
        try:
            cr = tc.result_from_outcome(
                prog, outcome,
                cache_key=key if self.cache is not None else None,
                corrupt_note=corrupt_note)
        except Exception as e:  # defensive: never strand a waiter
            if dsp is not None:
                dsp.finish(status="error")
            for fut in waiters:
                if not fut.done():
                    fut.set_exception(e)
            return
        if dsp is not None:
            dsp.finish(status=cr.status, waiters=len(waiters))
        for fut in waiters:
            if not fut.done():
                fut.set_result(cr)

    # -- connection handling -----------------------------------------------

    async def _send(self, writer, wlock: asyncio.Lock, msg: Dict) -> None:
        async with wlock:
            writer.write(encode(msg))
            await writer.drain()

    async def _serve_compile(self, msg: Dict, writer,
                             wlock: asyncio.Lock) -> None:
        self.stats.received += 1
        t_req = time.monotonic()
        raw = msg.get("request")
        rid = raw.get("request_id", "") if isinstance(raw, dict) else ""
        try:
            req = CompileRequest.from_dict(raw if isinstance(raw, dict)
                                           else {})
        except ProtocolError as e:
            self.stats.errors += 1
            self.metrics.inc("serve.errors")
            await self._send(writer, wlock, {
                "type": "error", "request_id": str(rid),
                "error": format_error(e)})
            return
        self.metrics.observe("serve.queue_depth", self.pool.pending())
        if not self.budgets.admit(req.tenant):
            self.stats.rejected += 1
            self.metrics.inc("serve.rejected")
            await self._send(writer, wlock, {
                "type": "rejected", "request_id": req.request_id,
                "tenant": req.tenant,
                "reason": (f"tenant {req.tenant!r} is at its admission "
                           f"budget of {self.budgets.max_inflight} "
                           f"in-flight requests")})
            return
        with obs_trace.span("serve.request",
                            kernel=(req.source if isinstance(req.source, str)
                                    else "<dfg>"),
                            arch=req.arch, tenant=req.tenant,
                            priority=req.priority) as rsp:
            try:
                cr, served = await self._compile(req)
                if served == "compiled":
                    self.stats.compiled += 1
                elif served == "coalesced":
                    self.stats.coalesced += 1
                rsp.set(served=served, status=cr.status)
                self.metrics.inc(f"serve.served.{served}")
                self.metrics.observe("serve.request_s",
                                     time.monotonic() - t_req)
                for stage, dt in cr.timings.items():
                    self.metrics.observe(f"serve.stage.{stage}_s", dt)
                await self._send(writer, wlock, {
                    "type": "result", "request_id": req.request_id,
                    "served": served, "result": cr.to_dict()})
            except Exception as e:
                self.stats.errors += 1
                self.metrics.inc("serve.errors")
                await self._send(writer, wlock, {
                    "type": "error", "request_id": req.request_id,
                    "error": format_error(e)})
            finally:
                self.budgets.release(req.tenant)

    #: additive revision of the ``stats`` body within wire v1: consumers
    #: may rely on every ``STATS_SCHEMA >= 2`` response carrying the
    #: ``metrics`` and ``queue`` fields below; v1 readers ignore them
    STATS_SCHEMA = 2

    def snapshot(self) -> Dict:
        """The ``stats`` message body.

        Every field present at wire v1 keeps its exact name, position
        and type — the golden-fixture test in ``tests/test_torch_serve.py``
        holds old clients parsing new responses.  New telemetry is
        namespaced under the added optional keys (``stats_schema``,
        ``metrics``, ``queue``)."""
        out = {
            "v": WIRE_VERSION,
            "serving": self.stats.snapshot(),
            "mapper_invocations": self.mapper_invocations,
            "inflight_keys": len(self.inflight),
            "tenants": self.budgets.snapshot(),
            "sessions": sorted(self._sessions),
            "jobs": self.jobs,
            "pool_pending": self.pool.pending(),
            "stats_schema": self.STATS_SCHEMA,
            "metrics": self.metrics.snapshot(),
            "queue": {
                "pool_pending": self.pool.pending(),
                "inflight_keys": len(self.inflight),
            },
        }
        if self.cache is not None:
            stats = getattr(self.cache, "stats", None)
            if callable(stats):
                out["cache"] = stats()
        return out

    async def _handle_conn(self, reader, writer) -> None:
        wlock = asyncio.Lock()
        compiles = set()
        await self._send(writer, wlock, {
            "type": "hello", "v": WIRE_VERSION, "server": "repro-serve",
            "arch": self.default_arch, "jobs": self.jobs})
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                if not line.strip():
                    continue
                try:
                    msg = decode(line)
                except ProtocolError as e:
                    await self._send(writer, wlock, {
                        "type": "error", "request_id": "",
                        "error": format_error(e)})
                    continue
                mtype = msg.get("type")
                rid = str(msg.get("request_id", ""))
                if mtype == "compile":
                    t = asyncio.ensure_future(
                        self._serve_compile(msg, writer, wlock))
                    compiles.add(t)
                    t.add_done_callback(compiles.discard)
                elif mtype == "stats":
                    await self._send(writer, wlock, {
                        "type": "stats", "request_id": rid,
                        "stats": self.snapshot()})
                elif mtype == "shutdown":
                    await self._send(writer, wlock,
                                     {"type": "bye", "request_id": rid})
                    if self._closing is not None:
                        self._closing.set()
                    break
                else:
                    await self._send(writer, wlock, {
                        "type": "error", "request_id": rid,
                        "error": f"unknown message type {mtype!r}"})
        finally:
            if compiles:
                await asyncio.gather(*compiles, return_exceptions=True)
            try:
                writer.close()
                # the stdio writer (FlowControlMixin) has no close
                # waiter on older Pythons
                await writer.wait_closed()
            except (ConnectionError, OSError, NotImplementedError):
                pass

    # -- lifecycles --------------------------------------------------------

    async def start(self, host: str = "127.0.0.1",
                    port: int = 0) -> Tuple[str, int]:
        """Listen on TCP; returns the bound ``(host, port)`` (``port=0``
        picks a free one — test harnesses)."""
        self._closing = asyncio.Event()
        self._server = await asyncio.start_server(
            self._handle_conn, host, port)
        sock = self._server.sockets[0].getsockname()
        return sock[0], sock[1]

    async def wait_closed(self) -> None:
        """Serve until a client sends ``shutdown``."""
        if self._closing is not None:
            await self._closing.wait()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def serve_stdio(self) -> None:
        """One connection over this process's stdin/stdout (the
        socketless embedding: editor integrations, subprocess tests)."""
        loop = asyncio.get_running_loop()
        self._closing = asyncio.Event()
        reader = asyncio.StreamReader()
        await loop.connect_read_pipe(
            lambda: asyncio.StreamReaderProtocol(reader), sys.stdin)
        transport, proto = await loop.connect_write_pipe(
            asyncio.streams.FlowControlMixin, sys.stdout)
        writer = asyncio.StreamWriter(transport, proto, reader, loop)
        await self._handle_conn(reader, writer)

    def close(self) -> None:
        """Release the worker pool (idempotent)."""
        try:
            self.pool.shutdown()
        except RuntimeError:
            pass
