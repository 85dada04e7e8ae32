"""Supervised worker fleet for ``compile_many`` — crash-safe, deadline-
safe, never loses a point.

The bare ``ProcessPoolExecutor`` it replaces had three failure modes
that killed whole sweeps: a segfaulting solver worker raised
``BrokenProcessPool`` out of ``compile_many``, a wedged CDCL solve
stalled its slot forever (the per-point ``total_timeout_s`` is enforced
*cooperatively* inside the worker), and any transient exception
collapsed into an opaque per-point ``"error"`` row.  This module owns
the countermeasures:

**Supervision.**  :class:`WorkerPool` keeps ``jobs`` long-lived worker
processes, each driven over its own pipe, and multiplexes on the parent
side with ``multiprocessing.connection.wait``.  The parent — not the
worker — enforces a wall-clock deadline per attempt
(``deadline_factor * total_timeout_s + deadline_slack_s``): a worker
that blows it is SIGKILLed, its slot is respawned, and the point goes
back on the queue.  A worker that dies on its own (segfault, OOM kill)
surfaces as EOF on its pipe; the supervisor classifies the exit code,
heals the pool, and requeues — ``BrokenProcessPool`` cannot happen
because there is no shared pool state to break.

**Pool, not batch.**  The pool outlives any one batch: ``submit()`` is
thread-safe (a self-pipe wakes the multiplexer), eligible tasks are
assigned to idle slots highest-:attr:`MapTask.priority` first, and
``start()`` moves the multiplexer onto a daemon thread so a long-lived
embedder (the compile server, :mod:`repro_torch.serve`) keeps warm
solver workers across requests.
:func:`run_supervised` is a thin batch adapter — create, submit
everything, drain, shut down.

**Retry, then degrade.**  Each point climbs a ladder:

1. up to ``max_retries`` plain retries (transient faults: crash,
   deadline, OOM), with exponential backoff and *deterministic* jitter
   (hash of the point key and attempt — reruns behave identically);
2. ``backend-flip``: re-solve on the other SAT backend (z3 <-> cdcl;
   skipped when the other backend is not installed);
3. ``oracle-off``: drop the CEGAR oracle, map-only;
4. ``ii-capped``: cap the II ladder at ``degraded_ii_max`` so the search
   cannot wander into the expensive tail;
5. a terminal row — ``status="failed"`` with a typed
   :class:`FailureKind` — never a lost point, never an exception out of
   ``compile_many``.

Rungs 2-4 apply cumulatively; a result produced on rung N is tagged
``degraded=<rung name>`` and is **not** written to the mapping cache
(its config differs from the cache key's).

**Attribution.**  Worker-side exceptions come back structured —
``{kind, stage, type, message, traceback}`` — not flattened to a bare
string, so fleet failures are debuggable post-hoc from the DSE rows.

The deterministic chaos harness (:mod:`repro_torch.toolchain.chaos`) injects
crashes/hangs/solver errors at the worker entry point
(:func:`_run_map_payload`) so all of the above is exercised by tests and
the nightly chaos CI lane.

A copy of ``src/repro/toolchain/resilience.py``.  Workers come from the
default ``multiprocessing`` context, which forks on Linux; nothing a
worker runs (mapping, the assembler oracle, a race attempt) imports or
touches CUDA, so a fleet may start after the parent has launched kernels.
"""

from __future__ import annotations

import hashlib
import heapq
import multiprocessing
import os
import signal
import threading
import time
import traceback as _traceback
from dataclasses import dataclass, field
from multiprocessing.connection import wait as _conn_wait
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import chaos


class FailureKind:
    """Typed failure taxonomy threaded through ``CompileResult`` and DSE
    rows (``failure["kind"]``).  Plain strings so rows stay JSON-native."""

    WORKER_CRASH = "worker-crash"   # worker process died (segfault, _exit)
    DEADLINE = "deadline"           # parent-side wall-clock kill
    SOLVER_ERROR = "solver-error"   # exception inside the map stage
    CACHE_CORRUPT = "cache-corrupt"  # quarantined cache entry for the key
    OOM = "oom"                     # MemoryError / SIGKILLed by the kernel

    ALL = (WORKER_CRASH, DEADLINE, SOLVER_ERROR, CACHE_CORRUPT, OOM)


#: degradation rung names, in ladder order
DEGRADATION_RUNGS = ("backend-flip", "oracle-off", "ii-capped")

#: characters of formatted traceback kept in a failure record (the tail —
#: the raise site — is the useful end)
TRACEBACK_LIMIT = 2000


@dataclass(frozen=True)
class ResilienceConfig:
    """Fleet policy: retries, backoff, deadlines, degradation ladder."""

    #: plain same-config retries before the ladder starts degrading
    max_retries: int = 2
    #: exponential backoff: ``base * 2**retry`` capped at ``cap``
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    #: deterministic jitter fraction added on top of the backoff
    jitter: float = 0.25
    #: parent-side deadline = ``factor * total_timeout_s + slack`` (the
    #: in-worker budget is cooperative; this one is not)
    deadline_factor: float = 1.5
    deadline_slack_s: float = 5.0
    #: rungs to climb after retries are exhausted, in order
    degradation: Tuple[str, ...] = DEGRADATION_RUNGS
    #: ``ii_max`` cap applied by the ``ii-capped`` rung
    degraded_ii_max: int = 8
    #: seed for the deterministic backoff jitter
    seed: int = 0

    def point_deadline_s(self, total_timeout_s: Optional[float],
                         ) -> Optional[float]:
        """Wall-clock kill deadline for one attempt (``None`` = no
        parent-side deadline when the point has no budget)."""
        if total_timeout_s is None:
            return None
        return total_timeout_s * self.deadline_factor + self.deadline_slack_s

    def backoff_s(self, key: str, retry: int) -> float:
        """Deterministic-jittered exponential backoff before a retry."""
        base = min(self.backoff_cap_s,
                   self.backoff_base_s * (2.0 ** max(retry, 0)))
        h = hashlib.sha256(f"{self.seed}|{key}|{retry}".encode()).digest()
        u = int.from_bytes(h[:8], "big") / 2.0**64
        return base * (1.0 + self.jitter * u)


def failure_record(kind: str, stage: str, exc: Optional[BaseException] = None,
                   message: Optional[str] = None,
                   attempt: int = 0) -> Dict[str, Any]:
    """The structured failure dict carried on results and DSE rows."""
    rec: Dict[str, Any] = {"kind": kind, "stage": stage, "attempt": attempt}
    if exc is not None:
        rec["type"] = type(exc).__name__
        rec["message"] = str(exc)
        tb = "".join(_traceback.format_exception(
            type(exc), exc, exc.__traceback__))
        rec["traceback"] = tb[-TRACEBACK_LIMIT:]
    elif message is not None:
        rec["message"] = message
    return rec


def failure_text(failure: Optional[Dict]) -> Optional[str]:
    """Flat ``"TypeName: message"`` digest of a failure record — the same
    shape :func:`repro_torch.toolchain.artifacts.format_error` produces, for
    the legacy ``CompileResult.error`` field."""
    if not failure:
        return None
    t, m = failure.get("type"), failure.get("message")
    if t and m is not None:
        return f"{t}: {m}"
    return m or failure.get("kind")


def classify_exception(exc: BaseException) -> str:
    """Map a worker-side exception onto the failure taxonomy."""
    if isinstance(exc, MemoryError):
        return FailureKind.OOM
    return FailureKind.SOLVER_ERROR


def _classify_exitcode(exitcode: Optional[int]) -> str:
    """A worker that died without sending a result: SIGKILL is the
    kernel OOM killer's signature; anything else is a crash."""
    if exitcode is not None and exitcode == -signal.SIGKILL:
        return FailureKind.OOM
    return FailureKind.WORKER_CRASH


def _arch_key(grid) -> str:
    """Deterministic architecture key for chaos decisions (stable across
    parent and workers)."""
    fp = grid.arch_fingerprint()
    return f"{grid.spec.rows}x{grid.spec.cols}" + (f"#{fp}" if fp else "")


# ---------------------------------------------------------------------------
# the worker entry point (one SAT mapping per message, chaos-aware)
# ---------------------------------------------------------------------------


def _resolve_runner(kind: str):
    """Payload-kind dispatch: every worker message carries an optional
    ``"kind"`` selecting its runner — ``"map"`` (default, one full
    mapping) or ``"race-ii"`` (one (II, strategy) portfolio attempt,
    :func:`repro_torch.core.portfolio.run_race_payload`)."""
    if kind == "race-ii":
        from ..core.portfolio import run_race_payload

        return run_race_payload
    return _run_map_payload


def _run_map_payload(payload: Dict[str, Any],
                     inline: bool = False, cancel=None) -> Dict[str, Any]:
    """One (kernel, grid, config, oracle) SAT mapping.  Never raises:
    failures come back as ``{"failure": {...}}`` with stage attribution
    and a truncated traceback.  The worker never touches the on-disk
    cache — the parent owns it.  ``kernel`` is a registry name or a bare
    :class:`~repro_torch.core.dfg.DFG` (the compile server's map-only wire
    requests pickle whole graphs).  ``cancel`` (the slot's cancel event)
    is accepted for runner-signature uniformity; whole-point mappings
    are not raced, so it is never polled here."""
    from ..obs import trace as obs_trace

    name = payload["kernel"]
    if not isinstance(name, str):
        name = getattr(name, "name", "<dfg>")
    with obs_trace.span("worker.map", parent=payload.get("trace"),
                        kernel=name,
                        attempt=payload.get("attempt", 0)) as wsp:
        out = _run_map_payload_impl(payload, inline=inline, cancel=cancel)
        if "result" in out:
            wsp.set(status=out["result"].get("status"))
        elif "failure" in out:
            wsp.set(failure=out["failure"].get("kind"))
    return out


def _run_map_payload_impl(payload: Dict[str, Any],
                          inline: bool = False, cancel=None) -> Dict[str, Any]:
    from ..core.facts import seed_from_jsonable
    from ..core.mapper import MapperConfig
    from .session import Toolchain

    kernel = payload["kernel"]
    grid = payload["grid"]
    attempt = payload.get("attempt", 0)

    spec = chaos.active()
    if spec is not None:
        chaos_key = (kernel if isinstance(kernel, str)
                     else getattr(kernel, "name", "<dfg>"))
        kind = spec.decide(chaos_key, _arch_key(grid), attempt)
        if kind in ("crash", "hang", "solver-error"):
            try:
                chaos.inject_worker_fault(kind, spec, inline=inline)
            except chaos.ChaosError as e:
                return {
                    "failure": failure_record(
                        FailureKind.SOLVER_ERROR, "map", e, attempt=attempt),
                    "map_time_s": 0.0,
                }

    stage = "source"
    t0 = time.monotonic()
    try:
        tc = Toolchain(grid, MapperConfig(**payload["cfg"]),
                       oracle=payload["oracle"])
        prog = tc.program(kernel)
        stage = "map"
        res, _hit = tc._map_cached(
            prog, facts_seed=seed_from_jsonable(payload.get("facts")),
            jobs=payload.get("map_jobs"))
    except BaseException as e:
        if isinstance(e, (KeyboardInterrupt, SystemExit)):
            raise
        err_stage = getattr(e, "stage", stage)
        return {
            "failure": failure_record(classify_exception(e), err_stage, e,
                                      attempt=attempt),
            "map_time_s": time.monotonic() - t0,
        }
    return {"result": res.to_dict(), "map_time_s": time.monotonic() - t0}


def _die_with_parent() -> None:
    """Ask the kernel to SIGKILL this worker when its parent dies
    (Linux ``PR_SET_PDEATHSIG``): a worker mid-solve or mid-(injected)-
    hang cannot watch its pipe for EOF, and must not outlive a killed
    sweep holding its stdout/journal fds open.  Best-effort no-op on
    platforms without ``prctl``."""
    try:
        import ctypes

        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(1, signal.SIGKILL)  # 1 = PR_SET_PDEATHSIG
        if os.getppid() == 1:  # parent already gone: the signal is lost
            os._exit(0)
    except Exception:
        pass


def _worker_loop(conn, peer_conns=(), cancel_event=None,
                 in_thread: bool = False) -> None:
    """Long-lived worker: receive ``(task_id, payload)``, answer
    ``(task_id, outcome)``; exit on EOF/sentinel (parent death included —
    a closed pipe ends the loop, no orphan can linger).  ``cancel_event``
    is this slot's cooperative-interruption flag: the parent sets it to
    abandon the in-flight task (portfolio racing), and clears it before
    every new assignment.

    ``peer_conns`` are the parent-side pipe ends inherited across
    ``fork`` — the siblings' and this worker's own (the parent closes
    our ``child_conn`` end only after the fork).  They must be closed
    here, or a worker keeps its own pipe writable and never sees EOF
    when the parent dies (the orphan fleet a chaos
    ``abort_after_points`` exit would otherwise leave behind).

    ``in_thread`` is the :class:`_InlineWorker` mode: the loop runs on a
    thread of the parent process, so it must not arm
    ``PR_SET_PDEATHSIG`` (that would cover the whole process) and it
    runs payloads ``inline`` so injected chaos faults raise instead of
    killing the embedder."""
    if not in_thread:
        _die_with_parent()
        for peer in peer_conns:
            try:
                peer.close()
            except OSError:
                pass
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError, KeyboardInterrupt):
            return
        if msg is None:
            return
        task_id, payload = msg
        runner = _resolve_runner(payload.get("kind", "map"))
        out = runner(payload, inline=in_thread, cancel=cancel_event)
        try:
            conn.send((task_id, out))
        except (BrokenPipeError, OSError):
            return


# ---------------------------------------------------------------------------
# per-point ladder state
# ---------------------------------------------------------------------------


@dataclass
class MapTask:
    """One design point riding the retry/degradation ladder."""

    key: Any                       # opaque caller key (e.g. (kernel, gi))
    kernel: Any                    # registry name, or a bare DFG (map-only)
    grid: Any                      # PEGrid (pickles whole)
    cfg: Dict[str, Any]            # MapperConfig asdict, mutated per rung
    oracle: Any                    # "assembler" | None | (tag, factory)
    #: scheduling priority: higher runs sooner among backoff-eligible
    #: tasks (FIFO within a priority level); batch fleets leave it 0
    priority: int = 0
    attempt: int = 0               # global attempt counter (chaos key)
    retries_in_rung: int = 0
    rung: int = -1                 # -1 = original config
    rung_label: Optional[str] = None
    not_before: float = 0.0        # monotonic backoff eligibility
    map_time_s: float = 0.0        # accumulated across attempts
    failures: List[Dict] = field(default_factory=list)
    #: late-bound fact lifting (repro_torch.core.facts): called at *assign*
    #: time — always in the parent, for both fleets — so a point queued
    #: behind a finished sibling sees the sibling's published facts.  The
    #: callable itself never crosses the pickle boundary, only its plain-
    #: JSON return value does.
    facts_provider: Optional[Callable[[], Optional[Dict]]] = None
    #: obs span shipping context (``Span.ship()`` of the parent-side
    #: bracketing span): rides the payload so the worker's shard joins
    #: the parent's trace
    trace_ctx: Optional[Dict[str, str]] = None

    def payload(self) -> Dict[str, Any]:
        p = {"kernel": self.kernel, "grid": self.grid, "cfg": self.cfg,
             "oracle": self.oracle, "attempt": self.attempt}
        if self.facts_provider is not None:
            facts = self.facts_provider()
            if facts:
                p["facts"] = facts
        if self.trace_ctx is not None:
            p["trace"] = self.trace_ctx
        return p

    def attempt_id(self) -> Tuple[int, int]:
        """Unique per *attempt*, so a stale answer from a worker we
        decided to kill can never be mistaken for the retry's answer."""
        return (id(self), self.attempt)

    def deadline_s(self, rcfg: ResilienceConfig) -> Optional[float]:
        return rcfg.point_deadline_s(self.cfg.get("total_timeout_s"))


def _rung_applies(task: MapTask, rung: str, rcfg: ResilienceConfig) -> bool:
    """Apply one degradation rung to the task config (cumulatively);
    ``False`` when the rung has nothing to change."""
    from ..core.backends import resolve_backend

    if rung == "backend-flip":
        current = resolve_backend(task.cfg.get("backend", "auto"))
        if current == "z3":
            other = "cdcl"
        else:
            try:
                import z3  # noqa: F401
                other = "z3"
            except ImportError:
                return False
        task.cfg = dict(task.cfg, backend=other)
        return True
    if rung == "oracle-off":
        if task.oracle is None:
            return False
        task.oracle = None
        return True
    if rung == "ii-capped":
        capped = min(task.cfg.get("ii_max", 50), rcfg.degraded_ii_max)
        if capped == task.cfg.get("ii_max"):
            return False
        task.cfg = dict(task.cfg, ii_max=capped)
        return True
    raise ValueError(f"unknown degradation rung {rung!r}")


def _advance(task: MapTask, failure: Dict, rcfg: ResilienceConfig,
             now: float) -> bool:
    """Record ``failure`` and move the task to its next ladder position.
    Returns ``False`` when the ladder is exhausted (terminal failure)."""
    task.failures.append(failure)
    task.attempt += 1
    if task.retries_in_rung < rcfg.max_retries:
        retry = task.retries_in_rung
        task.retries_in_rung += 1
        task.not_before = now + rcfg.backoff_s(str(task.key), retry)
        return True
    while True:
        task.rung += 1
        if task.rung >= len(rcfg.degradation):
            return False
        rung = rcfg.degradation[task.rung]
        if _rung_applies(task, rung, rcfg):
            task.rung_label = rung
            task.retries_in_rung = rcfg.max_retries  # one shot per rung
            task.not_before = now
            return True


def _finalize(task: MapTask, out: Optional[Dict]) -> Dict[str, Any]:
    """The per-point outcome handed back to ``compile_many``."""
    outcome: Dict[str, Any] = {
        "map_time_s": task.map_time_s,
        "attempts": task.attempt + 1,
        "degraded": task.rung_label,
        "failure": task.failures[-1] if task.failures else None,
    }
    if out is not None and "result" in out:
        outcome["result"] = out["result"]
    return outcome


# ---------------------------------------------------------------------------
# the supervised fleet
# ---------------------------------------------------------------------------


class _Worker:
    """One supervised slot: a process plus its dedicated duplex pipe and
    a cooperative-cancellation event (portfolio racing)."""

    __slots__ = ("proc", "conn", "task", "deadline_at", "cancel_event",
                 "cancelled")

    #: the parent may SIGKILL this slot on a blown deadline
    enforces_deadline = True

    def __init__(self, ctx, peers=(), extra_close=()):
        self.conn, child_conn = ctx.Pipe(duplex=True)
        self.cancel_event = ctx.Event()
        # every parent-side conn open at fork time is inherited by the
        # child — the peers' AND our own (child_conn.close() below only
        # runs in the parent).  The child must drop them all, or each
        # worker keeps its own pipe writable and never sees EOF when the
        # parent dies.  ``extra_close`` adds pool-level conns (the wake
        # pipe) to the same hygiene list.
        close_in_child = ([w.conn for w in peers] + [self.conn]
                          + list(extra_close))
        self.proc = ctx.Process(target=_worker_loop,
                                args=(child_conn, close_in_child,
                                      self.cancel_event),
                                daemon=True)
        self.proc.start()
        child_conn.close()
        self.task: Optional[MapTask] = None
        self.deadline_at: Optional[float] = None
        self.cancelled = False

    @property
    def busy(self) -> bool:
        return self.task is not None

    @property
    def exitcode(self) -> Optional[int]:
        return self.proc.exitcode

    def assign(self, task: MapTask, rcfg: ResilienceConfig,
               now: float) -> None:
        # the worker is idle (blocked in recv), so clearing a leftover
        # cancel flag here cannot race the previous task
        self.cancel_event.clear()
        self.cancelled = False
        self.task = task
        dl = task.deadline_s(rcfg)
        self.deadline_at = (now + dl) if dl is not None else None
        self.conn.send((task.attempt_id(), task.payload()))

    def cancel(self) -> bool:
        """Ask the in-flight task to stop (cooperative: the solver polls
        the event and answers ``"interrupted"``).  Returns True the first
        time a busy slot is cancelled, False otherwise."""
        if self.task is None or self.cancelled:
            return False
        self.cancelled = True
        self.cancel_event.set()
        return True

    def shutdown(self) -> None:
        try:
            if self.proc.is_alive():
                self.conn.send(None)
        except (BrokenPipeError, OSError):
            pass
        self.conn.close()
        self.proc.join(timeout=0.5)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(timeout=1.0)

    def kill(self) -> Optional[int]:
        """SIGKILL the slot (deadline enforcement); returns exit code."""
        self.proc.kill()
        self.proc.join(timeout=5.0)
        self.conn.close()
        return self.proc.exitcode


class _InlineWorker:
    """A slot backed by a thread of *this* process, speaking the exact
    same pipe protocol as :class:`_Worker` (the multiplexer cannot tell
    them apart).  For embedders that must not fork — the serving tests,
    stdio servers under multi-threaded runtimes — at the cost of
    process-grade isolation: deadlines degrade to the solver's
    cooperative budgets (a thread cannot be SIGKILLed), exactly like
    :func:`run_inline`."""

    __slots__ = ("conn", "cancel_event", "task", "deadline_at", "cancelled",
                 "_thread")

    enforces_deadline = False

    def __init__(self, ctx=None, peers=(), extra_close=()):
        self.conn, child_conn = multiprocessing.Pipe(duplex=True)
        self.cancel_event = threading.Event()
        self._thread = threading.Thread(
            target=_worker_loop,
            args=(child_conn, (), self.cancel_event),
            kwargs={"in_thread": True},
            daemon=True,
        )
        self._thread.start()
        self.task: Optional[MapTask] = None
        self.deadline_at: Optional[float] = None
        self.cancelled = False

    @property
    def busy(self) -> bool:
        return self.task is not None

    @property
    def exitcode(self) -> Optional[int]:
        return None

    def assign(self, task: MapTask, rcfg: ResilienceConfig,
               now: float) -> None:
        self.cancel_event.clear()
        self.cancelled = False
        self.task = task
        self.deadline_at = None  # cooperative budgets only (no SIGKILL)
        self.conn.send((task.attempt_id(), task.payload()))

    cancel = _Worker.cancel

    def shutdown(self) -> None:
        try:
            self.conn.send(None)
        except (BrokenPipeError, OSError):
            pass
        self.conn.close()
        self._thread.join(timeout=1.0)

    def kill(self) -> Optional[int]:  # pragma: no cover - never scheduled
        raise RuntimeError("inline workers enforce no deadline to kill for")


class WorkerPool:
    """Persistent supervised fleet with a thread-safe ``submit`` API.

    The pool decouples worker lifetime from any batch so a long-lived
    embedder (a compile server) keeps warm solver workers across
    requests.  Everything the batch fleet proved —
    parent-side deadlines, crash healing, the retry/degradation ladder,
    typed terminal failures — happens unchanged inside :meth:`_step`.

    Scheduling: among backoff-eligible tasks, higher
    :attr:`MapTask.priority` is assigned first (FIFO within a level); a
    task in backoff is ordered by its eligibility time first, so a
    retrying high-priority point cannot pin the queue.

    Two driving modes: :meth:`drain` runs the multiplexer in the calling
    thread until the queue is empty (batch mode, what
    :func:`run_supervised` uses), or :meth:`start` spawns a daemon
    multiplexer thread and ``submit``/outcome callbacks flow concurrently
    (server mode; callbacks fire on the multiplexer thread).

    ``inline=True`` swaps worker processes for :class:`_InlineWorker`
    threads — same protocol, no forking, cooperative deadlines only.
    """

    def __init__(self, jobs: Optional[int] = None,
                 rcfg: Optional[ResilienceConfig] = None,
                 inline: bool = False):
        self.rcfg = rcfg or ResilienceConfig()
        self.inline = inline
        self._ctx = multiprocessing.get_context()
        self._jobs = max(1, jobs if jobs is not None else (os.cpu_count()
                                                           or 1))
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        # heap of (not_before, -priority, seq, task): eligibility first —
        # every entry behind an ineligible top is ineligible too — then
        # priority, then submission order
        self._ready: List[Tuple[float, int, int, MapTask]] = []
        self._seq = 0
        self._pending = 0
        self._callbacks: Dict[int, Optional[Callable[[Any, Dict], None]]] = {}
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        # self-pipe: submit() wakes a multiplexer blocked in _conn_wait
        self._wake_r, self._wake_w = multiprocessing.Pipe(duplex=False)
        self._workers: List[Any] = []
        for _ in range(self._jobs):
            self._workers.append(self._new_worker(self._workers))

    def _new_worker(self, peers):
        if self.inline:
            return _InlineWorker()
        return _Worker(self._ctx, peers=peers,
                       extra_close=(self._wake_r, self._wake_w))

    # -- submission --------------------------------------------------------

    def submit(self, task: MapTask,
               on_outcome: Optional[Callable[[Any, Dict], None]] = None,
               ) -> None:
        """Enqueue one task; ``on_outcome(task.key, outcome)`` fires on
        the driving thread when it terminates (result or typed failure).
        Callable from any thread."""
        with self._lock:
            if self._stop:
                raise RuntimeError("WorkerPool is shut down")
            self._pending += 1
            self._callbacks[id(task)] = on_outcome
            self._push(task)
            try:
                self._wake_w.send_bytes(b"w")
            except (BrokenPipeError, OSError):  # pragma: no cover
                pass

    def _push(self, task: MapTask) -> None:
        heapq.heappush(self._ready, (task.not_before, -task.priority,
                                     self._seq, task))
        self._seq += 1

    def pending(self) -> int:
        """Tasks submitted but not yet settled (queued + in flight)."""
        with self._lock:
            return self._pending

    # -- driving -----------------------------------------------------------

    def start(self) -> None:
        """Run the multiplexer on a daemon thread (server mode)."""
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="repro-worker-pool")
            self._thread.start()

    def _run(self) -> None:
        while not self._stop:
            self._step()

    def drain(self) -> None:
        """Block until every submitted task has settled.  Drives the
        multiplexer in the calling thread unless :meth:`start` owns it."""
        if self._thread is not None:
            with self._idle:
                self._idle.wait_for(lambda: self._pending == 0)
            return
        while self.pending():
            self._step()

    def shutdown(self) -> None:
        """Stop the multiplexer thread (if any) and the workers.  Unsettled
        tasks never fire their callbacks — shut down drained pools."""
        with self._lock:
            self._stop = True
            try:
                self._wake_w.send_bytes(b"w")
            except (BrokenPipeError, OSError):  # pragma: no cover
                pass
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        for w in self._workers:
            w.shutdown()
        self._wake_r.close()
        self._wake_w.close()

    # -- one multiplexer step ---------------------------------------------

    def _settle(self, task: MapTask, out: Optional[Dict],
                failure: Optional[Dict], now: float) -> None:
        task.map_time_s += (out or {}).get("map_time_s", 0.0)
        if out is not None and "result" in out:
            self._finish_task(task, _finalize(task, out))
            return
        fail = failure if failure is not None else (out or {}).get("failure")
        if fail is None:  # defensive: a malformed worker answer
            fail = failure_record(FailureKind.WORKER_CRASH, "map",
                                  message="malformed worker answer",
                                  attempt=task.attempt)
        if _advance(task, fail, self.rcfg, now):
            with self._lock:
                self._push(task)
        else:
            self._finish_task(task, _finalize(task, None))

    def _finish_task(self, task: MapTask, outcome: Dict) -> None:
        with self._lock:
            cb = self._callbacks.pop(id(task), None)
            self._pending -= 1
            if self._pending == 0:
                self._idle.notify_all()
        if cb is not None:
            cb(task.key, outcome)

    def _respawn(self, w) -> None:
        idx = self._workers.index(w)
        others = self._workers[:idx] + self._workers[idx + 1:]
        self._workers[idx] = self._new_worker(others)

    def _step(self, max_block_s: float = 0.5) -> None:
        now = time.monotonic()
        # assign eligible tasks to idle slots
        with self._lock:
            for w in self._workers:
                if w.busy or not self._ready:
                    continue
                if self._ready[0][0] > now:
                    break
                task = heapq.heappop(self._ready)[3]
                w.assign(task, self.rcfg, now)
        busy = [w for w in self._workers if w.busy]
        # how long may we block? until the nearest deadline or the
        # nearest backoff-eligibility, capped for responsiveness
        timeout = max_block_s
        for w in busy:
            if w.deadline_at is not None:
                timeout = min(timeout, max(w.deadline_at - now, 0.0))
        with self._lock:
            if self._ready and any(not w.busy for w in self._workers):
                timeout = min(timeout, max(self._ready[0][0] - now, 0.0))
        conns = [w.conn for w in busy] + [self._wake_r]
        for conn in _conn_wait(conns, timeout):
            if conn is self._wake_r:
                try:
                    while self._wake_r.poll(0):
                        self._wake_r.recv_bytes()
                except (EOFError, OSError):  # pragma: no cover
                    pass
                continue
            w = next(x for x in busy if x.conn is conn)
            task = w.task
            try:
                task_id, out = conn.recv()
            except (EOFError, OSError):
                # the worker died under the task: classify and heal
                if not self.inline:
                    w.proc.join(timeout=5.0)
                kind = _classify_exitcode(w.exitcode)
                fail = failure_record(
                    kind, "map", attempt=task.attempt,
                    message=f"worker exited with code {w.exitcode}")
                w.conn.close()  # before the respawn fork: no leak
                self._respawn(w)
                self._settle(task, None, fail, time.monotonic())
                continue
            if task_id != task.attempt_id():
                continue  # stale answer from a pre-kill attempt
            w.task, w.deadline_at = None, None
            self._settle(task, out, None, time.monotonic())
        # parent-side deadline enforcement: kill + recycle + requeue
        now = time.monotonic()
        for w in list(self._workers):
            if not w.busy or w.deadline_at is None or now < w.deadline_at:
                continue
            task = w.task
            w.kill()  # closes the pipe before the respawn fork
            self._respawn(w)
            fail = failure_record(
                FailureKind.DEADLINE, "map", attempt=task.attempt,
                message=(f"worker killed after exceeding the "
                         f"{task.deadline_s(self.rcfg):.1f}s point deadline"))
            self._settle(task, None, fail, now)


def run_supervised(tasks: List[MapTask], jobs: int,
                   rcfg: Optional[ResilienceConfig] = None,
                   on_outcome: Optional[Callable[[Any, Dict], None]] = None,
                   ) -> Dict[Any, Dict]:
    """Drive ``tasks`` through a self-healing worker fleet (batch
    adapter over :class:`WorkerPool`).

    Returns ``{task.key: outcome}``; ``on_outcome`` additionally fires in
    completion order (journaling hook).  Never raises for per-point
    failures — every task terminates with a result or a typed failure.
    """
    outcomes: Dict[Any, Dict] = {}
    pool = WorkerPool(jobs=max(1, min(jobs, len(tasks))), rcfg=rcfg)

    def record(key: Any, outcome: Dict) -> None:
        outcomes[key] = outcome
        if on_outcome is not None:
            on_outcome(key, outcome)

    try:
        for t in tasks:
            pool.submit(t, record)
        pool.drain()
    finally:
        pool.shutdown()
    return outcomes


def run_inline(tasks: List[MapTask],
               rcfg: Optional[ResilienceConfig] = None,
               on_outcome: Optional[Callable[[Any, Dict], None]] = None,
               ) -> Dict[Any, Dict]:
    """The ``jobs=1`` path: same ladder, no subprocesses.  Deadlines stay
    cooperative (``total_timeout_s`` inside the solver) — an inline run
    cannot kill itself — and chaos ``crash``/``hang`` degrade to raised
    errors (see :func:`chaos.inject_worker_fault`)."""
    rcfg = rcfg or ResilienceConfig()
    outcomes: Dict[Any, Dict] = {}
    for task in tasks:
        while True:
            now = time.monotonic()
            if task.not_before > now:
                time.sleep(task.not_before - now)
            out = _run_map_payload(task.payload(), inline=True)
            task.map_time_s += out.get("map_time_s", 0.0)
            if "result" in out:
                outcome = _finalize(task, out)
                break
            if not _advance(task, out["failure"], rcfg, time.monotonic()):
                outcome = _finalize(task, None)
                break
        outcomes[task.key] = outcome
        if on_outcome is not None:
            on_outcome(task.key, outcome)
    return outcomes
