"""Cross-process trace spans.

A *trace* is a tree of *spans*; each span has a trace id, a span id, an
optional parent span id, a name, wall-clock start, duration, and typed
attributes. Spans are written as newline-JSON records to a per-process
*shard* file inside the trace directory — processes never share a file
descriptor, so no locking is needed across the fleet, and the analysis
layer (:mod:`repro.obs.report`) merges shards on read.

Cross-process propagation is explicit: the parent serializes
``span.ship()`` (directory + trace id + span id) into the task payload,
and the worker passes that dict as ``parent=`` to :func:`span`, which
(re-)enables tracing in the child on demand. This survives both ``fork``
(stale inherited state is overridden) and fresh processes.

When tracing is disabled, :func:`span` returns a shared no-op singleton
and writes nothing — the fast path is one global check. The toolchain's
stage timers use :func:`timed_span`, which still measures duration when
disabled (so ``CompileResult.timings`` stays populated) but never
touches the sink.

Record schema (``SCHEMA_VERSION == 1``)::

    {"v": 1, "k": "span", "trace": id, "span": id, "parent": id|null,
     "name": str, "pid": int, "tid": int, "ts": wall_s, "dur": s,
     "attrs": {...}}
    {"v": 1, "k": "event", "trace": id, "span": owner_id, "name": str,
     "pid": int, "tid": int, "ts": wall_s, "attrs": {...}}

``ts`` is ``time.time()`` so shards from different processes align on a
shared clock; ``dur`` is measured with ``time.monotonic()``.

While a ``torch.profiler`` records in this process, a span entered with
``with`` (a :class:`Span`, or the :func:`timed_span` timer) also enters a
``record_function`` range of its own name, so the profiler's host events
carry the program's phases; ``ts`` is on the profiler's clock (Unix
epoch), so shards line up with an exported profiler trace.  Without a
profiler the cost is one check per span, and this module never imports
torch itself.

A copy of ``src/repro/obs/trace.py`` (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from contextvars import ContextVar
from typing import Any, Dict, Optional

SCHEMA_VERSION = 1

#: Environment variable naming a trace directory; when set, tracing is
#: enabled at import time (how fresh worker processes inherit it).
ENV_VAR = "REPRO_TRACE"

_lock = threading.Lock()
_enabled = False
_dir: Optional[str] = None
_sink = None
_sink_pid: Optional[int] = None

_current: ContextVar[Optional["Span"]] = ContextVar("repro_obs_span", default=None)


def _new_id() -> str:
    return os.urandom(8).hex()


def enabled() -> bool:
    """True when spans are being recorded in this process."""
    return _enabled


def trace_dir() -> Optional[str]:
    """The active trace directory, or None when disabled."""
    return _dir


def enable(path: str) -> str:
    """Start recording spans into shard files under ``path``.

    Idempotent for the same directory; switching directories closes the
    previous shard. Returns the (created) directory.
    """
    global _enabled, _dir, _sink, _sink_pid
    path = os.path.abspath(path)
    with _lock:
        if _enabled and _dir == path:
            return path
        if _sink is not None:
            try:
                _sink.close()
            except OSError:
                pass
        os.makedirs(path, exist_ok=True)
        _dir = path
        _sink = None
        _sink_pid = None
        _enabled = True
    return path


def disable() -> None:
    """Stop recording; subsequent :func:`span` calls are no-ops."""
    global _enabled, _dir, _sink, _sink_pid
    with _lock:
        if _sink is not None:
            try:
                _sink.close()
            except OSError:
                pass
        _enabled = False
        _dir = None
        _sink = None
        _sink_pid = None


def _write(record: Dict[str, Any]) -> None:
    """Append one record to this process's shard (reopened after fork)."""
    global _sink, _sink_pid
    line = json.dumps(record, separators=(",", ":"), sort_keys=True)
    with _lock:
        if not _enabled or _dir is None:
            return
        pid = os.getpid()
        if _sink is None or _sink_pid != pid:
            # First write in this process, or an inherited file object
            # from a forked parent: (re)open our own shard.
            shard = os.path.join(_dir, f"shard-{pid}-{_new_id()[:6]}.jsonl")
            _sink = open(shard, "a", encoding="utf-8")
            _sink_pid = pid
        _sink.write(line + "\n")
        _sink.flush()


def _profiler_range(name: str):
    """A ``record_function`` range of ``name``, entered, while a torch
    profiler records in this process; otherwise None."""
    torch = sys.modules.get("torch")
    if torch is None or not torch._C._autograd._profiler_enabled():
        return None
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


class Span:
    """A live span. Use as a context manager, or ``begin()``/``finish()``."""

    __slots__ = (
        "trace_id",
        "span_id",
        "parent_id",
        "name",
        "attrs",
        "t0",
        "ts",
        "dur",
        "_token",
        "_done",
        "_range",
    )

    def __init__(
        self,
        name: str,
        attrs: Dict[str, Any],
        trace_id: Optional[str] = None,
        parent_id: Optional[str] = None,
    ) -> None:
        if trace_id is None:
            cur = _current.get()
            if cur is not None:
                trace_id = cur.trace_id
                parent_id = cur.span_id
            else:
                trace_id = _new_id()
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.span_id = _new_id()
        self.name = name
        self.attrs = attrs
        self.t0 = time.monotonic()
        self.ts = time.time()
        self.dur = 0.0
        self._token = None
        self._done = False
        self._range = None

    def set(self, **attrs: Any) -> "Span":
        """Attach attributes; must happen before the span finishes."""
        self.attrs.update(attrs)
        return self

    def event(self, name: str, **attrs: Any) -> None:
        """Record an instantaneous event owned by this span."""
        _write(
            {
                "v": SCHEMA_VERSION,
                "k": "event",
                "trace": self.trace_id,
                "span": self.span_id,
                "name": name,
                "pid": os.getpid(),
                "tid": threading.get_ident() & 0xFFFFFFFF,
                "ts": round(time.time(), 6),
                "attrs": attrs,
            }
        )

    def ship(self) -> Dict[str, str]:
        """Context for a child process: pass as ``parent=`` to :func:`span`."""
        return {"dir": _dir or "", "trace": self.trace_id, "span": self.span_id}

    def finish(self, **attrs: Any) -> "Span":
        """Close the span and write its record (idempotent)."""
        if self._done:
            return self
        self._done = True
        if attrs:
            self.attrs.update(attrs)
        self.dur = time.monotonic() - self.t0
        _write(
            {
                "v": SCHEMA_VERSION,
                "k": "span",
                "trace": self.trace_id,
                "span": self.span_id,
                "parent": self.parent_id,
                "name": self.name,
                "pid": os.getpid(),
                "tid": threading.get_ident() & 0xFFFFFFFF,
                "ts": round(self.ts, 6),
                "dur": round(self.dur, 6),
                "attrs": self.attrs,
            }
        )
        return self

    def __enter__(self) -> "Span":
        self._token = _current.set(self)
        self._range = _profiler_range(self.name)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self.finish()
        return False


class _NullSpan:
    """Shared do-nothing span returned when tracing is disabled."""

    __slots__ = ()
    trace_id = ""
    span_id = ""
    parent_id = None
    name = ""
    dur = 0.0

    def set(self, **attrs: Any) -> "_NullSpan":
        return self

    def event(self, name: str, **attrs: Any) -> None:
        return None

    def ship(self) -> None:  # no context to propagate
        return None

    def finish(self, **attrs: Any) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NULL_SPAN = _NullSpan()


class _Timer:
    """Duration-only span substitute used by :func:`timed_span` when
    tracing is off — measures ``dur`` but never touches the sink (a
    profiler, while one records, still sees its range)."""

    __slots__ = ("name", "t0", "dur", "_range")

    def __init__(self, name: str) -> None:
        self.name = name
        self.t0 = 0.0
        self.dur = 0.0
        self._range = None

    def set(self, **attrs: Any) -> "_Timer":
        return self

    def event(self, name: str, **attrs: Any) -> None:
        return None

    def ship(self) -> None:
        return None

    def finish(self, **attrs: Any) -> "_Timer":
        if self.dur == 0.0:
            self.dur = time.monotonic() - self.t0
        return self

    def __enter__(self) -> "_Timer":
        self.t0 = time.monotonic()
        self._range = _profiler_range(self.name)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        self.dur = time.monotonic() - self.t0
        return False


def span(name: str, parent: Optional[Dict[str, str]] = None, **attrs: Any):
    """Open a span (use ``with``). No-op singleton when disabled.

    ``parent`` is a ``Span.ship()`` dict from another process: it pins
    the trace/parent ids and enables tracing here on demand, overriding
    any state inherited across ``fork``.
    """
    if parent is not None and parent.get("dir"):
        enable(parent["dir"])
        return Span(name, attrs, trace_id=parent["trace"], parent_id=parent["span"])
    if not _enabled:
        return NULL_SPAN
    return Span(name, attrs)


def timed_span(name: str, **attrs: Any):
    """Like :func:`span`, but when tracing is disabled returns a
    duration-only timer instead of the no-op singleton. The toolchain's
    stage timing (``CompileResult.timings``) is a projection of these."""
    if not _enabled:
        return _Timer(name)
    return Span(name, attrs)


def current() -> Optional[Span]:
    """The innermost live span on this thread/task, if any."""
    if not _enabled:
        return None
    return _current.get()


def event(name: str, **attrs: Any) -> None:
    """Record an event on the current span (no-op without one)."""
    if not _enabled:
        return
    cur = _current.get()
    if cur is not None:
        cur.event(name, **attrs)


def shipping_context() -> Optional[Dict[str, str]]:
    """``ship()`` of the current span, for task payloads; None when
    disabled or outside any span."""
    if not _enabled:
        return None
    cur = _current.get()
    return cur.ship() if cur is not None else None


def begin(name: str, parent: Optional[Dict[str, str]] = None, **attrs: Any):
    """Start a span *without* making it current (no ``with`` nesting).

    For bracketing async work — e.g. a fleet task from submit to settle.
    The caller must ``finish()`` it. Parent defaults to the current span.
    """
    if parent is not None and parent.get("dir"):
        enable(parent["dir"])
        return Span(name, attrs, trace_id=parent["trace"], parent_id=parent["span"])
    if not _enabled:
        return NULL_SPAN
    return Span(name, attrs)


if os.environ.get(ENV_VAR):
    enable(os.environ[ENV_VAR])
