"""Server-side request bookkeeping: in-flight dedup, tenant budgets,
serving counters.

All three classes are plain single-threaded state — the compile server
touches them only from its event loop (pool callbacks hop onto the loop
via ``call_soon_threadsafe`` first), so no locking is needed or wanted
here.

A copy of ``src/repro/serve/queue.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional


class InflightCompiles:
    """Coalesces concurrent identical work by content-addressed cache
    key: the first waiter to :meth:`join` a key is the *leader* (it
    submits the one real compile), every later waiter rides along and is
    settled from the same outcome."""

    def __init__(self):
        self._waiters: Dict[str, List] = {}

    def join(self, key: str, waiter) -> bool:
        """Register ``waiter`` (an asyncio future) under ``key``;
        ``True`` iff it is the leader."""
        group = self._waiters.get(key)
        if group is None:
            self._waiters[key] = [waiter]
            return True
        group.append(waiter)
        return False

    def pop(self, key: str) -> List:
        """All waiters for ``key`` (leader first), clearing the entry."""
        return self._waiters.pop(key, [])

    def depth(self, key: str) -> int:
        return len(self._waiters.get(key, ()))

    def __len__(self) -> int:
        return len(self._waiters)


class TenantBudgets:
    """Per-tenant admission control: at most ``max_inflight`` admitted
    (not yet answered) requests per tenant; ``None`` disables the
    limit.  Rejection is explicit and immediate — a tenant at its budget
    gets a typed ``rejected`` response, not unbounded queueing."""

    def __init__(self, max_inflight: Optional[int] = None):
        self.max_inflight = max_inflight
        self._inflight: Dict[str, int] = {}

    def admit(self, tenant: str) -> bool:
        n = self._inflight.get(tenant, 0)
        if self.max_inflight is not None and n >= self.max_inflight:
            return False
        self._inflight[tenant] = n + 1
        return True

    def release(self, tenant: str) -> None:
        n = self._inflight.get(tenant, 0) - 1
        if n <= 0:
            self._inflight.pop(tenant, None)
        else:
            self._inflight[tenant] = n

    def snapshot(self) -> Dict[str, int]:
        return dict(self._inflight)


class ServeStats:
    """Monotonic serving counters, exposed over the ``stats`` message
    and consumed by the serving benchmark lane.  ``received`` counts
    every compile request; exactly one of ``compiled`` / ``cache_hits``
    / ``coalesced`` / ``rejected`` / ``errors`` accounts for each."""

    def __init__(self):
        self.received = 0
        self.compiled = 0
        self.cache_hits = 0
        self.coalesced = 0
        self.rejected = 0
        self.errors = 0

    def snapshot(self) -> Dict[str, int]:
        return {
            "received": self.received,
            "compiled": self.compiled,
            "cache_hits": self.cache_hits,
            "coalesced": self.coalesced,
            "rejected": self.rejected,
            "errors": self.errors,
        }
