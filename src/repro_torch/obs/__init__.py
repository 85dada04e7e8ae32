"""repro_torch.obs — tracing, metrics, and "where did the time go" analysis,
copied from ``src/repro/obs``.

Three layers:

- :mod:`repro_torch.obs.trace` — hierarchical spans with trace/span/parent
  ids, a near-zero-cost no-op path when disabled, and a process-safe
  JSONL shard sink so fleet workers contribute to one merged trace.
- :mod:`repro_torch.obs.metrics` — an in-process counter/histogram
  registry.
- :mod:`repro_torch.obs.report` — loads merged traces, checks span-tree
  well-formedness, renders critical-path/attribution reports, and
  exports Chrome trace-event JSON (Perfetto-viewable).

Both packages write one shard schema, so either package's report reads
either package's traces (``python -m repro_torch trace``).
"""

from .metrics import Counter, Histogram, MetricsRegistry
from .trace import (
    SCHEMA_VERSION,
    disable,
    enable,
    enabled,
    event,
    shipping_context,
    span,
    timed_span,
    trace_dir,
)

__all__ = [
    "SCHEMA_VERSION",
    "Counter",
    "Histogram",
    "MetricsRegistry",
    "disable",
    "enable",
    "enabled",
    "event",
    "shipping_context",
    "span",
    "timed_span",
    "trace_dir",
]
