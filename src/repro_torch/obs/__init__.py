"""Tracing for the port's mapper and toolchain: :mod:`repro_torch.obs.trace`
is a copy of ``src/repro/obs/trace.py`` (spans, ``timed_span``, JSONL
shards under ``REPRO_TRACE``).  The metrics registry and the trace
reports are not ported yet (``ROADMAP.md``)."""
