"""The content-addressed mapping cache of ``src/repro/dse``.  The sweep,
the design space and the Pareto analysis of that package are not ported
yet (``ROADMAP.md``)."""
from .cache import MappingCache

__all__ = ["MappingCache"]
