"""CEGAR oracles for the mapping stage — one shared implementation.

Before the toolchain existed, the bitstream-assembler oracle (reject a
mapping whose prologue clobbers a live carry, feed the offending
placement triples back as a blocking clause) was re-implemented as a
private closure in ``dse/sweep.py``, ``frontend/verify.py``,
``cgra/simulator.py`` and the benchmark scripts.  This module is now the
only place that builds it.

An oracle *factory* takes the program (LoopBuilder) and returns the
per-mapping ``check`` callable that :func:`repro_torch.core.mapper.map_dfg`
accepts as ``assemble_check``: ``check(mapping)`` returns ``None`` when
the mapping survives code generation, else the placement-triple list to
forbid.  Each factory carries a *tag* that becomes part of the
content-addressed cache key (``mapping_cache_key(..., extra=tag)``) so
plain un-oracled results can never alias oracle-checked ones.

A copy of ``src/repro/toolchain/oracles.py``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

# cache-key tag of the assembler oracle — the exact string the DSE sweep
# has always used, so pre-toolchain cache entries stay valid
ORACLE_TAG = "oracle=bitstream-prologue"


def assembler_oracle(program) -> Callable:
    """The paper's codegen-level CEGAR oracle: try to assemble, convert a
    :class:`~repro_torch.cgra.bitstream.PrologueClobber` into a counterexample."""
    from ..cgra.bitstream import PrologueClobber, assemble

    def check(mapping):
        try:
            assemble(program, mapping)
        except PrologueClobber as e:
            return e.triples
        return None

    return check


def resolve_oracle(oracle) -> Tuple[str, Optional[Callable]]:
    """Normalize the ``Toolchain(oracle=...)`` argument.

    ``"assembler"`` (the default) -> the shared assembler oracle;
    ``None`` -> no CEGAR feedback; a ``(tag, factory)`` pair -> a custom
    oracle with an explicit cache tag; a bare callable -> a custom
    factory tagged by its ``__name__``.
    """
    if oracle is None:
        return "", None
    if oracle == "assembler":
        return ORACLE_TAG, assembler_oracle
    if isinstance(oracle, tuple):
        tag, factory = oracle
        return str(tag), factory
    if callable(oracle):
        name = getattr(oracle, "__name__", oracle.__class__.__name__)
        return f"oracle={name}", oracle
    msg = (
        f"unknown oracle {oracle!r}; expected 'assembler', None, "
        "a factory callable, or a (tag, factory) pair"
    )
    raise ValueError(msg)
