"""The paper's primary contribution: SAT-based exact modulo-scheduling
mapping, copied from ``src/repro/core`` (the heuristic baseline is not
ported yet; see ``ROADMAP.md``)."""
from .dfg import DFG, Edge, Node, running_example
from .schedule import (KMS, MobilitySchedule, Slot, asap_alap, fold_kms,
                       kms_ii_upper_bound)
from .mii import min_ii, rec_ii, res_ii
from .sat_encoding import EncodingBudgetExceeded, KMSEncoding
from .backends import (CDCLSession, PortfolioSpec, SolverSession, Strategy,
                       Z3Session, make_session, parse_portfolio,
                       parse_strategy, resolve_backend)
from .mapping import Mapping, Placement, validate_mapping
from .facts import FactStore
from .mapper import (IIAttempt, IIOutcome, MapperConfig, MapResult,
                     attempt_ii, map_dfg, map_dfg_cached, mapping_cache_key)
from .regalloc import allocate_registers

__all__ = [
    "DFG", "Edge", "Node", "running_example",
    "KMS", "MobilitySchedule", "Slot", "asap_alap", "fold_kms",
    "kms_ii_upper_bound",
    "min_ii", "rec_ii", "res_ii",
    "KMSEncoding", "EncodingBudgetExceeded",
    "SolverSession", "CDCLSession", "Z3Session", "make_session",
    "resolve_backend",
    "Strategy", "PortfolioSpec", "parse_strategy", "parse_portfolio",
    "Mapping", "Placement", "validate_mapping",
    "FactStore",
    "MapperConfig", "MapResult", "IIAttempt", "IIOutcome", "attempt_ii",
    "map_dfg", "map_dfg_cached", "mapping_cache_key",
    "allocate_registers",
]
