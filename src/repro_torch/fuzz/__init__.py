"""Batched differential fuzzing of mapped kernels: corpora, oracle, engine,
stacked runs, triage, switching activity, CLI.

* :mod:`repro_torch.fuzz.corpus`   deterministic seeded memory generators
* :mod:`repro_torch.fuzz.engine`   batched oracle + batched/stacked execution
* :mod:`repro_torch.fuzz.triage`   shrinking, divergence replay, reproducers
* :mod:`repro_torch.fuzz.activity` switching activity, on the trace's device
* :mod:`repro_torch.fuzz.cli`      ``python -m repro_torch fuzz``
"""

from .activity import ActivityAccumulator, ActivityReport, harvest_activity  # noqa: F401
from .corpus import STRATEGIES, make_corpus  # noqa: F401
from .engine import (  # noqa: F401
    FuzzReport,
    batched_oracle,
    batched_oracle_iterations,
    fuzz_kernel,
    fuzz_program,
    fuzz_stacked,
    run_stacked,
)
from .triage import (  # noqa: F401
    Divergence,
    first_divergence,
    inject_fault,
    shrink,
    triage_failure,
)
