"""``python -m repro_torch.dse``: the same sweep as ``python -m
repro_torch sweep``, kept as ``src/repro/dse/__main__.py`` keeps it — a
deprecated shim that forwards its arguments verbatim."""

import sys
import warnings

from .cli import main

warnings.warn(
    "python -m repro_torch.dse is deprecated; "
    "use: python -m repro_torch sweep",
    DeprecationWarning, stacklevel=1)
sys.exit(main(sys.argv[1:]))
