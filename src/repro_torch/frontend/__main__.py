"""Deprecated entry point — ``python -m repro_torch cosim`` is the
canonical CLI, as ``python -m repro cosim`` is in the JAX package.  This
shim forwards verbatim."""

import sys
import warnings

from .verify import main

warnings.warn(
    "python -m repro_torch.frontend is deprecated; use: "
    "python -m repro_torch cosim",
    DeprecationWarning, stacklevel=1)
sys.exit(main(sys.argv[1:]))
