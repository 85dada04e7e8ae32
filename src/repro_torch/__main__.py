"""``python -m repro_torch fuzz ...``: the port's command line."""
import sys

from .fuzz.cli import main


def _main(argv) -> int:
    if not argv or argv[0] != "fuzz":
        print("usage: python -m repro_torch fuzz [--help]", file=sys.stderr)
        return 2
    return main(argv[1:])


sys.exit(_main(sys.argv[1:]))
