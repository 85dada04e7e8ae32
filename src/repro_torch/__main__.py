"""``python -m repro_torch {map,fuzz} ...``: the port's command line."""
import sys

_USAGE = "usage: python -m repro_torch {map,fuzz} [--help]"


def _main(argv) -> int:
    if argv and argv[0] == "map":
        from .toolchain.cli import main
    elif argv and argv[0] == "fuzz":
        from .fuzz.cli import main
    else:
        print(_USAGE, file=sys.stderr)
        return 2
    return main(argv[1:])


sys.exit(_main(sys.argv[1:]))
