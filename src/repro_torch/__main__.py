"""``python -m repro_torch {map,serve,submit,cosim,fuzz,sweep,trace,list,arch}
...``: the port's command line.  Each verb is dispatched before any argparse, as
``src/repro/toolchain/cli.py`` does, so its own flags and ``--help`` reach
its parser."""
import sys

_USAGE = ("usage: python -m repro_torch "
          "{map,serve,submit,cosim,fuzz,sweep,trace,list,arch} [--help]")


def _main(argv) -> int:
    if argv and argv[0] == "map":
        from .toolchain.cli import main
    elif argv and argv[0] == "serve":
        from .toolchain.cli import serve_main as main
    elif argv and argv[0] == "submit":
        from .toolchain.cli import submit_main as main
    elif argv and argv[0] == "cosim":
        from .frontend.verify import main
    elif argv and argv[0] == "fuzz":
        from .fuzz.cli import main
    elif argv and argv[0] == "sweep":
        from .dse.cli import main
    elif argv and argv[0] == "trace":
        from .obs.cli import main
    elif argv and argv[0] == "list":
        from .toolchain.cli import list_main as main
    elif argv and argv[0] == "arch":
        from .toolchain.cli import arch_main as main
    else:
        print(_USAGE, file=sys.stderr)
        return 2
    return main(argv[1:])


sys.exit(_main(sys.argv[1:]))
