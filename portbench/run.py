"""Run one cell of the benchmark of ``repro_torch`` once, on the card.

    python3 portbench/run.py --workload fuzz-4x4-b16384 --seed 7 \\
        --seconds 10 --trace 0

Run from the root of a checkout.  The cell is read from ``BENCHMARK.json``;
its configuration, traffic and metrics from their files under
``portbench/``.  The run sets up, warms every shape it uses, measures, and
then checks what the timed path answered against the plain reference.
The last line of standard output is the result (``--trace 0``: the cell's
end-to-end metrics; ``--trace 1``: its per-layer metrics, from one
profiled window); the last lines of standard error are the numbers
compared, each beside its limit.  Without a card it prints no result and
exits 2; with JAX or the JAX package loaded once the window has closed it
exits 3.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = ROOT / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from portbench.harness import result, spec

    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    line, numbers = result.run_once(cell, args.seed, args.seconds,
                                    bool(args.trace), "cuda", T0)
    found = result.forbidden_modules()
    if found:
        print(f"portbench: loaded in the measuring process: {found}",
              file=sys.stderr)
        return 3
    for name, (value, limit) in numbers.items():
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
