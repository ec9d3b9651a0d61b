"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints diagnostics and each compared number
beside its limit on standard error, and the result as the last line of
standard output. Exits non-zero, with no result, without a CUDA card, if a
module of JAX or of the package this program was ported from was loaded,
or if the program or a file of the benchmark is missing.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Every compile cache of the program at a fixed path inside the checkout.
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch
    from benchmark import harness

    # One process with few threads: the host launches the card's work on
    # shared cores, and idle CPU worker threads only take time from it.
    torch.set_num_threads(1)

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("benchmark: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.find_cell(args.workload)
    run = harness.Run(cell=cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device=torch.device("cuda", 0),
                      t_start=T_START)
    try:
        result = harness.run_cell(run)
    except harness.RunError as err:
        print(f"benchmark: {err}", file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
