"""Run one cell of the benchmark of ``lightmotif_tpu_torch`` once.

    python3 motifbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout holding ``BENCHMARK.json``, ``motifbench/``
and the program.  It needs the CUDA cards the cell names.  The last line
of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics; with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``, each number of the comparison with its limit (also
the last lines of standard error).  With no card, or with JAX loaded in
the process, it exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: Kernel builds stay inside the checkout, at a fixed path, so that only
#: a cell's first run in a checkout compiles.
CACHE = Path(__file__).resolve().parent / "build-cache"


def environment(cache: Path) -> None:
    """Point every build cache the process may use at ``cache``."""
    os.environ["LIGHTMOTIF_TPU_COMPILE_CACHE"] = str(cache / "lightmotif")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    environment(CACHE)
    sys.path.insert(0, str(ROOT))
    from motifbench import harness

    try:
        result = harness.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                             t_start=T_START)
    except harness.NoResult as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
