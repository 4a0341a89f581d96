"""The readings that a cell's limits are set from, in one process:

    python3 motifbench/readings.py --workload <name> --seconds <s> \
        --seeds <n> ... [--control <n> ...]

For each seed of ``--seeds`` a run of the cell with a window of
``--seconds`` and the numbers of its comparison (the lower readings: the
largest that sound runs give); for each of ``--control`` also the
control's, the reference in bfloat16 in the program's place (the upper
readings: the smallest that the control gives).  The benchmark's own
runs never run this.  The last line of standard output is one JSON
object: ``program`` and ``control``, each number's largest and smallest
reading, and every seed's numbers.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import CACHE, ROOT, environment  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control", type=int, nargs="*", default=[])
    args = parser.parse_args(argv)
    environment(CACHE)
    sys.path.insert(0, str(ROOT))
    from motifbench import harness

    program, control = {}, {}
    for seed in sorted(set(args.seeds) | set(args.control)):
        res = harness.run(ROOT, args.workload, seed, args.seconds, False,
                          t_start=time.perf_counter(), control=seed in args.control)
        if seed in args.seeds:
            program[seed] = {k: v["value"] for k, v in res["checks"].items()}
        if seed in args.control:
            control[seed] = res["control"]
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "program": program.get(seed), "control": control.get(seed)}),
              flush=True)
    names = harness.check.NAMES
    summary = {
        "program": {n: max(r[n] for r in program.values()) for n in names} if program else {},
        "control": {n: min(r[n] for r in control.values()) for n in names} if control else {},
        "seeds": {"program": program, "control": control}}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
