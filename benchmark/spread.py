"""Runs of one cell as separate processes, and the spread of each metric.

    python3 benchmark/spread.py --workload <cell> --seeds 1,2,3,4,5,6 \
        [--sets 2] [--trace-seeds 7,8,9] --seconds <s> [--out <file.jsonl>]

runs ``benchmark/run.py`` once per seed in each set (every set on the same
seeds, in the same order), then once per trace seed with ``--trace 1``.
Each run's result line (or its failure and the end of its standard
error) goes to ``--out``.  Per set and metric it prints the median and
the spread: the distance between the first and the third quartile
(``statistics.quantiles(values, n=4)``) as a share of the median, over
all runs and with the run farthest from the median left out.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402


def spread(values: list) -> float:
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def spread_but_farthest(values: list) -> float:
    """The spread with the run farthest from the median left out."""
    med = statistics.median(values)
    rest = sorted(values, key=lambda v: abs(v - med))[:-1]
    return spread(rest) if len(rest) >= 2 else 0.0


def run(cell: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
           "--workload", cell, "--seed", str(seed), "--seconds",
           str(seconds), "--trace", str(trace)]
    t = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=1500)
    rec = {"workload": cell, "seed": seed, "trace": trace,
           "rc": p.returncode, "run_s": time.perf_counter() - t,
           "stderr_tail": p.stderr[-1500:]}
    lines = p.stdout.strip().splitlines()
    if p.returncode == 0 and lines:
        rec["result"] = json.loads(lines[-1])
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--trace-seeds", default="")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    plan = [(k, s, 0) for k in range(args.sets) for s in seeds]
    plan += [(None, int(s), 1) for s in args.trace_seeds.split(",") if s]
    by_set = {}
    for k, seed, trace in plan:
        rec = run(args.workload, seed, args.seconds, trace)
        rec["set"] = k
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        if trace == 0 and "result" in rec:
            for name, m in rec["result"]["metrics"].items():
                by_set.setdefault(k, {}).setdefault(name, []).append(
                    m["value"])
    for k, metrics in sorted(by_set.items()):
        for name, vals in metrics.items():
            if len(vals) >= 2:
                line = json.dumps({"workload": args.workload, "set": k,
                                   "metric": name, "n": len(vals),
                                   "median": statistics.median(vals),
                                   "spread": spread(vals),
                                   "spread_but_farthest":
                                       spread_but_farthest(vals),
                                   "values": vals})
                print(line, flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
