"""Runs one cell of BENCHMARK.json on the card and prints its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  It refuses to run (exit 2, no result)
without as many CUDA devices as the cell asks for, and never falls back
to the CPU.  With ``--trace 0`` the result's metrics are the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics.  The last
lines on standard error are the numbers compared for ``correct``, each
beside its limit; the last line on standard output is the result.  A run
that has loaded JAX or the JAX package by the time it ends exits 3 and
prints no result.

Every TPUSPARSE_* variable is taken out of the environment before the
program is imported, so the program runs at its defaults.  The kernel
library and the native planner build into ``build/tpusparse_torch/``
inside the checkout on the first run there; later runs load them.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root in place of this script's folder, whose modules
# would otherwise shadow top-level names
sys.path[0] = ROOT

import argparse  # noqa: E402
import json  # noqa: E402


def _args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _chips(cell: str) -> int:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cells = {w["name"]: w for w in json.load(f)["workloads"]}
    if cell not in cells:
        sys.exit(f"no workload {cell!r} in BENCHMARK.json")
    return int(cells[cell]["chips"])


def main(argv=None) -> int:
    args = _args(argv)
    chips = _chips(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}: not run",
              file=sys.stderr)
        return 2
    for k in [k for k in os.environ if k.startswith("TPUSPARSE_")]:
        del os.environ[k]
    from benchmark import harness
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}: no result", file=sys.stderr)
        return 3
    sys.stderr.write("\n".join(harness.check_lines(result)) + "\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
