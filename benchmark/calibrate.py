"""The readings that a cell's correctness limits are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds <s> [--out <file.jsonl>]

runs the cell once per seed in this one process (set-up, a window of
``--seconds``, the check; the matrix and the plan, the same for every
seed, are made once and kept), first as the program runs it and then
with the control in the program's place: the same op with TF32 on for the factor
and solve traffic, the TF32 reference for the SpMV traffic.  It prints,
and appends to ``--out``, one JSON line per run with the numbers
compared.  The largest sound reading and the smallest control reading
bound each limit (PERF.md).  The benchmark's own runs never run the
control.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: not run", file=sys.stderr)
        return 2
    for k in [k for k in os.environ if k.startswith("TPUSPARSE_")]:
        del os.environ[k]
    from benchmark import harness
    runs = [(int(s), False) for s in args.seeds.split(",") if s]
    runs += [(int(s), True) for s in args.control_seeds.split(",") if s]
    cache = {}
    for seed, control in runs:
        t = time.perf_counter()
        r = harness.run_cell(ROOT, args.workload, seed, args.seconds, False,
                             device=args.device, control=control,
                             cache=cache)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "control": control, "correct": r["correct"],
                           "attempted": r["attempted"],
                           "checks": r["checks"], "metrics": r["metrics"],
                           "run_s": time.perf_counter() - t})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del r
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
