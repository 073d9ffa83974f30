"""Readings for the limits of ``correct``: the program's and the control's.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds <s>

On a CUDA device, in one process: for each of ``--seeds``, one run of the
cell exactly as ``run.py`` makes it (its timed path, its sizes, a window
of ``--seconds``), printing the numbers that the comparison gives; for
each of ``--control-seeds``, the control in the program's place (the
reference in TF32, ``reference.control``) on the rows that such a run
compares, printing the same numbers.  The lower reading of a number is
the largest over the program's seeds, the upper the smallest over the
control's; a limit lies between them.  The benchmark's own runs never run
this.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from portbench.run import ROOT, _caches, _paths, load_json  # noqa: E402


def control_numbers(bench, cell, seed, seconds, device):
    from portbench import reference
    from portbench.run import Run

    run = Run(bench, cell, seed, seconds, False, device)
    rows = run.kind.compared_rows(run, seconds)
    (ri, rv, _), (si, sv, _) = run.R, run.S
    dim, k = run.config["dim"], run.config["k"]
    q = (ri[rows], rv[rows])
    ctl_s, ctl_i = reference.control(q, (si, sv), k, dim, device)
    return reference.judge(q, (si, sv), ctl_i, ctl_s, k, dim, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    _paths()
    _caches()
    import torch

    from portbench.run import run_cell

    if not torch.cuda.is_available():
        print("calibrate.py reads the card: no CUDA device here", file=sys.stderr)
        return 2
    bench = load_json(ROOT / "BENCHMARK.json")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = [int(s) for s in args.control_seeds.split(",") if s]
    lower, upper = {}, {}
    for seed in seeds:
        t = time.perf_counter()
        result, _ = run_cell(bench, args.workload, seed, args.seconds, False, "cuda")
        nums = {n: c["value"] for n, c in result["checks"].items()}
        for n, v in nums.items():
            lower[n] = max(lower.get(n, v), v)
        print(json.dumps({"side": "program", "seed": seed, "numbers": nums,
                          "metrics": {n: m["value"] for n, m in result["metrics"].items()},
                          "correct": result["correct"], "s": time.perf_counter() - t}), flush=True)
    for seed in ctl:
        t = time.perf_counter()
        nums = control_numbers(bench, args.workload, seed, args.seconds, "cuda")
        for n, v in nums.items():
            upper[n] = min(upper.get(n, v), v)
        print(json.dumps({"side": "control", "seed": seed, "numbers": nums,
                          "s": time.perf_counter() - t}), flush=True)
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
