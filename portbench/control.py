"""Readings for the limits of `correct`: the numbers one cell compares,
for several seeds in one process, from the program (`--precision
program`) or from the control, the plain reference at a lower precision
put in the program's place (`--precision tf32`, `bf16` or `fp8`), or
from the program with faults of `faults.py` planted (`--faults`).

    python3 -m portbench.control --workload <cell> --precision tf32 \
        --seeds 1,2,3 --seconds 3

Each seed prints one JSON line: the seed, the numbers and the run's
diagnostics (for an eval cell also the comparison's witnesses,
`kinds/eval.affinity_witness`, and each cloud's shift quantiles). The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import faults, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--precision", required=True,
                    choices=("program", "tf32", "bf16", "fp8"))
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--faults", default="",
                    help="faults of faults.py, comma-separated: each seed "
                    "runs under each, planted in the program's timed path")
    args = ap.parse_args(argv)
    hooks = {**{k: ("step_hook", f) for k, f in faults.TRAIN.items()},
             **{k: ("capture_hook", f) for k, f in faults.EVAL.items()},
             **{k: ("cluster_hook", f) for k, f in faults.CLUSTER.items()}}
    planted = args.faults.split(",") if args.faults else [None]
    for fault in planted:
        if fault is not None and fault not in hooks:
            ap.error(f"no fault {fault!r}; faults: {sorted(hooks)}")
    _, cell, config, traffic, limits = run.load_cell(args.workload)
    run.process_env()
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    kind = run.kind_module(traffic["kind"])
    control = None if args.precision == "program" else args.precision
    for fault in planted:
        kw = dict([hooks[fault]]) if fault is not None else {}
        if traffic["kind"] == "eval":
            kw["diagnose"] = True
        for seed in (int(s) for s in args.seeds.split(",")):
            res = kind.run(config, traffic, seed=seed, seconds=args.seconds,
                           trace=False, device="cuda", t_start=time.time(),
                           control=control, **kw)
            ok, _ = run.judge(res["checks"], limits)
            print(json.dumps({"cell": cell["name"], "precision": args.precision,
                              "fault": fault, "seed": seed, "correct": ok,
                              "checks": res["checks"], "info": res["info"]},
                             default=str), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
