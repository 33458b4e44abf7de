"""One run of one benchmark cell of the PyTorch and CUDA port.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's entry in BENCHMARK.json names its configuration and its
traffic mix; both are data files found by name:

    portbench/configs/<config>.json     the port's Config fields, the weights
    portbench/workloads/<traffic>.json  the traffic mix; its "kind" names the
                                        runner portbench/kinds/<kind>.py
    portbench/limits/<cell>.json        the limit of each number `correct`
                                        compares
    portbench/metrics/<metric>.py       the reader of each per-layer metric

The runner sets up the cell, measures a window of --seconds, checks what
the timed path produced against the plain reference (`reference.py`),
and hands back the numbers. This module prints the compared numbers with
their limits as the last lines of standard error, and the result as one
JSON object on the last line of standard output. Without a CUDA device,
or with fewer than the cell asks for, it exits with 2 and prints no
result.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "sednet_tpu")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, manifest_path: Path = ROOT / "BENCHMARK.json"):
    """(manifest, cell entry, config file, traffic file, limits file)."""
    manifest = read_json(manifest_path)
    cells = {c["name"]: c for c in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"portbench: no cell {name!r} in {manifest_path}")
    cell = cells[name]
    config = read_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = read_json(HERE / "workloads" / f"{cell['traffic']}.json")
    limits = read_json(HERE / "limits" / f"{name}.json")
    return manifest, cell, config, traffic, limits


def load_module(path: Path):
    """A module of portbench loaded from its file (metric readers are
    named after their metric, which holds dots)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind_module(kind: str):
    return load_module(HERE / "kinds" / f"{kind}.py")


def metric_reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py")


def cell_metrics(manifest: dict, cell: str, group: str) -> list:
    """The metrics of `group` ("end_to_end" or "per_layer") that `cell`
    reports: those without a "workloads" key, and those listing it."""
    return [m for m in manifest[group]
            if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def judge(checks: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number compared must
    be present, a finite number, and at or below its limit."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = checks.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        out[name] = {"value": v, "limit": limit}
    return ok, out


def device_info(torch, chips: int, peak: int, trace_summary=None) -> dict:
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak)}
    if trace_summary is not None:
        info["busy_s"] = trace_summary.busy_s
        info["window_s"] = trace_summary.window_s
    return info


def process_env():
    """The run's process settings, made before torch or numpy load. One
    thread in the OpenMP and BLAS pools: their idle threads spin beside
    the thread that launches the kernels, and the train cell's rate
    spreads about twice as wide with the default pools. Fixed build and
    kernel-cache directories inside the checkout: the port builds its
    kernels under build/ beside its package; Triton's cache, should
    anything compile through it, goes here too."""
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    triton = ROOT / "build" / "portbench" / "triton"
    triton.mkdir(parents=True, exist_ok=True)
    os.environ["TRITON_CACHE_DIR"] = str(triton)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    manifest, cell, config, traffic, limits = load_cell(args.workload)
    process_env()
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs on the card "
              "only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['name']} needs {cell['chips']} devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2

    kind = kind_module(traffic["kind"])
    res = kind.run(config, traffic, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), device="cuda", t_start=T_START)

    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3

    if args.trace:
        metrics = {}
        for m in cell_metrics(manifest, cell["name"], "per_layer"):
            v = metric_reader(m["name"]).read(res["ctx"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": res["end_to_end"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell_metrics(manifest, cell["name"], "end_to_end")}
    correct, checks = judge(res["checks"], limits)
    print(f"info {json.dumps(res['info'], default=str)}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    out = {"correct": correct, "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics,
           "device": device_info(torch, cell["chips"], res["peak_bytes"],
                                 res["ctx"].get("trace") if args.trace
                                 else None)}
    if args.trace:
        out["breakdown"] = res["ctx"]["trace"].breakdown()
    out["checks"] = checks
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
