"""Tabulate the output of several `chip_smoke.py` runs side by side.

    python scripts/smoke_table.py RUN.log [RUN.log ...]

Each argument is the standard output of one `python3 chip_smoke.py` (for
example the parent commit's and a change's, run in turns in one call on one
card). Prints, one column a run: the card, the build and smoke seconds, each
kernel case's time (K4 also with its index route's time and tied rows; K5
and K6 with their device time, K6 also along the identity order), the
Morton order's time, and the end-to-end phases' shapes/s, peak memory and
quality figures.
"""
from __future__ import annotations

import json
import os
import sys


def records(path):
    out = {"card": None, "phases": {}}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("{"):
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if "phase" in rec:
                    out["phases"][rec["phase"]] = rec
            elif line.startswith("NVIDIA") and out["card"] is None:
                out["card"] = line
    return out


def kernel_rows(run):
    """{(kernel, case): record} over the kernel phases of one run."""
    rows = {}
    for phase in ("kernels", "kernels_slice2", "kernels_slice3"):
        for key, cases in run["phases"].get(phase, {}).get(
                "results", {}).items():
            for case in cases if isinstance(cases, list) else [cases]:
                rows[(key, case.get("case", ""))] = case
    return rows


def fmt(v):
    return "-" if v is None else (f"{v:.4f}" if isinstance(v, float)
                                  else str(v))


def main(paths):
    runs = [records(p) for p in paths]
    names = [os.path.basename(p) for p in paths]
    print("| | " + " | ".join(names) + " |")
    print("|---" * (len(runs) + 1) + "|")

    def row(label, values):
        print(f"| {label} | " + " | ".join(fmt(v) for v in values) + " |")

    row("card", [r["card"] for r in runs])
    row("nvcc s", [r["phases"].get("build", {}).get("nvcc_seconds")
                   for r in runs])
    row("smoke s", [r["phases"].get("done", {}).get("seconds") for r in runs])
    krows = [kernel_rows(r) for r in runs]
    keys = list(dict.fromkeys(k for kr in krows for k in kr))
    for key in keys:
        recs = [kr.get(key, {}) for kr in krows]
        row(f"{key[0]} {key[1]} ms", [c.get("ms") for c in recs])
        if key[0] in ("K5", "K6"):
            row(f"{key[0]} {key[1]} device ms",
                [c.get("device_ms") for c in recs])
        if key[0] == "K6":
            row(f"{key[0]} {key[1]} identity order ms",
                [c.get("identity_ms") for c in recs])
        if key[0] == "K4":
            row(f"{key[0]} {key[1]} index route ms",
                [c.get("nonfused_route_ms") for c in recs])
            row(f"{key[0]} {key[1]} tied rows",
                [c.get("tied_rows") for c in recs])
            row(f"{key[0]} {key[1]} bound ms",
                [c.get("bound_ms") for c in recs])
    fwd = [r["phases"].get("kernels_slice3", {}).get("encoder_forward", {})
           for r in runs]
    row("Morton order ms (8 x 10000)", [f.get("order_ms") for f in fwd])
    row("Morton order device ms", [f.get("order_device_ms") for f in fwd])
    row("K6 x 3 device ms gained by the order, net",
        [f.get("net_device_gain_ms") for f in fwd])
    for phase in ("headline", "predict", "predict_fused",
                  "predict_fold5drop", "predict_bigcloud"):
        recs = [r["phases"].get(phase, {}) for r in runs]
        row(f"{phase} shapes/s", [c.get("shapes_per_s") for c in recs])
        row(f"{phase} peak GiB", [c.get("peak_mem_gib") for c in recs])
        row(f"{phase} inst_iou", [c.get("inst_iou") for c in recs])
        if phase != "headline":
            row(f"{phase} type_iou / recall",
                [f"{c.get('type_iou')} / {c.get('inst_recall')}"
                 for c in recs])
        row(f"{phase} K4 launches",
            [c.get("launches", {}).get("K4") for c in recs])


if __name__ == "__main__":
    main(sys.argv[1:])
