"""K2/K2b's bf16 mean-shift step alone, on one NVIDIA GPU.

    python3 scripts/bench_ms_bf16.py [--parent DIR] [--out FILE] [--quick]

Clustered unit rows made from a seed (8 centres a shape), each shape's
bandwidth drawn as the main path draws it (`compute_bandwidth`, quantile
0.015). Cases: K2 at (10000, 128), K2b at (8, 10000, 128) and at (8, 10000,
140), which runs at 144, the main path's shapes; then (2, 10000, 256) and
(1, 3333, 32), the widest width and `resplit`'s candidates. Each goes
through `chip_smoke.check_k2_bf16`: the float64 rule, the same bits on
three launches, the device ms of the call and of the launch alone, SDPA
on bf16 inputs, the bound and the achieved TFLOP/s, and with --parent DIR
(an older checkout, e.g. unpacked with `git archive` into build/parent)
its bf16 kernel on the same inputs. Prints one JSON line a case, the
card's name and power limit first, and the ptxas report of the kernel's
widths (registers, spills). --quick: the first three cases only.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CASES = (("K2 bf16, one shape E=128", 1, 10000, 128),
         ("K2b bf16 E=128", 8, 10000, 128),
         ("K2b bf16, enriched E=140", 8, 10000, 140),
         ("K2b bf16 E=256", 2, 10000, 256),
         ("K2 bf16, resplit candidate E=32", 1, 3333, 32))


def clustered(gen, b, n, e, spread=0.1):
    import torch

    centres = torch.nn.functional.normalize(
        torch.randn((b, 8, e), generator=gen), dim=-1)
    lab = torch.randint(0, 8, (b, n), generator=gen)
    x = torch.gather(centres, 1, lab[..., None].expand(b, n, e))
    x = x + (spread / e ** 0.5) * torch.randn((b, n, e), generator=gen)
    return torch.nn.functional.normalize(x, dim=-1)


def ptxas_report(log):
    """The ptxas lines of mean_shift_bf16.cu's kernels: registers, spills
    and warnings."""
    part = log.split("== mean_shift_bf16.cu", 1)[-1].split("\n== ", 1)[0]
    return [ln.strip() for ln in part.splitlines()
            if re.search(r"registers|spill|arning|Compiling entry", ln)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from sednet_tpu_torch.cluster.mean_shift import compute_bandwidth
    from sednet_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        sys.exit("bench_ms_bf16: no CUDA device")
    _build.lib()
    lines = [{"card": cs.nvidia_smi(), "torch": torch.__version__,
              "cuda": torch.version.cuda,
              "build_s": _build.build_info.get("seconds"),
              "ptxas": ptxas_report(_build.build_info.get("log", ""))}]
    print(json.dumps(lines[0]), flush=True)
    parent = cs.parent_ms_bf16(args.parent) if args.parent else None
    gen = torch.Generator().manual_seed(15)
    failed = []
    for case, b, n, e in CASES[:3] if args.quick else CASES:
        x = clustered(gen, b, n, e).to("cuda")
        bw = torch.stack([torch.clamp_min(compute_bandwidth(
            x[i], 10000, np.float32(0.015),
            generator=torch.Generator().manual_seed(i)), 0.003)
            for i in range(b)])
        try:
            rec = cs.check_k2_bf16(case, x, bw, parent)
        except AssertionError as exc:   # the next cases still run
            rec = {"case": case, "failed": str(exc)}
            failed.append(case)
        lines.append(rec)
        print(json.dumps(rec), flush=True)
        del x
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            for rec in lines:
                f.write(json.dumps(rec) + "\n")
    if failed:
        sys.exit(f"bench_ms_bf16: failed {failed}")


if __name__ == "__main__":
    main()
