"""Batch visualisation tool: coloured per-point txt dumps of the predicted
and true type and instance labels (counterpart of `sednet_tpu/gen_vis.py`,
reference: gen_test_vis.py:51-92).

It reads the predict CLI's {id}_type / {id}_inst (and, where present,
{id}_GT_type / {id}_GT_inst) txt dumps beside {id}_GT_points.txt and writes
{id}_{kind}.txt files of "x;y;z;r;g;b" rows into SRC_DIR/VIS, a thread per
shape. The rows are written from float32 as the JAX package's native
writer writes them (`data.native.savetxt_fast`), through np.savetxt of the
float32 array, which gives the same bytes without building the library.

    python -m sednet_tpu_torch.gen_vis SRC_DIR [--ids 0 1 2] [--workers 8]
        [--images]

`--images` also renders one grid PNG a kind over every shape
(`utils.grid_vis`, which needs matplotlib).
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import os

import numpy as np

from sednet_tpu_torch.utils.vis import (COLORS_TYPE, instance_palette,
                                        visual_labels)


def gen_vis(src: str, shape_id) -> dict:
    """{kind: (N, 6) [xyz rgb]} for one shape (gen_test_vis.gen_vis,
    :61-75): pred_type, pred_inst, and GT_type, GT_inst where the true
    labels were dumped."""
    types = np.loadtxt(os.path.join(src, f"{shape_id}_type.txt")).astype(int)
    insts = np.loadtxt(os.path.join(src, f"{shape_id}_inst.txt")).astype(int)
    pts = np.loadtxt(os.path.join(src, f"{shape_id}_GT_points.txt"),
                     delimiter=";")[:, :3]
    out = {
        "pred_type": visual_labels(pts, types, COLORS_TYPE),
        "pred_inst": visual_labels(
            pts, insts, instance_palette(max(insts.max() + 1, 2))),
    }
    gt_type_path = os.path.join(src, f"{shape_id}_GT_type.txt")
    gt_inst_path = os.path.join(src, f"{shape_id}_GT_inst.txt")
    if os.path.exists(gt_type_path) and os.path.exists(gt_inst_path):
        gt_types = np.loadtxt(gt_type_path).astype(int)
        gt_insts = np.loadtxt(gt_inst_path).astype(int)
        out["GT_type"] = visual_labels(pts, gt_types, COLORS_TYPE)
        out["GT_inst"] = visual_labels(
            pts, gt_insts, instance_palette(max(gt_insts.max() + 1, 2)))
    return out


def _one(src, dst, shape_id, keep: bool = False):
    out = gen_vis(src, shape_id)
    for kind, arr in out.items():
        np.savetxt(os.path.join(dst, f"{shape_id}_{kind}.txt"),
                   arr.astype(np.float32), delimiter=";", fmt="%0.4f")
    # only the --images pass needs the arrays back: keeping every shape's
    # would hold all the decoded clouds of a large dump directory
    return out if keep else None


def gen_total_vis(src: str, ids=None, workers: int = 8,
                  images: bool = False) -> str:
    """gen_test_vis.gen_total_vis (:84-89) over a thread pool: every
    shape's dumps into src/VIS (the shapes of src's {id}_type.txt files
    when ids is None); images=True also renders a grid PNG a kind
    (pred/GT x type/inst) over every shape. Returns src/VIS."""
    dst = os.path.join(src, "VIS")
    os.makedirs(dst, exist_ok=True)
    if ids is None:
        ids = sorted({f.split("_")[0] for f in os.listdir(src)
                      if f.endswith("_type.txt") and "GT" not in f})
    with cf.ThreadPoolExecutor(max_workers=workers) as ex:
        outs = list(ex.map(lambda i: _one(src, dst, i, keep=images), ids))
    if images and ids:
        from sednet_tpu_torch.utils.grid_vis import render_pointclouds_grid

        by_kind: dict[str, list] = {}
        for out in outs:
            for kind, arr in out.items():
                by_kind.setdefault(kind, []).append(arr)
        for kind, arrs in by_kind.items():
            render_pointclouds_grid(
                arrs, os.path.join(dst, f"grid_{kind}.png"))
    return dst


def main(argv=None):
    p = argparse.ArgumentParser(description="Coloured txt dumps of the "
                                "predict CLI's labels.")
    p.add_argument("src")
    p.add_argument("--ids", nargs="*", default=None)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--images", action="store_true",
                   help="also render grid PNGs of the coloured dumps")
    a = p.parse_args(argv)
    gen_total_vis(a.src, ids=a.ids, workers=a.workers, images=a.images)


if __name__ == "__main__":
    main()
