"""Time K4 (the fused edge-conv reductions) at the encoder's three layers,
with and without tied rows, beside the index route's two kernels.

    python3 scripts/bench_fused.py [--tag NAME] [--out DIR (default build)]

Run from the root of a checkout on a machine with an NVIDIA GPU. On the
real layer inputs of `chip_smoke.py` (`_fused_layer_inputs`: the headline
batch of 8 x 10000 points through the trained inst encoder) it times, one
JSON line a layer (also written to `<out>/bench_fused_<tag>.json`):

  k4_ms          K4 as the fused route calls it;
  k4_untied_ms   K4 on the same rows moved by 1e-4 of their spread, which
                 leaves no exact tie at the k-th distance, so its rescan
                 launch (phase 2b) returns at once in every block;
  k1_ms, k6_ms   the index route's graph (K1) and gather-reduce (K6) on the
                 original rows, and `route_ms` the two in one call;

with the rows K4 flags for a tie in each input. The difference of the first
two is what the rescan of the tied rows costs.
"""
import argparse
import json
import os
import sys

ROOT = os.getcwd()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="run")
    ap.add_argument("--out", default="build")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_fused: no CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from sednet_tpu_torch.ops import _build
    from sednet_tpu_torch.ops import fused_edgeconv as fe
    from sednet_tpu_torch.ops.flash_topk import flash_topk
    from sednet_tpu_torch.ops.graph import gather_reduce
    from sednet_tpu_torch.predict import headline_shapes, load_models

    _build.lib()
    card = cs.nvidia_smi()
    _, x_np = headline_shapes(cs.BATCH, cs.N_POINTS)
    models = load_models(os.path.join(ROOT, "checkpoints", "bench_10k.npz"),
                         device="cuda")
    x = torch.from_numpy(x_np).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    lines = []
    for name, g, a, metric in cs._fused_layer_inputs(models["inst"], x):
        k = cs.K
        spread = g.std(dim=1, keepdim=True)
        gu = (g + 1e-4 * spread * torch.randn(g.shape, generator=gen,
                                              device="cuda")).contiguous()
        if metric == "points_normals":   # keep the normals unit
            gu[..., 3:6] = torch.nn.functional.normalize(gu[..., 3:6], dim=-1)

        def tied(geom):
            return int((fe.fused_edge_reductions(geom, a, k, metric=metric)[3]
                        > k).sum())

        idx = flash_topk(g, g, k, metric=metric)
        rec = {"case": name, "card": card, "k": k,
               "shape": list(g.shape) + [a.shape[-1]],
               "tied_rows": tied(g), "untied_rows": tied(gu),
               "k4_ms": cs.time_ms(lambda: fe.fused_edge_reductions(
                   g, a, k, metric=metric), reps=20),
               "k4_untied_ms": cs.time_ms(lambda: fe.fused_edge_reductions(
                   gu, a, k, metric=metric), reps=20),
               "k1_ms": cs.time_ms(lambda: flash_topk(g, g, k, metric=metric),
                                   reps=20),
               "k6_ms": cs.time_ms(lambda: gather_reduce(a, idx), reps=20),
               "route_ms": cs.time_ms(lambda: cs._nonfused_route(
                   g, a, k, metric), reps=20)}
        print(json.dumps(rec), flush=True)
        lines.append(rec)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"bench_fused_{args.tag}.json"),
              "w") as f:
        f.write("\n".join(json.dumps(r) for r in lines) + "\n")


if __name__ == "__main__":
    main()
