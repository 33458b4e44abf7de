"""Time the exact top-k kernel (K1) at every shape the main paths give it.

    python3 scripts/bench_topk.py [--tag NAME] [--out DIR (default build)]

Run from the root of a checkout on a machine with an NVIDIA GPU. Builds the
checkout's kernels and runs `chip_smoke.check_topk` (K1 held against its
plain version, with the kernel's, the plain version's and `cdist`+`topk`'s
times and the bound) on the eight K1 cases of `chip_smoke.py`
(`k1_headline_cases`, `k1_eval_cases`), one JSON line each; the lines also
go to `<out>/bench_topk_<tag>.json`. To compare two checkouts, run both on
one card in one sitting, in turns.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.getcwd()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="run")
    ap.add_argument("--out", default="build")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_topk: no CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from sednet_tpu_torch.ops import _build
    from sednet_tpu_torch.predict import forward, headline_shapes, load_models

    t0 = time.time()
    _build.lib()
    card = cs.nvidia_smi()
    _, x_np = headline_shapes(cs.BATCH, cs.N_POINTS)
    models = load_models(os.path.join(ROOT, "checkpoints", "bench_10k.npz"),
                         device="cuda")
    x = torch.from_numpy(x_np).to("cuda")
    emb = forward(models["inst"], x)[0].contiguous()
    emb_e, sels = cs.eval_subsamples(models, x)
    recs = []
    for name, q, p, k, kw in (cs.k1_headline_cases(models["inst"], x, emb)
                              + cs.k1_eval_cases(x, emb_e, sels)):
        rec = {"tag": args.tag, "card": card,
               **cs.check_topk(name, q, p, k, **kw)}
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"bench_topk_{args.tag}.json"), "w") as f:
        json.dump({"card": card, "seconds": time.time() - t0,
                   "cases": recs}, f, indent=1)


if __name__ == "__main__":
    main()
