"""The smoke's `train` check (`chip_smoke.card_vs_cpu_step`) on states
trained afresh, on the card:

    python3 scripts/probe_train_check.py [--states 4] [--out FILE]

Each state is the smoke's `train` phase's model: the inst model of
checkpoints/bench_10k.npz preloaded, 8 steps of the production config on
the smoke's synthetic training sets. Torch's CUDA ops leave the state's
last bits to chance (ROADMAP queue 3), so each training gives another
state. Printed, a JSON line a state (appended to FILE too):

  * `check`: the smoke's check. The CPU replays the card's kNN graphs and
    the neighbours that win each edge convolution's max (K6's max held to
    the max of its gathered values; each neighbour the CPU would pick
    otherwise held to be a near-tie); the loss is held to the CPU float64
    step within 1e-4, every gradient leaf within max(1e-3, twice the CPU
    float32 step's distance from it). With its outcome: the (row, channel)
    pairs of each layer whose max falls on another neighbour on the CPU
    than on the card (`max_flips`), their largest gap and its bound
    (`flip_gaps`), and both sides' largest distance from float64.
  * `graphs_only`: the check as it stood before (the CPU on the card's
    graphs alone, the card held to the CPU float32 step within 1e-3 per
    leaf), with the card's and the CPU float32 step's distance from the
    CPU float64 step on the same graphs for its three worst leaves and
    over every leaf.
"""
import argparse
import copy
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--states", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_train_check: needs the card")
    import chip_smoke as S
    from sednet_tpu_torch import train as T
    from sednet_tpu_torch.data import BatchLoader, PrefetchLoader
    from sednet_tpu_torch.losses import TripletConfig
    from sednet_tpu_torch.losses.embedding import sample_draws
    from sednet_tpu_torch.predict import load_models
    from sednet_tpu_torch.weights import save_params_npz

    print(S.nvidia_smi(), flush=True)
    root = os.path.join(ROOT, "build", "probe_train_check")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    models = load_models(os.path.join(ROOT, "checkpoints", "bench_10k.npz"),
                         device="cuda", which=("inst",))
    preload = os.path.join(root, "preload_inst.npz")
    save_params_npz(preload, models["inst"])
    cfg = S.train_cfg(preload)
    def trained():
        mixed, test_ds = S.train_sets()
        model, optimizer, gen = T.init_training(cfg, "cuda")
        run_dir = os.path.join(root, f"run_{len(os.listdir(root))}")
        os.makedirs(run_dir)
        T.train_loader(cfg, model, PrefetchLoader(BatchLoader(
            mixed, cfg.batch_size, shuffle=True, seed=cfg.seed)),
            BatchLoader(test_ds, cfg.batch_size, shuffle=False),
            optimizer=optimizer, run_dir=run_dir, max_steps=S.TRAIN_STEPS,
            log_every=100, generator=gen)
        batch = T.to_device(next(iter(BatchLoader(
            mixed, cfg.batch_size, shuffle=False))), "cuda")
        return model, batch

    def float64_distances(model, batch):
        one = {k: v[:1].cpu() for k, v in batch.items()}
        draws = sample_draws(one["labels"], TripletConfig(
            margin=cfg.triplet_margin, max_segments=cfg.ms_max_clusters),
            torch.Generator().manual_seed(S.TRAIN_SEED))

        def grads(dev, dtype, replay=None):
            m = copy.deepcopy(model).to(dev).to(dtype)
            m.zero_grad(set_to_none=True)
            with S._Graphs(replay) as graphs:
                b = {k: v.to(dev, dtype if v.is_floating_point() else v.dtype)
                     for k, v in one.items()}
                total = T.make_loss_fn(m, cfg)(b, draws)[0]
                total.backward()
            return ({k: p.grad.detach().cpu().double()
                     for k, p in m.named_parameters()},
                    [g.cpu() for g in graphs.graphs], float(total.detach()))

        def rel(a, b):
            return {k: float((a[k] - b[k]).norm()
                             / b[k].norm().clamp_min(1e-30)) for k in b}

        card, graphs, card_loss = grads("cuda", torch.float32)
        cpu, _, cpu_loss = grads("cpu", torch.float32, graphs)
        exact = grads("cpu", torch.float64, graphs)[0]
        vs_cpu, card_f64, cpu_f64 = rel(card, cpu), rel(card, exact), rel(
            cpu, exact)
        worst = sorted(vs_cpu, key=vs_cpu.get)[-3:]
        loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
        return {"check_ok": loss_rel <= S.TRAIN_LOSS_RTOL
                and max(vs_cpu.values()) <= S.TRAIN_GRAD_RTOL,
                "loss_rel_err": loss_rel,
                "grad_rel_err_max": max(vs_cpu.values()),
                "worst_leaf": worst[-1],
                "card_vs_f64_max": max(card_f64.values()),
                "cpu_f32_vs_f64_max": max(cpu_f64.values()),
                "worst": {k: {"card_vs_cpu": vs_cpu[k],
                              "card_vs_f64": card_f64[k],
                              "cpu_f32_vs_f64": cpu_f64[k]} for k in worst}}

    for i in range(args.states):
        model, batch = trained()
        rec = {"state": i}
        try:
            out = S.card_vs_cpu_step(model, cfg, batch, own_graphs=True)
            rec["check"] = {"ok": True, **{k: out[k] for k in (
                "loss_rel_err", "loss_vs_f64", "loss_allowed", "max_flips",
                "max_flips_f64", "flip_gaps", "flip_gaps_f64",
                "card_vs_f64_max", "cpu_f32_vs_f64_max", "worst_vs_f64",
                "grad_rel_err_max", "global_max_argmax_flips",
                "cpu_own_graphs")}}
        except AssertionError as exc:
            rec["check"] = {"ok": False, "failure": str(exc)[:2000]}
        rec["graphs_only"] = float64_distances(model, batch)
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
