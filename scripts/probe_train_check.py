"""The smoke's `train` check (`chip_smoke.card_vs_cpu_step`: one cloud's step
on the card against the CPU's float32 step on the card's graphs, the loss
within 1e-4 and every gradient leaf within 1e-3 relative L2) on states
trained afresh, on the card:

    python3 scripts/probe_train_check.py [--states 4] [--out FILE]

Each state is the smoke's `train` phase's model: the inst model of
checkpoints/bench_10k.npz preloaded, 8 steps of the production config on
the smoke's synthetic training sets. Torch's CUDA ops leave the state's
last bits to chance (ROADMAP queue 3), so each training gives another
state. Printed, a JSON line a state (appended to FILE too): the check's
outcome and worst leaf, and for the three leaves farthest from the CPU
the card's and the CPU float32 step's relative L2 distance from the CPU
float64 step on the same graphs and draws, and the largest of each over
every leaf. It is the measurement a change to that check is tested
against (ROADMAP queue 3).
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
                T.make_loss_fn(m, cfg)(b, draws)[0].backward()
            return ({k: p.grad.detach().cpu().double()
                     for k, p in m.named_parameters()},
                    [g.cpu() for g in graphs.graphs])

        def rel(a, b):
            return {k: float((a[k] - b[k]).norm()
                             / b[k].norm().clamp_min(1e-30)) for k in b}

        card, graphs = grads("cuda", torch.float32)
        cpu = grads("cpu", torch.float32, graphs)[0]
        exact = grads("cpu", torch.float64, graphs)[0]
        vs_cpu, card_f64, cpu_f64 = rel(card, cpu), rel(card, exact), rel(
            cpu, exact)
        worst = sorted(vs_cpu, key=vs_cpu.get)[-3:]
        return {"card_vs_f64_max": max(card_f64.values()),
                "cpu_f32_vs_f64_max": max(cpu_f64.values()),
                "worst": {k: {"card_vs_cpu": vs_cpu[k],
                              "card_vs_f64": card_f64[k],
                              "cpu_f32_vs_f64": cpu_f64[k]} for k in worst}}

    for i in range(args.states):
        model, batch = trained()
        rec = {"state": i}
        try:
            out = S.card_vs_cpu_step(model, cfg, batch)
            rec.update(check_ok=True, grad_rel_err_max=out["grad_rel_err_max"],
                       worst_leaf=out["grad_worst_leaf"],
                       loss_rel_err=out["loss_rel_err"])
        except AssertionError as exc:
            rec.update(check_ok=False, failure=str(exc)[:300])
        rec["float64"] = float64_distances(model, batch)
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
