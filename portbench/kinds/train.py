"""The train runner: a closed loop of the port's training step,
`train.make_train_step` (the four-term loss, backward through K6b,
AdamW), fed as `train.train` feeds it: the port's own host augmentation
behind its `PrefetchLoader`, over a pool of clouds with edge labels.

Set-up builds the model, makes its weights on the device from the seed,
builds the optimizer and the step once, and drives that step through its
first three batches (the checked steps, which also build and warm every
kernel). The window runs the same step on the following batches and
ends, after --seconds, once the last step enqueued has completed.

`correct`: the reference (`reference.py`) trains the same weights on the
same three batches, worked out again from the pool and the seed by
`gen.feed_batches`, with the same triplet draws, and is compared by each
step's loss, the norm of each leaf's first gradient (as the optimizer
holds it after step 1: its first moment over 1 - beta1) and the norm of
each leaf's change over the three steps.
"""
from __future__ import annotations

import math
import statistics
import time
from itertools import islice

import numpy as np

from portbench import counts, gen
from portbench.shared import port_config
from portbench import reference as ref
from portbench.trace import WINDOW, profiled

FEED_KEYS = ("points", "normals", "labels", "prim", "edges", "edges_w")


def flax_name(name: str, ndim: int) -> str:
    path, leaf = name.rsplit(".", 1)
    if leaf == "weight":
        leaf = "kernel" if ndim == 2 else "scale"
    return path.replace(".", "/") + "/" + leaf


def make_weights(model, seed: int, device):
    """Every matrix from one normal draw on the device, scaled by
    1/sqrt(fan-in); norm scales 1, biases 0. Returns the same values in
    the reference's layout (matrices as (in, out))."""
    import torch

    gen_dev = torch.Generator(device=device).manual_seed(seed)
    params = dict(model.named_parameters())
    mats = [(k, p) for k, p in params.items() if p.ndim == 2]
    flat = torch.randn(sum(p.numel() for _, p in mats), generator=gen_dev,
                       device=device)
    out, o = {}, 0
    with torch.no_grad():
        for k, p in params.items():
            if p.ndim == 2:
                p.copy_(flat[o:o + p.numel()].view(p.shape)
                        / math.sqrt(p.shape[1]))
                o += p.numel()
            elif k.endswith("weight"):
                p.fill_(1.0)
            else:
                p.zero_()
            out[flax_name(k, p.ndim)] = (p.T if p.ndim == 2 else p).detach().clone()
    return out


def reference_steps(w0: dict, batches: list, gen_state, cfg, device,
                    prec=ref.F32):
    """Three AdamW steps of the reference from w0 on `batches` with the
    triplet draws of a generator at `gen_state`. Returns (losses, first
    gradient norms, change norms), norms by leaf name."""
    import torch

    g = torch.Generator()
    g.set_state(gen_state)
    w = {k: v.clone().requires_grad_(True) for k, v in w0.items()}
    opt = ref.AdamW(w, cfg.lr, cfg.weight_decay)
    losses, g1 = [], None
    for hb in batches:
        b = {k: torch.from_numpy(hb[k]).to(device) for k in FEED_KEYS}
        draws = ref.sample_draws(b["labels"], g, cfg.ms_max_clusters)
        loss = ref.sednet_loss(w, b, draws, k=cfg.knn, smooth=cfg.smooth,
                               edge_topk=min(cfg.edge_topk, cfg.num_points),
                               w_edge_embed=cfg.w_edge_embed_loss, prec=prec)
        grads = dict(zip(w, torch.autograd.grad(loss, list(w.values()),
                                                allow_unused=True)))
        grads = {k: (torch.zeros_like(w[k]) if v is None else v)
                 for k, v in grads.items()}
        if g1 is None:
            g1 = {k: float(v.norm()) for k, v in grads.items()}
        opt.step(w, grads)
        losses.append(float(loss.detach()))
        del loss, grads
    change = {k: float((w[k].detach() - w0[k]).norm()) for k in w}
    return losses, g1, change


def compare(out: tuple, ref_out: tuple, feed_gap: float) -> tuple:
    """The numbers `correct` holds to their limits: the relative gap of
    the first step's loss (the later steps' losses swing with the
    discrete decisions of the graphs and the edge top-k), and by the worst leaf the gap between the norms
    of the first gradient and of the change, each over the larger of the
    reference leaf's norm and the median leaf's. Leaves whose reference
    gradient is under a thousandth of the median leaf's (nought to
    rounding, moved by Adam on round-off alone) are left out of the
    change."""
    (lp, gp, cp), (lr, gr, cr) = out, ref_out
    loss_gap = abs(lp[0] - lr[0]) / abs(lr[0])
    med_g = statistics.median(gr.values())
    med_c = statistics.median(cr.values())
    grad_gap = max(abs(gp[k] - gr[k]) / max(gr[k], med_g) for k in gr)
    kept = [k for k in cr if gr[k] >= 1e-3 * med_g]
    change_gap = max(abs(cp[k] - cr[k]) / max(cr[k], med_c) for k in kept)
    return ({"loss_gap": loss_gap, "grad_gap": grad_gap,
             "change_gap": change_gap, "feed_gap": feed_gap},
            {"left_out": sorted(set(cr) - set(kept))})


def run(config: dict, traffic: dict, *, seed: int, seconds: float,
        trace: bool, device: str, t_start: float, control: str | None = None,
        step_hook=None) -> dict:
    """One run of a train cell. control: a precision of `reference.Prec`
    at which the reference takes the program's place in the comparison.
    step_hook(step): wraps the program's step (the tests plant faults
    with it)."""
    import torch
    from sednet_tpu_torch import train
    from sednet_tpu_torch.data.datasets import (BatchLoader, PrefetchLoader,
                                                _H5Dataset)

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg = port_config(config, traffic)
    model = train.build_model(cfg).to(dev)
    w0 = make_weights(model, gen.derived_seed(seed, 7), dev)
    optimizer = train.make_optimizer(cfg, model.parameters())
    step = train.make_train_step(model, optimizer, cfg)
    if step_hook is not None:
        step = step_hook(step)
    draws = torch.Generator().manual_seed(gen.derived_seed(seed, 6))
    pool = gen.make_pool(seed, traffic["pool"], traffic["points"],
                         traffic["segments"], edges=True, prepare=dict)
    arrays = gen.stack(pool, FEED_KEYS)
    loader_seed, item_seed = gen.derived_seed(seed, 8), gen.derived_seed(seed, 9)
    ds = _H5Dataset(arrays["points"], arrays["labels"], arrays["normals"],
                    arrays["prim"], arrays["edges"], arrays["edges_w"],
                    train=True, augment=True, num_points=cfg.num_points,
                    max_segments=cfg.ms_max_clusters, seed=item_seed)
    loader = PrefetchLoader(BatchLoader(ds, cfg.batch_size, shuffle=True,
                                        seed=loader_seed))

    def endless():
        while True:
            yield from loader

    it = endless()
    params = dict(model.named_parameters())
    flax = {k: flax_name(k, p.ndim) for k, p in params.items()}
    beta1 = optimizer.param_groups[0]["betas"][0]
    gen_state = draws.get_state()
    first, losses, g1 = [], [], None
    for s in range(3):
        hb = next(it)
        first.append(hb)
        m = step(train.to_device(hb, dev), generator=draws)
        losses.append(float(m["loss"]))
        if s == 0:
            g1 = {flax[k]: float(optimizer.state[p]["exp_avg"].norm()) / (1 - beta1)
                  for k, p in params.items()}
    change = {flax[k]: float((p.detach() - (w0[flax[k]].T if p.ndim == 2
                                             else w0[flax[k]])).norm())
              for k, p in params.items()}
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.time() - t_start

    n = 0
    with profiled(trace) as prof:
        with torch.profiler.record_function(WINDOW):
            t0 = time.perf_counter()
            while True:
                step(train.to_device(next(it), dev), generator=draws)
                n += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            if cuda:
                torch.cuda.synchronize()
            t1 = time.perf_counter()
    it.close()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del model, optimizer, step
    if cuda:
        torch.cuda.empty_cache()

    ref_batches = list(islice(gen.feed_batches(pool, cfg.batch_size,
                                               loader_seed, item_seed,
                                               cfg.ms_max_clusters), 3))
    feed_gap = max(float(np.max(np.abs(a[k].astype(np.float64)
                                       - b[k].astype(np.float64))))
                   for a, b in zip(first, ref_batches) for k in FEED_KEYS)
    ref_out = reference_steps(w0, ref_batches, gen_state, cfg, dev)
    out = ((losses, g1, change) if control is None else
           reference_steps(w0, ref_batches, gen_state, cfg, dev,
                           ref.Prec(control)))
    checks, info = compare(out, ref_out, feed_gap)
    info["losses"], info["ref_losses"] = out[0], ref_out[0]
    window = t1 - t0
    b, npts = traffic["batch"], traffic["points"]
    ctx = {"trace": prof["trace"], "window_s": window, "steps": n,
           "peak_bytes": peak,
           "peak_flops": counts.PEAK[config["mfu_peak"]],
           "step_flops": counts.train_step_flops(b, npts, cfg.knn, cfg.embed,
                                                 cfg.num_primitives),
           "knn_roofline_s": counts.train_knn_roofline_s(b, npts, cfg.knn)}
    return {"attempted": n * b, "failed": 0,
            "end_to_end": {"train_shapes_per_s": n * b / window,
                           "setup_s": setup_s},
            "checks": checks, "peak_bytes": peak, "ctx": ctx, "info": info}
