"""Training: train and eval steps, schedules, three-criteria checkpoints.

Counterpart of `sednet_tpu/train.py` (reference: train_sed_net.py), with
JAX's names:
  * loss = triplet + label-smoothed type NLL + weighted edge CE
    + w_edge_embed_loss (0.25) * edge-embedding loss (train_sed_net.py:252-270);
  * type labels remapped {9,6,7}->0, 8->2 before the type loss (:254-255);
  * eval every eval_T steps with criterion = pull/push loss + 0.15 * type
    NLL (:298-356);
  * ReduceLROnPlateau(factor 0.5, patience, min_lr 5e-5) or the cosine
    schedule, stepped at eval time (:205-210, 361-364);
  * best_total / best_inst / best_type checkpoints and latest (:367-395).

What differs from JAX, by design:
  * the optimizer is torch's AdamW (Adam for `optim: adam`) over every
    parameter in one group, optax's unmasked `adamw` in another rounding
    order; `cfg.grad_clip` runs in the step as the port's copy of optax's
    `clip_by_global_norm`, where JAX chains it before the update;
  * the step's random draws (the triplet loss's samples and pairs) come
    from a `torch.Generator` seeded with `cfg.seed`, not `jax.random`;
  * checkpoints are flat `.npz` files (`weights.save_params_npz`, JAX's
    `save_params_npz` format, which JAX's `load_params` reads), the
    optimizer's state a `torch.save` of its state dict; no orbax is
    written. The preload reads all three formats of `weights.load_params`
    (`.npz`, the reference's `.pth`, orbax) and the optimizer resumes from
    JAX's orbax `latest_opt` as well as from the port's `latest_opt.pt`;
  * one device: `mesh_shape` > 1 raises (item 9). On one device the loss
    is the global-batch loss that JAX's data-parallel step computes.

Every edge convolution of the forward runs kernel K6 on the card, and the
backward its gradient, kernel K6b (`ops.graph.gather_reduce`); the kNN
graphs are kernel K1, under no gradient.

CLI: python -m sednet_tpu_torch.train <config.yml> [--data-root DIR]
     [--steps N] [--run-dir DIR]
"""
from __future__ import annotations

import json
import logging
import os
import shutil
from typing import NamedTuple

import numpy as np
import torch

from sednet_tpu_torch.config import Config, load_config
from sednet_tpu_torch.device import resolve_device
from sednet_tpu_torch.losses import (TripletConfig, edge_cls_loss,
                                     edge_embedding_loss, evaluate_type_miou,
                                     label_smoothing_nll, primitive_nll,
                                     pull_push_embedding_loss, triplet_loss)
from sednet_tpu_torch.models import SEDNet
from sednet_tpu_torch.models.init import init_like_flax
from sednet_tpu_torch.weights import (flatten_tree, load_params,
                                      params_from_flat, read_orbax_tree,
                                      save_params_npz)

logger = logging.getLogger("sednet_tpu_torch.train")


class TrainState(NamedTuple):
    model: SEDNet
    optimizer: torch.optim.Optimizer
    step: int


def build_model(cfg: Config) -> SEDNet:
    """The SEDNet that `sednet_tpu/train.py build_model` builds (mode 5 with
    normals, else 0). bf16 compute, the normal head and the direct
    GroupNorm edge convolution are not ported and raise."""
    for field, what in (("model_bf16", "bf16 compute"),
                        ("predict_normal", "the normal head")):
        if getattr(cfg, field):
            raise NotImplementedError(f"{field}: {what} is not ported")
    if not cfg.factored_gn:
        raise NotImplementedError(
            "factored_gn=False: the direct GroupNorm edge convolution is not "
            "ported; the port's encoder is the factored one")
    return SEDNet(emb_size=cfg.embed, num_primitives=cfg.num_primitives,
                  mode=5 if cfg.normals else 0, k=cfg.knn,
                  normal_metric_w=cfg.normal_metric_W,
                  w_pos_enc=cfg.w_pos_enc, edge_module=cfg.edge_module,
                  late_fusion=cfg.late_fusion,
                  combine_label_prim=cfg.combine_label_prim)


def make_optimizer(cfg: Config, params) -> torch.optim.Optimizer:
    """torch AdamW (Adam for `optim: adam`) at cfg.lr with optax's defaults
    (b1 0.9, b2 0.999, eps 1e-8) over every parameter in one group, as
    optax's unmasked `adamw`/`adam`. The clip of cfg.grad_clip is applied
    by the train step (`clip_by_global_norm`)."""
    params = list(params)
    if cfg.optim == "adam":
        return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999),
                                eps=1e-8)
    return torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=cfg.weight_decay)


@torch.no_grad()
def clip_by_global_norm(params, max_norm: float):
    """optax.clip_by_global_norm on the gradients of `params`, in place:
    with g_norm the L2 norm of all of them together, each g becomes
    (g / g_norm) * max_norm unless g_norm < max_norm (not torch's
    clip_grad_norm_, which divides by g_norm + 1e-6). Returns g_norm."""
    grads = [p.grad for p in params if p.grad is not None]
    g_norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = g_norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / g_norm) * max_norm))
    return g_norm


def model_input(batch: dict, normals: bool):
    pts = batch["points"]
    return torch.cat([pts, batch["normals"]], -1) if normals else pts


def remap_train_types(prim):
    """{9,6,7}->0, 8->2 (reference: train_sed_net.py:254-255)."""
    prim = torch.where((prim == 9) | (prim == 6) | (prim == 7), 0, prim)
    return torch.where(prim == 8, 2, prim)


def to_device(batch: dict, device) -> dict:
    """A loader's numpy batch as tensors on `device`."""
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def make_loss_fn(model: SEDNet, cfg: Config):
    """loss_fn(batch, draws=None, generator=None) -> (total, metrics): the
    four-term loss of `sednet_tpu/train.py make_train_step`, differentiable
    in the model's parameters; draws / generator feed the triplet loss
    (`losses.triplet_loss`)."""
    tri_cfg = TripletConfig(margin=cfg.triplet_margin,
                            max_segments=cfg.ms_max_clusters)

    def loss_fn(batch, draws=None, generator=None):
        out = model(model_input(batch, cfg.normals))
        prim = remap_train_types(batch["prim"])
        emb_loss = triplet_loss(out.embedding, batch["labels"], tri_cfg,
                                draws=draws, generator=generator)
        p_loss = label_smoothing_nll(out.type_log_prob, prim, cfg.smooth)
        e_loss = edge_cls_loss(out.edge_logits, batch["edges"],
                               batch["edges_w"])
        ee_loss = edge_embedding_loss(
            out.edge_logits, out.embedding, batch["labels"],
            edges_num=min(cfg.edge_topk, cfg.num_points), use_type=True,
            primitives=prim, type_log_prob=out.type_log_prob,
            max_segments=cfg.ms_max_clusters + 1)
        total = emb_loss + p_loss + e_loss + cfg.w_edge_embed_loss * ee_loss
        with torch.no_grad():
            # train-side type mIoU = the reference's TrI
            # (train_sed_net.py:339-354)
            iou = evaluate_type_miou(prim, out.type_log_prob)
        metrics = {"loss": total, "emb": emb_loss, "type": p_loss,
                   "edge_cls": e_loss, "edge_embed": ee_loss, "iou": iou}
        return total, {k: v.detach() for k, v in metrics.items()}

    return loss_fn


def make_train_step(model: SEDNet, optimizer: torch.optim.Optimizer,
                    cfg: Config):
    """train_step(batch, draws=None, generator=None) -> metrics: one
    gradient step of the model's parameters (loss, backward, the optional
    global-norm clip, the optimizer's update); metrics are 0-d tensors on
    the model's device."""
    loss_fn = make_loss_fn(model, cfg)
    params = list(model.parameters())

    def train_step(batch, draws=None, generator=None):
        optimizer.zero_grad(set_to_none=True)
        total, metrics = loss_fn(batch, draws, generator)
        total.backward()
        if cfg.grad_clip > 0:
            # clip BEFORE the adam moments, as optax chains it, so that one
            # spiked batch cannot poison them
            clip_by_global_norm(params, cfg.grad_clip)
        optimizer.step()
        return metrics

    return train_step


def make_eval_step(model: SEDNet, cfg: Config):
    @torch.no_grad()
    def eval_step(batch):
        out = model(model_input(batch, cfg.normals))
        prim = remap_train_types(batch["prim"])
        emb_loss, _, _ = pull_push_embedding_loss(
            out.embedding, batch["labels"],
            max_segments=cfg.ms_max_clusters + 1)
        p_loss = primitive_nll(out.type_log_prob, prim)
        miou = evaluate_type_miou(prim, out.type_log_prob)
        return {"emb": emb_loss, "type": p_loss, "iou": miou,
                "loss": emb_loss + p_loss}

    return eval_step


class PlateauScheduler:
    """ReduceLROnPlateau equivalent (reference: train_sed_net.py:208-210):
    halve the learning rate when the criterion has not improved for
    `patience` evals."""

    def __init__(self, lr: float, factor=0.5, patience=5, min_lr=5e-5):
        self.lr, self.factor, self.patience, self.min_lr = (
            lr, factor, patience, min_lr)
        self.best = float("inf")
        self.bad = 0

    def step(self, criterion: float) -> float:
        if criterion < self.best:
            self.best = criterion
            self.bad = 0
        else:
            self.bad += 1
            if self.bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad = 0
        return self.lr


class CosineScheduler:
    """CosineAnnealingLR(T_max=10, eta_min=lr/20) stepped per eval
    (reference: train_sed_net.py:205-206); past T_max the cosine reflects
    back up, as torch's closed form does."""

    def __init__(self, lr: float, t_max=10):
        self.base, self.eta_min, self.t_max = lr, lr / 20, t_max
        self.t = 0

    def step(self, _criterion: float) -> float:
        self.t += 1
        cos = (1 + np.cos(np.pi * self.t / self.t_max)) / 2
        return self.eta_min + (self.base - self.eta_min) * cos


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float):
    """Set the learning rate of every parameter group; returns the
    optimizer."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
    return optimizer


def load_params_tolerant(template: dict, path: str) -> dict:
    """Shape-mismatch-tolerant load: the checkpoint's leaves whose shape
    matches the template state dict's, the template's init elsewhere
    (reference: train_sed_net.py on_load_checkpoint :97-113)."""
    loaded = load_params(path)
    merged = {}
    for key, tpl in template.items():
        new = loaded.get(key)
        if new is not None and tuple(new.shape) == tuple(tpl.shape):
            merged[key] = new.to(dtype=tpl.dtype, device=tpl.device)
            continue
        if new is not None:
            logger.info("dropping mismatched checkpoint leaf %s: %s vs %s",
                        key, tuple(new.shape), tuple(tpl.shape))
        merged[key] = tpl
    return merged


def load_optimizer_state(optimizer: torch.optim.Optimizer, path: str,
                         model: torch.nn.Module | None = None):
    """Resume the optimizer from the port's own `latest_opt.pt`, or from the
    orbax directory that JAX's `CheckpointManager` writes as `latest_opt`:
    the state of `sednet_tpu/train.py make_optimizer`, optax's
    `inject_hyperparams(adamw | adam)`, behind `clip_by_global_norm` in a
    chain when grad_clip > 0 (the chain's second entry) or alone. Its
    moments `mu` / `nu` become each parameter's `exp_avg` / `exp_avg_sq`,
    matched to `model`'s parameters by name (kernels transposed as in
    `weights.py`), its `count` the `step`; b1, b2, eps and weight_decay come
    from the saved hyperparameters, and so does the learning rate, which
    the caller overrides with cfg.lr as JAX's `set_learning_rate` does.
    An orbax state needs `model`."""
    if path.endswith(".pt"):
        optimizer.load_state_dict(torch.load(path, map_location="cpu",
                                             weights_only=True))
        return optimizer
    if model is None:
        raise ValueError(f"{path!r}: an orbax optimizer state is matched to "
                         "the parameters by name; pass the model")
    tree = read_orbax_tree(path)
    inject = tree if "hyperparams" in tree else tree.get("1", {})
    if "hyperparams" not in inject:
        raise ValueError(f"{path!r}: not the optax state of make_optimizer "
                         f"(top-level keys {sorted(tree)})")
    hyper = {k: float(v) for k, v in inject["hyperparams"].items()}
    adam = inject["inner_state"]["0"]
    if hyper.get("eps_root", 0.0) != 0.0:
        raise ValueError(f"{path!r}: eps_root {hyper['eps_root']} has no "
                         "torch Adam counterpart")
    if ("weight_decay" in hyper) != isinstance(optimizer,
                                               torch.optim.AdamW):
        raise ValueError(f"{path!r}: saved hyperparameters {sorted(hyper)} "
                         f"do not fit {type(optimizer).__name__}")
    mu = params_from_flat(flatten_tree(adam["mu"]), "")
    nu = params_from_flat(flatten_tree(adam["nu"]), "")
    name_of = {id(p): n for n, p in model.named_parameters()}
    differ = set(mu) ^ set(name_of.values())
    if differ:
        raise KeyError(f"{path!r}: the saved moments and the model's "
                       f"parameters differ in {sorted(differ)}")
    for name, p in model.named_parameters():
        if mu[name].shape != p.shape:
            raise ValueError(f"{path!r}: moment of {name} has shape "
                             f"{tuple(mu[name].shape)}, the parameter "
                             f"{tuple(p.shape)}")
    step = torch.tensor(float(adam["count"]), dtype=torch.float32)
    sd = optimizer.state_dict()
    state = {}
    for group, saved in zip(optimizer.param_groups, sd["param_groups"]):
        for p, index in zip(group["params"], saved["params"]):
            name = name_of[id(p)]
            state[index] = {"step": step.clone(), "exp_avg": mu[name],
                            "exp_avg_sq": nu[name]}
        saved.update(lr=hyper["learning_rate"], eps=hyper["eps"],
                     betas=(hyper["b1"], hyper["b2"]))
        if "weight_decay" in hyper:
            saved["weight_decay"] = hyper["weight_decay"]
    optimizer.load_state_dict({"state": state,
                               "param_groups": sd["param_groups"]})
    return optimizer


class CheckpointManager:
    """best_total / best_inst / best_type / latest as `<name>.npz` (flat,
    JAX's `save_params_npz` format) and the optimizer's state as
    `latest_opt.pt` (reference: train_sed_net.py:367-395)."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.best_total = float("inf")
        self.best_inst = float("inf")
        self.best_type = float("inf")

    def path(self, name: str) -> str:
        return os.path.join(self.root, name + ".npz")

    def update(self, model, criterion: float, emb: float, type_loss: float,
               optimizer=None):
        saved = []
        for name, value in (("best_total", criterion), ("best_inst", emb),
                            ("best_type", type_loss)):
            if value < getattr(self, name):
                setattr(self, name, value)
                save_params_npz(self.path(name), model)
                saved.append(name)
        save_params_npz(self.path("latest"), model)
        if optimizer is not None:
            # optimizer state for resume (reference: pretrain_opti_path,
            # train_sed_net.py:170-176)
            torch.save(optimizer.state_dict(),
                       os.path.join(self.root, "latest_opt.pt"))
        return saved

    def load(self, name: str) -> dict:
        return load_params(self.path(name))


def _mean(accum, key):
    return float(np.mean([a[key] for a in accum]))


def train_loader(cfg: Config, model: SEDNet, loader, test_loader, *,
                 optimizer: torch.optim.Optimizer, run_dir: str,
                 max_steps: int | None = None, log_every: int = 10,
                 generator: torch.Generator | None = None):
    """The training loop of `sednet_tpu/train.py:388-455` over any batch
    loaders (numpy batches, `data.BatchLoader` or an iterable like it), on
    the model's device: warmup, a step a batch, eval every eval_T steps and
    at max_steps, the scheduler, checkpoints under `run_dir/ckpts` and
    `run_dir/metrics.jsonl`. generator: the triplet draws' (default: seeded
    with cfg.seed). Returns (TrainState, history)."""
    device = next(model.parameters()).device
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    train_step = make_train_step(model, optimizer, cfg)
    eval_step = make_eval_step(model, cfg)
    sched = (CosineScheduler(cfg.lr) if cfg.sche == "cos"
             else PlateauScheduler(cfg.lr, patience=cfg.patience))
    ckpts = CheckpointManager(os.path.join(run_dir, "ckpts"))
    history = []
    step = 0
    train_accum: list[dict] = []
    done = False
    n_epochs = cfg.epochs if max_steps is None else 10 ** 9
    if len(loader) == 0:
        raise ValueError(
            f"empty train loader at batch_size={cfg.batch_size} (drop_last): "
            "the max_steps loop would spin through empty epochs forever")
    with open(os.path.join(run_dir, "metrics.jsonl"), "a") as metrics_log:
        for epoch in range(n_epochs):
            if done:
                break
            for batch in loader:
                batch = to_device(batch, device)
                if cfg.warmup_steps and step < cfg.warmup_steps:
                    set_learning_rate(
                        optimizer, cfg.lr * (step + 1) / cfg.warmup_steps)
                metrics = train_step(batch, generator=generator)
                values = torch.stack(list(metrics.values())).tolist()
                train_accum.append(dict(zip(metrics, values)))
                step += 1
                if step % log_every == 0:
                    m = {k: _mean(train_accum[-log_every:], k)
                         for k in train_accum[-1]}
                    logger.info("epoch %d step %d %s", epoch, step,
                                {k: round(v, 4) for k, v in m.items()})

                if step % cfg.eval_T == 0 or (max_steps and step >= max_steps):
                    evals = [{k: float(v) for k, v in eval_step(
                        to_device(b, device)).items()} for b in test_loader]
                    ts_e = _mean(evals, "emb")
                    ts_p = _mean(evals, "type")
                    criterion = ts_e + 0.15 * ts_p  # reference :356
                    lr = sched.step(criterion)
                    set_learning_rate(optimizer, lr)
                    record = {
                        "step": step, "epoch": epoch,
                        "TrL": _mean(train_accum, "loss"), "TsL": ts_e + ts_p,
                        "TrP": _mean(train_accum, "type"), "TsP": ts_p,
                        "TrE": _mean(train_accum, "emb"), "TsE": ts_e,
                        "TrI": _mean(train_accum, "iou"),
                        "TsI": _mean(evals, "iou"),
                        "TrEdgeCls": _mean(train_accum, "edge_cls"),
                        "TrEdgeEmbed": _mean(train_accum, "edge_embed"),
                        "criterion": criterion, "lr": lr,
                    }
                    record["saved"] = ckpts.update(model, criterion, ts_e,
                                                   ts_p, optimizer=optimizer)
                    history.append(record)
                    metrics_log.write(json.dumps(record) + "\n")
                    metrics_log.flush()
                    logger.info("eval %s", {k: (round(v, 4)
                                                if isinstance(v, float) else v)
                                            for k, v in record.items()})
                    train_accum = []
                if max_steps and step >= max_steps:
                    done = True
                    break
    return TrainState(model, optimizer, step), history


def init_training(cfg: Config, device):
    """The model from flax's default init (`models.init.init_like_flax`,
    seeded with cfg.seed) or preloaded tolerantly from
    cfg.pretrain_model_path, on `device`; its optimizer, resumed from
    cfg.pretrain_opti_path; and the generator of the steps' draws, which
    the init started. Returns (model, optimizer, generator)."""
    generator = torch.Generator().manual_seed(cfg.seed)
    model = init_like_flax(build_model(cfg), generator)
    if cfg.preload_model and cfg.pretrain_model_path:
        logger.info("preloading params from %s", cfg.pretrain_model_path)
        model.load_state_dict(load_params_tolerant(model.state_dict(),
                                                   cfg.pretrain_model_path))
    model.to(device)
    optimizer = make_optimizer(cfg, model.parameters())
    if cfg.preload_model and cfg.pretrain_opti_path:
        # optimizer resume with the LR override (train_sed_net.py:170-176)
        logger.info("preloading optimizer from %s", cfg.pretrain_opti_path)
        load_optimizer_state(optimizer, cfg.pretrain_opti_path, model)
        set_learning_rate(optimizer, cfg.lr)
    return model, optimizer, generator


def train(cfg: Config, *, data_root: str = ".", max_steps: int | None = None,
          run_dir: str | None = None, use_edge_dataset: bool = True,
          log_every: int = 10, device=None):
    """The training entry of `sednet_tpu/train.py train`: the model, its
    optimizer and the draws' generator (`init_training`), the h5 datasets
    under data_root (ParseNet, mixed with the SED-Net edge set where it
    exists), then `train_loader`. On the card unless device says
    otherwise. Returns (TrainState, history)."""
    from sednet_tpu_torch.data import (BatchLoader, EdgeDataset, MixedDataset,
                                       ParseNetDataset, PrefetchLoader)

    dev = resolve_device(device)
    if cfg.mesh_shape is not None and cfg.mesh_shape > 1:
        raise NotImplementedError(
            f"mesh_shape={cfg.mesh_shape}: the port trains on one device; "
            "multi-device is ROADMAP queue 1 item 9")
    model_name = cfg.model_path.format("mix", cfg.lr, cfg.mode, cfg.knn)
    run_dir = run_dir or os.path.join("trains", model_name)
    os.makedirs(run_dir, exist_ok=True)
    cfg.save(os.path.join(run_dir, "config.json"))
    # the entry script beside the config, as the reference's run directory
    # keeps it (train_sed_net.py:73-79)
    shutil.copy(os.path.abspath(__file__),
                os.path.join(run_dir, "train_entry.py"))
    logging.basicConfig(level=logging.INFO)

    model, optimizer, generator = init_training(cfg, dev)

    kw = dict(normals=cfg.normals, num_points=cfg.num_points,
              max_segments=cfg.ms_max_clusters)
    train_ds = ParseNetDataset(data_root, train=True, **kw)
    if use_edge_dataset:
        try:
            train_ds = MixedDataset(train_ds,
                                    EdgeDataset(data_root, train=True, **kw))
        except (FileNotFoundError, OSError):
            logger.info("edge dataset not found; training on ParseNet only")
    test_ds = ParseNetDataset(data_root, train=False, **kw)
    loader = PrefetchLoader(BatchLoader(train_ds, cfg.batch_size,
                                        shuffle=True, seed=cfg.seed))
    test_loader = BatchLoader(test_ds, cfg.batch_size, shuffle=False,
                              seed=cfg.seed)
    return train_loader(cfg, model, loader, test_loader, optimizer=optimizer,
                        run_dir=run_dir, max_steps=max_steps,
                        log_every=log_every, generator=generator)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("config")
    p.add_argument("--data-root", default=".")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--run-dir", default=None)
    args = p.parse_args(argv)
    train(load_config(args.config), data_root=args.data_root,
          max_steps=args.steps, run_dir=args.run_dir)


if __name__ == "__main__":
    main()
