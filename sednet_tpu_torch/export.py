"""Ahead-of-time export of the inference forward into a serving bundle.

Counterpart of `sednet_tpu/export.py`. `torch.export` traces the forward of
a SEDNet at one fixed (batch, points, channels) shape into an
`ExportedProgram`, which `torch.export.save` writes to one `.pt2` file with
the parameters inside it: the file is the whole model, and a serving
process runs it without the model's source. The forward's kernels are
`torch.library` ops (`sednet::topk`, kernel K1, for the kNN graphs and
`sednet::gather_reduce`, kernel K6, for the edge convolutions), so the
exported graph calls them; loading a bundle imports the port's ops, which
registers them.

A bundle is a directory holding:
    type_model.pt2    exported forward of the type/edge model
    inst_model.pt2    exported forward of the instance model
    meta.json         config snapshot, input and output specs, torch version

Shapes are static: one bundle per (batch, num_points) serving shape. A
bundle runs on the device it was exported on (`device` in meta.json):
JAX's cross-platform lowering has no counterpart here, so a bundle for the
card is exported on the card.

CLI:
    python -m sednet_tpu_torch.export <cfg.yml> --type-ckpt C1 \\
        --inst-ckpt C2 --out bundle_dir [--batch 8] [--device cuda]
"""
from __future__ import annotations

import json
import os

import torch

from sednet_tpu_torch.config import Config
from sednet_tpu_torch.device import resolve_device

_DTYPE_NAMES = {torch.float32: "float32", torch.int64: "int64",
                torch.int32: "int32"}


class _Forward(torch.nn.Module):
    """The inference forward that `export_forward` traces (JAX's
    `_forward_fn`): x (B, N, C) -> a plain dict with JAX's keys, so that
    the bundle's calling convention needs no class of this package.
    `edge_logits` appears only when the model has an edge head (the port's
    SEDNet has no normal head, so `normals_pred` never appears)."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x):
        out = self.model(x)
        res = {"embedding": out.embedding,
               "type_log_prob": out.type_log_prob,
               "type_logits": out.type_logits}
        if out.edge_logits is not None:
            res["edge_logits"] = out.edge_logits
        if getattr(out, "normals_pred", None) is not None:
            res["normals_pred"] = out.normals_pred
        return res


def export_forward(model, batch_size: int, num_points: int, channels: int,
                   *, device=None) -> torch.export.ExportedProgram:
    """Export the inference forward of `model` at a fixed serving shape, on
    `device` (None: the card), where the model is moved first and where the
    bundle will run. The trace runs with fake tensors, in eval mode and
    without gradients; the ops of the kernels appear in its graph as calls
    of `torch.ops.sednet.*`."""
    dev = resolve_device(device)
    model = model.to(dev).eval()
    x = torch.zeros((batch_size, num_points, channels), dtype=torch.float32,
                    device=dev)
    with torch.no_grad():
        return torch.export.export(_Forward(model), (x,))


def _spec(node) -> str:
    """A graph node's tensor spec as JAX's avals print: "float32[B,N,C]"."""
    val = node.meta["val"]
    return (f"{_DTYPE_NAMES.get(val.dtype, str(val.dtype))}"
            f"[{','.join(str(int(d)) for d in val.shape)}]")


def _avals(ep: torch.export.ExportedProgram):
    """(input specs, output specs) of an exported forward: the user inputs
    (not the lifted parameters) and the outputs in the dict's order."""
    sig = ep.graph_signature
    nodes = {n.name: n for n in ep.graph.nodes}
    return ([_spec(nodes[name]) for name in sig.user_inputs],
            [_spec(nodes[name]) for name in sig.user_outputs])


def save_bundle(out_dir: str, cfg: Config,
                exported: dict[str, torch.export.ExportedProgram], *,
                device) -> None:
    """Write each exported program as `<name>.pt2` and a meta.json
    describing them (JAX's keys, `torch_version` in place of `jax_version`
    and each model's `device` in place of its `platforms`)."""
    os.makedirs(out_dir, exist_ok=True)
    meta = {"torch_version": torch.__version__,
            "config": cfg.asdict(),
            "models": {}}
    for name, ep in exported.items():
        path = os.path.join(out_dir, f"{name}.pt2")
        torch.export.save(ep, path)
        ins, outs = _avals(ep)
        meta["models"][name] = {"file": f"{name}.pt2",
                                "device": torch.device(device).type,
                                "in_avals": ins, "out_avals": outs}
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)


def load_bundle(bundle_dir: str, device=None):
    """Load a bundle for serving: returns (meta, {name: callable}).

    Each callable takes x (B, N, C) float32 at the exported shape, on the
    bundle's device, and returns the output dict. The model's source is not
    needed, but the port's ops are: this imports them, which registers the
    `sednet::` ops that the graphs call. Raises when the bundle was
    exported for another device than `device` (None: the card)."""
    from sednet_tpu_torch.ops import flash_topk, graph  # noqa: F401

    dev = resolve_device(device)
    with open(os.path.join(bundle_dir, "meta.json")) as f:
        meta = json.load(f)
    fns = {}
    for name, info in meta["models"].items():
        if info["device"] != dev.type:
            raise ValueError(
                f"{bundle_dir}: {name} was exported for {info['device']}, "
                f"not {dev.type}; export the bundle on the device it serves "
                "on")
        ep = torch.export.load(os.path.join(bundle_dir, info["file"]))
        fns[name] = ep.module()
    return meta, fns


def export_serving_bundle(cfg: Config, params_type, params_inst,
                          out_dir: str, *, batch_size: int | None = None,
                          device=None) -> None:
    """Export the two-checkpoint inference API as one serving bundle. As in
    `predict.run_prediction` (the reference's convention,
    generate_predictions_aug.py:142-198), params_type feeds the type/edge
    model and params_inst the instance model; each is a state dict of the
    port's SEDNet (`weights.load_params`) or a SEDNet."""
    from sednet_tpu_torch.train import build_model

    dev = resolve_device(device)
    b = batch_size or cfg.batch_size
    c = 6 if cfg.normals else 3
    exported = {}
    for name, params in (("type_model", params_type),
                         ("inst_model", params_inst)):
        if isinstance(params, torch.nn.Module):
            model = params
        else:
            model = build_model(cfg)
            model.load_state_dict(params, strict=True)
        exported[name] = export_forward(model, b, cfg.num_points, c,
                                        device=dev)
    save_bundle(out_dir, cfg, exported, device=dev)


def main(argv=None):
    import argparse

    from sednet_tpu_torch.config import load_config
    from sednet_tpu_torch.weights import load_params

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config")
    ap.add_argument("--type-ckpt", required=True)
    ap.add_argument("--inst-ckpt", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu: where the bundle runs")
    args = ap.parse_args(argv)

    cfg = load_config(args.config)
    pt = load_params(args.type_ckpt)
    pi = load_params(args.inst_ckpt)
    export_serving_bundle(cfg, pt, pi, args.out, batch_size=args.batch,
                          device=args.device)
    sizes = {f: os.path.getsize(os.path.join(args.out, f))
             for f in sorted(os.listdir(args.out))}
    print(json.dumps({"bundle": args.out, "files": sizes}))


if __name__ == "__main__":
    main()
