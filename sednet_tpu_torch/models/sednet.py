"""SEDNet: type, edge and embedding heads over the DGCNN encoder.

Counterpart of `sednet_tpu/models/sednet.py:46-150` (reference:
src/SEDNet.py:216-343), channels-last, with the same layer names:

  trunk: [tile(global), feats] 1280 -> 512 (GN 8, ReLU) -> 256 (GN 4, ReLU) = x_all
  type:  x_all -> 256 (GN 4, ReLU) = x_type -> num_primitives, log-softmax
  edge:  x_type -> 128 (GN 4, no activation) -> 2
  embed: x_all -> 256 (GN 4, ReLU); early fusion += w * relu(GN(asis(x_type)));
         late fusion += w * relu(Dense([type_logits, edge_logits])); -> emb_size
  normal (`predict_normal`): x_all -> 128 (GN 4, no activation) -> 3, unit
         rows (norm clipped at 1e-12)

`dtype` (bf16 under `config.model_bf16`) is the compute dtype of every
Dense and GroupNorm of the encoder and the heads, as
`sednet_tpu/models/sednet.py:57-150` threads it; the parameters stay
float32, and the last Dense of each head runs in float32 on its input cast
up, so that logits, log-probs, embedding and normals leave in float32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from sednet_tpu_torch.models.backbone import (DGCNNEncoder, GroupNorm, dense,
                                              scaled)


@dataclass
class SEDNetOutput:
    embedding: torch.Tensor            # (B, N, emb_size)
    type_log_prob: torch.Tensor        # (B, N, num_primitives)
    type_logits: torch.Tensor          # (B, N, num_primitives)
    edge_logits: Optional[torch.Tensor] = None   # (B, N, 2)
    normals_pred: Optional[torch.Tensor] = None  # (B, N, 3) unit rows


class SEDNet(nn.Module):
    def __init__(self, emb_size: int = 128, num_primitives: int = 6,
                 mode: int = 5, k: int = 64, normal_metric_w: float = 1.0,
                 w_pos_enc: float = 0.2, edge_module: bool = True,
                 late_fusion: bool = True, combine_label_prim: bool = True,
                 predict_normal: bool = False, dtype=torch.float32,
                 factored_gn: bool = True, sort_points: bool = False):
        super().__init__()
        self.w_pos_enc = w_pos_enc
        self.edge_module = edge_module
        self.late_fusion = late_fusion
        self.combine_label_prim = combine_label_prim
        self.dtype = dtype
        self.encoder = DGCNNEncoder(mode=mode, k=k,
                                    normal_metric_w=normal_metric_w,
                                    dtype=dtype, factored_gn=factored_gn,
                                    sort_points=sort_points)
        self.conv1, self.gn1 = nn.Linear(1280, 512), GroupNorm(8, 512)
        self.conv2, self.gn2 = nn.Linear(512, 256), GroupNorm(4, 256)
        self.mlp_prim_prob1 = nn.Linear(256, 256)
        self.gn_prim = GroupNorm(4, 256)
        self.mlp_prim_prob2 = nn.Linear(256, num_primitives)
        if edge_module:
            self.edge_conv1 = nn.Linear(256, 128)
            self.edge_gn = GroupNorm(4, 128)
            self.edge_conv2 = nn.Linear(128, 2)
        self.mlp_seg_prob1 = nn.Linear(256, 256)
        self.gn_seg = GroupNorm(4, 256)
        if combine_label_prim:
            self.asis_conv = nn.Linear(256, 256)
            self.asis_gn = GroupNorm(4, 256)
        if late_fusion:
            fuse_in = num_primitives + (2 if edge_module else 0)
            self.prim_encoding = nn.Linear(fuse_in, 256)
        self.mlp_seg_prob2 = nn.Linear(256, emb_size)
        self.predict_normal = predict_normal
        if predict_normal:
            self.normal_conv1 = nn.Linear(256, 128)
            self.normal_gn = GroupNorm(4, 128)
            self.normal_conv2 = nn.Linear(128, 3)

    @classmethod
    def from_config(cls, cfg) -> "SEDNet":
        return cls(emb_size=cfg.embed, num_primitives=cfg.num_primitives,
                   mode=cfg.mode, k=cfg.knn,
                   normal_metric_w=cfg.normal_metric_W,
                   w_pos_enc=cfg.w_pos_enc, edge_module=cfg.edge_module,
                   late_fusion=cfg.late_fusion,
                   combine_label_prim=cfg.combine_label_prim,
                   predict_normal=cfg.predict_normal,
                   dtype=torch.bfloat16 if cfg.model_bf16 else torch.float32,
                   factored_gn=cfg.factored_gn)

    def forward(self, points, idx1=None, encoder_out=None,
                graphs=None) -> SEDNetOutput:
        """points: (B, N, 6) (mode 5) or (B, N, 3) (mode 0). encoder_out:
        an encoder result (global (B, 1024), features (B, N, 256)) computed
        elsewhere (`apply_fused`); the heads then run on it. graphs: the
        encoder's three graphs, given (`DGCNNEncoder.forward`)."""
        if encoder_out is None:
            encoder_out = self.encoder(points, idx1, graphs)
        return self.heads(*encoder_out)

    def heads(self, global_feat, feats, norm=None) -> SEDNetOutput:
        """The heads on an encoder's result, global (B, 1024) and features
        (B, N, 256). norm(gn, x), where given, takes the place of each
        GroupNorm layer gn's own gn(x) (`parallel.big_forward` passes one
        whose statistics are all-reduced over a sharded cloud)."""
        dt = self.dtype
        if norm is None:
            def norm(gn, x):
                return gn(x)

        def to_dt(t):
            # float32 compute casts nothing: a float32 model moved to
            # float64 (the smoke's reference steps) stays float64
            return t if dt == torch.float32 else t.to(dt)

        def to_out(t):
            # the heads' last Dense runs in float32, or wider where dt is
            return (t if dt == torch.float32
                    else t.to(torch.promote_types(dt, torch.float32)))

        b, n, _ = feats.shape
        x = torch.cat([to_dt(global_feat)[:, None, :].expand(b, n, -1),
                       to_dt(feats)], -1)
        x = F.relu(norm(self.gn1, dense(self.conv1, x, dt)))
        x_all = F.relu(norm(self.gn2, dense(self.conv2, x, dt)))

        x_type = F.relu(norm(self.gn_prim,
                             dense(self.mlp_prim_prob1, x_all, dt)))
        type_logits = self.mlp_prim_prob2(to_out(x_type))
        type_log_prob = F.log_softmax(type_logits, dim=-1)

        edge_logits = None
        if self.edge_module:
            e = norm(self.edge_gn, dense(self.edge_conv1, x_type, dt))
            edge_logits = self.edge_conv2(to_out(e))

        x = F.relu(norm(self.gn_seg, dense(self.mlp_seg_prob1, x_all, dt)))
        if self.combine_label_prim:
            asis = F.relu(norm(self.asis_gn,
                               dense(self.asis_conv, x_type, dt)))
            x = scaled(self.w_pos_enc, asis) + x
        if self.late_fusion:
            fuse_in = type_logits.detach()
            if self.edge_module:
                fuse_in = torch.cat([fuse_in, edge_logits.detach()], -1)
            fuse = F.relu(dense(self.prim_encoding, to_dt(fuse_in), dt))
            x = x + scaled(self.w_pos_enc, fuse)
        embedding = self.mlp_seg_prob2(to_out(x))

        normals_pred = None
        if self.predict_normal:
            nr = norm(self.normal_gn, dense(self.normal_conv1, x_all, dt))
            nr = self.normal_conv2(to_out(nr))
            normals_pred = nr / torch.clamp_min(
                torch.linalg.vector_norm(nr, dim=-1, keepdim=True), 1e-12)
        return SEDNetOutput(embedding, type_log_prob, type_logits, edge_logits,
                            normals_pred)


def apply_fused(model: SEDNet, points) -> SEDNetOutput:
    """Inference forward through the index-free fused encoder
    (`ops.fused_edgeconv.encoder_apply_fused`, kernel K4) on the same
    parameters, then the heads (`sednet_tpu/models/sednet.py:153-169`).
    Matches model(points) to float tolerance, ties at the k-th neighbour
    distance aside. float32 only, as JAX's: a bf16 model (`model_bf16`)
    raises."""
    from sednet_tpu_torch.ops.fused_edgeconv import encoder_apply_fused

    if model.dtype != torch.float32:
        raise ValueError("apply_fused: the fused encoder (fused_encoder) runs "
                         "float32 only; model_bf16 builds a bf16 model")

    return model(points, encoder_out=encoder_apply_fused(model.encoder,
                                                         points))
