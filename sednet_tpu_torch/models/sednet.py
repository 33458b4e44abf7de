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
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from sednet_tpu_torch.models.backbone import DGCNNEncoder, GroupNorm


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
                 predict_normal: bool = False):
        super().__init__()
        self.w_pos_enc = w_pos_enc
        self.edge_module = edge_module
        self.late_fusion = late_fusion
        self.combine_label_prim = combine_label_prim
        self.encoder = DGCNNEncoder(mode=mode, k=k,
                                    normal_metric_w=normal_metric_w)
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
                   predict_normal=cfg.predict_normal)

    def forward(self, points, idx1=None, encoder_out=None) -> SEDNetOutput:
        """points: (B, N, 6) (mode 5) or (B, N, 3) (mode 0). encoder_out:
        an encoder result (global (B, 1024), features (B, N, 256)) computed
        elsewhere (`apply_fused`); the heads then run on it."""
        if encoder_out is None:
            encoder_out = self.encoder(points, idx1)
        global_feat, feats = encoder_out
        b, n, _ = feats.shape
        x = torch.cat([global_feat[:, None, :].expand(b, n, -1), feats], -1)
        x = F.relu(self.gn1(self.conv1(x)))
        x_all = F.relu(self.gn2(self.conv2(x)))

        x_type = F.relu(self.gn_prim(self.mlp_prim_prob1(x_all)))
        type_logits = self.mlp_prim_prob2(x_type)
        type_log_prob = F.log_softmax(type_logits, dim=-1)

        edge_logits = None
        if self.edge_module:
            edge_logits = self.edge_conv2(self.edge_gn(self.edge_conv1(x_type)))

        x = F.relu(self.gn_seg(self.mlp_seg_prob1(x_all)))
        if self.combine_label_prim:
            asis = F.relu(self.asis_gn(self.asis_conv(x_type)))
            x = self.w_pos_enc * asis + x
        if self.late_fusion:
            fuse_in = type_logits.detach()
            if self.edge_module:
                fuse_in = torch.cat([fuse_in, edge_logits.detach()], -1)
            x = x + self.w_pos_enc * F.relu(self.prim_encoding(fuse_in))
        embedding = self.mlp_seg_prob2(x)

        normals_pred = None
        if self.predict_normal:
            nr = self.normal_conv2(self.normal_gn(self.normal_conv1(x_all)))
            normals_pred = nr / torch.clamp_min(
                torch.linalg.vector_norm(nr, dim=-1, keepdim=True), 1e-12)
        return SEDNetOutput(embedding, type_log_prob, type_logits, edge_logits,
                            normals_pred)


def apply_fused(model: SEDNet, points) -> SEDNetOutput:
    """Inference forward through the index-free fused encoder
    (`ops.fused_edgeconv.encoder_apply_fused`, kernel K4) on the same
    parameters, then the heads (`sednet_tpu/models/sednet.py:153-169`).
    Matches model(points) to float tolerance, ties at the k-th neighbour
    distance aside."""
    from sednet_tpu_torch.ops.fused_edgeconv import encoder_apply_fused

    return model(points, encoder_out=encoder_apply_fused(model.encoder,
                                                         points))
