"""Legacy ParseNet-style segmentation model.

Counterpart of `sednet_tpu/models/parsenet.py:26-79` (reference:
src/SEDNet.py:101-213, PrimitivesEmbeddingDGCNGn), on the port's DGCNN
encoder and with the flax layer names, so that `weights.params_from_flat`
carries JAX's parameters across. What differs from SEDNet
(`models/sednet.py`):
  * the edge head hangs off x_all, not x_type (SEDNet.py:182-183);
  * early fusion adds asis(x_type) without a weight (no w_pos_enc,
    :199-200);
  * late fusion concatenates softmax(type) (and softmax(edge)) onto the
    embedding instead of adding a learned projection (:204-207), so the
    embedding has emb_size (+ num_primitives) (+ 2) channels.

The end-to-end training of the reference's e2e variant lives in
`sednet_tpu_torch.parsenet_e2e`.
"""
from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from sednet_tpu_torch.models.backbone import DGCNNEncoder, GroupNorm
from sednet_tpu_torch.models.sednet import SEDNetOutput


class ParseNetEmbedding(nn.Module):
    def __init__(self, emb_size: int = 128, num_primitives: int = 6,
                 mode: int = 5, k: int = 64, normal_metric_w: float = 1.0,
                 edge_module: bool = True, late_fusion: bool = True,
                 combine_label_prim: bool = True):
        super().__init__()
        self.edge_module = edge_module
        self.late_fusion = late_fusion
        self.combine_label_prim = combine_label_prim
        self.encoder = DGCNNEncoder(mode=mode, k=k,
                                    normal_metric_w=normal_metric_w)
        self.conv1, self.gn1 = nn.Linear(1280, 512), GroupNorm(8, 512)
        self.conv2, self.gn2 = nn.Linear(512, 256), GroupNorm(4, 256)
        if edge_module:
            self.edge_conv1 = nn.Linear(256, 128)
            self.edge_gn = GroupNorm(4, 128)
            self.edge_conv2 = nn.Linear(128, 2)
        self.mlp_prim_prob1 = nn.Linear(256, 256)
        self.gn_prim = GroupNorm(4, 256)
        self.mlp_prim_prob2 = nn.Linear(256, num_primitives)
        self.mlp_seg_prob1 = nn.Linear(256, 256)
        self.gn_seg = GroupNorm(4, 256)
        if combine_label_prim:
            self.asis_conv = nn.Linear(256, 256)
            self.asis_gn = GroupNorm(4, 256)
        self.mlp_seg_prob2 = nn.Linear(256, emb_size)

    def forward(self, points) -> SEDNetOutput:
        """points: (B, N, 6) (mode 5) or (B, N, 3) (mode 0)."""
        global_feat, feats = self.encoder(points)
        b, n, _ = feats.shape
        x = torch.cat([global_feat[:, None, :].expand(b, n, -1), feats], -1)
        x = F.relu(self.gn1(self.conv1(x)))
        x_all = F.relu(self.gn2(self.conv2(x)))

        edge_logits = None
        if self.edge_module:
            edge_logits = self.edge_conv2(self.edge_gn(self.edge_conv1(x_all)))

        x_type = F.relu(self.gn_prim(self.mlp_prim_prob1(x_all)))
        type_logits = self.mlp_prim_prob2(x_type)
        type_log_prob = F.log_softmax(type_logits, dim=-1)

        x = F.relu(self.gn_seg(self.mlp_seg_prob1(x_all)))
        if self.combine_label_prim:
            x = F.relu(self.asis_gn(self.asis_conv(x_type))) + x
        embedding = self.mlp_seg_prob2(x)
        if self.late_fusion:
            parts = [embedding, F.softmax(type_logits, dim=-1)]
            if self.edge_module:
                parts.append(F.softmax(edge_logits, dim=-1))
            embedding = torch.cat(parts, -1)
        return SEDNetOutput(embedding, type_log_prob, type_logits, edge_logits)
