"""Model_V5: self-attention detectors + cross-attention correspondences
(port of `pcd_reg_hregnet_tpu/models/attention.py`).

The detectors weigh each grouped neighbourhood by QKV self-attention; the
correspondences come from multi-head cross-attention between the two
clouds' keypoint features, not from kNN matching.  The MI outputs are made
from the level-2 cross-attended features as FineReg2 makes them
(projection, batch-rolled negatives).  The attention here is dense batched
matmuls, as it is in the JAX package (no Pallas kernel there).  A bf16
compute dtype reaches the detectors alone, as in the JAX module: their
Dense layers in bf16, the scores and the attended values in f32.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import ModelConfig
from ..core.device import fp32_numerics
from ..geometry import se3
from ..ops.neighbors import knn_group
from ..ops.sampling import fps, gather_points, weighted_fps
from .layers import ConvBNReLU, Dense, MLPHead, SVDHead, compute_dtype


class KeypointDetectorSelfAttention(nn.Module):
    """Self-attention keypoint detector.  `in_channels` is the width of the
    input features (0 at the first level).  Returns (keypoints [B, M, 3],
    sigmas [B, M], attentive_feature [B, M, C_o])."""

    def __init__(self, in_channels: int, nsample: int, k: int,
                 out_channels: Sequence[int], use_fps: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.nsample, self.k, self.use_fps = nsample, k, use_fps
        c_o = out_channels[-1]
        self.ConvBNReLU_0 = ConvBNReLU(in_channels + 4, out_channels, dtype)
        self.Dense_0 = Dense(c_o, c_o // 4, bias=False, dtype=dtype)     # q
        self.Dense_1 = Dense(c_o, c_o // 4, bias=False, dtype=dtype)     # k
        self.Dense_2 = Dense(c_o, c_o, bias=False, dtype=dtype)          # v
        self.MLPHead_0 = MLPHead(c_o, (c_o, c_o), 1, dtype)

    def forward(self, xyz, features=None, weights=None):
        if xyz.shape[1] < self.nsample:
            raise ValueError(
                f'KeypointDetectorSelfAttention(nsample={self.nsample}) needs '
                f'at least {self.nsample} input points, got {xyz.shape[1]}')
        if self.use_fps:
            idx = (fps(xyz, self.nsample) if weights is None else
                   weighted_fps(xyz, weights, self.nsample))
            sampled_xyz = gather_points(xyz, idx)
        else:
            stride = xyz.shape[1] // self.nsample
            sampled_xyz = xyz[:, ::stride][:, :self.nsample]

        grouped, knn_xyz = knn_group(sampled_xyz, xyz, features, self.k)
        emb = self.ConvBNReLU_0(grouped)
        q, k, v = self.Dense_0(emb), self.Dense_1(emb), self.Dense_2(emb)
        # f32 products of the compute-dtype values (preferred_element_type=f32)
        wide = torch.promote_types(q.dtype, torch.float32)
        scores = torch.einsum('bmkc,bmjc->bmkj', q.to(wide), k.to(wide)) / (self.k ** 0.5)
        attn = torch.softmax(scores, dim=-1)                      # [B,M,k,k]
        attended = torch.einsum('bmkj,bmjc->bmkc', attn.to(v.dtype).to(wide), v.to(wide))
        attentive_feature = torch.sum(attended, dim=2)
        # keypoints from the column-summed attention over the neighbours
        keypoints = torch.einsum('bmk,bmkc->bmc', torch.sum(attn, dim=2), knn_xyz)
        sigmas = F.softplus(self.MLPHead_0(attentive_feature))[..., 0] + 0.001
        return keypoints, sigmas, attentive_feature


class MultiHeadCrossAttention(nn.Module):
    """Cross attention from the source features to the target's: returns
    the projected output [B, N, C] and the attention [B, H, N, M]."""

    def __init__(self, feature_dim: int, num_heads: int = 4):
        super().__init__()
        self.num_heads = num_heads
        C = feature_dim
        self.Dense_0 = Dense(C, C, bias=False)
        self.Dense_1 = Dense(C, C, bias=False)
        self.Dense_2 = Dense(C, C, bias=False)
        self.Dense_3 = Dense(C, C)

    def forward(self, feats_left, feats_right):
        B, N, C = feats_left.shape
        H = self.num_heads
        d = C // H
        q = self.Dense_0(feats_left).reshape(B, N, H, d)
        k = self.Dense_1(feats_right).reshape(B, -1, H, d)
        v = self.Dense_2(feats_right).reshape(B, -1, H, d)
        attn = torch.softmax(torch.einsum('bnhd,bmhd->bhnm', q, k) / (d ** 0.5), dim=-1)
        out = torch.einsum('bhnm,bmhd->bnhd', attn, v).reshape(B, N, C)
        return self.Dense_3(out), attn


def correspondence_estimator(dst_xyz, attn_scores, sigmas):
    """Attention-weighted correspondences: softmax of the (already softmaxed)
    head-wise attention, as the JAX package and the reference do, mean over
    heads, dst points weighted by it; confidence = max attention x sigma."""
    attn = torch.mean(torch.softmax(attn_scores, dim=-1), dim=1)  # [B,N,M]
    corres_xyz = torch.einsum('bnm,bmc->bnc', attn, dst_xyz)
    return corres_xyz, torch.amax(attn, dim=-1) * sigmas


class AttentionRegistrationModel(nn.Module):
    """Model_V5 coarse-to-fine pipeline: one detector stack shared by both
    clouds, cross-attention correspondences and an SVD pose per level.
    Returns the dict of `RegistrationModel` (its `src_feats`/`dst_feats`
    hold `feat_i` in place of `desc_i`)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        dtype = compute_dtype(cfg.compute_dtype)
        self.cfg = cfg
        in_ch = 0
        for i, lvl in enumerate(cfg.levels):
            self.add_module(f'detector_{i + 1}', KeypointDetectorSelfAttention(
                in_ch, lvl.nsample, lvl.k, lvl.conv_channels, cfg.use_fps, dtype))
            in_ch = lvl.conv_channels[-1]
        dims = [lvl.conv_channels[-1] for lvl in cfg.levels]
        for i in (3, 2, 1):
            self.add_module(f'cross_attn_{i}', MultiHeadCrossAttention(dims[i - 1]))
        if cfg.mi_from_fine2:
            self.mi_proj = ConvBNReLU(dims[1], (dims[1],))
        self.pose_head = SVDHead()

    def _extract(self, points):
        ret = {}
        xyz, feat, weights = points, None, None
        for i in range(len(self.cfg.levels)):
            xyz, sigmas, feat = getattr(self, f'detector_{i + 1}')(xyz, feat, weights)
            ret[f'xyz_{i + 1}'] = xyz
            ret[f'sigmas_{i + 1}'] = sigmas
            ret[f'feat_{i + 1}'] = feat
            if self.cfg.use_weights:
                w = 1.0 / (sigmas + 1e-5)
                weights = w / torch.mean(w, dim=1, keepdim=True)
            else:
                weights = None
        return ret

    def _level(self, i, src, dst):
        feats, attn = getattr(self, f'cross_attn_{i}')(src[f'feat_{i}'], dst[f'feat_{i}'])
        corres, w = correspondence_estimator(dst[f'xyz_{i}'], attn, src[f'sigmas_{i}'])
        return feats, corres, w

    @fp32_numerics()
    def forward(self, src_points: torch.Tensor, dst_points: torch.Tensor) -> dict:
        src, dst = self._extract(src_points), self._extract(dst_points)
        head = self.pose_head
        _, corres3, w3 = self._level(3, src, dst)
        R3, t3 = head(src['xyz_3'], corres3, w3)
        T3 = se3.pack(R3, t3)

        src_xyz_2t = se3.apply(R3, t3, src['xyz_2'])
        feats2, corres2, w2 = self._level(2, src, dst)
        R2_, t2_ = head(src_xyz_2t, corres2, w2)
        R2, t2 = se3.unpack(se3.compose(se3.pack(R2_, t2_), T3))

        src_xyz_1t = se3.apply(R2, t2, src['xyz_1'])
        _, corres1, w1 = self._level(1, src, dst)
        R1_, t1_ = head(src_xyz_1t, corres1, w1)
        R1, t1 = se3.unpack(se3.compose(se3.pack(R1_, t1_), se3.pack(R2, t2)))

        ret = {}
        if self.cfg.mi_from_fine2:
            mi_feats = self.mi_proj(feats2)
            ret.update(mi_weights=w2, mi_weights_prime=torch.roll(w2, 1, dims=0),
                       mi_feats=mi_feats, mi_feats_prime=torch.roll(mi_feats, 1, dims=0),
                       mi_c_local=src['feat_2'], mi_c_global=src['sigmas_2'])
        ret.update(
            rotation=[R3, R2, R1], translation=[t3, t2, t1],
            src_xyz_corres_3=corres3, src_xyz_corres_2=corres2, src_xyz_corres_1=corres1,
            src_dst_weights_3=w3, src_dst_weights_2=w2, src_dst_weights_1=w1,
            src_feats=src, dst_feats=dst,
            src_xyz_2_trans=src_xyz_2t, dst_xyz_2=dst['xyz_2'],
        )
        return ret
