"""Hierarchical coarse-to-fine registration network (port of
`pcd_reg_hregnet_tpu/models/registration.py`): conv or PTv3 descriptors,
SVD or regression pose head, MI outputs from the coarse or the second level.

src/dst points [B, N, 3]; the forward returns a dict with `rotation` =
[R3, R2, R1] and `translation` = [t3, t2, t1] (coarse -> fine, composed),
plus the variant-specific loss tensors, like the JAX module.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.config import ModelConfig
from ..core.device import fp32_numerics
from ..geometry import se3
from .layers import (CoarseReg, DescExtractor, FineReg, KeypointDetector,
                     Regression6DHead, RegressionHead, SVDHead, compute_dtype)
from .ptv3 import PointTransformerEncoder

HEADS = {'svd': SVDHead, 'regression': RegressionHead, 'regression6d': Regression6DHead}


class HierFeatureExtraction(nn.Module):
    """3-level keypoint + descriptor pyramid; level-(i+1) WFPS weights are
    the mean-normalised inverse sigmas of level i.  Descriptors come from a
    PTv3 encoder over the keypoints (`backbone='ptv3'`) or, for any other
    backbone, as in the JAX module, from a `DescExtractor` over the
    detector's grouped neighbourhoods.  `cfg.compute_dtype` sets every
    submodule's compute dtype (`layers.compute_dtype`); xyz, sigmas and the
    WFPS weights stay f32.  `cfg.seq_axis` goes to the PTv3 encoders,
    which shard their serialized order under
    `parallel.sequence.sequence_mesh` (eval only).  Raises
    `NotImplementedError` for a compute dtype other than float32 or
    bfloat16."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        dtype = compute_dtype(cfg.compute_dtype)
        self.cfg = cfg
        in_ch = 0
        for i, lvl in enumerate(cfg.levels):
            self.add_module(f'detector_{i + 1}', KeypointDetector(
                in_ch, lvl.nsample, lvl.k, lvl.conv_channels, cfg.use_fps, dtype))
            if cfg.backbone == 'ptv3':
                self.add_module(f'ptv3_{i + 1}', PointTransformerEncoder(
                    lvl.conv_channels[-1], lvl.desc_dim, cfg.ptv3_depths,
                    cfg.ptv3_num_heads, cfg.ptv3_patch_sizes[i],
                    cfg.ptv3_mlp_ratio, cfg.ptv3_grid_size, cfg.ptv3_cpe, dtype,
                    cfg.seq_axis))
            else:
                self.add_module(f'desc_extractor_{i + 1}', DescExtractor(
                    in_ch + 4, lvl.conv_channels[-1], lvl.conv_channels, lvl.desc_dim,
                    dtype))
            in_ch = lvl.conv_channels[-1]

    def forward(self, points: torch.Tensor) -> dict:
        ret = {}
        xyz, feat, weights = points, None, None
        for i in range(len(self.cfg.levels)):
            det = getattr(self, f'detector_{i + 1}')
            xyz, sigmas, att_feat, grouped, att_map = det(xyz, feat, weights)
            if self.cfg.backbone == 'ptv3':
                desc = getattr(self, f'ptv3_{i + 1}')(xyz, att_feat)
            else:
                desc = getattr(self, f'desc_extractor_{i + 1}')(grouped, att_map)
            ret[f'xyz_{i + 1}'] = xyz
            ret[f'sigmas_{i + 1}'] = sigmas
            ret[f'desc_{i + 1}'] = desc
            feat = att_feat
            if self.cfg.use_weights:
                w = 1.0 / (sigmas + 1e-5)
                weights = w / torch.mean(w, dim=1, keepdim=True)
            else:
                weights = None
        return ret


class RegistrationModel(nn.Module):
    """CoarseReg@L3 -> pose -> FineReg@L2 -> pose -> FineReg@L1 -> pose.

    The two feature towers are two calls of the same module, as in the JAX
    package's default (`fuse_towers_*=False`): in training each call takes
    its own BatchNorm statistics and updates the running ones in turn.
    `fuse_towers_train` (in train mode) and `fuse_towers_eval` (in eval mode)
    make them one call on the 2B clouds, split after, as the JAX package
    does: joint BatchNorm statistics in training.
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.feature_extraction = HierFeatureExtraction(cfg)
        dtype = compute_dtype(cfg.compute_dtype)
        c1, c2, c3 = (lvl.desc_dim for lvl in cfg.levels)
        self.coarse_corres = CoarseReg(cfg.coarse_k, c3, cfg.use_sim, cfg.use_neighbor,
                                       cfg.circle_dists, cfg.mi_from_coarse, dtype)
        self.fine_corres_2 = FineReg(cfg.fine_k, c2, cfg.mi_from_fine2, dtype)
        self.fine_corres_1 = FineReg(cfg.fine_k, c1, dtype=dtype)
        self.pose_head = HEADS[cfg.head]()

    @fp32_numerics()
    def forward(self, src_points: torch.Tensor, dst_points: torch.Tensor) -> dict:
        cfg = self.cfg
        if cfg.fuse_towers_train if self.training else cfg.fuse_towers_eval:
            B = src_points.shape[0]
            both = self.feature_extraction(torch.cat([src_points, dst_points], dim=0))
            src = {k: v[:B] for k, v in both.items()}
            dst = {k: v[B:] for k, v in both.items()}
        else:
            src = self.feature_extraction(src_points)
            dst = self.feature_extraction(dst_points)
        head = self.pose_head

        ret = {}
        out3 = self.coarse_corres(src['xyz_3'], src['desc_3'], dst['xyz_3'],
                                  dst['desc_3'], src['sigmas_3'], dst['sigmas_3'])
        if cfg.mi_from_coarse:
            corres3, w3, w3_prime, mi_feats3, mi_feats3_prime = out3
            ret.update(mi_weights=w3, mi_weights_prime=w3_prime,
                       mi_feats=mi_feats3, mi_feats_prime=mi_feats3_prime,
                       mi_c_local=src['desc_3'], mi_c_global=src['sigmas_3'])
        elif cfg.circle_dists:
            corres3, w3, coord_dist, feats_dist = out3
            ret.update(coord_dist=coord_dist, feats_dist=feats_dist)
        else:
            corres3, w3 = out3
        R3, t3 = head(src['xyz_3'], corres3, w3)
        T3 = se3.pack(R3, t3)

        src_xyz_2t = se3.apply(R3, t3, src['xyz_2'])
        out2 = self.fine_corres_2(src_xyz_2t, src['desc_2'], dst['xyz_2'],
                                  dst['desc_2'], src['sigmas_2'], dst['sigmas_2'])
        if cfg.mi_from_fine2:
            corres2, w2, w2_prime, mi_feats2, mi_feats2_prime = out2
            ret.update(mi_weights=w2, mi_weights_prime=w2_prime,
                       mi_feats=mi_feats2, mi_feats_prime=mi_feats2_prime,
                       mi_c_local=src['desc_2'], mi_c_global=src['sigmas_2'])
        else:
            corres2, w2 = out2
        R2_, t2_ = head(src_xyz_2t, corres2, w2)
        R2, t2 = se3.unpack(se3.compose(se3.pack(R2_, t2_), T3))

        src_xyz_1t = se3.apply(R2, t2, src['xyz_1'])
        corres1, w1 = self.fine_corres_1(src_xyz_1t, src['desc_1'], dst['xyz_1'],
                                         dst['desc_1'], src['sigmas_1'],
                                         dst['sigmas_1'])
        R1_, t1_ = head(src_xyz_1t, corres1, w1)
        R1, t1 = se3.unpack(se3.compose(se3.pack(R1_, t1_), se3.pack(R2, t2)))

        ret.update(
            rotation=[R3, R2, R1],
            translation=[t3, t2, t1],
            src_xyz_corres_3=corres3, src_xyz_corres_2=corres2,
            src_xyz_corres_1=corres1,
            src_dst_weights_3=w3, src_dst_weights_2=w2, src_dst_weights_1=w1,
            src_feats=src, dst_feats=dst,
            src_xyz_2_trans=src_xyz_2t, dst_xyz_2=dst['xyz_2'],
        )
        return ret
