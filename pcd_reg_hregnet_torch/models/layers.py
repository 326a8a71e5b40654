"""HRegNet model layers in PyTorch, channels-last (port of
`pcd_reg_hregnet_tpu/models/layers.py`).

Submodules carry the flax auto-names (`Dense_0`, `BatchNorm_0`,
`ConvBNReLU_0`, ...) so `utils.convert.from_flax` maps a flax variable tree
onto `state_dict` keys mechanically.  Tensors are [B, N, C] / [B, M, k, C];
the 1x1 convolutions of the reference are `Dense` on the last axis.

The compute dtype follows the JAX package's policy, module by module: a
`dtype` of None computes in f32 (the model's `compute_dtype='float32'`),
bf16 makes every `Dense` compute in bf16 as flax's `nn.Dense(dtype=)`
does, while parameters and BatchNorm statistics stay f32.  BatchNorm runs
in f32 in train mode and in the compute dtype in eval mode; the final
Dense of `MLPHead` promotes (f32 parameters), so sigmas and correspondence
weights stay f32; kNN in xyz and everything geometric stays f32.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..geometry import so3
from ..ops.neighbors import knn, knn_gather, knn_group
from ..ops.procrustes import weighted_kabsch
from ..ops.sampling import fps, gather_points, weighted_fps
from ..parallel import distributed


def low_precision(dtype: torch.dtype) -> bool:
    """bf16 (or f16): the dtypes whose rounding the bf16 path reproduces op
    by op; f32 and f64 compute as they are."""
    return dtype.itemsize < 4


def softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """`jax.nn.softmax` with its rounding in bf16 (XLA's, op by op): the
    shifted scores rounded, their exponentials summed in f32 and the sum
    rounded, each exponential rounded and divided by it.  `torch.softmax`
    in f32, where the two agree to f32 round-off."""
    if not low_precision(x.dtype):
        return torch.softmax(x, dim=dim)
    e = torch.exp((x - torch.amax(x, dim=dim, keepdim=True)).float())
    s = torch.sum(e, dim=dim, keepdim=True).to(x.dtype)
    return e.to(x.dtype) / s


def mul_sum(a: torch.Tensor, b: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
    """sum(a * b) over `dim` in the promoted dtype.  In bf16 as XLA fuses
    `jnp.sum` of a product: the products in f32 (exact for bf16 values),
    summed in f32 and rounded once."""
    dt = torch.promote_types(a.dtype, b.dtype)
    if not low_precision(dt):
        return torch.sum(a * b, dim=dim, keepdim=keepdim)
    return torch.sum(a.float() * b.float(), dim=dim, keepdim=keepdim).to(dt)


def _safe_dist(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, finite gradient at 0."""
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-12)


def _cosine_similarity_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cosine-similarity map [B, Na, Nb] from [B, Na, C], [B, Nb, C]."""
    inner = torch.bmm(a, b.transpose(1, 2))
    na = torch.sqrt(mul_sum(a, a, -1) + 1e-12)
    nb = torch.sqrt(mul_sum(b, b, -1) + 1e-12)
    return inner / (na[:, :, None] * nb[:, None, :] + 1e-6)


COMPUTE_DTYPES = {'float32': None, 'bfloat16': torch.bfloat16}


def compute_dtype(name: str) -> Optional[torch.dtype]:
    """The modules' `dtype` for a `ModelConfig.compute_dtype`: None for
    float32 (f32 throughout), bf16 for bfloat16, as the JAX models pass
    flax's `dtype`.  Raises `NotImplementedError` for any other (float16
    is not ported)."""
    if name not in COMPUTE_DTYPES:
        raise NotImplementedError(f'compute_dtype {name!r} is not ported '
                                  f'(one of {sorted(COMPUTE_DTYPES)})')
    return COMPUTE_DTYPES[name]


def result_dtype(dtype: Optional[torch.dtype], *tensors) -> torch.dtype:
    """flax's dtype rule: `dtype` when set, else the promotion of the
    tensors' dtypes (a bf16 input with f32 parameters computes in f32)."""
    if dtype is not None:
        return dtype
    out = tensors[0].dtype
    for t in tensors[1:]:
        out = torch.promote_types(out, t.dtype)
    return out


class Dense(nn.Linear):
    """`nn.Linear` with flax `nn.Dense`'s dtype rule: with `dtype` set, the
    input, weight and bias are cast to it (the product accumulates in f32
    and returns `dtype`); with None, they are promoted together.  The
    parameters stay f32, so the `state_dict` is `nn.Linear`'s."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor, upcast: bool = False) -> torch.Tensor:
        """`upcast`: the caller takes the result in f32 (a BatchNorm, or
        `.astype(f32)`), where XLA adds the bias in f32 to the product
        rounded to `dtype`; else the sum is rounded again, as flax's add in
        `dtype` is."""
        if self.compute_dtype is None and x.dtype == self.weight.dtype:
            return F.linear(x, self.weight, self.bias)   # f32 (or f64) as it is
        dt = result_dtype(self.compute_dtype, x, self.weight)
        if not low_precision(dt) or self.bias is None:
            b = None if self.bias is None else self.bias.to(dt)
            return F.linear(x.to(dt), self.weight.to(dt), b)
        y = F.linear(x.to(dt), self.weight.to(dt))
        if upcast:
            return y.float() + self.bias.to(dt).float()
        return y + self.bias.to(dt)


def _global_moments(flat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean and fast biased variance of `flat` [n, C] over the rows of every
    rank of the default group."""
    from torch.distributed.nn.functional import all_reduce
    C = flat.shape[-1]
    sums = all_reduce(torch.cat([flat.sum(0), (flat * flat).sum(0),
                                 flat.new_full((1,), flat.shape[0])]))
    mean = sums[:C] / sums[-1]
    return mean, torch.clamp(sums[C:2 * C] / sums[-1] - mean * mean, min=0.0)


class BatchNorm(nn.Module):
    """Channels-last BatchNorm over every axis but the last, flax's in both
    modes.

    `momentum` is torch's (flax momentum 0.9 is torch 0.1, 0.99 is 0.01).
    Parameters map from flax as scale -> weight, bias -> bias, mean ->
    running_mean, var -> running_var.  Eval mode normalises with the running
    statistics.  Train mode follows `flax.linen.BatchNorm`: the batch mean
    and the *biased* batch variance, max(0, E[x^2] - E[x]^2) (flax's fast
    variance), normalise, and the running statistics move towards those same
    two values (torch's `F.batch_norm` would store the unbiased variance).

    Data parallel (a process group of more than one rank): train mode takes
    the statistics over the global batch, as flax's BatchNorm does under a
    sharded jit: one all-reduce of the f32 sums of x and x^2 and the row
    count (differentiable: its backward sums the ranks' gradients), then the
    same fast variance.  Alone, or at world size 1, nothing changes.

    dtype, as the JAX layers set flax's: train mode computes in f32 from an
    input of any dtype and returns f32; eval mode computes in f32 and
    returns `dtype` (None: the promotion of the input and f32), as flax's
    `_normalize` casts its f32 result once at the end.
    """

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer('running_mean', torch.zeros(channels))
        self.register_buffer('running_var', torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        wide = torch.promote_types(x.dtype, self.weight.dtype)   # at least f32
        if not self.training:
            out = result_dtype(self.compute_dtype, x, self.weight)
            y = F.batch_norm(x.reshape(-1, x.shape[-1]).to(wide), self.running_mean,
                             self.running_var, self.weight, self.bias,
                             False, self.momentum, self.eps)
            return y.reshape(x.shape).to(out)
        x = x.to(wide)
        flat = x.reshape(-1, x.shape[-1])
        if distributed.world_size() > 1:
            mean, var = _global_moments(flat)
        else:
            mean = flat.mean(0)
            var = torch.clamp((flat * flat).mean(0) - mean * mean, min=0.0)
        with torch.no_grad():
            decay = 1.0 - self.momentum
            self.running_mean.copy_(decay * self.running_mean + self.momentum * mean)
            self.running_var.copy_(decay * self.running_var + self.momentum * var)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class ConvBNReLU(nn.Module):
    """Stack of (pointwise Dense -> BatchNorm -> ReLU); `dtype` is the
    compute dtype of the Dense layers and of eval-mode BatchNorm."""

    def __init__(self, in_features: int, features: Sequence[int],
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.depth = len(features)
        for j, f in enumerate(features):
            self.add_module(f'Dense_{j}', Dense(in_features, f, bias=False, dtype=dtype))
            self.add_module(f'BatchNorm_{j}', BatchNorm(f, dtype=dtype))
            in_features = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for j in range(self.depth):
            x = getattr(self, f'Dense_{j}')(x)
            x = F.relu(getattr(self, f'BatchNorm_{j}')(x))
        return x


class MLPHead(nn.Module):
    """(Dense+BN+ReLU) per hidden width, then a final biased Dense, which
    promotes (flax `dtype=None`): its output is f32 in every compute dtype."""

    def __init__(self, in_features: int, hidden: Sequence[int], out: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.depth = len(hidden)
        for j, f in enumerate(hidden):
            self.add_module(f'Dense_{j}', Dense(in_features, f, dtype=dtype))
            self.add_module(f'BatchNorm_{j}', BatchNorm(f, dtype=dtype))
            in_features = f
        self.add_module(f'Dense_{self.depth}', Dense(in_features, out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for j in range(self.depth):
            x = getattr(self, f'Dense_{j}')(x, upcast=True)
            x = F.relu(getattr(self, f'BatchNorm_{j}')(x))
        return getattr(self, f'Dense_{self.depth}')(x)


class KeypointDetector(nn.Module):
    """Attentive keypoint detection on (W)FPS-sampled neighbourhoods.

    `in_channels` is the width of the input features (0 at the first level).
    Returns (keypoints [B, M, 3], sigmas [B, M], attentive_feature
    [B, M, C_o], grouped_features [B, M, k, C+4], attentive_map
    [B, M, k, C_o]).  With a bf16 `dtype`, the attention weights are bf16
    and the keypoints (their sum with the f32 neighbours) and sigmas f32.
    """

    def __init__(self, in_channels: int, nsample: int, k: int,
                 out_channels: Sequence[int], use_fps: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.nsample, self.k, self.use_fps = nsample, k, use_fps
        c_o = out_channels[-1]
        self.ConvBNReLU_0 = ConvBNReLU(in_channels + 4, out_channels, dtype)
        self.MLPHead_0 = MLPHead(c_o, (c_o, c_o), 1, dtype)

    def forward(self, xyz, features=None, weights=None):
        if xyz.shape[1] < self.nsample:
            raise ValueError(
                f'KeypointDetector(nsample={self.nsample}) needs at least '
                f'{self.nsample} input points, got {xyz.shape[1]}')
        if self.use_fps:
            if weights is None:
                idx = fps(xyz, self.nsample)
            else:
                idx = weighted_fps(xyz, weights, self.nsample)
            sampled_xyz = gather_points(xyz, idx)
        else:
            stride = xyz.shape[1] // self.nsample
            sampled_xyz = xyz[:, ::stride][:, :self.nsample]

        grouped, knn_xyz = knn_group(sampled_xyz, xyz, features, self.k)
        embedding = self.ConvBNReLU_0(grouped)
        attn = softmax(torch.amax(embedding, dim=-1), dim=-1)          # [B,M,k]
        keypoints = torch.sum(attn[..., None] * knn_xyz, dim=2)
        attentive_map = embedding * attn[..., None]
        attentive_feature = mul_sum(embedding, attn[..., None], 2)
        sigmas = F.softplus(self.MLPHead_0(attentive_feature))[..., 0] + 0.001
        return keypoints, sigmas, attentive_feature, grouped, attentive_map


class DescExtractor(nn.Module):
    """Descriptors from the detector's grouped neighbourhoods: a conv stack,
    the concat [k-max tiled over k, per-neighbour, detector attention map],
    two (Dense, BN, ReLU) and a k-max.

    `in_channels` is the width of the grouped features (C + 4) and
    `map_channels` that of the detector's attention map.  Takes grouped
    [B, M, k, C + 4] and attentive_map [B, M, k, C_o]; returns [B, M,
    desc_dim].
    """

    def __init__(self, in_channels: int, map_channels: int,
                 out_channels: Sequence[int], desc_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        c = out_channels[-1]
        self.ConvBNReLU_0 = ConvBNReLU(in_channels, out_channels, dtype)
        self.ConvBNReLU_1 = ConvBNReLU(2 * c + map_channels, (out_channels[-2],), dtype)
        self.ConvBNReLU_2 = ConvBNReLU(out_channels[-2], (desc_dim,), dtype)

    def forward(self, grouped, attentive_map):
        x1 = self.ConvBNReLU_0(grouped)
        x2 = torch.amax(x1, dim=2, keepdim=True).expand(x1.shape)
        x = torch.cat([x2, x1, attentive_map], dim=-1)
        return torch.amax(self.ConvBNReLU_2(self.ConvBNReLU_1(x)), dim=2)


class CoarseReg(nn.Module):
    """Coarse correspondence via descriptor-space kNN + similarity features.

    `return_dists` adds the overlap-circle outputs (coord_dist, feats_dist);
    `mi_outputs` (model_v1) adds the MI projection and batch-rolled
    negatives, as FineReg's and in its place.  The descriptor-space kNN and
    cosine maps run in the descriptors' dtype (bf16 in a bf16 eval), as in
    the JAX module.
    """

    def __init__(self, k: int, in_channels: int, use_sim: bool = True,
                 use_neighbor: bool = True, return_dists: bool = False,
                 mi_outputs: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.k, self.use_sim, self.use_neighbor = k, use_sim, use_neighbor
        self.return_dists, self.mi_outputs = return_dists, mi_outputs
        C = in_channels
        n = 0
        if use_neighbor:
            self.ConvBNReLU_0 = ConvBNReLU(C + 4, (C,) * 3, dtype)
            n = 1
        feat_in = 10 + 2 * C + 2 + 2 * use_sim + 2 * use_neighbor
        self.add_module(f'ConvBNReLU_{n}', ConvBNReLU(feat_in, (2 * C,) * 3, dtype))
        self._feat_convs = f'ConvBNReLU_{n}'
        self.MLPHead_0 = MLPHead(2 * C, (2 * C,) * 2, 1, dtype)
        if mi_outputs:
            self.add_module(f'ConvBNReLU_{n + 1}', ConvBNReLU(2 * C, (C,), dtype))
            self._mi_convs = f'ConvBNReLU_{n + 1}'

    def _nbr_desc(self, xyz, desc):
        _, nbr_idx = knn(xyz, xyz, self.k)
        ng = knn_gather(torch.cat([xyz, desc], -1), nbr_idx)
        nbr_xyz, nbr_feats = ng[..., :3], ng[..., 3:]
        rela = nbr_xyz - xyz[:, :, None, :]
        x = torch.cat([nbr_feats, rela, _safe_dist(rela)], dim=-1)
        w = softmax(torch.amax(self.ConvBNReLU_0(x), dim=-1), dim=-1)
        return torch.sum(nbr_feats * w[..., None], dim=2)

    def forward(self, src_xyz, src_desc, dst_xyz, dst_desc,
                src_weights, dst_weights):
        B, N, C = src_desc.shape
        k = self.k
        _, knn_idx = knn(src_desc, dst_desc, k)
        g = knn_gather(torch.cat([dst_xyz, dst_desc, dst_weights[..., None]], -1),
                       knn_idx)
        src_knn_xyz, src_knn_desc, src_knn_w = g[..., :3], g[..., 3:3 + C], g[..., 3 + C:]

        src_xyz_expand = src_xyz[:, :, None, :].expand(B, N, k, 3)
        src_desc_expand = src_desc[:, :, None, :].expand(B, N, k, C)
        src_rela_xyz = src_knn_xyz - src_xyz_expand
        src_rela_dist = _safe_dist(src_rela_xyz)
        src_w_expand = src_weights[:, :, None, None].expand(B, N, k, 1)

        sim_parts = []
        feats_dist = None
        if self.use_sim:
            cos = _cosine_similarity_matrix(src_desc, dst_desc)
            src_dst_norm = cos / (torch.amax(cos, dim=2, keepdim=True) + 1e-6)
            dst_src_norm = cos / (torch.amax(cos, dim=1, keepdim=True) + 1e-6)
            src_dst_cos = torch.gather(src_dst_norm, 2, knn_idx)
            dst_src_cos = torch.gather(dst_src_norm, 2, knn_idx)
            sim_parts += [src_dst_cos[..., None], dst_src_cos[..., None]]
            feats_dist = 1.0 - dst_src_cos

        if self.use_neighbor:
            src_nbr = self._nbr_desc(src_xyz, src_desc)
            dst_nbr = self._nbr_desc(dst_xyz, dst_desc)
            ncos = _cosine_similarity_matrix(src_nbr, dst_nbr)
            src_dst_nnorm = ncos / (torch.amax(ncos, dim=2, keepdim=True) + 1e-6)
            dst_src_nnorm = ncos / (torch.amax(ncos, dim=1, keepdim=True) + 1e-6)
            sim_parts += [torch.gather(src_dst_nnorm, 2, knn_idx)[..., None],
                          torch.gather(dst_src_nnorm, 2, knn_idx)[..., None]]

        geom = [src_rela_xyz, src_rela_dist, src_xyz_expand, src_knn_xyz]
        desc = [src_desc_expand, src_knn_desc, src_w_expand, src_knn_w]
        feats = torch.cat(geom + desc + sim_parts, dim=-1)

        feats = getattr(self, self._feat_convs)(feats)
        attn = softmax(torch.amax(feats, dim=-1), dim=-1)
        corres_xyz = torch.sum(attn[..., None] * src_knn_xyz, dim=2)
        attentive_feats = mul_sum(attn[..., None], feats, 2)
        weights = torch.sigmoid(self.MLPHead_0(attentive_feats)[..., 0])

        if self.mi_outputs:
            mi_feats = getattr(self, self._mi_convs)(attentive_feats)
            return (corres_xyz, weights, torch.roll(weights, 1, dims=0),
                    mi_feats, torch.roll(mi_feats, 1, dims=0))
        if self.return_dists:
            return corres_xyz, weights, src_rela_dist[..., 0], feats_dist
        return corres_xyz, weights


class FineReg(nn.Module):
    """Fine correspondence via xyz-space kNN; `mi_outputs` adds the MI
    projection and batch-rolled negatives (FineReg2)."""

    def __init__(self, k: int, in_channels: int, mi_outputs: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.k, self.mi_outputs = k, mi_outputs
        C = in_channels
        self.ConvBNReLU_0 = ConvBNReLU(2 * C + 12, (2 * C,) * 3, dtype)
        self.MLPHead_0 = MLPHead(2 * C, (2 * C,) * 2, 1, dtype)
        if mi_outputs:
            self.ConvBNReLU_1 = ConvBNReLU(2 * C, (C,), dtype)

    def forward(self, src_xyz, src_feat, dst_xyz, dst_feat,
                src_weights, dst_weights):
        B, N, C = src_feat.shape
        k = self.k
        _, knn_idx = knn(src_xyz, dst_xyz, k)
        g = knn_gather(torch.cat([dst_xyz, dst_feat, dst_weights[..., None]], -1),
                       knn_idx)
        src_knn_xyz, src_knn_feat, src_knn_w = g[..., :3], g[..., 3:3 + C], g[..., 3 + C:]
        src_xyz_expand = src_xyz[:, :, None, :].expand(B, N, k, 3)
        src_feat_expand = src_feat[:, :, None, :].expand(B, N, k, C)
        rela = src_knn_xyz - src_xyz_expand
        src_w_expand = src_weights[:, :, None, None].expand(B, N, k, 1)

        feats = torch.cat([rela, _safe_dist(rela), src_xyz_expand, src_knn_xyz,
                           src_feat_expand, src_knn_feat,
                           src_w_expand, src_knn_w], dim=-1)
        feats = self.ConvBNReLU_0(feats)
        attn = softmax(torch.amax(feats, dim=-1), dim=-1)
        corres_xyz = torch.sum(attn[..., None] * src_knn_xyz, dim=2)
        attentive_feats = mul_sum(attn[..., None], feats, 2)
        weights = torch.sigmoid(self.MLPHead_0(attentive_feats)[..., 0])

        if not self.mi_outputs:
            return corres_xyz, weights
        mi_feats = self.ConvBNReLU_1(attentive_feats)
        return (corres_xyz, weights, torch.roll(weights, 1, dims=0),
                mi_feats, torch.roll(mi_feats, 1, dims=0))


class SVDHead(nn.Module):
    """Parameter-free weighted-Kabsch pose head."""

    def forward(self, src, src_corres, weights):
        return weighted_kabsch(src, src_corres, weights)


def _weighted_centroids(src, src_corres, weights):
    """[B, 6]: the weight-normalised centroids of src and its correspondences."""
    w = weights / (torch.sum(weights, dim=1, keepdim=True) + 1e-4)
    return torch.cat([torch.einsum('bn,bnc->bc', w, src),
                      torch.einsum('bn,bnc->bc', w, src_corres)], dim=-1)


class RegressionHead(nn.Module):
    """MLP pose head (model_v3): the weighted centroids [B, 6] through two
    MLPs to an axis-angle rotation (as a matrix by `so3.exp`) and a
    translation."""

    def __init__(self):
        super().__init__()
        for j, (i, o) in enumerate(((6, 128), (128, 64), (64, 3)) * 2):
            self.add_module(f'Dense_{j}', Dense(i, o))

    def forward(self, src, src_corres, weights):
        x = _weighted_centroids(src, src_corres, weights)
        xr = F.relu(self.Dense_1(F.relu(self.Dense_0(x))))
        xt = F.relu(self.Dense_4(F.relu(self.Dense_3(x))))
        return so3.exp(self.Dense_2(xr)), self.Dense_5(xt)


class Regression6DHead(nn.Module):
    """6D-rotation pose head (model_v3's alternative): a Gram-Schmidt frame
    from two regressed columns, and a translation.  Its flax auto-names
    follow construction order, and `Dense(3)(relu(Dense(64)(relu(Dense(128)
    (x)))))` constructs the outer Dense first: the translation MLP is
    Dense_5 (6 -> 128), Dense_4 (128 -> 64), Dense_3 (64 -> 3)."""

    def __init__(self):
        super().__init__()
        for j, (i, o) in enumerate(((6, 128), (128, 64), (64, 6),
                                    (64, 3), (128, 64), (6, 128))):
            self.add_module(f'Dense_{j}', Dense(i, o))

    def forward(self, src, src_corres, weights):
        x = _weighted_centroids(src, src_corres, weights)
        rot6d = self.Dense_2(F.relu(self.Dense_1(F.relu(self.Dense_0(x)))))
        trans = self.Dense_3(F.relu(self.Dense_4(F.relu(self.Dense_5(x)))))
        m = rot6d.reshape(-1, 3, 2)
        b1 = m[:, :, 0] / (torch.linalg.norm(m[:, :, 0], dim=-1, keepdim=True) + 1e-6)
        b2 = m[:, :, 1] - torch.sum(b1 * m[:, :, 1], dim=-1, keepdim=True) * b1
        b2 = b2 / (torch.linalg.norm(b2, dim=-1, keepdim=True) + 1e-6)
        return torch.stack([b1, b2, torch.cross(b1, b2, dim=-1)], dim=-1), trans
