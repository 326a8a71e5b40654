"""Training objective: the model and its loss as one module (port of
`pcd_reg_hregnet_tpu/train/objective.py::RegistrationObjective`).

Semantics, as in the JAX package:
  * inputs src = uncalibed_pcd, dst = pcd_left; gt = inverse(igt);
  * the transformation loss of each pyramid layer, weighted by
    `loss.layer_weights` and averaged (sum / sum of weights);
  * the finest layer's errors are the metrics, under the JAX names;
  * chamfer on (src_xyz_2_trans, dst_xyz_2) at `loss.chamfer_scale`;
  * the deep-MI loss on the model's MI outputs, through the `mi_loss`
    discriminators (a submodule, so their parameters join the optimizer);
  * overlap-circle on (coord_dist, feats_dist);
  * `detach_transformation`: the pose loss is reported but not optimised.
The whole forward, losses included, runs without TF32
(`core.device.fp32_numerics`).
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.config import Config
from ..core.device import fp32_numerics
from ..geometry import se3
from ..losses import DeepMILoss, chamfer_loss, overlap_circle_loss, transformation_loss
from ..models.zoo import model_for


class RegistrationObjective(nn.Module):
    """`forward(batch)` -> (total loss, metrics dict, model outputs) for a
    batch of `uncalibed_pcd`, `pcd_left` [B, N, 3] and `igt` [B, 4, 4]
    tensors; train or eval mode follows the module's."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.model = model_for(cfg.model)
        lc = cfg.loss
        if lc.mi:
            lvl = cfg.model.levels[2 if cfg.model.mi_from_coarse else 1]
            self.mi_loss = DeepMILoss(
                global_in_channels=lc.mi_global_channels or lvl.nsample,
                local_in_channels=lc.mi_local_channels or lvl.desc_dim)

    @fp32_numerics()
    def forward(self, batch: dict):
        lc = self.cfg.loss
        src = batch['uncalibed_pcd']
        gt_R, gt_t = se3.unpack(se3.inverse(batch['igt']))
        ret = self.model(src, batch['pcd_left'])
        lw = torch.tensor(lc.layer_weights, dtype=torch.float32)
        tf_losses = []
        for i, (R, t) in enumerate(zip(ret['rotation'], ret['translation'])):
            out = transformation_loss(R, t, gt_R, gt_t, alpha=lc.alpha)
            tf_losses.append(out['loss'] * float(lw[i]))
        metrics = dict(
            rot_err_x=out['rot_err'][0], rot_err_y=out['rot_err'][1],
            rot_err_z=out['rot_err'][2],
            trans_err_x=out['trans_err'][0], trans_err_y=out['trans_err'][1],
            trans_err_z=out['trans_err'][2],
            rre=torch.mean(out['rre']), rte=torch.mean(out['rte']),
            loss_R=out['loss_R'], loss_t=out['loss_t'])
        tf_total = torch.sum(torch.stack(tf_losses)) / float(torch.sum(lw))
        metrics['tf_loss'] = tf_total
        total = torch.zeros((), dtype=torch.float32, device=tf_total.device)
        if lc.transformation and not lc.detach_transformation:
            total = total + tf_total

        if lc.chamfer:
            ch = chamfer_loss(ret['src_xyz_2_trans'], ret['dst_xyz_2'], scale=lc.chamfer_scale)
            metrics['chamfer_loss'] = ch
            total = total + ch

        if lc.mi:
            if self.training and src.shape[0] < 2:
                # the negatives are the batch rolled by one: at B=1 they are
                # the positives and the bound carries no information.  Eval
                # and serving still run it (the pose metrics ignore it).
                raise ValueError('MI loss needs batch_size >= 2: its negatives are a '
                                 'batch permutation, degenerate at B=1')
            mi = self.mi_loss(
                x_global=ret['mi_weights'], x_global_prime=ret['mi_weights_prime'],
                x_local=ret['mi_feats'], x_local_prime=ret['mi_feats_prime'],
                c_local=ret['mi_c_local'], c_global=ret['mi_c_global'])
            metrics['mi_loss'] = mi
            total = total + mi

        if lc.circle:
            circ = overlap_circle_loss(ret['coord_dist'], ret['feats_dist'])
            metrics['circle_loss'] = circ
            total = total + circ

        metrics['loss'] = total
        return total, metrics, ret
