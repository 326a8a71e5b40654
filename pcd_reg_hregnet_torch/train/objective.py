"""Training objective: the model and its loss as one module (port of
`pcd_reg_hregnet_tpu/train/objective.py::RegistrationObjective`).

Semantics, as in the JAX package:
  * inputs src = uncalibed_pcd, dst = pcd_left; gt = inverse(igt);
  * the transformation loss of each pyramid layer, weighted by
    `loss.layer_weights` and averaged (sum / sum of weights);
  * the finest layer's errors are the metrics, under the JAX names;
  * `detach_transformation`: the pose loss is reported but not optimised.
The chamfer, MI and overlap-circle losses are not ported yet (ROADMAP queue
1 item 8): the objective refuses them.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.config import Config
from ..geometry import se3
from ..losses import transformation_loss
from ..models.registration import RegistrationModel


class RegistrationObjective(nn.Module):
    """`forward(batch)` -> (total loss, metrics dict, model outputs) for a
    batch of `uncalibed_pcd`, `pcd_left` [B, N, 3] and `igt` [B, 4, 4]
    tensors; train or eval mode follows the module's."""

    def __init__(self, cfg: Config):
        super().__init__()
        for name in ('chamfer', 'mi', 'circle'):
            if getattr(cfg.loss, name):
                raise NotImplementedError(
                    f'the {name} loss is not ported yet (ROADMAP queue 1 item 8); '
                    f'the port trains the transformation loss only')
        self.cfg = cfg
        self.model = RegistrationModel(cfg.model)

    def forward(self, batch: dict):
        lc = self.cfg.loss
        gt_R, gt_t = se3.unpack(se3.inverse(batch['igt']))
        ret = self.model(batch['uncalibed_pcd'], batch['pcd_left'])
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
        metrics['loss'] = total
        return total, metrics, ret
