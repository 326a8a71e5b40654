"""Registration losses (port of `pcd_reg_hregnet_tpu/losses/`): the
transformation, chamfer, deep-MI and overlap-circle losses, and the feats
pretrain's probabilistic chamfer and matching losses."""
from .chamfer import chamfer_distance, chamfer_loss
from .circle import overlap_circle_loss
from .losses import (matching_loss, prob_chamfer_loss, rotation_errors, transformation_loss,
                     translation_errors)
from .mi import DeepMILoss, GlobalInfoNet, LocalInfoNet

__all__ = ['transformation_loss', 'rotation_errors', 'translation_errors',
           'prob_chamfer_loss', 'matching_loss',
           'chamfer_distance', 'chamfer_loss', 'overlap_circle_loss',
           'DeepMILoss', 'GlobalInfoNet', 'LocalInfoNet']
