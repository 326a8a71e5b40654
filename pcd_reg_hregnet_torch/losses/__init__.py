"""Registration losses (port of `pcd_reg_hregnet_tpu/losses/`): the
transformation, chamfer, deep-MI and overlap-circle losses; the feats
pretrain's matching losses are queued (ROADMAP queue 1 item 10)."""
from .chamfer import chamfer_distance, chamfer_loss
from .circle import overlap_circle_loss
from .losses import rotation_errors, transformation_loss, translation_errors
from .mi import DeepMILoss, GlobalInfoNet, LocalInfoNet

__all__ = ['transformation_loss', 'rotation_errors', 'translation_errors',
           'chamfer_distance', 'chamfer_loss', 'overlap_circle_loss',
           'DeepMILoss', 'GlobalInfoNet', 'LocalInfoNet']
