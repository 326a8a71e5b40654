"""Registration losses (port of `pcd_reg_hregnet_tpu/losses/`): the
transformation loss for now; chamfer, matching, MI and circle losses are
queued (ROADMAP queue 1 items 8 and 10)."""
from .losses import rotation_errors, transformation_loss, translation_errors

__all__ = ['transformation_loss', 'rotation_errors', 'translation_errors']
