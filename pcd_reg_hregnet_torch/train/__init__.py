"""Training (port of `pcd_reg_hregnet_tpu/train/`): the experiment table,
the registration objective, the feats pretrain, the optimizer and the loops."""
