"""Training (port of `pcd_reg_hregnet_tpu/train/`): the experiment table,
the registration objective, the optimizer and the loop."""
