"""Data parallelism on `torch.distributed` (port of `pcd_reg_hregnet_tpu/parallel/`)."""
