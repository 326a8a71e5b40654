"""PyTorch/CUDA port of `pcd_reg_hregnet_tpu` for NVIDIA Hopper.

Mirrors the JAX package's layout and names.  Imports `torch` and never
`jax`, nor anything of the JAX package.  Hand-written CUDA kernels live in
`csrc/` and are built at first use by `ops.kernels.build`.
"""
