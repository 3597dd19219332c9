"""PDM-SSD in PyTorch for NVIDIA Hopper.

The port of `pdm_ssd_tpu` (the JAX reference, which stays as it is). It keeps
the reference's module layout and names, its batch layouts (points
(B, N, C), BEV maps (B, H, W, C)) and its parameter tree, so that weights map
one to one (`utils/weights.from_flax`). Kernels that the reference wrote in
Pallas are hand-written CUDA for sm_90a under `csrc/`; each has a plain
PyTorch version that CPU tensors run. This package never imports JAX.
"""
