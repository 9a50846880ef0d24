"""PyTorch + CUDA port of `fseend_tpu` for NVIDIA Hopper.

Mirrors the JAX package's module layout (`ops/`, `models/`, `kernels/`,
`serving/`, `utils/`).  Importing the package builds no kernel: the CUDA
sources under `kernels/csrc/` are compiled at their first launch.
"""
