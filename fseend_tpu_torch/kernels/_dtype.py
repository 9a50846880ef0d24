"""The element-type rule of the port's kernels.

A kernel takes float32 or bf16 (the JAX package serves in bf16): its data
tensors, weights and states share one dtype, and the 0/1 masks are float32.
A bf16 call is never run in float32: the wrappers raise on a mixed call
instead of casting.  The bf16 form of a kernel is the same CUDA source
built with the define FS_BF16.  Its plain version computes in float32 on
the bf16 values (a product of two bf16 values is exact in float32) and
rounds back to bf16 where the TPU kernel rounds (`rounding`).
"""

from __future__ import annotations

import torch


def check_dtypes(what: str, data: dict, weights: dict, masks: dict) -> None:
    """The data tensors and the weights share one dtype, float32 or bf16;
    the 0/1 masks are float32.  Raises on anything else: a bf16 call never
    runs in float32, and no tensor is cast here."""
    dt = next(iter(data.values())).dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: {next(iter(data))} is {dt}; the kernel takes float32 "
                         f"or bfloat16")
    for name, t in list(data.items()) + list(weights.items()):
        if t.dtype != dt:
            raise ValueError(f"{what}: mixed dtypes: {name} is {t.dtype}, the data "
                             f"{dt}")
    for name, t in masks.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} is {t.dtype}; the 0/1 mask is float32")


def build_defines(dtype, **defines) -> dict:
    """The compile defines of a build for `dtype` (bf16: FS_BF16)."""
    return dict(defines, FS_BF16=1) if dtype == torch.bfloat16 else defines


def rounding(dtype):
    """The rounding point of a bf16 form: a float32 value rounded to bf16 and
    read back (the identity for any other dtype, so the float32 and float64
    arithmetic is unchanged)."""
    if dtype != torch.bfloat16:
        return lambda t: t
    return lambda t: t.to(dtype).float()


def compute(t: torch.Tensor) -> torch.Tensor:
    """`t` in the plain versions' compute dtype: bf16 read to float32,
    anything else as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t
