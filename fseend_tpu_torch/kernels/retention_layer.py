"""A whole retention layer with carried chunk state: the CUDA kernel's
wrapper, its plain PyTorch version, and the weight packing.

Replaces `fseend_tpu/kernels/retention_layer_pallas.py:_forward` (public
`fused_retention_layer`): q/k/v/g projections (+bias, k scaled by
dk**-0.5), the chunkwise core of `chunk_retention` per head with per-head
decay, the per-head group norm (non-affine, eps 1e-6), the silu(g) gate and
the out projection (+bias).  One call per layer and block of frames.

On a CUDA tensor the wrapper launches `csrc/retention_layer.cu` (the two
projections and the chunkwise core of this repository behind one call; see
the note there); on a CPU tensor it runs `retention_layer_plain`.  Neither
touches the incoming state.  Float32 only.  When a gradient is wanted the call goes through
`_RetentionLayerFn`, whose backward re-runs `retention_layer_plain` under
autograd (the recompute backward of `retention_layer_pallas.py:261-280`).

Layouts: gammas (H,); x (B, T, D); kv0 (B, H, dk, dv); s0 (B, H, 1, 1);
T % chunk == 0.  Returns (y (B, T, D), kv_f, s_f).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from fseend_tpu_torch.kernels import _build
from fseend_tpu_torch.kernels.chunk_retention import (aligned, chunk_retention_plain,
                                                      recompute_grads)
from fseend_tpu_torch.ops import nn as tnn

# launches of the CUDA kernel since the count was last set to 0
launches = 0


class RetLayerWeights(NamedTuple):
    """One retention layer's weights in the (in, out) layout the kernel's
    products read (the JAX package's `kernel` layout), the four input
    projections stacked."""
    wqkvg: torch.Tensor  # (D, 2D + 2F): q | k | v | g columns, F = D * value_factor
    bqkvg: torch.Tensor  # (2D + 2F,)
    wo: torch.Tensor     # (F, D)
    bo: torch.Tensor     # (D,)


def pack_retention(ret) -> RetLayerWeights:
    """Stack a `Retention` module's projections, transposed to (in, out) (a
    server packs once, under no_grad; in training the packing is part of
    the graph)."""
    projs = (ret.q_proj, ret.k_proj, ret.v_proj, ret.g_proj)
    return RetLayerWeights(torch.cat([p.weight.T for p in projs], dim=1),
                           torch.cat([p.bias for p in projs]),
                           ret.out_proj.weight.T.contiguous(), ret.out_proj.bias)


def retention_layer(gammas: torch.Tensor, x: torch.Tensor, w: RetLayerWeights,
                    kv0: torch.Tensor, s0: torch.Tensor, chunk: int):
    """Launches the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    _check(gammas, x, w, kv0, s0, chunk)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"retention_layer: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, kv0, s0) + tuple(w)):
        return _RetentionLayerFn.apply(gammas, x, *w, kv0, s0, chunk)
    return _forward(gammas, x, w, kv0, s0, chunk)


def _forward(gammas, x, w, kv0, s0, chunk):
    if x.device.type == "cpu":
        return retention_layer_plain(gammas, x, w, kv0, s0, chunk)
    return _launch(gammas, x, w, kv0, s0, chunk)


def _plain_flat(gammas, x, wqkvg, bqkvg, wo, bo, kv0, s0, chunk):
    return retention_layer_plain(gammas, x, RetLayerWeights(wqkvg, bqkvg, wo, bo), kv0, s0,
                                 chunk)


class _RetentionLayerFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gammas, x, wqkvg, bqkvg, wo, bo, kv0, s0, chunk):
        ctx.save_for_backward(gammas, x, wqkvg, bqkvg, wo, bo, kv0, s0)
        ctx.chunk = chunk
        return _forward(gammas, x, RetLayerWeights(wqkvg, bqkvg, wo, bo), kv0, s0, chunk)

    @staticmethod
    def backward(ctx, *grads_out):
        grads = recompute_grads(lambda *a: _plain_flat(*a, ctx.chunk), ctx.saved_tensors,
                                ctx.needs_input_grad[:8], grads_out)
        return (*grads, None)


def _check(gammas, x, w, kv0, s0, chunk):
    B, T, D = x.shape
    H = gammas.shape[0]
    Fv = w.wo.shape[0]
    if D % H or Fv % H:
        raise ValueError(f"retention_layer: {H} heads do not tile D={D}, F={Fv}")
    dk, dv = D // H, Fv // H
    want = {"gammas": (H,), "x": (B, T, D), "wqkvg": (D, 2 * D + 2 * Fv),
            "bqkvg": (2 * D + 2 * Fv,), "wo": (Fv, D), "bo": (D,),
            "kv0": (B, H, dk, dv), "s0": (B, H, 1, 1)}
    got = {"gammas": gammas, "x": x, "kv0": kv0, "s0": s0, **w._asdict()}
    for name, shape in want.items():
        t = got[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"retention_layer: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != torch.float32:
            raise ValueError(f"retention_layer: {name} is {t.dtype}; float32 only")
        if t.device != x.device:
            raise ValueError(f"retention_layer: {name} is on {t.device}, x on {x.device}")
    if chunk <= 0 or T % chunk:
        raise ValueError(f"retention_layer: T={T} is not a multiple of chunk={chunk}")


def _launch(gammas, x, w, kv0, s0, chunk):
    global launches
    B, T, D = x.shape
    H = gammas.shape[0]
    Fv = w.wo.shape[0]
    dk, dv = D // H, Fv // H
    if dk % 16 or dv % 16 or dk > 128 or dv > 128:
        raise ValueError(f"retention_layer: head dims {dk}, {dv} must be multiples of 16, "
                         f"at most 128")
    if B * T > 128 * 65535:
        raise ValueError(f"retention_layer: {B * T} frames exceed one launch's grid")
    lib = _build.load("retention_layer", {"CR_DK": dk, "CR_DV": dv})
    fn = lib.retention_layer_launch
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_float]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    gammas, x, kv0, s0 = (aligned(t.contiguous()) for t in (gammas, x, kv0, s0))
    w = RetLayerWeights(*(aligned(t.contiguous()) for t in w))
    ws = torch.empty((B * T, 2 * D + 2 * Fv), dtype=x.dtype, device=x.device)
    N = T // chunk
    # the chunks' summaries and scales, when there is more than one chunk
    scratch = x.new_empty(B * H * N * (dk * dv + 1)) if N > 1 else None
    y = torch.empty_like(x)
    kv_f, s_f = torch.empty_like(kv0), torch.empty_like(s0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(gammas.data_ptr(), x.data_ptr(), w.wqkvg.data_ptr(), w.bqkvg.data_ptr(),
                 w.wo.data_ptr(), w.bo.data_ptr(), ws.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), y.data_ptr(),
                 kv0.data_ptr(), s0.data_ptr(), kv_f.data_ptr(), s_f.data_ptr(),
                 B, T, chunk, H, dk ** -0.5, stream)
    _build.check(lib, err, "retention_layer")
    launches += 1
    return y, kv_f, s_f


def retention_layer_plain(gammas: torch.Tensor, x: torch.Tensor, w: RetLayerWeights,
                          kv0: torch.Tensor, s0: torch.Tensor, chunk: int):
    """The kernel's arithmetic with tensor ops: one stacked projection, the
    plain chunkwise core over (batch x head) rows, group norm, gate, out
    projection."""
    B, T, D = x.shape
    H = gammas.shape[0]
    Fv = w.wo.shape[0]
    dk, dv = D // H, Fv // H
    q, k, v, g = (x @ w.wqkvg + w.bqkvg).split([D, D, Fv, Fv], dim=-1)

    def rows(t, d):                                   # (B, T, H*d) -> (B*H, T, d)
        return t.reshape(B, T, H, d).transpose(1, 2).reshape(B * H, T, d)

    out, kv_f, s_f = chunk_retention_plain(
        gammas.repeat(B), rows(q, dk), rows(k * dk ** -0.5, dk), rows(v, dv),
        kv0.reshape(B * H, dk, dv), s0.reshape(B * H, 1, 1), chunk)
    out = out.reshape(B, H, T, dv).transpose(1, 2)    # (B, T, H, dv)
    out = tnn.layer_norm(out, eps=1e-6).reshape(B, T, Fv)
    y = (F.silu(g) * out) @ w.wo + w.bo
    return y, kv_f.reshape(B, H, dk, dv), s_f.reshape(B, H, 1, 1)
