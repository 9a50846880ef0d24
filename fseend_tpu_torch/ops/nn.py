"""Core neural building blocks as plain functions on tensors, plus the small
`nn.Module` parameter holders the models are built from.

Port of the subset of `fseend_tpu/ops/nn.py` that LS-EEND inference runs
(batch, blockwise and per-frame).  Numerics follow the JAX functions (and through them the torch modules
of the reference): layer norm is written out as mean / biased variance /
rsqrt, the l2 norm has no eps, attention scales by 1/sqrt(head_dim) after the
dot product.  Convolutions are written as matmuls over an unfolded window,
so that no float32 convolution goes through cuDNN (whose TF32 default would
round the inputs to 10 mantissa bits on the card).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


# ---------------------------------------------------------------------------
# primitive appliers
# ---------------------------------------------------------------------------


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    """x @ weight.T + bias, weight in torch's (out, in) layout."""
    return F.linear(x, weight, bias)


def layer_norm(x: torch.Tensor, weight: torch.Tensor | None = None,
               bias: torch.Tensor | None = None, eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight + bias
    return y


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 0.0) -> torch.Tensor:
    """x / ||x||; no eps by default, like the reference's torch.norm division."""
    return x / torch.sqrt(x.square().sum(dim=dim, keepdim=True) + eps)


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm1d) -> torch.Tensor:
    """Eval-mode BatchNorm over the last axis of (..., D) from the running
    statistics held in `bn`."""
    y = (x - bn.running_mean) * torch.rsqrt(bn.running_var + bn.eps)
    return y * bn.weight + bn.bias


def mha(p: "MultiheadAttention", query: torch.Tensor, key: torch.Tensor,
        value: torch.Tensor) -> torch.Tensor:
    """torch-compatible multi-head attention without mask or dropout.
    query/key/value: (..., T, D) -> (..., T, D)."""
    D = query.shape[-1]
    H = p.n_heads
    w, b = p.in_proj.weight, p.in_proj.bias
    q = linear(query, w[:D], b[:D])
    k = linear(key, w[D:2 * D], b[D:2 * D])
    v = linear(value, w[2 * D:], b[2 * D:])

    def split(t):                                   # (..., T, D) -> (..., H, T, hd)
        return t.reshape(*t.shape[:-1], H, D // H).transpose(-3, -2)

    q, k, v = split(q), split(k), split(v)
    logits = q @ k.transpose(-1, -2) / math.sqrt(D // H)
    out = torch.softmax(logits, dim=-1) @ v          # (..., H, T, hd)
    out = out.transpose(-3, -2).reshape(*query.shape)
    return linear(out, p.out_proj.weight, p.out_proj.bias)


def ff_block(x: torch.Tensor, linear1: nn.Linear, linear2: nn.Linear) -> torch.Tensor:
    """relu feed-forward of a transformer layer (no dropout: serving)."""
    return linear(torch.relu(linear(x, linear1.weight, linear1.bias)),
                  linear2.weight, linear2.bias)


def conv1d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
           padding: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Dense 1-D convolution of (B, T, C_in) -> (B, T', C_out) with a torch
    Conv1d weight (C_out, C_in, k), as one matmul over the unfolded window."""
    k = weight.shape[-1]
    if padding != (0, 0):
        x = F.pad(x, (0, 0, padding[0], padding[1]))
    win = x.unfold(1, k, 1)                          # (B, T', C_in, k)
    y = win.reshape(*win.shape[:2], -1) @ weight.reshape(weight.shape[0], -1).T
    return y if bias is None else y + bias


def lookahead_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   delay: int) -> torch.Tensor:
    """The k=2*delay+1, pad=delay smoothing conv between encoder and decoder."""
    return conv1d(x, weight, bias, padding=(delay, delay))


def causal_depthwise_conv(x: torch.Tensor, weight: torch.Tensor,
                          cache: torch.Tensor | None = None) -> torch.Tensor:
    """Causal depthwise convolution of (B, T, D) -> (B, T, D) with a torch
    depthwise Conv1d weight (D, 1, k), as k shifted multiply-adds.  The k-1
    frames before x are zeros (the batch form), or `cache` (B, k-1, D), the
    history a block-by-block caller carries."""
    k = weight.shape[-1]
    T = x.shape[1]
    if cache is None:
        window = F.pad(x, (0, 0, k - 1, 0))
    else:
        window = torch.cat([cache, x], dim=1)
    taps = weight[:, 0, :]                           # (D, k)
    y = window[:, :T] * taps[:, 0]
    for j in range(1, k):
        y = y + window[:, j:j + T] * taps[:, j]
    return y


def sinusoidal_table(max_len: int, d_model: int, device=None) -> torch.Tensor:
    """(max_len, d_model) sin/cos table (the decoder's speaker-slot queries)."""
    position = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d_model))
    pe = torch.zeros(max_len, d_model, device=device)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div)
    return pe


# ---------------------------------------------------------------------------
# parameter holders
# ---------------------------------------------------------------------------


class MultiheadAttention(nn.Module):
    """Packed q/k/v in-projection + out projection (the layout of the JAX
    `mha_init` pytree and of torch.nn.MultiheadAttention)."""

    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.in_proj = nn.Linear(d_model, 3 * d_model)
        self.out_proj = nn.Linear(d_model, d_model)
