"""Core neural building blocks as plain functions on tensors, plus the small
`nn.Module` parameter holders the models are built from.

Port of the subset of `fseend_tpu/ops/nn.py` that LS-EEND and FS-EEND run
(inference, batch, blockwise and per-frame, and training: dropout from a
`torch.Generator`, train-mode BatchNorm, attention dropout, the post-norm
transformer layer with its dropout sites).  Numerics follow the JAX
functions (and through them the torch modules of the reference): layer
norm is written out as mean / biased variance / rsqrt, the l2 norm has no
eps, attention scales by 1/sqrt(head_dim) after the dot product.  Convolutions are written as matmuls over an unfolded window,
so that no float32 convolution goes through cuDNN (whose TF32 default would
round the inputs to 10 mantissa bits on the card).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from fseend_tpu_torch.parallel import collectives as C


# ---------------------------------------------------------------------------
# primitive appliers
# ---------------------------------------------------------------------------


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    """x @ weight.T + bias, weight in torch's (out, in) layout."""
    return F.linear(x, weight, bias)


def full_linear(m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """x through the linear module `m`, its weight and bias gathered whole
    where they are tensor-parallel shards (`collectives.gathered`)."""
    return linear(x, C.gathered(m, "weight"), C.gathered(m, "bias"))


def column_shard(m: nn.Linear) -> C.Shard | None:
    """The shard of a column-parallel module (its outputs split), else None."""
    s = C.shards_of(m).get("weight")
    return s if s is not None and s.dim == 0 else None


def column_linear(m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """x (replicated) -> this rank's columns of the output when `m` is
    column parallel (`collectives.column_linear`: *f* on x), else the whole
    output."""
    if column_shard(m) is None:
        return full_linear(m, x)
    return C.column_linear(x, m.weight, m.bias)


def row_linear(m: nn.Linear, h: torch.Tensor) -> torch.Tensor:
    """h, this rank's slice of the inputs when `m` is row parallel: the
    partial products summed over the model group (*g*), then the bias
    (replicated); else `m` on the whole h.  bf16 partial sums are carried in
    float32 and rounded once, as one product accumulates them."""
    s = C.shards_of(m).get("weight")
    if s is None or s.dim != 1:
        return full_linear(m, h)
    if h.dtype == torch.bfloat16:
        y = C.reduce_from_model(linear(h.float(), m.weight.float()))
        return (y + m.bias.float()).to(h.dtype)
    return C.reduce_from_model(linear(h, m.weight)) + m.bias


def ffn(x: torch.Tensor, linear1: nn.Linear, linear2: nn.Linear, act, rate: float = 0.0,
        generator: torch.Generator | None = None) -> torch.Tensor:
    """linear2(dropout(act(linear1(x)))), then dropout: the feed-forward of
    the transformer layers and the conformer.  Tensor parallel when both
    linears are shards (Megatron's pair: linear1 column parallel, the
    activation and its dropout on this rank's columns, linear2 row
    parallel)."""
    shard = column_shard(linear1)
    if shard is None or C.shards_of(linear2).get("weight") is None:
        h = act(full_linear(linear1, x))
        return dropout(full_linear(linear2, dropout(h, rate, generator)), rate, generator)
    h = dropout(act(column_linear(linear1, x)), rate, generator, shard)
    return dropout(row_linear(linear2, h), rate, generator)


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


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            shard: C.Shard | None = None) -> torch.Tensor:
    """Inverted dropout: x / keep where kept, 0 elsewhere; the identity when
    rate is 0 or there is no generator (eval).  The mask is drawn from
    `generator`, which must live on x's device.  With `shard`, x is this
    rank's slice of the last axis of a tensor-parallel hidden: the mask is
    drawn at full width and sliced, so it is the one-process mask."""
    if rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    shape = x.shape if shard is None else x.shape[:-1] + (x.shape[-1] * shard.n,)
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if shard is not None:
        mask = mask.narrow(-1, shard.index * x.shape[-1], x.shape[-1])
    return torch.where(mask, x / keep, 0.0)


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm1d) -> torch.Tensor:
    """Eval-mode BatchNorm over the last axis of (..., D) from the running
    statistics held in `bn`, returned in x's dtype (bf16 data against the
    float32 statistics of training computes in float32, as JAX promotes)."""
    y = (x - bn.running_mean) * torch.rsqrt(bn.running_var + bn.eps)
    return (y * bn.weight + bn.bias).to(x.dtype)


def batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm1d, momentum: float = 0.1):
    """Train-mode BatchNorm over the last axis of (..., D): normalizes with
    the batch mean and biased variance over every leading position (padding
    included, as the reference does) and returns (y, {"mean", "var"}), the
    running statistics updated with the unbiased variance.  `bn`'s buffers
    are not written.  On bf16 data the statistics are taken in bf16 and the
    running update in the buffers' float32 (the JAX `batch_norm`).  Inside
    `parallel/collectives.py:data_parallel` the statistics are those of the
    global batch, summed over the ranks in two passes."""
    axes = tuple(range(x.ndim - 1))
    active = C.data_group()
    if active is None:
        n = x[..., 0].numel()
        mean = x.mean(dim=axes)
        var = (x - mean).square().mean(dim=axes)
    else:
        mean, var, n = C.batch_moments(x, active[0])
    unbiased = var.detach() * (n / max(n - 1, 1))
    rd = bn.running_mean.dtype
    new = {"mean": (1 - momentum) * bn.running_mean + momentum * mean.detach().to(rd),
           "var": (1 - momentum) * bn.running_var + momentum * unbiased.to(rd)}
    y = (x - mean) * torch.rsqrt(var + bn.eps)
    return y * bn.weight + bn.bias, new


def split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(..., T, D) -> (..., H, T, D // H)."""
    return x.reshape(*x.shape[:-1], n_heads, x.shape[-1] // n_heads).transpose(-3, -2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(..., H, T, hd) -> (..., T, H * hd)."""
    x = x.transpose(-3, -2)
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def mha_project_qkv(p: "MultiheadAttention", query: torch.Tensor, key: torch.Tensor,
                    value: torch.Tensor):
    """The packed in-projection split into per-head q, k, v: (..., H, T, hd)
    each."""
    D = query.shape[-1]
    w, b = C.gathered(p.in_proj, "weight"), C.gathered(p.in_proj, "bias")
    q = linear(query, w[:D], b[:D])
    k = linear(key, w[D:2 * D], b[D:2 * D])
    v = linear(value, w[2 * D:], b[2 * D:])
    return (split_heads(q, p.n_heads), split_heads(k, p.n_heads),
            split_heads(v, p.n_heads))


def mha_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             mask: torch.Tensor | None = None, rate: float = 0.0,
             generator: torch.Generator | None = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd) + mask) v on split heads, the softmax in
    float32; `mask` is additive (-inf where a position may not be read) and
    broadcasts to (..., Tq, Tk).  In training, dropout on the weights (rows
    then no longer sum to 1).  bf16 as the JAX function computes it: the
    logits in float32 (sums of exact bf16 products), the softmax in
    float32, the weights rounded to v's dtype, then w v with float32 sums
    rounded to bf16."""
    if q.dtype == torch.bfloat16:
        logits = q.float() @ k.float().transpose(-1, -2) / math.sqrt(q.shape[-1])
        if mask is not None:
            logits = logits + mask
        w = dropout(torch.softmax(logits, dim=-1).to(v.dtype), rate, generator)
        return (w.float() @ v.float()).to(v.dtype)
    logits = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    if mask is not None:
        logits = logits + mask
    w = dropout(torch.softmax(logits, dim=-1), rate, generator)
    return w @ v


def mha(p: "MultiheadAttention", query: torch.Tensor, key: torch.Tensor,
        value: torch.Tensor, rate: float = 0.0,
        generator: torch.Generator | None = None,
        mask: torch.Tensor | None = None) -> torch.Tensor:
    """torch-compatible multi-head attention, with an optional additive mask
    (broadcast to (..., H, Tq, Tk)); in training, dropout on the
    post-softmax weights.  query/key/value: (..., T, D) -> (..., T, D)."""
    q, k, v = mha_project_qkv(p, query, key, value)
    out = merge_heads(mha_core(q, k, v, mask, rate, generator))
    return full_linear(p.out_proj, out)


def causal_mask(T: int, mask_delay: int = 0, device=None) -> torch.Tensor:
    """(T, T) additive mask: position i may read j <= i + mask_delay (the
    reference's `_generate_square_subsequent_mask`)."""
    i = torch.arange(T, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    zero = torch.zeros((), device=device)
    return torch.where(j <= i + mask_delay, zero, float("-inf"))


def ff_block(x: torch.Tensor, linear1: nn.Linear, linear2: nn.Linear, rate: float = 0.0,
             generator: torch.Generator | None = None) -> torch.Tensor:
    """relu feed-forward of a transformer layer, dropout after the
    activation and after the second linear in training."""
    return ffn(x, linear1, linear2, torch.relu, rate, generator)


def transformer_layer(p: "TransformerLayer", x: torch.Tensor,
                      mask: torch.Tensor | None = None, rate: float = 0.0,
                      generator: torch.Generator | None = None) -> torch.Tensor:
    """Post-norm encoder layer (torch TransformerEncoderLayer,
    norm_first=False): x = LN1(x + attn(x)); x = LN2(x + FF(x)).  In
    training, dropout on the attention weights, on the attention output and
    twice in the FFN, as the JAX `transformer_layer` draws it."""
    a = mha(p.self_attn, x, x, x, rate, generator, mask=mask)
    x = layer_norm(x + dropout(a, rate, generator), p.norm1.weight, p.norm1.bias)
    return layer_norm(x + ff_block(x, p.linear1, p.linear2, rate, generator),
                      p.norm2.weight, p.norm2.bias)


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


class _Bound(nn.Module):
    """`fn(module, ...)` as a module's forward, so that
    `torch.func.functional_call` can run it on other parameters."""

    def __init__(self, module, fn):
        super().__init__()
        self.module, self.fn = module, fn

    def forward(self, *args, **kw):
        return self.fn(self.module, *args, **kw)


def call_with(tensors: dict, module: nn.Module, fn, *args, **kw):
    """fn(module, *args, **kw) with the module's parameters named in
    `tensors` (names as `module.named_parameters()` gives them) replaced by
    those tensors for the call; the other parameters and the buffers are the
    module's own."""
    return torch.func.functional_call(_Bound(module, fn),
                                      {"module." + n: t for n, t in tensors.items()},
                                      args, kw, strict=False)


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


class TransformerLayer(nn.Module):
    """Self-attention + relu FFN + two layer norms (the JAX
    `transformer_layer_init` pytree)."""

    def __init__(self, d_model: int, n_heads: int, dim_ff: int):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, n_heads)
        self.linear1 = nn.Linear(d_model, dim_ff)
        self.linear2 = nn.Linear(dim_ff, d_model)
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)
