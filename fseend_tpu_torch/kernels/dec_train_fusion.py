"""One decoder fusion layer in training semantics, forward and backward: the
CUDA kernels' wrappers, their plain PyTorch versions, the dropout hash and
the `torch.autograd.Function` the model calls.

Replaces `fseend_tpu/kernels/dec_train_fusion_pallas.py`: `_fwd_call` (the
forward with per-chunk retention state checkpoints) and `_bwd_call` (the
hand-written backward, a reverse sweep over the chunks).  On the slot-major
grid x (B, C, T, D), T a multiple of the internal chunk L, from a zero
retention state (kv 0, scale 1), per chunk:
  1. gamma = 1 chunkwise retention per (b, c, head): q | k | v | g projection
     (k scaled by dk**-0.5), `q k^T * tril / sqrt(i+1)` renormalized by
     `max(sum |q k|, 1)`, the cross read of the incoming `kv / s` scaled by
     `sqrt(L) / sqrt(i+1)`, both mixed by `max(sum, s)`, group norm (eps
     1e-6), the state update `kv += k^T v / sqrt(L)`, `s = max(max col-sum
     |kv|, 1)`;
  2. silu(g) gate, out projection, dropout, residual, LayerNorm;
  3. attention across the C slots of each frame, dropout on the softmax
     weights, out projection, dropout, residual, LayerNorm;
  4. relu FFN D -> F -> D, dropout on the hidden and on the output,
     residual, LayerNorm.
The renormalizers are constants of the backward, as the JAX package's
stop-gradients make them.

Dropout is `hash_keep`, the JAX kernel's counter hash (`_hash_keep`), bit
for bit: the element index is the linear index inside the chunk-local shape
of the site ((C, L, D), (C, L, F) for the FFN hidden, (C, L, C) for the
attention weights of head h, site 1 + 16 h), keyed by (seed, b, n, site).
So the masks depend on L, and the port's masks equal the JAX kernel's.

On CUDA tensors the wrappers launch `csrc/dec_train_fusion_fwd.cu` and
`csrc/dec_train_fusion_bwd.cu` (each a sequence of this repository's
kernels behind one call; design notes there; both run the one forward
sequence of `csrc/dec_train_fusion_seq.cuh`, the backward as its recompute,
with every product on the tensor cores, float32-exact, and the backward's
gradients come out the same to the bit from run to run); on CPU tensors
they run `fusion_layer_fwd_plain` / `fusion_layer_bwd_plain`.  The products
read the weights transposed to (in, out): `_FusedFusionLayerFn` makes the
transposes once per forward and keeps them for its backward.

Float32 or bf16: x, dy, y, dx and the weights share one dtype; the state
checkpoints kvs and ss are float32 in either.  The bf16 forms (the same
sources built with FS_BF16) compute as `dec_train_fusion_pallas.py` does on
bf16 data ("one-pass bf16 semantics"): each product of two bf16 operands
is one bf16 tensor-core pass with float32 accumulation, the cross read of
the carried state has float32 operands, and the values are rounded to bf16
where the Pallas source rounds them (q | k | v, the normalized scores, the
gated value, the LayerNorms' outputs before a product, the attention
weights (their dropout multiplier 1 / (1 - rate) itself rounded to bf16),
each product of the slot attention, the FFN hidden; in the backward the
stashed g, group-norm output and LayerNorm xhats, every gradient before a
product, and dx).  The 14 weight gradients sum in float32 and come back
rounded to the weights' dtype, as the JAX VJP returns them.  The plain
versions follow the same rounding points on bf16 inputs.

Weights (`FusionWeights`) are in torch's (out, in) layout: wqkvg (4D, D) the
q | k | v | g rows, wro (D, D), wmi (3D, D) the slot attention's packed
in-projection, wmo (D, D), wf1 (F, D), wf2 (D, F), biases beside them, lns
and lnb (3, D) the scales and biases of norm11, norm21, norm22.  The state
checkpoints are the JAX layout: kvs (B, N, H, C, dk, dv) and ss (B, N, H,
C, 1, 1), the state each chunk reads.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from fseend_tpu_torch.kernels import _build
from fseend_tpu_torch.kernels._dtype import build_defines, compute, rounding
from fseend_tpu_torch.parallel.collectives import gathered

# launches of the CUDA forward / backward since the counts were last set to
# 0: their float32 forms, their bf16 forms
fwd_launches = 0
bwd_launches = 0
fwd_launches_bf16 = 0
bwd_launches_bf16 = 0

# dropout sites, in the JAX kernel's numbering
SITE_RET, SITE_ATTNW, SITE_MHA, SITE_FFH, SITE_FFO = range(5)
_M32 = 0xFFFFFFFF


class FusionWeights(NamedTuple):
    wqkvg: torch.Tensor
    bqkvg: torch.Tensor
    wro: torch.Tensor
    bro: torch.Tensor
    wmi: torch.Tensor
    bmi: torch.Tensor
    wmo: torch.Tensor
    bmo: torch.Tensor
    wf1: torch.Tensor
    bf1: torch.Tensor
    wf2: torch.Tensor
    bf2: torch.Tensor
    lns: torch.Tensor
    lnb: torch.Tensor


def pack_fusion(layer) -> FusionWeights:
    """A `FusionLayer` module's weights as one tuple; the packing is part
    of the autograd graph, so gradients reach the module's parameters.
    Tensor-parallel shards are gathered whole (`collectives.gathered`, its
    backward this rank's slice): the kernels take whole matrices."""
    tr, at = layer.time_ret, layer.spk_attn
    projs = (tr.q_proj, tr.k_proj, tr.v_proj, tr.g_proj)
    norms = (layer.norm11, layer.norm21, layer.norm22)
    w = gathered
    return FusionWeights(
        torch.cat([w(p, "weight") for p in projs]), torch.cat([w(p, "bias") for p in projs]),
        w(tr.out_proj, "weight"), tr.out_proj.bias, w(at.in_proj, "weight"),
        w(at.in_proj, "bias"), w(at.out_proj, "weight"), at.out_proj.bias,
        w(layer.linear1, "weight"), w(layer.linear1, "bias"), w(layer.linear2, "weight"),
        layer.linear2.bias,
        torch.stack([m.weight for m in norms]), torch.stack([m.bias for m in norms]))


# ---------------------------------------------------------------------------
# dropout: the JAX kernel's counter hash
# ---------------------------------------------------------------------------


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for int64 a in [0, 2**32) and a constant c, in
    16-bit halves so that no product leaves int64."""
    return ((a & 0xFFFF) * c + (((a >> 16) * (c & 0xFFFF)) << 16)) & _M32


def keep_threshold(rate: float) -> int:
    """An element is kept iff its hash is >= this."""
    return min(int(rate * 2.0 ** 32), 2 ** 32 - 1)


def hash_keep(seed: int, b, n: int, site: int, shape: tuple, rate: float,
              device=None) -> torch.Tensor:
    """The dropout multiplier of `dec_train_fusion_pallas.py:_hash_keep`:
    1 / (1 - rate) (float32) where kept, 0 elsewhere, over the chunk-local
    `shape` of `site` in chunk n of batch row b.  `b` may be a 1-D tensor of
    batch rows; the result then has a leading axis for it."""
    bt = torch.as_tensor(b, dtype=torch.int64, device=device)
    base = (((int(seed) & _M32) * 0x9E3779B9 & _M32)
            ^ ((int(n) & _M32) * 0xC2B2AE35 & _M32)
            ^ ((site * 0x27D4EB2F) & _M32))
    base = _mul32(bt & _M32, 0x85EBCA6B) ^ base
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device).reshape(shape)
    h = idx ^ base.reshape(base.shape + (1,) * len(shape))
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    mult = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)
    return (h >= keep_threshold(rate)).to(torch.float32) * mult.to(h.device)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _consts(L: int, device):
    i = torch.arange(L, dtype=torch.float32, device=device)
    sc = torch.sqrt(i + 1.0)[:, None]                             # (L, 1) sqrt(i+1)
    mask = torch.where(i[None, :] <= i[:, None], 1.0, 0.0) / sc   # (L, L)
    return mask, sc[-1:] / sc, 1.0 / math.sqrt(L)                 # mask, inner decay, wlast


def _heads(t: torch.Tensor, H: int) -> torch.Tensor:
    """(B, C, L, H*d) -> (B, H, C, L, d)."""
    B, C, L, HD = t.shape
    return t.reshape(B, C, L, H, HD // H).permute(0, 3, 1, 2, 4)


def _merge(t: torch.Tensor) -> torch.Tensor:
    """(B, H, C, L, d) -> (B, C, L, H*d)."""
    B, H, C, L, d = t.shape
    return t.permute(0, 2, 3, 1, 4).reshape(B, C, L, H * d)


def _ln_fwd(x, scale, bias):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    rs = torch.rsqrt(var + 1e-5)
    xh = (x - mu) * rs
    return xh * scale + bias, xh, rs


def _chunk_masks(seed, n, B, C, L, D, F, H, rate, device, rnd):
    """Dropout multipliers of chunk n for every batch row, or None at rate 0.
    The attention weights' mask is in the data dtype (`rnd`), the others
    float32, as the JAX kernel builds them."""
    if rate <= 0.0:
        return None
    b = torch.arange(B, device=device)
    return {"m0": hash_keep(seed, b, n, SITE_RET, (C, L, D), rate, device),
            "m1": rnd(torch.stack([hash_keep(seed, b, n, SITE_ATTNW + 16 * h, (C, L, C), rate,
                                             device) for h in range(H)], dim=1)),
            "m2": hash_keep(seed, b, n, SITE_MHA, (C, L, D), rate, device),
            "m3": hash_keep(seed, b, n, SITE_FFH, (C, L, F), rate, device),
            "m4": hash_keep(seed, b, n, SITE_FFO, (C, L, D), rate, device)}


def _kscale(dk: int, dtype) -> float:
    """dk**-0.5 in the data dtype, as the JAX kernel scales the rounded k."""
    return float(torch.tensor(dk ** -0.5).to(dtype)) if dtype == torch.bfloat16 else dk ** -0.5


def _slot_products(a, b, rnd):
    """out[..., c, l, j] = sum_d rnd(a[..., c, l, d] * b[..., j, l, d]) for a,
    b (B, H, C, L, d): each product of two bf16 values rounded to bf16 before
    the float32 sum (the JAX kernel's `(qh * kh).astype(f32)`)."""
    return rnd(a.unsqueeze(3) * b.unsqueeze(2)).sum(-1).transpose(-1, -2)


def _chunk_fwd(xc, kv_in, s_in, w: FusionWeights, seed, n, H, rate, collect=False):
    """Chunk n of the layer for every batch row: xc (B, C, L, D) in the data
    dtype, the incoming state kv_in (B, H, C, dk, dv) and s_in (B, H, C, 1,
    1) float32; w in the data dtype.  Returns (y float32, kv_out, s_out,
    stash); the stash (collect) holds what the backward reads, rounded
    where the JAX kernel stashes rounded values."""
    dt = xc.dtype
    bf = dt == torch.bfloat16
    rnd = rounding(dt)
    xc = compute(xc)
    w = FusionWeights(*(compute(t) for t in w))
    B, C, L, D = xc.shape
    Fh = w.wf1.shape[0]
    dk = D // H
    mask, inner_decay, wlast = _consts(L, xc.device)
    ms = _chunk_masks(seed, n, B, C, L, D, Fh, H, rate, xc.device, rnd)

    def drop(t, key):
        return t if ms is None else t * ms[key]

    # time-axis retention, per (b, head, slot)
    qkvg = xc @ w.wqkvg.T + w.bqkvg                              # (B, C, L, 4D)
    q = rnd(_heads(qkvg[..., :D], H))
    k = rnd(rnd(_heads(qkvg[..., D:2 * D], H)) * _kscale(dk, dt))
    v = rnd(_heads(qkvg[..., 2 * D:3 * D], H))
    g = qkvg[..., 3 * D:]
    qk = (q @ k.transpose(-1, -2)) * mask                         # (B, H, C, L, L)
    is_ = qk.detach().abs().sum(-1, keepdim=True).clamp(min=1.0)
    innin = rnd(qk / is_)
    inner = innin @ v
    kvn = kv_in / s_in
    cross = (q * inner_decay) @ kvn
    all_ = torch.maximum(is_, s_in)
    oh = inner * (is_ / all_) + cross * (s_in / all_)
    mu = oh.mean(-1, keepdim=True)
    grs = torch.rsqrt((oh - mu).square().mean(-1, keepdim=True) + 1e-6)
    ohn = (oh - mu) * grs
    kv_out = kv_in + (k.transpose(-1, -2) @ v) * wlast
    s_out = kv_out.detach().abs().sum(-2, keepdim=True).amax(-1, keepdim=True).clamp(min=1.0)
    retcat = _merge(ohn)
    gated = rnd(F.silu(g) * retcat)
    a = drop(gated @ w.wro.T + w.bro, "m0")
    x1, xh1, rs1 = _ln_fwd(xc + a, w.lns[0], w.lnb[0])
    x1r = rnd(x1)
    # attention across the C slots of each frame
    qkv = rnd(x1r @ w.wmi.T + w.bmi)
    qh, kh, vh = (_heads(qkv[..., i * D:(i + 1) * D], H) for i in range(3))
    inv = 1.0 / math.sqrt(dk)
    if bf:
        scores = _slot_products(qh, kh, rnd)
    else:
        scores = torch.einsum("bhcld,bhjld->bhclj", qh, kh)
    wts = rnd(torch.softmax(scores * inv, dim=-1))
    wd = wts if ms is None else wts * ms["m1"]
    if bf:       # each weight rounded, then each product, summed over the slots in order
        wdr = rnd(wd)
        attn = torch.zeros_like(qh)
        for j in range(C):
            attn = attn + rnd(wdr[..., j:j + 1] * vh[:, :, j:j + 1])
        attn = rnd(_merge(attn))
    else:
        attn = _merge(torch.einsum("bhclj,bhjld->bhcld", wd, vh))
    s = drop(attn @ w.wmo.T + w.bmo, "m2")
    x2, xh2, rs2 = _ln_fwd(x1 + s, w.lns[1], w.lnb[1])
    x2r = rnd(x2)
    # relu feed-forward
    hpre = x2r @ w.wf1.T + w.bf1
    hdrop = rnd(drop(torch.relu(hpre), "m3"))
    f = drop(hdrop @ w.wf2.T + w.bf2, "m4")
    y, xh3, rs3 = _ln_fwd(x2 + f, w.lns[2], w.lnb[2])
    st = None
    if collect:
        st = dict(ms or {}, xc=xc, q=q, k=k, v=v, g=rnd(g), qk=qk, is_=is_, innin=innin,
                  all_=all_, kv_in=kv_in, s_in=s_in, ohn=rnd(ohn), grs=grs,
                  retcat=rnd(retcat), gated=gated, xh1=rnd(xh1), rs1=rs1, x1=x1r, qh=qh,
                  kh=kh, vh=vh, wts=wts, wd=wd, attn=attn, xh2=rnd(xh2), rs2=rs2, x2=x2r,
                  hpre=hpre, hdrop=hdrop, xh3=rnd(xh3), rs3=rs3)
    return y, kv_out, s_out, st
def fusion_layer_fwd_plain(x: torch.Tensor, w: FusionWeights, seed: int, n_heads: int,
                           chunk: int, rate: float, checkpoints: bool = True):
    """The forward as a loop over the chunks, every batch row at once (the
    oracle `tests/test_dec_train_fusion.py` holds the JAX kernel to), in
    x's dtype: float32, or bf16 at the JAX kernel's rounding points.
    Differentiable by torch autograd.  Returns (y, kvs, ss), kvs and ss
    float32; None, None without `checkpoints`."""
    B, C, T, D = x.shape
    H, L = n_heads, chunk
    dk = D // H
    sdt = compute(x[:0]).dtype                      # the state's: float32 for bf16 data
    kv = x.new_zeros(B, H, C, dk, dk, dtype=sdt)
    s = x.new_ones(B, H, C, 1, 1, dtype=sdt)
    ys, kvs, ss = [], [], []
    for n in range(T // L):
        kvs.append(kv)
        ss.append(s)
        y, kv, s, _ = _chunk_fwd(x[:, :, n * L:(n + 1) * L], kv, s, w, seed, n, H, rate)
        ys.append(y)
    y = torch.cat(ys, dim=2).to(x.dtype)
    if not checkpoints:
        return y, None, None
    return y, torch.stack(kvs, dim=1), torch.stack(ss, dim=1)


def _ln_bwd(dy, xh, rs, scale):
    dxh = dy * scale
    m1 = dxh.mean(-1, keepdim=True)
    m2 = (dxh * xh).mean(-1, keepdim=True)
    return rs * (dxh - m1 - xh * m2), dy * xh, dy


def _chunk_bwd(dy, st, w: FusionWeights, dS, acc: list, H: int, dtype):
    """Backward of chunk n (the JAX `_bwd_kernel` op for op).  dy float32,
    w the weights as float32 values, dS the cotangent of the state after
    the chunk; a gradient is rounded to the data dtype where the JAX kernel
    casts it before a product.  Adds the weight gradients to `acc` (a
    FusionWeights-ordered list of float32 sums) and returns (dx float32,
    the cotangent of the state the chunk read)."""
    B, C, L, D = dy.shape
    dk = D // H
    mask, inner_decay, wlast = _consts(L, dy.device)
    bf = dtype == torch.bfloat16
    rnd = rounding(dtype)

    def rows(t):
        return t.reshape(-1, t.shape[-1])

    def wgrad(i, d, a):                      # weight i += rnd(d)^T a, bias i + 1 += sum d
        acc[i] += rows(rnd(d)).T @ rows(a)
        acc[i + 1] += rows(d).sum(0)

    def dmul(t, key):
        return t if key not in st else t * st[key]

    def ln_grads(j, dy_, xh, rs):
        dr, dls, dlb = _ln_bwd(dy_, xh, rs, w.lns[j])
        acc[12][j] += rows(dls).sum(0)
        acc[13][j] += rows(dlb).sum(0)
        return dr

    # LN3, FFN
    dr3 = ln_grads(2, dy, st["xh3"], st["rs3"])
    df = dmul(dr3, "m4")
    wgrad(10, df, st["hdrop"])
    dhpre = dmul(rnd(df) @ w.wf2, "m3") * (st["hpre"] > 0)
    wgrad(8, dhpre, st["x2"])
    dx2 = dr3 + rnd(dhpre) @ w.wf1
    # LN2, slot attention
    dr2 = ln_grads(1, dx2, st["xh2"], st["rs2"])
    ds = dmul(dr2, "m2")
    wgrad(6, ds, st["attn"])
    dah = _heads(rnd(ds) @ w.wmo, H)
    wts, wd = st["wts"], st["wd"]
    if bf:
        dwd = _slot_products(rnd(dah), st["vh"], rnd)
    else:
        dwd = torch.einsum("bhcld,bhjld->bhclj", dah, st["vh"])
    dvh = torch.einsum("bhclj,bhcld->bhjld", wd, dah)
    dw = dwd if "m1" not in st else dwd * st["m1"]
    dscore = wts * (dw - (dw * wts).sum(-1, keepdim=True)) / math.sqrt(dk)
    dqh = torch.einsum("bhclj,bhjld->bhcld", dscore, st["kh"])
    dkh = torch.einsum("bhclj,bhcld->bhjld", dscore, st["qh"])
    dqkv = torch.cat([_merge(dqh), _merge(dkh), _merge(dvh)], dim=-1)
    wgrad(4, dqkv, st["x1"])
    dx1 = dr2 + rnd(dqkv) @ w.wmi
    # LN1, gate, out projection
    dr1 = ln_grads(0, dx1, st["xh1"], st["rs1"])
    da = dmul(dr1, "m0")
    wgrad(2, da, st["gated"])
    dgated = rnd(da) @ w.wro
    g = st["g"]
    sg = torch.sigmoid(g)
    dretcat = dgated * (g * sg)
    dg = dgated * st["retcat"] * (sg * (1.0 + g * (1.0 - sg)))
    # group norm, retention core
    dohn = _heads(dretcat, H)
    ohn = st["ohn"]
    doh = st["grs"] * (dohn - dohn.mean(-1, keepdim=True)
                       - ohn * (dohn * ohn).mean(-1, keepdim=True))
    q, k, v, is_, all_, s_in = (st[key] for key in ("q", "k", "v", "is_", "all_", "s_in"))
    # the products of the core's backward all take operands in the data dtype
    dinner = rnd(doh * (is_ / all_))
    dcross = rnd(doh * (s_in / all_))
    dq = (dcross @ rnd(st["kv_in"] / s_in).transpose(-1, -2)) * inner_decay
    dkv_cross = (rnd(q * inner_decay).transpose(-1, -2) @ dcross) / s_in
    dqk = rnd((dinner @ v.transpose(-1, -2)) / is_ * mask)
    dv = st["innin"].transpose(-1, -2) @ dinner
    dSr = rnd(dS)
    dq = dq + dqk @ k
    dkk = dqk.transpose(-1, -2) @ q + (v @ dSr.transpose(-1, -2)) * wlast
    dv = dv + (k @ dSr) * wlast
    dqkvg = torch.cat([_merge(dq), _merge(dkk * dk ** -0.5), _merge(dv), dg], dim=-1)
    wgrad(0, dqkvg, st["xc"])
    return dr1 + rnd(dqkvg) @ w.wqkvg, dS + dkv_cross


@torch.no_grad()
def fusion_layer_bwd_plain(x: torch.Tensor, dy: torch.Tensor, kvs: torch.Tensor,
                           ss: torch.Tensor, w: FusionWeights, seed: int, n_heads: int,
                           chunk: int, rate: float):
    """The hand-written backward: a reverse sweep over the chunks, each
    recomputed from its state checkpoint, carrying the state cotangent.
    Returns (dx in x's dtype, FusionWeights of the weight gradients in the
    weights' dtype, each summed in float32)."""
    B, C, T, D = x.shape
    H, L = n_heads, chunk
    dk = D // H
    w32 = FusionWeights(*(compute(t) for t in w))
    acc = [torch.zeros_like(t) for t in w32]
    dS = x.new_zeros(B, H, C, dk, dk, dtype=compute(x[:0]).dtype)
    dx = torch.empty_like(x)
    for n in reversed(range(T // L)):
        sl = slice(n * L, (n + 1) * L)
        _, _, _, st = _chunk_fwd(x[:, :, sl], kvs[:, n], ss[:, n], w, seed, n, H, rate,
                                 collect=True)
        dxc, dS = _chunk_bwd(compute(dy[:, :, sl]), st, w32, dS, acc, H, x.dtype)
        dx[:, :, sl] = dxc.to(x.dtype)
    return dx, FusionWeights(*(a.to(t.dtype) for a, t in zip(acc, w)))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check(x, w: FusionWeights, n_heads, chunk):
    B, C, T, D = x.shape
    Fh = w.wf1.shape[0]
    want = {"wqkvg": (4 * D, D), "bqkvg": (4 * D,), "wro": (D, D), "bro": (D,),
            "wmi": (3 * D, D), "bmi": (3 * D,), "wmo": (D, D), "bmo": (D,), "wf1": (Fh, D),
            "bf1": (Fh,), "wf2": (D, Fh), "bf2": (D,), "lns": (3, D), "lnb": (3, D)}
    got = {"x": x, **w._asdict()}
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fusion layer: x is {x.dtype}; the layer takes float32 or bfloat16")
    for name, t in got.items():
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"fusion layer: {name} has shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
        if t.dtype != x.dtype:
            raise ValueError(f"fusion layer: mixed dtypes: {name} is {t.dtype}, x {x.dtype} "
                             f"(float32 or bfloat16, all alike)")
        if t.device != x.device:
            raise ValueError(f"fusion layer: {name} is on {t.device}, x on {x.device}")
    if D % n_heads:
        raise ValueError(f"fusion layer: {n_heads} heads do not tile D={D}")
    if chunk <= 0 or T % chunk:
        raise ValueError(f"fusion layer: T={T} is not a multiple of chunk={chunk}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fusion layer: unsupported device {x.device}")


def transposed(w: FusionWeights) -> list:
    """The six products' weights (wqkvg, wro, wmi, wmo, wf1, wf2)
    transposed to (in, out) and contiguous: the layout the kernels' forward
    products read."""
    return [w[i].T.contiguous() for i in (0, 2, 4, 6, 8, 10)]


def fusion_layer_fwd(x: torch.Tensor, w: FusionWeights, seed: int, n_heads: int,
                     chunk: int, rate: float, checkpoints: bool = True, wt=None):
    """Forward of one layer -> (y, kvs, ss) (None, None without
    `checkpoints`): the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  `wt`: `transposed(w)`, where the caller has it already."""
    _check(x, w, n_heads, chunk)
    if x.device.type == "cpu":
        return fusion_layer_fwd_plain(x, w, seed, n_heads, chunk, rate, checkpoints)
    return _launch_fwd(x, w, seed, n_heads, chunk, rate, checkpoints, wt)


def fusion_layer_bwd(x: torch.Tensor, dy: torch.Tensor, kvs: torch.Tensor, ss: torch.Tensor,
                     w: FusionWeights, seed: int, n_heads: int, chunk: int, rate: float,
                     wt=None):
    """Backward of one layer -> (dx, weight gradients): the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors.  `wt`: `transposed(w)`,
    where the caller has it already."""
    _check(x, w, n_heads, chunk)
    B, C, T, D = x.shape
    H, dk, N = n_heads, D // n_heads, T // chunk
    for name, t, shape, dt in (("dy", dy, x.shape, x.dtype),
                               ("kvs", kvs, (B, N, H, C, dk, dk), torch.float32),
                               ("ss", ss, (B, N, H, C, 1, 1), torch.float32)):
        if tuple(t.shape) != tuple(shape) or t.dtype != dt or t.device != x.device:
            raise ValueError(f"fusion layer backward: {name} is {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}, expected {tuple(shape)} {dt} on {x.device}")
    if x.device.type == "cpu":
        return fusion_layer_bwd_plain(x, dy, kvs, ss, w, seed, n_heads, chunk, rate)
    return _launch_bwd(x, dy, kvs, ss, w, seed, n_heads, chunk, rate, wt)


class _FusedFusionLayerFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, n_heads, chunk, rate, *w):
        w = FusionWeights(*w)
        # the kernels' products read the weights transposed: made once, for
        # the forward and its backward
        wt = transposed(w) if x.device.type == "cuda" else []
        y, kvs, ss = fusion_layer_fwd(x, w, seed, n_heads, chunk, rate, wt=wt or None)
        ctx.save_for_backward(x, kvs, ss, *w, *wt)
        ctx.args = (seed, n_heads, chunk, rate)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, kvs, ss, *rest = ctx.saved_tensors
        n = len(FusionWeights._fields)
        dx, dw = fusion_layer_bwd(x, dy.contiguous(), kvs, ss, FusionWeights(*rest[:n]),
                                  *ctx.args, wt=rest[n:] or None)
        return (dx, None, None, None, None, *dw)


def fused_fusion_layer(x: torch.Tensor, w: FusionWeights, seed: int, n_heads: int,
                       chunk: int, rate: float) -> torch.Tensor:
    """One decoder fusion layer on the slot-major grid x (B, C, T, D);
    `rate` is the dropout rate (0 in eval) and `seed` keys its masks.
    Differentiable through the hand-written backward; without a gradient
    to take, the forward skips the state checkpoints."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x,) + tuple(w)):
        return _FusedFusionLayerFn.apply(x, seed, n_heads, chunk, rate, *w)
    return fusion_layer_fwd(x, w, seed, n_heads, chunk, rate, checkpoints=False)[0]


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def _lib(which: str, D: int, H: int, dtype=torch.float32):
    """The forward or backward library for model width D, H heads and the
    data dtype (bf16: the FS_BF16 build)."""
    dk = D // H
    if D % 64 or D > 512 or 32 % H or dk % 16:
        raise ValueError(f"fusion layer kernels: D={D}, {H} heads unsupported (D a multiple "
                         f"of 64 up to 512, H dividing 32, head dim a multiple of 16)")
    return _build.load(f"dec_train_fusion_{which}",
                       build_defines(dtype, CR_DK=dk, CR_DV=dk, DTF_D=D))


def _dims(x, w, n_heads, chunk):
    B, C, T, D = x.shape
    Fh = w.wf1.shape[0]
    if C > 32:
        raise ValueError(f"fusion layer kernels: {C} slots exceed one warp")
    if Fh % 16:
        raise ValueError(f"fusion layer kernels: F={Fh} must be a multiple of 16")
    return B, C, T, D, Fh


def _rate_args(seed, rate):
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"fusion layer: dropout rate {rate} outside [0, 1)")
    return (ctypes.c_uint(int(seed) & _M32), ctypes.c_uint(keep_threshold(rate)),
            ctypes.c_float(1.0 / (1.0 - rate)))


def _workspace(n: int, H: int) -> int:
    if n == 0:
        raise ValueError(f"fusion layer kernels: library built for another head count than {H}")
    return n


def _ptrs(ts):
    return [t.data_ptr() for t in ts]


def _launch_fwd(x, w, seed, n_heads, chunk, rate, checkpoints, wt=None):
    global fwd_launches, fwd_launches_bf16
    B, C, T, D, Fh = _dims(x, w, n_heads, chunk)
    H, dk, N = n_heads, D // n_heads, T // chunk
    lib = _lib("fwd", D, H, x.dtype)
    x = x.contiguous()
    wt = transposed(w) if wt is None else wt
    # the products' weights (in, out), their biases, the LayerNorms'
    w = [t.contiguous() for t in (wt[0], w.bqkvg, wt[1], w.bro, wt[2], w.bmi, wt[3], w.bmo,
                                  wt[4], w.bf1, wt[5], w.bf2, w.lns, w.lnb)]
    y = torch.empty_like(x)
    kvs = ss = None
    # the bf16 form's chunks read their states from the checkpoint buffers
    # (dtf_tc16.cuh): it takes them on every call, scratch without checkpoints
    if checkpoints or x.dtype == torch.bfloat16:
        kvs = x.new_empty(B, N, H, C, dk, dk, dtype=torch.float32)
        ss = x.new_empty(B, N, H, C, 1, 1, dtype=torch.float32)
    lib.dtf_fwd_workspace.restype = ctypes.c_size_t
    lib.dtf_fwd_workspace.argtypes = [ctypes.c_int] * 4
    ws = x.new_empty(_workspace(lib.dtf_fwd_workspace(B * C, T, H, Fh), H),
                     dtype=torch.float32)
    fn = lib.dtf_forward
    fn.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 5
                   + [ctypes.c_uint, ctypes.c_uint, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), *_ptrs(w), y.data_ptr(),
                 None if kvs is None else kvs.data_ptr(), None if ss is None else ss.data_ptr(),
                 ws.data_ptr(), B, C, T, chunk, Fh, *_rate_args(seed, rate), stream)
    _build.check(lib, err, "fusion layer forward")
    if x.dtype == torch.bfloat16:
        fwd_launches_bf16 += 1
    else:
        fwd_launches += 1
    return (y, kvs, ss) if checkpoints else (y, None, None)


def _launch_bwd(x, dy, kvs, ss, w, seed, n_heads, chunk, rate, wt=None):
    global bwd_launches, bwd_launches_bf16
    B, C, T, D, Fh = _dims(x, w, n_heads, chunk)
    H = n_heads
    lib = _lib("bwd", D, H, x.dtype)
    x, dy, kvs, ss = (t.contiguous() for t in (x, dy, kvs, ss))
    # the recompute's products read the weights transposed, (in, out)
    wt = transposed(w) if wt is None else wt
    w = [t.contiguous() for t in w]
    dx = torch.empty_like(x)
    grads = [torch.empty_like(t) for t in w]         # each written once, in w's dtype
    lib.dtf_bwd_workspace.restype = ctypes.c_size_t
    lib.dtf_bwd_workspace.argtypes = [ctypes.c_int] * 5
    ws = x.new_empty(_workspace(lib.dtf_bwd_workspace(B * C, T, chunk, H, Fh), H),
                     dtype=torch.float32)
    fn = lib.dtf_backward
    fn.argtypes = ([ctypes.c_void_p] * 40 + [ctypes.c_int] * 5
                   + [ctypes.c_uint, ctypes.c_uint, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), dy.data_ptr(), kvs.data_ptr(), ss.data_ptr(), *_ptrs(w),
                 *_ptrs(wt), dx.data_ptr(), *_ptrs(grads), ws.data_ptr(),
                 B, C, T, chunk, Fh, *_rate_args(seed, rate), stream)
    _build.check(lib, err, "fusion layer backward")
    if x.dtype == torch.bfloat16:
        bwd_launches_bf16 += 1
    else:
        bwd_launches += 1
    return dx, FusionWeights(*grads)
