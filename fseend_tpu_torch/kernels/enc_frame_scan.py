"""Frame scan of the LS-EEND conformer encoder: the CUDA kernel's wrapper,
its plain PyTorch version, and the weight packing.

Replaces `fseend_tpu/kernels/enc_frame_scan_pallas.py:enc_frame_scan`.  One
call runs K frames of every lane through all conformer blocks (half FF ->
recurrent retention -> causal depthwise conv module -> half FF -> LN) with a
per-lane flush that gates the retention update and keeps the conv ring.

On a CUDA tensor the wrapper launches `csrc/enc_frame_scan.cu` (see the note
there for what bounds it and how it is laid out); on a CPU tensor it runs
`enc_frame_scan_plain`, which repeats the kernel's arithmetic with batched
tensor ops.  Both update the carried state in place.  Float32 only.

Layouts (lane-major, as the port's stream state holds them):
  h0 (B, K, D) after the input projection + LN; flush (B, K) 0/1 float;
  kv (L, B, H, dv, dk) normalized retention state; s (L, B, H) its running
  scale (gamma = 1: equal over heads); ring (L, B, k-1, D) post-GLU history.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from fseend_tpu_torch.kernels import _build
from fseend_tpu_torch.ops import nn as tnn

# launches of the CUDA kernel since the count was last set to 0
launches = 0


class EncWeights(NamedTuple):
    """Conformer-block weights stacked over layers, (in, out) layouts; the
    field order is the kernel's (`EncWeights` in the CUDA source)."""
    lns: torch.Tensor    # (L, 5, D): ff1, ret_norm, conv, ff2, final_norm
    lnb: torch.Tensor
    wf1a: torch.Tensor   # (L, D, F)
    bf1a: torch.Tensor   # (L, F)
    wf1b: torch.Tensor   # (L, F, D)
    bf1b: torch.Tensor   # (L, D)
    wqkvg: torch.Tensor  # (L, D, 4D): q | k | v | g
    bqkvg: torch.Tensor  # (L, 4D)
    wro: torch.Tensor    # (L, D, D)
    bro: torch.Tensor    # (L, D)
    wpw1: torch.Tensor   # (L, D, 2D)
    bpw1: torch.Tensor   # (L, 2D)
    dw: torch.Tensor     # (L, k, D) depthwise taps
    bna: torch.Tensor    # (L, D) folded BatchNorm: y * a + b
    bnb: torch.Tensor    # (L, D)
    wpw2: torch.Tensor   # (L, D, D)
    bpw2: torch.Tensor   # (L, D)
    wf2a: torch.Tensor
    bf2a: torch.Tensor
    wf2b: torch.Tensor
    bf2b: torch.Tensor


@torch.no_grad()
def pack_enc_weights(blocks, eps: float = 1e-5) -> EncWeights:
    """Stack the conformer blocks' weights into the kernel's operands and fold
    eval-mode BatchNorm into a per-channel (a, b): a = scale * rsqrt(var + eps),
    b = bias - mean * a."""
    def t(lin):
        return lin.weight.T

    cols = {k: [] for k in EncWeights._fields}
    for bp in blocks:
        norms = [bp.ff1.norm, bp.ret_norm, bp.conv.norm, bp.ff2.norm, bp.final_norm]
        cols["lns"].append(torch.stack([n.weight for n in norms]))
        cols["lnb"].append(torch.stack([n.bias for n in norms]))
        for ff, pre in ((bp.ff1, "f1"), (bp.ff2, "f2")):
            cols[f"w{pre}a"].append(t(ff.linear1))
            cols[f"b{pre}a"].append(ff.linear1.bias)
            cols[f"w{pre}b"].append(t(ff.linear2))
            cols[f"b{pre}b"].append(ff.linear2.bias)
        r = bp.ret
        cols["wqkvg"].append(torch.cat([t(r.q_proj), t(r.k_proj), t(r.v_proj),
                                        t(r.g_proj)], dim=1))
        cols["bqkvg"].append(torch.cat([r.q_proj.bias, r.k_proj.bias,
                                        r.v_proj.bias, r.g_proj.bias]))
        cols["wro"].append(t(r.out_proj))
        cols["bro"].append(r.out_proj.bias)
        cv = bp.conv
        cols["wpw1"].append(t(cv.pw1))
        cols["bpw1"].append(cv.pw1.bias)
        cols["dw"].append(cv.dw.weight[:, 0, :].T)          # (D, 1, k) -> (k, D)
        a = cv.bn.weight * torch.rsqrt(cv.bn.running_var + eps)
        cols["bna"].append(a)
        cols["bnb"].append(cv.bn.bias - cv.bn.running_mean * a)
        cols["wpw2"].append(t(cv.pw2))
        cols["bpw2"].append(cv.pw2.bias)
    return EncWeights(*(torch.stack(cols[k]).float().contiguous()
                        for k in EncWeights._fields))


def enc_frame_scan(h0: torch.Tensor, flush: torch.Tensor, w: EncWeights,
                   kv: torch.Tensor, s: torch.Tensor, ring: torch.Tensor, *,
                   ffac: float) -> torch.Tensor:
    """Run K frames of B lanes through the encoder; returns h (B, K, D) and
    updates kv, s and ring in place.  Launches the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    _check(h0, flush, w, kv, s, ring)
    if h0.device.type == "cpu":
        return enc_frame_scan_plain(h0, flush, w, kv, s, ring, ffac=ffac)
    if h0.device.type != "cuda":
        raise ValueError(f"enc_frame_scan: unsupported device {h0.device}")
    return _launch(h0, flush, w, kv, s, ring, ffac)


def _check(h0, flush, w, kv, s, ring):
    B, K, D = h0.shape
    L, _, H, dv, dk = kv.shape
    kc = w.dw.shape[1]
    want = {"h0": (B, K, D), "flush": (B, K), "kv": (L, B, H, dv, dk),
            "s": (L, B, H), "ring": (L, B, kc - 1, D)}
    got = {"h0": h0, "flush": flush, "kv": kv, "s": s, "ring": ring}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"enc_frame_scan: {name} has shape "
                             f"{tuple(got[name].shape)}, expected {shape}")
    if H * dv != D or H * dk != D or dk > 64:
        raise ValueError(f"enc_frame_scan: heads {H}x{dv} do not tile D={D} "
                         f"(or key dim {dk} > 64)")
    for name, t in list(got.items()) + list(w._asdict().items()):
        if t.dtype != torch.float32:
            raise ValueError(f"enc_frame_scan: {name} is {t.dtype}; the kernel "
                             f"takes float32 only")
        if t.device != h0.device or not t.is_contiguous():
            raise ValueError(f"enc_frame_scan: {name} must be contiguous on "
                             f"{h0.device}")


def _launch(h0, flush, w, kv, s, ring, ffac):
    global launches
    lib = _build.load("enc_frame_scan")
    fn = lib.enc_frame_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    B, K, D = h0.shape
    L, _, H, dv, dk = kv.shape
    Fh = w.wf1a.shape[2]
    kc = w.dw.shape[1]
    if D % 4 or Fh % 4:
        raise ValueError(f"enc_frame_scan: D={D} and F={Fh} must be multiples of 4")
    hout = torch.empty_like(h0)
    ptrs = (ctypes.c_void_p * len(w))(*[t.data_ptr() for t in w])
    with torch.cuda.device(h0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ptrs, h0.data_ptr(), flush.data_ptr(), hout.data_ptr(),
                 kv.data_ptr(), s.data_ptr(), ring.data_ptr(),
                 B, K, L, D, H, dk, Fh, kc, ffac, dk ** -0.5, stream)
    _build.check(lib, err, "enc_frame_scan")
    launches += 1
    return hout


@torch.no_grad()
def enc_frame_scan_plain(h0: torch.Tensor, flush: torch.Tensor, w: EncWeights,
                         kv: torch.Tensor, s: torch.Tensor, ring: torch.Tensor, *,
                         ffac: float) -> torch.Tensor:
    """The kernel's arithmetic with batched tensor ops: frames and layers in
    Python loops, lanes batched.  Same in-place contract as enc_frame_scan."""
    B, K, D = h0.shape
    L, _, H, dv, dk = kv.shape
    s_cur = s[..., 0].clone()                                 # (L, B)
    KV = kv * torch.sqrt(s_cur)[..., None, None, None]        # unnormalized
    rg = torch.cat([torch.zeros_like(ring[:, :, :1]), ring], dim=2)  # (L, B, k, D)

    def ln(x, l, i):
        return tnn.layer_norm(x, w.lns[l, i], w.lnb[l, i])

    def half_ff(x, l, i, wa, ba, wb, bb):
        h = F.silu(ln(x, l, i) @ wa[l] + ba[l])
        return x + ffac * (h @ wb[l] + bb[l])

    outs = []
    for k in range(K):
        x = h0[:, k]
        fl = flush[:, k]
        mg = 1.0 - fl
        keep = (fl != 0)[:, None, None]
        for l in range(L):
            x = half_ff(x, l, 0, w.wf1a, w.bf1a, w.wf1b, w.bf1b)
            # retention, one recurrent step in the unnormalized form
            qkvg = ln(x, l, 1) @ w.wqkvg[l] + w.bqkvg[l]
            q = qkvg[:, :D].reshape(B, H, dk)
            kk = qkvg[:, D:2 * D].reshape(B, H, dk) * dk ** -0.5
            v = qkvg[:, 2 * D:3 * D].reshape(B, H, dv)
            r0 = torch.einsum("bhk,bhvk->bhv", q, KV[l])
            qk = (q * kk).sum(-1, keepdim=True)
            out = (r0 + qk * v) * torch.rsqrt(s_cur[l] + 1.0)[:, None, None]
            out = tnn.layer_norm(out, eps=1e-6).reshape(B, D)
            KV[l] = KV[l] + v[..., :, None] * (kk * mg[:, None, None])[..., None, :]
            s_cur[l] = s_cur[l] + mg
            x = x + (F.silu(qkvg[:, 3 * D:]) * out) @ w.wro[l] + w.bro[l]
            # causal depthwise conv module over the k-slot ring
            pw = ln(x, l, 2) @ w.wpw1[l] + w.bpw1[l]
            glu = pw[:, :D] * torch.sigmoid(pw[:, D:])
            shifted = torch.cat([rg[l, :, 1:], glu[:, None]], dim=1)
            rg[l] = torch.where(keep, rg[l], shifted)
            y = (rg[l] * w.dw[l]).sum(1) * w.bna[l] + w.bnb[l]
            x = x + F.silu(y) @ w.wpw2[l] + w.bpw2[l]
            x = half_ff(x, l, 3, w.wf2a, w.bf2a, w.wf2b, w.bf2b)
            x = ln(x, l, 4)
        outs.append(x)
    kv.copy_(KV * torch.rsqrt(s_cur.clamp(min=1.0))[..., None, None, None])
    s.copy_(s_cur[..., None].expand_as(s))
    ring.copy_(rg[:, :, 1:])
    return torch.stack(outs, dim=1)
