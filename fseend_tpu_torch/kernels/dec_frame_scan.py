"""Frame scan of the LS-EEND attractor decoder: the CUDA kernel's wrapper,
its plain PyTorch version, and the weight packing.

Replaces `fseend_tpu/kernels/dec_frame_scan_pallas.py:dec_frame_scan`.  One
call runs K frames of every lane through all fusion layers: per slot a
gamma = 1 recurrent retention step (output from the would-be-updated state,
carry gated by the lane's `valid`), LN, attention across the C slots of the
lane, LN, relu FFN, LN; then logits = l2-normed attractor . embedding.

On a CUDA tensor the wrapper launches `csrc/dec_frame_scan.cu` (see the note
there for what bounds it and how it is laid out); on a CPU tensor it runs
`dec_frame_scan_plain`.  Both update the carried state in place.  Float32
only.

Layouts (lane-major, as the port's stream state holds them):
  embp (B, K, D) = emb @ Wc[:D], the embedding's part of the decoder's
  `convert`; embn (B, K, D) the l2-normed embedding; valid (B, K) 0/1 float;
  pe (C, D) = pe @ Wc[D:] + bias, the slots' part; kv (L, B*C, H, dv, dk)
  normalized retention state, lane b's slots contiguous; s (L, B*C, H).
  Returns logits (B, K, C).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from fseend_tpu_torch.kernels import _build
from fseend_tpu_torch.ops import nn as tnn

# launches of the CUDA kernel since the count was last set to 0
launches = 0


class DecWeights(NamedTuple):
    """Fusion-layer weights stacked over layers, (in, out) layouts; the field
    order is the kernel's (`DecWeights` in the CUDA source)."""
    w_qkvg: torch.Tensor  # (L, D, 4D): q | k | v | g of time_ret
    b_qkvg: torch.Tensor  # (L, 4D)
    w_ro: torch.Tensor    # (L, D, D)
    b_ro: torch.Tensor    # (L, D)
    w_mi: torch.Tensor    # (L, D, 3D) packed slot-attention in-projection
    b_mi: torch.Tensor    # (L, 3D)
    w_mo: torch.Tensor    # (L, D, D)
    b_mo: torch.Tensor    # (L, D)
    w_f1: torch.Tensor    # (L, D, F)
    b_f1: torch.Tensor    # (L, F)
    w_f2: torch.Tensor    # (L, F, D)
    b_f2: torch.Tensor    # (L, D)
    ln_s: torch.Tensor    # (L, 3, D): norm11, norm21, norm22
    ln_b: torch.Tensor


@torch.no_grad()
def pack_dec_weights(layers) -> DecWeights:
    """Stack the decoder fusion layers' weights into the kernel's operands."""
    cols = {k: [] for k in DecWeights._fields}
    for lp in layers:
        r = lp.time_ret
        cols["w_qkvg"].append(torch.cat([r.q_proj.weight.T, r.k_proj.weight.T,
                                         r.v_proj.weight.T, r.g_proj.weight.T], dim=1))
        cols["b_qkvg"].append(torch.cat([r.q_proj.bias, r.k_proj.bias,
                                         r.v_proj.bias, r.g_proj.bias]))
        for key, lin in (("ro", r.out_proj), ("mi", lp.spk_attn.in_proj),
                         ("mo", lp.spk_attn.out_proj), ("f1", lp.linear1),
                         ("f2", lp.linear2)):
            cols[f"w_{key}"].append(lin.weight.T)
            cols[f"b_{key}"].append(lin.bias)
        norms = (lp.norm11, lp.norm21, lp.norm22)
        cols["ln_s"].append(torch.stack([n.weight for n in norms]))
        cols["ln_b"].append(torch.stack([n.bias for n in norms]))
    return DecWeights(*(torch.stack(cols[k]).float().contiguous()
                        for k in DecWeights._fields))


def dec_frame_scan(embp: torch.Tensor, embn: torch.Tensor, valid: torch.Tensor,
                   pe: torch.Tensor, w: DecWeights, kv: torch.Tensor,
                   s: torch.Tensor) -> torch.Tensor:
    """Run K frames of B lanes x C slots through the decoder; returns logits
    (B, K, C) and updates kv and s in place.  Launches the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    _check(embp, embn, valid, pe, w, kv, s)
    if embp.device.type == "cpu":
        return dec_frame_scan_plain(embp, embn, valid, pe, w, kv, s)
    if embp.device.type != "cuda":
        raise ValueError(f"dec_frame_scan: unsupported device {embp.device}")
    return _launch(embp, embn, valid, pe, w, kv, s)


def _check(embp, embn, valid, pe, w, kv, s):
    B, K, D = embp.shape
    C = pe.shape[0]
    L, _, H, dv, dk = kv.shape
    want = {"embp": (B, K, D), "embn": (B, K, D), "valid": (B, K), "pe": (C, D),
            "kv": (L, B * C, H, dv, dk), "s": (L, B * C, H)}
    got = {"embp": embp, "embn": embn, "valid": valid, "pe": pe, "kv": kv, "s": s}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"dec_frame_scan: {name} has shape "
                             f"{tuple(got[name].shape)}, expected {shape}")
    if H * dv != D or H * dk != D or dk > 64:
        raise ValueError(f"dec_frame_scan: heads {H}x{dv} do not tile D={D} "
                         f"(or key dim {dk} > 64)")
    for name, t in list(got.items()) + list(w._asdict().items()):
        if t.dtype != torch.float32:
            raise ValueError(f"dec_frame_scan: {name} is {t.dtype}; the kernel "
                             f"takes float32 only")
        if t.device != embp.device or not t.is_contiguous():
            raise ValueError(f"dec_frame_scan: {name} must be contiguous on "
                             f"{embp.device}")


def _launch(embp, embn, valid, pe, w, kv, s):
    global launches
    B, K, D = embp.shape
    C = pe.shape[0]
    L, _, H, dv, dk = kv.shape
    Fh = w.w_f1.shape[2]
    if D % 4 or Fh % 4:
        raise ValueError(f"dec_frame_scan: D={D} and F={Fh} must be multiples of 4")
    lib = _build.load("dec_frame_scan", {"FS_NSLOTS": C})
    fn = lib.dec_frame_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    logits = torch.empty(B, K, C, device=embp.device, dtype=torch.float32)
    ptrs = (ctypes.c_void_p * len(w))(*[t.data_ptr() for t in w])
    with torch.cuda.device(embp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ptrs, embp.data_ptr(), embn.data_ptr(), valid.data_ptr(),
                 pe.data_ptr(), logits.data_ptr(), kv.data_ptr(), s.data_ptr(),
                 B, K, L, D, H, dk, Fh, dk ** -0.5, stream)
    _build.check(lib, err, "dec_frame_scan")
    launches += 1
    return logits


@torch.no_grad()
def dec_frame_scan_plain(embp: torch.Tensor, embn: torch.Tensor, valid: torch.Tensor,
                         pe: torch.Tensor, w: DecWeights, kv: torch.Tensor,
                         s: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic with batched tensor ops: frames and layers in
    Python loops, lanes and slots batched.  Same in-place contract as
    dec_frame_scan."""
    B, K, D = embp.shape
    C = pe.shape[0]
    L, BC, H, dv, dk = kv.shape
    hd = D // H
    s_cur = s[..., 0].clone()                                 # (L, B*C)
    KV = kv * torch.sqrt(s_cur)[..., None, None, None]        # unnormalized
    logits = torch.empty(B, K, C, dtype=torch.float32, device=embp.device)

    def ln(x, l, i):
        return tnn.layer_norm(x, w.ln_s[l, i], w.ln_b[l, i])

    def heads(t):                                             # (B, C, D) -> (B, H, C, hd)
        return t.reshape(B, C, H, hd).transpose(1, 2)

    for k in range(K):
        x = (embp[:, k, None, :] + pe[None]).reshape(BC, D)
        mt = valid[:, k].repeat_interleave(C)                 # (B*C,)
        for l in range(L):
            qkvg = x @ w.w_qkvg[l] + w.b_qkvg[l]
            q = qkvg[:, :D].reshape(BC, H, dk)
            kk = qkvg[:, D:2 * D].reshape(BC, H, dk) * dk ** -0.5
            v = qkvg[:, 2 * D:3 * D].reshape(BC, H, dv)
            r0 = torch.einsum("nhk,nhvk->nhv", q, KV[l])
            qk = (q * kk).sum(-1, keepdim=True)
            out = (r0 + qk * v) * torch.rsqrt(s_cur[l] + 1.0)[:, None, None]
            out = tnn.layer_norm(out, eps=1e-6).reshape(BC, D)
            KV[l] = KV[l] + v[..., :, None] * (kk * mt[:, None, None])[..., None, :]
            s_cur[l] = s_cur[l] + mt
            a = (torch.nn.functional.silu(qkvg[:, 3 * D:]) * out) @ w.w_ro[l] + w.b_ro[l]
            x = ln(x + a, l, 0)
            # attention across the C slots of each lane
            qkv = (x @ w.w_mi[l] + w.b_mi[l]).reshape(B, C, 3 * D)
            qh, kh, vh = (heads(qkv[..., i * D:(i + 1) * D]) for i in range(3))
            p = torch.softmax(qh @ kh.transpose(-1, -2) / math.sqrt(hd), dim=-1)
            att = (p @ vh).transpose(1, 2).reshape(BC, D)
            x = ln(x + att @ w.w_mo[l] + w.b_mo[l], l, 1)
            hid = torch.relu(x @ w.w_f1[l] + w.b_f1[l])
            x = ln(x + hid @ w.w_f2[l] + w.b_f2[l], l, 2)
        attr = x * torch.rsqrt(x.square().sum(-1, keepdim=True))
        logits[:, k] = (embn[:, k, None, :] * attr.reshape(B, C, D)).sum(-1)
    kv.copy_(KV * torch.rsqrt(s_cur.clamp(min=1.0))[..., None, None, None])
    s.copy_(s_cur[..., None].expand_as(s))
    return logits
