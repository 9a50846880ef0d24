"""Frame scan of the LS-EEND conformer encoder: the CUDA kernel's wrapper,
its plain PyTorch version, and the weight packing.

Replaces `fseend_tpu/kernels/enc_frame_scan_pallas.py:enc_frame_scan`.  One
call runs K frames of every lane through all conformer blocks (half FF ->
recurrent retention -> causal depthwise conv module -> half FF -> LN) with a
per-lane flush that gates the retention update and keeps the conv ring.

On a CUDA tensor the wrapper runs `csrc/enc_frame_scan.cu`: the block
computed layer by layer over all (lane, frame) rows, the linear layers as
float32-exact tensor-core products (3xTF32, `csrc/tc_f32.cuh`), the
retention in its exact recurrent form and the causal conv as a gather over
the kept frames (see the note there); one call of that source is one launch
of the count, whatever kernels it runs.  It needs D a multiple of 64 (at
most 512), head dims that are multiples of 16, F a multiple of 4 and a
workspace of B*min(K, 128) rows that the wrapper allocates (about 0.2 GB
at 128 lanes x 128 frames, D 256, F 1024); a longer K is walked in slices
of 128 frames that carry the state.  A K = 1 call (`step()`, bound by the
launches' host time) runs as a CUDA graph in a workspace the wrapper keeps
for each shape, so that every call with the same weights and state replays
one graph (one per dtype: the two forms are two builds).  The bf16 form at
D 256 runs its layer on `wgmma` products with fused epilogues
(`csrc/scan16.cuh`) from weights transposed into the workspace: once a
call, or for the K = 1 graph once per set of weights, outside the graph
(again when a weight is changed in place).  On
a CPU tensor it runs `enc_frame_scan_plain`, which repeats the arithmetic
frame by frame with batched tensor ops.  Both update the carried state in
place.

Float32 or bf16, as `dec_frame_scan` (the data tensors h0, the weights,
kv, s and ring share one dtype; flush is float32): the bf16 form rounds to
bf16 where `enc_frame_scan_pallas.py` rounds, and carries the retention
state in float32 within a call.

Layouts (lane-major, as the port's stream state holds them):
  h0 (B, K, D) after the input projection + LN; flush (B, K) 0/1 float;
  kv (L, B, H, dv, dk) normalized retention state; s (L, B, H) its running
  scale (gamma = 1: equal over heads); ring (L, B, k-1, D) post-GLU history.
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict
from typing import NamedTuple

import torch
import torch.nn.functional as F

from fseend_tpu_torch.kernels import _build
from fseend_tpu_torch.kernels._dtype import build_defines, check_dtypes, compute, rounding
from fseend_tpu_torch.ops import nn as tnn

# launches of the CUDA kernel since the count was last set to 0: its
# float32 form, its bf16 form
launches = 0
launches_bf16 = 0

# the K = 1 calls' workspaces, one per shape (device, dtype, B, L, D, H, F,
# kc, workspace floats) and set of weights (by identity), the most recent
# last: each as (the workspace, which the call's CUDA graph is keyed by; the
# weights, held so that no other set takes their memory; their versions
# when their transposed copies were written into the workspace)
_graph_ws: OrderedDict = OrderedDict()
_MAX_GRAPH_WS = 8   # as many as the CUDA source keeps graphs


def _version(t: torch.Tensor) -> int:
    """The tensor's in-place version counter (0 for an inference tensor,
    which has none and cannot be changed in place)."""
    try:
        return t._version
    except RuntimeError:
        return 0


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
    """Stack the conformer blocks' weights into the kernel's operands, in
    the blocks' own dtype, and fold eval-mode BatchNorm into a
    per-channel (a, b): a = scale * rsqrt(var + eps), b = bias - mean * a,
    in the model's own dtype (a bf16 model folds in bf16, as the JAX
    package's `pack_enc_weights` does on a bf16 tree)."""
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
    return EncWeights(*(torch.stack(cols[k]).contiguous()
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
    check_dtypes("enc_frame_scan", {k: v for k, v in got.items() if k != "flush"},
                 w._asdict(), {"flush": flush})
    for name, t in list(got.items()) + list(w._asdict().items()):
        if t.device != h0.device or not t.is_contiguous():
            raise ValueError(f"enc_frame_scan: {name} must be contiguous on "
                             f"{h0.device}")


def _launch(h0, flush, w, kv, s, ring, ffac):
    global launches, launches_bf16
    B, K, D = h0.shape
    L, _, H, dv, dk = kv.shape
    Fh = w.wf1a.shape[2]
    kc = w.dw.shape[1]
    if D % 64 or D > 512 or dk % 16 or Fh % 4:
        raise ValueError(f"enc_frame_scan: the CUDA kernel takes D a multiple of 64 up "
                         f"to 512, head dims a multiple of 16 and F a multiple of 4; "
                         f"got D={D}, dk={dk}, F={Fh}")
    lib = _build.load("enc_frame_scan", build_defines(h0.dtype, DTF_D=D, CR_DK=dk, CR_DV=dk))
    fn, size = lib.enc_frame_scan_launch, lib.enc_frame_scan_workspace
    if fn.argtypes is None:
        size.argtypes = [ctypes.c_int] * 8
        size.restype = ctypes.c_size_t
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    graph = K == 1
    hout = torch.empty_like(h0)
    ptrs = (ctypes.c_void_p * len(w))(*[t.data_ptr() for t in w])
    with torch.cuda.device(h0.device):
        n = size(B, K, L, D, H, Fh, kc, int(graph))   # depends on the card's SM count
        if n == 0:
            raise ValueError(f"enc_frame_scan: the build for D={D}, dk={dk} does not take "
                             f"{H} heads")
        key = (h0.device, h0.dtype, B, L, D, H, Fh, kc, n) + tuple(id(t) for t in w)
        mode, held = int(graph), _graph_ws.get(key) if graph else None
        versions = tuple(_version(t) for t in w)
        if held is None:
            ws = torch.empty(n, device=h0.device, dtype=torch.float32)
            if graph:
                # a new workspace: the graph is captured anew, and the bf16
                # layer's transposed weights are written into it first (mode 2)
                mode = 2
                _graph_ws[key] = (ws, tuple(w), versions)
                if len(_graph_ws) > _MAX_GRAPH_WS:
                    _graph_ws.popitem(last=False)
        else:
            ws = held[0]
            _graph_ws.move_to_end(key)
            if held[2] != versions:        # a weight changed in place: copied again
                mode = 2
                _graph_ws[key] = (ws, held[1], versions)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ptrs, h0.data_ptr(), flush.data_ptr(), hout.data_ptr(), kv.data_ptr(),
                 s.data_ptr(), ring.data_ptr(), ws.data_ptr(), B, K, L, Fh, kc, ffac, mode,
                 stream)
    if err != 0 and graph:
        _graph_ws.pop(key, None)
    _build.check(lib, err, "enc_frame_scan")
    if h0.dtype == torch.bfloat16:
        launches_bf16 += 1
    else:
        launches += 1
    return hout


@torch.no_grad()
def enc_frame_scan_plain(h0: torch.Tensor, flush: torch.Tensor, w: EncWeights,
                         kv: torch.Tensor, s: torch.Tensor, ring: torch.Tensor, *,
                         ffac: float) -> torch.Tensor:
    """The kernel's arithmetic with batched tensor ops: frames and layers in
    Python loops, lanes batched.  Same in-place contract as enc_frame_scan.
    In bf16 it computes in float32 on the bf16 values and rounds to bf16
    where the kernel does; the retention state is carried in float32 over
    the call and rounded when it is written back."""
    dt = h0.dtype
    r = rounding(dt)
    B, K, D = h0.shape
    L, _, H, dv, dk = kv.shape
    w = EncWeights(*(compute(t) for t in w))
    kscale = float(torch.tensor(dk ** -0.5).to(dt)) if dt == torch.bfloat16 else dk ** -0.5
    s_cur = compute(s[..., 0]).clone()                        # (L, B)
    KV = compute(kv) * torch.sqrt(s_cur)[..., None, None, None]  # unnormalized
    rg = compute(torch.cat([torch.zeros_like(ring[:, :, :1]), ring], dim=2))  # (L, B, k, D)

    def ln(x, l, i):
        return r(tnn.layer_norm(x, w.lns[l, i], w.lnb[l, i]))

    def half_ff(x, l, i, wa, ba, wb, bb):
        h = r(F.silu(ln(x, l, i) @ wa[l] + ba[l]))
        return r(x + ffac * (h @ wb[l] + bb[l]))

    outs = []
    for k in range(K):
        x = compute(h0[:, k])
        fl = flush[:, k]
        mg = 1.0 - fl
        keep = (fl != 0)[:, None, None]
        for l in range(L):
            x = half_ff(x, l, 0, w.wf1a, w.bf1a, w.wf1b, w.bf1b)
            # retention, one recurrent step in the unnormalized form
            qkvg = r(ln(x, l, 1) @ w.wqkvg[l] + w.bqkvg[l])
            q = qkvg[:, :D].reshape(B, H, dk)
            kk = r(qkvg[:, D:2 * D].reshape(B, H, dk) * kscale)
            v = qkvg[:, 2 * D:3 * D].reshape(B, H, dv)
            r0 = torch.einsum("bhk,bhvk->bhv", q, KV[l])
            qk = (q * kk).sum(-1, keepdim=True)
            out = (r0 + qk * v) * torch.rsqrt(s_cur[l] + 1.0)[:, None, None]
            out = r(tnn.layer_norm(out, eps=1e-6)).reshape(B, D)
            KV[l] = KV[l] + v[..., :, None] * (kk * mg[:, None, None])[..., None, :]
            s_cur[l] = s_cur[l] + mg
            x = r(x + r(F.silu(qkvg[:, 3 * D:]) * out) @ w.wro[l] + w.bro[l])
            # causal depthwise conv module over the k-slot ring
            pw = ln(x, l, 2) @ w.wpw1[l] + w.bpw1[l]
            glu = r(pw[:, :D] * torch.sigmoid(pw[:, D:]))
            shifted = torch.cat([rg[l, :, 1:], glu[:, None]], dim=1)
            rg[l] = torch.where(keep, rg[l], shifted)
            y = (rg[l] * w.dw[l]).sum(1) * w.bna[l] + w.bnb[l]
            x = r(x + r(F.silu(y)) @ w.wpw2[l] + w.bpw2[l])
            x = half_ff(x, l, 3, w.wf2a, w.bf2a, w.wf2b, w.bf2b)
            x = ln(x, l, 4)
        outs.append(x)
    kv.copy_(KV * torch.rsqrt(s_cur.clamp(min=1.0))[..., None, None, None])
    s.copy_(s_cur[..., None].expand_as(s))
    ring.copy_(rg[:, :, 1:])
    return torch.stack(outs, dim=1).to(dt)
