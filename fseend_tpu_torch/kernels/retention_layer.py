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
touches the incoming state.  Without a gradient the call is the custom op
`torch.ops.fseend_tpu_torch.retention_layer` (flat tensor and int
arguments; its CUDA implementation is the launch, its CPU one the plain
version, its fake one gives the output shapes and dtypes), so that
`torch.export` can trace a server through it (`serving/aot.py`).  When a
gradient is wanted the call goes through `_RetentionLayerFn`, whose
backward recomputes under autograd what the JAX package differentiates
(`retention_layer_pallas.py:261-280`: its pure route), the plain route on the
packed weights (`ops/retention.py:retention_layer_pure`): in float32 the same
function as `retention_layer_plain`, in bf16 rounded elsewhere than the
kernel's bf16 plain version.

Float32 or bf16: x, the weights and the state share one dtype, gammas is
float32.  The bf16 form (the same source built with FS_BF16) computes as
`retention_layer_pallas.py` does on bf16 data: the projections rounded to
bf16, the core in float32 on the bf16 values with the state carried in
float32 within the call and stored in bf16, the core's output, the group
norm's output, the gated value and y rounded to bf16; its products of bf16
operands are bf16 tensor-core passes, a float32 operand of the core's
products three bf16 terms.  The plain version follows the same rounding
points.  At head dims 64 and D a multiple of 128 (`_ret16`) the bf16 launch
is `csrc/ret16.cuh`'s layer, whose workspace also holds the gated value and
both weights transposed; other widths keep the mma.sync form.

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
from fseend_tpu_torch.kernels._dtype import build_defines, check_dtypes, compute, rounding
from fseend_tpu_torch.ops import nn as tnn
from fseend_tpu_torch.parallel.collectives import gathered

# launches of the CUDA kernel since the count was last set to 0: its
# float32 form, its bf16 form
launches = 0
launches_bf16 = 0


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
    the graph).  Tensor-parallel shards are gathered whole
    (`collectives.gathered`): the kernel takes whole matrices."""
    projs = (ret.q_proj, ret.k_proj, ret.v_proj, ret.g_proj)
    w = gathered
    return RetLayerWeights(torch.cat([w(p, "weight").T for p in projs], dim=1),
                           torch.cat([w(p, "bias") for p in projs]),
                           w(ret.out_proj, "weight").T.contiguous(), ret.out_proj.bias)


def retention_layer(gammas: torch.Tensor, x: torch.Tensor, w: RetLayerWeights,
                    kv0: torch.Tensor, s0: torch.Tensor, chunk: int):
    """Launches the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    _check(gammas, x, w, kv0, s0, chunk)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"retention_layer: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, kv0, s0) + tuple(w)):
        return _RetentionLayerFn.apply(gammas, x, *w, kv0, s0, chunk)
    return tuple(retention_layer_op(gammas, x, *w, kv0, s0, chunk))


def _forward(gammas, x, w, kv0, s0, chunk):
    if x.device.type == "cpu":
        return retention_layer_plain(gammas, x, w, kv0, s0, chunk)
    return _launch(gammas, x, w, kv0, s0, chunk)


def _plain_flat(gammas, x, wqkvg, bqkvg, wo, bo, kv0, s0, chunk):
    return retention_layer_plain(gammas, x, RetLayerWeights(wqkvg, bqkvg, wo, bo), kv0, s0,
                                 chunk)


@torch.library.custom_op("fseend_tpu_torch::retention_layer", mutates_args=(),
                         device_types="cpu")
def retention_layer_op(gammas: torch.Tensor, x: torch.Tensor, wqkvg: torch.Tensor,
                       bqkvg: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                       kv0: torch.Tensor, s0: torch.Tensor,
                       chunk: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The custom op; this body is its CPU implementation (the plain
    version)."""
    return _plain_flat(gammas, x, wqkvg, bqkvg, wo, bo, kv0, s0, chunk)


@retention_layer_op.register_kernel("cuda")
def _op_cuda(gammas, x, wqkvg, bqkvg, wo, bo, kv0, s0, chunk):
    return _launch(gammas, x, RetLayerWeights(wqkvg, bqkvg, wo, bo), kv0, s0, chunk)


@retention_layer_op.register_fake
def _op_fake(gammas, x, wqkvg, bqkvg, wo, bo, kv0, s0, chunk):
    return torch.empty_like(x), torch.empty_like(kv0), torch.empty_like(s0)


class _RetentionLayerFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gammas, x, wqkvg, bqkvg, wo, bo, kv0, s0, chunk):
        ctx.save_for_backward(gammas, x, wqkvg, bqkvg, wo, bo, kv0, s0)
        ctx.chunk = chunk
        return _forward(gammas, x, RetLayerWeights(wqkvg, bqkvg, wo, bo), kv0, s0, chunk)

    @staticmethod
    def backward(ctx, *grads_out):
        grads = recompute_grads(lambda *a: _pure_flat(*a, ctx.chunk), ctx.saved_tensors,
                                ctx.needs_input_grad[:8], grads_out)
        return (*grads, None)


def _pure_flat(gammas, x, wqkvg, bqkvg, wo, bo, kv0, s0, chunk):
    # ops/retention.py imports this module: imported here, at the first backward
    from fseend_tpu_torch.ops.retention import retention_layer_pure

    return retention_layer_pure(gammas, x, RetLayerWeights(wqkvg, bqkvg, wo, bo), kv0, s0,
                                chunk)


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
        if t.device != x.device:
            raise ValueError(f"retention_layer: {name} is on {t.device}, x on {x.device}")
    if chunk <= 0 or T % chunk:
        raise ValueError(f"retention_layer: T={T} is not a multiple of chunk={chunk}")
    if gammas.dtype != torch.float32:
        raise ValueError(f"retention_layer: gammas is {gammas.dtype}; float32")
    check_dtypes("retention_layer", {"x": x, "kv0": kv0, "s0": s0}, w._asdict(), {})


def _launch(gammas, x, w, kv0, s0, chunk):
    global launches, launches_bf16
    B, T, D = x.shape
    H = gammas.shape[0]
    Fv = w.wo.shape[0]
    dk, dv = D // H, Fv // H
    if dk % 16 or dv % 16 or dk > 128 or dv > 128:
        raise ValueError(f"retention_layer: head dims {dk}, {dv} must be multiples of 16, "
                         f"at most 128")
    if B * T > 128 * 65535:
        raise ValueError(f"retention_layer: {B * T} frames exceed one launch's grid")
    lib = _build.load("retention_layer", build_defines(x.dtype, CR_DK=dk, CR_DV=dv))
    fn = lib.retention_layer_launch
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_float]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    gammas, x, kv0, s0 = (aligned(t.contiguous()) for t in (gammas, x, kv0, s0))
    w = RetLayerWeights(*(aligned(t.contiguous()) for t in w))
    W = 2 * D + 2 * Fv
    # q | k | v | g, and on csrc/ret16.cuh's path the gated value and both
    # weights transposed
    extra = B * T * Fv + W * D + D * Fv if _ret16(x.dtype, D, dk, dv) else 0
    ws = torch.empty(B * T * W + extra, dtype=x.dtype, device=x.device)
    N = T // chunk
    # the chunks' summaries and scales, when there is more than one chunk
    scratch = (torch.empty(B * H * N * (dk * dv + 1), device=x.device, dtype=torch.float32)
               if N > 1 else None)
    kscale = _in(x.dtype, dk ** -0.5) if x.dtype == torch.bfloat16 else dk ** -0.5
    y = torch.empty_like(x)
    kv_f, s_f = torch.empty_like(kv0), torch.empty_like(s0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(gammas.data_ptr(), x.data_ptr(), w.wqkvg.data_ptr(), w.bqkvg.data_ptr(),
                 w.wo.data_ptr(), w.bo.data_ptr(), ws.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), y.data_ptr(),
                 kv0.data_ptr(), s0.data_ptr(), kv_f.data_ptr(), s_f.data_ptr(),
                 B, T, chunk, H, kscale, stream)
    _build.check(lib, err, "retention_layer")
    if x.dtype == torch.bfloat16:
        launches_bf16 += 1
    else:
        launches += 1
    return y, kv_f, s_f


def _ret16(dtype, D: int, dk: int, dv: int) -> bool:
    """Whether the CUDA launch takes csrc/ret16.cuh's layer (retention_layer.cu
    chooses by the same rule): the bf16 form at head dims 64 with D a
    multiple of 128, the wgmma out projection's tile (the LS decoder's and
    encoder's D 256).  Other widths keep the mma.sync form."""
    return dtype == torch.bfloat16 and dk == dv == 64 and D % 128 == 0


def _in(dtype, v: float) -> float:
    """v rounded to dtype (the TPU kernel's `jnp.asarray(v, dt)`)."""
    return float(torch.tensor(v).to(dtype))


def retention_layer_plain(gammas: torch.Tensor, x: torch.Tensor, w: RetLayerWeights,
                          kv0: torch.Tensor, s0: torch.Tensor, chunk: int):
    """The kernel's arithmetic with tensor ops: one stacked projection, the
    plain chunkwise core over (batch x head) rows, group norm, gate, out
    projection.  In bf16 it computes in float32 on the bf16 values and
    rounds to bf16 where the kernel does; the state is carried in float32
    and rounded to bf16 on the way out."""
    dt = x.dtype
    r = rounding(dt)
    B, T, D = x.shape
    H = gammas.shape[0]
    Fv = w.wo.shape[0]
    dk, dv = D // H, Fv // H
    if dt == torch.bfloat16:
        x, kv0, s0 = compute(x), compute(kv0), compute(s0)
        w = RetLayerWeights(*(compute(t) for t in w))
    kscale = _in(dt, dk ** -0.5) if dt == torch.bfloat16 else dk ** -0.5
    q, k, v, g = r(x @ w.wqkvg + w.bqkvg).split([D, D, Fv, Fv], dim=-1)

    def rows(t, d):                                   # (B, T, H*d) -> (B*H, T, d)
        return t.reshape(B, T, H, d).transpose(1, 2).reshape(B * H, T, d)

    out, kv_f, s_f = chunk_retention_plain(
        gammas.repeat(B), rows(q, dk), rows(r(k * kscale), dk), rows(v, dv),
        kv0.reshape(B * H, dk, dv), s0.reshape(B * H, 1, 1), chunk)
    out = r(out).reshape(B, H, T, dv).transpose(1, 2)  # (B, T, H, dv)
    out = r(tnn.layer_norm(out, eps=1e-6)).reshape(B, T, Fv)
    y = r(F.silu(g) * out) @ w.wo + w.bo
    return (y.to(dt), kv_f.reshape(B, H, dk, dv).to(dt), s_f.reshape(B, H, 1, 1).to(dt))
