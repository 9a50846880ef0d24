"""Chunkwise retention core with carried state: the CUDA kernel's wrapper
and its plain PyTorch version.

Replaces `fseend_tpu/kernels/retention_pallas.py:_forward_stateful` (public
`chunkwise_retention_stateful`; `chunkwise_retention` is the same call with
gamma = 1 and a fresh state).  Per (batch x head) row and L-frame chunk: the
decay-masked `q k^T` with its row renormalizer clamped at 1, the read of the
carried state `(kv, scale)` as it was before the chunk, and the update
`kv * gamma^L + k^T (v * last mask row)` with the new scale
`max(|kv|.sum(dk).max(dv), 1)`.  The state is carried unnormalized.

On a CUDA tensor the wrapper launches `csrc/chunk_retention.cu` (design
notes there and in `csrc/chunk_retention_core.cuh`); on a CPU tensor it runs
`chunk_retention_plain`.  Neither touches the incoming state.  Float32 only.
When a gradient is wanted the call goes through `_ChunkRetentionFn`, whose
backward re-runs `chunk_retention_plain` under autograd (the recompute
backward of `retention_pallas.py:253-263`; the JAX package has no backward
kernel either).

Layouts: gammas (BH,) per row; q, k (BH, T, dk) with k already scaled by
dk**-0.5; v (BH, T, dv); kv0 (BH, dk, dv); s0 (BH, 1, 1); T % chunk == 0.
Returns (out (BH, T, dv), kv_f, s_f).
"""

from __future__ import annotations

import ctypes

import torch

from fseend_tpu_torch.kernels import _build

# launches of the CUDA kernel since the count was last set to 0
launches = 0


def chunk_retention(gammas: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, kv0: torch.Tensor, s0: torch.Tensor, chunk: int):
    """Launches the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    _check(gammas, q, k, v, kv0, s0, chunk)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"chunk_retention: unsupported device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, kv0, s0)):
        return _ChunkRetentionFn.apply(gammas, q, k, v, kv0, s0, chunk)
    return _forward(gammas, q, k, v, kv0, s0, chunk)


def _forward(gammas, q, k, v, kv0, s0, chunk):
    if q.device.type == "cpu":
        return chunk_retention_plain(gammas, q, k, v, kv0, s0, chunk)
    return _launch(gammas, q, k, v, kv0, s0, chunk)


def recompute_grads(plain, inputs, needs, grads_out):
    """Backward of a kernel that has no backward of its own: re-run
    `plain(*inputs)` under autograd and return the gradients of the inputs
    flagged in `needs` (None for the others) given the output gradients
    `grads_out`."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(bool(n)) for t, n in zip(inputs, needs)]
        outs = plain(*ins)
    pairs = [(o, g) for o, g in zip(outs, grads_out) if o.requires_grad and g is not None]
    wanted = [t for t in ins if t.requires_grad]
    got = iter(torch.autograd.grad([o for o, _ in pairs], wanted, [g for _, g in pairs],
                                   allow_unused=True))
    return [next(got) if t.requires_grad else None for t in ins]


class _ChunkRetentionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gammas, q, k, v, kv0, s0, chunk):
        ctx.save_for_backward(gammas, q, k, v, kv0, s0)
        ctx.chunk = chunk
        return _forward(gammas, q, k, v, kv0, s0, chunk)

    @staticmethod
    def backward(ctx, *grads_out):
        grads = recompute_grads(lambda *a: chunk_retention_plain(*a, ctx.chunk),
                                ctx.saved_tensors, ctx.needs_input_grad[:6], grads_out)
        return (*grads, None)


def _check(gammas, q, k, v, kv0, s0, chunk):
    BH, T, dk = q.shape
    dv = v.shape[-1]
    want = {"gammas": (BH,), "q": (BH, T, dk), "k": (BH, T, dk), "v": (BH, T, dv),
            "kv0": (BH, dk, dv), "s0": (BH, 1, 1)}
    got = {"gammas": gammas, "q": q, "k": k, "v": v, "kv0": kv0, "s0": s0}
    for name, shape in want.items():
        t = got[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"chunk_retention: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != torch.float32:
            raise ValueError(f"chunk_retention: {name} is {t.dtype}; float32 only")
        if t.device != q.device:
            raise ValueError(f"chunk_retention: {name} is on {t.device}, q on {q.device}")
    if chunk <= 0 or T % chunk:
        raise ValueError(f"chunk_retention: T={T} is not a multiple of chunk={chunk}")


def _launch(gammas, q, k, v, kv0, s0, chunk):
    global launches
    BH, T, dk = q.shape
    dv = v.shape[-1]
    if dk % 16 or dv % 16:
        raise ValueError(f"chunk_retention: head dims {dk}, {dv} must be multiples of 16")
    lib = _build.load("chunk_retention", {"CR_DK": dk, "CR_DV": dv})
    fn = lib.chunk_retention_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    gammas, q, k, v, kv0, s0 = (t.contiguous() for t in (gammas, q, k, v, kv0, s0))
    out = torch.empty_like(v)
    kv_f, s_f = torch.empty_like(kv0), torch.empty_like(s0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(gammas.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), kv0.data_ptr(), s0.data_ptr(), kv_f.data_ptr(),
                 s_f.data_ptr(), BH, T, chunk, stream)
    _build.check(lib, err, "chunk_retention")
    launches += 1
    return out, kv_f, s_f


def chunk_retention_plain(gammas: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, kv0: torch.Tensor, s0: torch.Tensor,
                          chunk: int):
    """The TPU kernel's arithmetic with batched tensor ops: rows batched,
    chunks in a Python loop.  gamma**x is exp(x * log gamma), exactly 1 for
    gamma = 1."""
    BH, T, dk = q.shape
    L = chunk
    lg = torch.log(gammas).reshape(BH, 1, 1)
    i = torch.arange(L, dtype=torch.float32, device=q.device)
    delta = i[:, None] - i[None, :]
    tri = delta >= 0
    decay = torch.where(tri, torch.exp(lg * delta.clamp(min=0)), 0.0)   # (BH, L, L)
    scale_vec = torch.sqrt(decay.sum(-1, keepdim=True))                # (BH, L, 1)
    mask = decay / scale_vec
    scale_last = scale_vec[:, -1:]
    inner_decay = torch.exp(lg * (i + 1.0)[:, None]) * scale_last / scale_vec
    last_row = torch.exp(lg * (L - 1 - i)[:, None]) / scale_last       # (BH, L, 1)
    cross_decay = torch.exp(lg * float(L))
    kv, s = kv0, s0
    outs = []
    for n in range(T // L):
        sl = slice(n * L, (n + 1) * L)
        qc, kc, vc = q[:, sl], k[:, sl], v[:, sl]
        qk = (qc @ kc.transpose(1, 2)) * mask
        inner_scale = qk.detach().abs().sum(-1, keepdim=True).clamp(min=1.0)
        inner = (qk / inner_scale) @ vc
        cross = ((qc * inner_decay) @ kv) / s
        all_scale = torch.maximum(inner_scale, s)
        outs.append(inner * (inner_scale / all_scale) + cross * (s / all_scale))
        kv = kv * cross_decay + kc.transpose(1, 2) @ (vc * last_row)
        s = kv.detach().abs().sum(1, keepdim=True).amax(2, keepdim=True).clamp(min=1.0)
    return torch.cat(outs, dim=1), kv, s
