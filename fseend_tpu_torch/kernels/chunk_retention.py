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
notes there and in `csrc/chunk_retention_tc.cuh`); on a CPU tensor it runs
`chunk_retention_plain`.  Neither touches the incoming state.

Float32 or bf16: q, k, v and the state (kv0, s0) share one dtype, gammas
is float32.  The bf16 form (the same source built with FS_BF16) computes as
`retention_pallas.py` does on bf16 data: the scores from the bf16 values in
float32, the rest in float32, the state carried in float32 within the call
and returned in bf16, the output rounded to bf16; so does the plain
version.  At head dims 64 the bf16 build is `csrc/ret16.cuh`'s core (its
float32 operands as three bf16 terms on the tensor cores; its order of work
mirrored in tests/test_torch_port_ret16_order.py).  The scratch is float32
in either form.
`chunk_retention_passes` is the kernel's algorithm (the state scanned over
the chunks' summaries, the output per 64-query tile) in plain tensor ops,
for the tests.
When a gradient is wanted the call goes through `_ChunkRetentionFn`, whose
backward re-runs `chunk_retention_plain` under autograd (the recompute
backward of `retention_pallas.py:253-263`; the JAX package has no backward
kernel either).  JAX differentiates its pure core (`_pure_core`), which in
float32 is this plain version and in bf16 rounds v / sqrt(L) to bf16
before the state update: the recompute takes `pure=True`.

Layouts: gammas (BH,) per row; q, k (BH, T, dk) with k already scaled by
dk**-0.5; v (BH, T, dv); kv0 (BH, dk, dv); s0 (BH, 1, 1); T % chunk == 0.
Returns (out (BH, T, dv), kv_f, s_f).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from fseend_tpu_torch.kernels import _build
from fseend_tpu_torch.kernels._dtype import build_defines

# launches of the CUDA kernel since the count was last set to 0: its
# float32 form, its bf16 form
launches = 0
launches_bf16 = 0


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
        grads = recompute_grads(lambda *a: chunk_retention_plain(*a, ctx.chunk, pure=True),
                                ctx.saved_tensors, ctx.needs_input_grad[:6], grads_out)
        return (*grads, None)


def _check(gammas, q, k, v, kv0, s0, chunk):
    BH, T, dk = q.shape
    dv = v.shape[-1]
    want = {"gammas": (BH,), "q": (BH, T, dk), "k": (BH, T, dk), "v": (BH, T, dv),
            "kv0": (BH, dk, dv), "s0": (BH, 1, 1)}
    got = {"gammas": gammas, "q": q, "k": k, "v": v, "kv0": kv0, "s0": s0}
    dt = q.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"chunk_retention: q is {dt}; the kernel takes float32 or bfloat16")
    for name, shape in want.items():
        t = got[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"chunk_retention: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != (torch.float32 if name == "gammas" else dt):
            raise ValueError(f"chunk_retention: mixed dtypes: {name} is {t.dtype}, q {dt} "
                             f"(gammas is float32)")
        if t.device != q.device:
            raise ValueError(f"chunk_retention: {name} is on {t.device}, q on {q.device}")
    if chunk <= 0 or T % chunk:
        raise ValueError(f"chunk_retention: T={T} is not a multiple of chunk={chunk}")


def aligned(t: torch.Tensor) -> torch.Tensor:
    """`t` (contiguous), copied when its data does not start on 16 bytes: the
    kernels read their operands with 16-byte asynchronous copies."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(gammas, q, k, v, kv0, s0, chunk):
    global launches, launches_bf16
    BH, T, dk = q.shape
    dv = v.shape[-1]
    if dk % 16 or dv % 16 or dk > 128 or dv > 128:
        raise ValueError(f"chunk_retention: head dims {dk}, {dv} must be multiples of 16, "
                         f"at most 128")
    lib = _build.load("chunk_retention", build_defines(q.dtype, CR_DK=dk, CR_DV=dv))
    fn = lib.chunk_retention_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    gammas, q, k, v, kv0, s0 = (aligned(t.contiguous()) for t in (gammas, q, k, v, kv0, s0))
    out = torch.empty_like(v)
    kv_f, s_f = torch.empty_like(kv0), torch.empty_like(s0)
    N = T // chunk
    # the chunks' summaries and scales, when there is more than one chunk
    scratch = (torch.empty(BH * N * (dk * dv + 1), dtype=torch.float32, device=q.device)
               if N > 1 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(gammas.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), kv0.data_ptr(), s0.data_ptr(), kv_f.data_ptr(),
                 s_f.data_ptr(), None if scratch is None else scratch.data_ptr(),
                 BH, T, chunk, stream)
    _build.check(lib, err, "chunk_retention")
    if q.dtype == torch.bfloat16:
        launches_bf16 += 1
    else:
        launches += 1
    return out, kv_f, s_f


def chunk_retention_plain(gammas: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, kv0: torch.Tensor, s0: torch.Tensor,
                          chunk: int, pure: bool = False):
    """The TPU kernel's arithmetic with batched tensor ops: rows batched,
    chunks in a Python loop.  gamma**x is exp(x * log gamma), exactly 1 for
    gamma = 1.  bf16: the same arithmetic in float32 on the bf16 values
    (the scores are sums of exact products), the output rounded to bf16 and
    the state to bf16 at the end (`retention_pallas.py:57-59,
    94-95, 111-112`); with `pure`, the JAX package's `_pure_core`
    (`retention_pallas.py:200-241`, what its gradient differentiates): v
    times the last mask row rounded to bf16 before the state update."""
    dt = q.dtype
    kv, s = kv0, s0
    if dt == torch.bfloat16:
        q, k, v, kv, s = (t.float() for t in (q, k, v, kv, s))
    round_v = pure and dt == torch.bfloat16
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
        vl = vc * last_row
        if round_v:
            vl = vl.to(dt).float()
        kv = kv * cross_decay + kc.transpose(1, 2) @ vl
        s = kv.detach().abs().sum(1, keepdim=True).amax(2, keepdim=True).clamp(min=1.0)
    return torch.cat(outs, dim=1).to(dt), kv.to(kv0.dtype), s.to(s0.dtype)


TILE = 64     # frames of a query tile and of a k/v tile (csrc/chunk_retention_tc.cuh:kTile)
SLICE = 32    # frames a warp sums into a fresh accumulator


def chunk_retention_passes(gammas: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, kv0: torch.Tensor, s0: torch.Tensor,
                           chunk: int):
    """The CUDA kernel's algorithm (csrc/chunk_retention_tc.cuh) in plain
    tensor ops and in its fixed order, rows batched: each chunk zero-padded
    to whole 64-frame tiles; (a) every chunk's summary U_m = K_m^T (V_m *
    last mask row), summed over 32-frame slices in order; (b) the state
    before each chunk, KV_n = KV_{n-1} gamma^L + U_{n-1}, and its scale, in
    chunk order; (c) per (chunk, 64-query tile) two sums of their own, each
    starting from the cross read idec * (q KV_n) over one half of dk and
    taking one 32-frame half of each k/v tile at or before the query tile
    (its masked scores, absolute row sums and S V), the second added to the
    first at the end.  Same arguments and results as
    `chunk_retention_plain`."""
    BH, T, dk = q.shape
    dv = v.shape[-1]
    L, N = chunk, T // chunk
    nqt = -(-L // TILE)
    Lp = nqt * TILE

    def chunks(t):                                  # (BH, T, d) -> (BH, N, Lp, d)
        return F.pad(t.reshape(BH, N, L, t.shape[-1]), (0, 0, 0, Lp - L))

    qp, kp, vp = chunks(q), chunks(k), chunks(v)
    lg = torch.log(gammas).reshape(BH, 1)
    i = torch.arange(Lp, dtype=q.dtype, device=q.device)
    sv = torch.sqrt(torch.cumsum(torch.exp(lg * i), dim=1))              # (BH, Lp)
    svl = torch.sqrt(torch.exp(lg * i[:L]).sum(dim=1, keepdim=True))   # (BH, 1)
    rsv = 1.0 / sv
    # (a)
    lr = torch.where(i < L, torch.exp(lg * (L - 1 - i)) / svl, 0.0)    # (BH, Lp)
    vl = vp * lr[:, None, :, None]
    U = sum(kp[:, :, j:j + SLICE].transpose(2, 3) @ vl[:, :, j:j + SLICE]
            for j in range(0, Lp, SLICE))                              # (BH, N, dk, dv)
    # (b)
    cd = torch.exp(lg * float(L))[:, :, None]
    kv, c = kv0, s0.reshape(BH, 1)
    states = []
    for m in range(N):
        states.append((kv, c))
        kv = kv * cd + U[:, m]
        c = kv.abs().sum(1).amax(1, keepdim=True).clamp(min=1.0)
    # (c)
    out = q.new_zeros(BH, N, Lp, dv)
    for n, (kvn, cn) in enumerate(states):
        for it in range(nqt):
            rows = slice(it * TILE, (it + 1) * TILE)
            qt, ii = qp[:, n, rows], i[rows]
            idec = torch.where(ii < L, torch.exp(lg * (ii + 1)) * svl / sv[:, rows], 0.0)
            acc = [(qt[..., h] @ kvn[:, h]) * idec[..., None]
                   for h in (slice(0, dk // 2), slice(dk // 2, dk))]
            rowabs = [0.0, 0.0]
            for jt in range(it + 1):
                for hf in range(2):
                    cols = slice(jt * TILE + hf * SLICE, jt * TILE + (hf + 1) * SLICE)
                    delta = ii[:, None] - i[None, cols]
                    mask = torch.where(delta >= 0, torch.exp(lg[..., None] * delta.clamp(min=0)),
                                       0.0) * rsv[:, rows, None]
                    s = (qt @ kp[:, n, cols].transpose(1, 2)) * mask
                    rowabs[hf] = rowabs[hf] + s.abs().sum(-1)
                    acc[hf] = acc[hf] + s @ vp[:, n, cols]
            inner = (rowabs[0] + rowabs[1]).clamp(min=1.0)
            out[:, n, rows] = (acc[0] + acc[1]) / torch.maximum(inner, cn)[..., None]
    return out[:, :, :L].reshape(BH, T, dv), kv, c.reshape(BH, 1, 1)
