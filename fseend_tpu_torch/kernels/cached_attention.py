"""Attention of K queries against a fixed-capacity KV cache: the CUDA
kernel's two wrappers and their plain PyTorch versions.

Replaces `fseend_tpu/kernels/cached_attention_pallas.py`:
  * `cached_attention_perlane` <- `flash_cached_attention_perlane` (one
    write head per lane and a `min_pos` floor; FS-EEND's per-frame-exact
    fast block, every encoder and decoder layer);
  * `cached_attention` <- `flash_cached_attention` / `cached_attention_block`
    (one write head shared by every row, no floor; the encoder of FS-EEND's
    blockwise step).
Query i of row r sits at qpos = start + i (start of r's lane for the
per-lane form) and reads the cache positions p with
(min_pos <= p <= qpos) or p == qpos: the self position is always readable,
so a pre-warm-up decoder query (qpos < min_pos) reads its own value and no
row is empty.  Softmax in float32 with the 1/sqrt(hd) scale after the dot.

On a CUDA tensor each wrapper launches `csrc/cached_attention.cu` (one source,
two entry points; design notes there: a block of K > 1 queries on the tensor
cores, float32-exact, for both forms; the per-lane form's K = 1 calls
(`step()`) streaming the cache on the FMA pipe, split over the cache when
the rows alone do not fill the card, into scratch allocated here); on a CPU
tensor it runs the plain version, the masked `mha_core` form the JAX
package's non-flash paths use.  Forward only; hd <= 128.

Float32 or bf16: q, k and v share one dtype (`_dtype.check_dtypes`).  The
bf16 form (the same source built with FS_BF16; hd a multiple of 16)
computes as `cached_attention_pallas.py` does on bf16 data: the scores and
the softmax in float32, the unnormalized probabilities rounded to bf16
before the value product while the row sum adds them unrounded, the output
rounded to bf16.  Its plain version is that arithmetic (`_attend_bf16`),
not `mha_core`'s bf16 form, which rounds the normalized weights: over one
kv block of the whole cache by default (`block_kv` = cap), or over the
kernel's own tiles and splits (`kernel_tiling`), where each probability is
rounded at the running max the kernel has reached.  The K = 1 path's
scratch is float32 in either form.
The shared-head form is the custom op `torch.ops.fseend_tpu_torch.cached_attention`
(CUDA implementation: the launch; CPU: the plain version; fake: the output
shape), so that `torch.export` can trace the blockwise FS server through it
(`serving/aot.py`); the per-lane form serves only the per-frame server,
which is not exported, and stays a direct call.

Layouts: q (R, K, hd); k, v (R, cap, hd) with the block's keys and values
already written; rows lane-major (`rows_per_lane` consecutive rows share a
lane); start (R // rows_per_lane,) int32 per lane, or one int for the
shared head.  Returns (R, K, hd).
"""

from __future__ import annotations

import ctypes
import math

import torch

from fseend_tpu_torch.kernels import _build
from fseend_tpu_torch.kernels._dtype import build_defines, check_dtypes
from fseend_tpu_torch.kernels.chunk_retention import aligned
from fseend_tpu_torch.ops import nn as tnn

# launches of each CUDA entry point since the count was last set to 0: the
# float32 forms, the bf16 forms
launches = 0                 # cached_attention (shared write head)
perlane_launches = 0         # cached_attention_perlane
launches_bf16 = 0
perlane_launches_bf16 = 0

MAX_HD = 128
_NEG = -1e30     # the kernels' finite stand-in for -inf
# csrc/cached_attention.cu: positions per online-softmax tile at K > 1
# (kTcKV) and at K = 1 (kSplitT), and the blocks that fill the card, below
# which the K = 1 path splits the cache (kFillBlocks); both forms
TC_TILE, SPLIT_TILE, FILL_BLOCKS = 64, 128, 132 * 8


def cached_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     start) -> torch.Tensor:
    """Shared write head `start` (an int or a one-element int tensor):
    query i reads positions <= start + i.  Launches the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    _check("cached_attention", q, k, v)
    return cached_attention_op(q, k, v, _start_tensor(start, q.device, 1))


@torch.library.custom_op("fseend_tpu_torch::cached_attention", mutates_args=(),
                         device_types="cpu")
def cached_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        start: torch.Tensor) -> torch.Tensor:
    """The custom op; this body is its CPU implementation (the plain
    version)."""
    return cached_attention_plain(q, k, v, start)


@cached_attention_op.register_kernel("cuda")
def _op_cuda(q, k, v, start):
    return _launch(q, k, v, start, q.shape[0], 0, perlane=False)


@cached_attention_op.register_fake
def _op_fake(q, k, v, start):
    return torch.empty_like(q)


def cached_attention_perlane(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             start: torch.Tensor, rows_per_lane: int,
                             min_pos: int = 0) -> torch.Tensor:
    """Per-lane write heads `start` (R // rows_per_lane,): query i of lane b
    reads positions p with (min_pos <= p <= start[b] + i) or
    p == start[b] + i.  Launches the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    R = _check("cached_attention_perlane", q, k, v)
    if rows_per_lane <= 0 or R % rows_per_lane:
        raise ValueError(f"cached_attention_perlane: {R} rows are not a multiple of "
                         f"rows_per_lane={rows_per_lane}")
    if min_pos < 0:
        raise ValueError(f"cached_attention_perlane: min_pos={min_pos} < 0")
    start = _start_tensor(start, q.device, R // rows_per_lane)
    if q.device.type == "cpu":
        return cached_attention_perlane_plain(q, k, v, start, rows_per_lane, min_pos)
    return _launch(q, k, v, start, rows_per_lane, min_pos, perlane=True)


def _check(name, q, k, v) -> int:
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"{name}: expected q (R, K, hd), k and v (R, cap, hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    R, K, hd = q.shape
    if k.shape[0] != R or k.shape[2] != hd or K < 1 or k.shape[1] < 1:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit the cache "
                         f"{tuple(k.shape)}")
    check_dtypes(name, {"q": q}, {"k": k, "v": v}, {})
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {t.device} and {q.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")
    return R


def _start_tensor(start, device, n: int) -> torch.Tensor:
    start = torch.as_tensor(start, device=device)
    if start.dtype not in (torch.int32, torch.int64) or start.numel() != n:
        raise ValueError(f"cached attention: start must hold {n} integer(s), got "
                         f"{start.dtype} {tuple(start.shape)}")
    return start.to(torch.int32).reshape(n)


def _launch(q, k, v, start, rows_per_lane, min_pos, perlane):
    global launches, perlane_launches, launches_bf16, perlane_launches_bf16
    R, K, hd = q.shape
    cap = k.shape[1]
    bf16 = q.dtype == torch.bfloat16
    if hd > MAX_HD or (bf16 and hd % 16):
        raise ValueError(f"cached attention: head dim {hd}: at most {MAX_HD}"
                         f"{', a multiple of 16 in bf16' if bf16 else ''}")
    lib = _build.load("cached_attention", build_defines(q.dtype, CA_HD=hd))
    q, k, v, start = (aligned(t.contiguous()) for t in (q, k, v, start))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if perlane:
            # the K = 1 path's per-split partials, when it splits the cache
            lib.cached_attention_perlane_scratch.argtypes = [ctypes.c_int] * 3
            lib.cached_attention_perlane_scratch.restype = ctypes.c_size_t
            n = lib.cached_attention_perlane_scratch(R, K, cap)
            part = torch.empty(n, dtype=torch.float32, device=q.device) if n else None
            fn = lib.cached_attention_perlane_launch
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), start.data_ptr(),
                     out.data_ptr(), part.data_ptr() if n else None, R, K, cap,
                     rows_per_lane, min_pos, stream)
        else:
            fn = lib.cached_attention_launch
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), start.data_ptr(),
                     out.data_ptr(), R, K, cap, stream)
    name = "cached_attention_perlane" if perlane else "cached_attention"
    _build.check(lib, err, name)
    if perlane and bf16:
        perlane_launches_bf16 += 1
    elif perlane:
        perlane_launches += 1
    elif bf16:
        launches_bf16 += 1
    else:
        launches += 1
    return out


def kernel_tiling(R: int, K: int, cap: int, dtype=torch.bfloat16, perlane: bool = True) -> dict:
    """The kv tiling of the CUDA kernel's online softmax at (R, K, cap) for
    data of `dtype`, as the bf16 plain versions' `tile` and `split`: tiles
    of 64 positions at K > 1 and for the shared-head form (`perlane`
    False) at any K; the per-lane form's K = 1 calls take tiles of 128, in
    splits of whole tiles when R rows alone do not fill the card
    (`csrc/cached_attention.cu:split_count`).  The bf16 form streams its
    tiles through a deeper ring of copies than the float32 form, but over
    the same tiles and splits, so the plan is one for both dtypes."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel_tiling: no kernel form for {dtype}")
    if K > 1 or not perlane:
        return {"tile": TC_TILE}
    tiles = -(-cap // SPLIT_TILE)
    n = min(1 if R >= FILL_BLOCKS else -(-FILL_BLOCKS // R), tiles)
    return {"tile": SPLIT_TILE, "split": -(-tiles // n) * SPLIT_TILE}


def cached_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           start, mha: bool = False, tile: int | None = None,
                           split: int | None = None) -> torch.Tensor:
    """The masked `mha_core` form (`fs_eend.py:400-403`): an additive
    (K, cap) mask, -inf past start + i.  Any leading dims.  In bf16 the
    Pallas kernel's arithmetic (`_attend_bf16`, over kv tiles of `tile`
    positions in splits of `split`, each the whole cache when None), unless
    `mha` asks for `mha_core`'s in every dtype (the servers' plain route,
    the JAX package's XLA path)."""
    K, cap = q.shape[-2], k.shape[-2]
    start = torch.as_tensor(start, device=q.device).reshape(())
    pos = torch.arange(cap, device=q.device)[None, :]
    qpos = start + torch.arange(K, device=q.device)[:, None]
    return _attend(q, k, v, pos <= qpos, mha, tile, split)


def cached_attention_perlane_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   start: torch.Tensor, rows_per_lane: int,
                                   min_pos: int = 0, mha: bool = False,
                                   tile: int | None = None,
                                   split: int | None = None) -> torch.Tensor:
    """The masked `mha_core` form (`fs_eend.py:547-561`), self position
    included: one (K, cap) mask per lane, broadcast over the lane's rows.
    In bf16 the Pallas kernel's arithmetic, unless `mha` (`tile`, `split`
    and `mha` as in `cached_attention_plain`)."""
    R, K, hd = q.shape
    cap = k.shape[1]
    nl = R // rows_per_lane
    start = torch.as_tensor(start, device=q.device).reshape(nl)
    pos = torch.arange(cap, device=q.device)[None, None, :]
    qpos = start[:, None, None] + torch.arange(K, device=q.device)[None, :, None]
    ok = ((pos <= qpos) & (pos >= min_pos)) | (pos == qpos)          # (nl, K, cap)
    out = _attend(q.reshape(nl, rows_per_lane, K, hd), k.reshape(nl, rows_per_lane, cap, hd),
                  v.reshape(nl, rows_per_lane, cap, hd), ok[:, None], mha, tile, split)
    return out.reshape(R, K, hd)


def _attend(q, k, v, ok, mha, tile, split):
    if q.dtype == torch.bfloat16 and not mha:
        return _attend_bf16(q, k, v, ok, tile, split)
    zero = torch.zeros((), device=q.device)
    return tnn.mha_core(q, k, v, torch.where(ok, zero, float("-inf")))


def _attend_bf16(q, k, v, ok, tile=None, split=None):
    """`cached_attention_pallas.py`'s arithmetic on bf16 q, k, v: s = (q
    k^T) * hd**-0.5 in float32 (exact bf16 products), masked where `ok`
    (broadcast to (..., K, cap)) fails.  The cache is cut into splits of
    `split` positions and each split into tiles of `tile` (the whole cache
    when None), from position 0.  Within a split the softmax is online:
    at each tile m = the running max so far, p = exp(s - m) in float32 (0
    where masked), l and acc rescaled by exp(m_old - m), l += the sum of p,
    acc += (p rounded to bf16) v.  One split: out = acc / l; several: the
    splits' (m, l, acc) merged in order, each weighted by exp(m - the
    largest m), as the kernel's combine does.  Rounded to bf16."""
    cap = k.shape[-2]
    tile, split = tile or cap, split or cap
    s = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    ok = ok.expand(s.shape)
    s = torch.where(ok, s, _NEG)
    vf = v.float()
    parts = []
    for z0 in range(0, cap, split):
        m = torch.full_like(s[..., :1], _NEG)
        l = torch.zeros_like(m)
        acc = torch.zeros(s.shape[:-1] + vf.shape[-1:], device=s.device)
        for j0 in range(z0, min(z0 + split, cap), tile):
            j1 = min(j0 + tile, z0 + split, cap)
            sj = s[..., j0:j1]
            m_new = torch.maximum(m, sj.amax(-1, keepdim=True))
            corr = torch.exp(m - m_new)
            p = torch.where(ok[..., j0:j1], torch.exp(sj - m_new), 0.0)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p.to(v.dtype).float() @ vf[..., j0:j1, :]
            m = m_new
        parts.append((m, l, acc))
    if len(parts) == 1:
        return (acc / l).to(q.dtype)
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    num, den = torch.zeros_like(acc), torch.zeros_like(l)
    for m, l, acc in parts:
        w = torch.exp(m - mx)
        num, den = num + w * acc, den + w * l
    return (num / den).to(q.dtype)
