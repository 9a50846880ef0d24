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
package's non-flash paths use.  Forward only; float32 only; hd <= 128.
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

import torch

from fseend_tpu_torch.kernels import _build
from fseend_tpu_torch.ops import nn as tnn

# launches of each CUDA entry point since the count was last set to 0
launches = 0            # cached_attention (shared write head)
perlane_launches = 0    # cached_attention_perlane

MAX_HD = 128


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
    for t in (q, k, v):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {t.dtype}; float32 only")
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
    global launches, perlane_launches
    R, K, hd = q.shape
    cap = k.shape[1]
    if hd > MAX_HD:
        raise ValueError(f"cached attention: head dim {hd} > {MAX_HD}")
    lib = _build.load("cached_attention", {"CA_HD": hd})
    q, k, v, start = (t.contiguous() for t in (q, k, v, start))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if perlane:
            # the K = 1 path's per-split partials, when it splits the cache
            lib.cached_attention_perlane_scratch.argtypes = [ctypes.c_int] * 3
            lib.cached_attention_perlane_scratch.restype = ctypes.c_size_t
            n = lib.cached_attention_perlane_scratch(R, K, cap)
            part = q.new_empty(n) if n else None
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
    if perlane:
        perlane_launches += 1
    else:
        launches += 1
    return out


def cached_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           start) -> torch.Tensor:
    """The masked `mha_core` form (`fs_eend.py:400-403`): an additive
    (K, cap) mask, -inf past start + i.  Any leading dims."""
    K, cap = q.shape[-2], k.shape[-2]
    start = torch.as_tensor(start, device=q.device).reshape(())
    pos = torch.arange(cap, device=q.device)[None, :]
    qpos = start + torch.arange(K, device=q.device)[:, None]
    zero = torch.zeros((), device=q.device)
    return tnn.mha_core(q, k, v, torch.where(pos <= qpos, zero, float("-inf")))


def cached_attention_perlane_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   start: torch.Tensor, rows_per_lane: int,
                                   min_pos: int = 0) -> torch.Tensor:
    """The masked `mha_core` form (`fs_eend.py:547-561`), self position
    included: one (K, cap) mask per lane, broadcast over the lane's rows."""
    R, K, hd = q.shape
    cap = k.shape[1]
    nl = R // rows_per_lane
    start = torch.as_tensor(start, device=q.device).reshape(nl)
    pos = torch.arange(cap, device=q.device)[None, None, :]
    qpos = start[:, None, None] + torch.arange(K, device=q.device)[None, :, None]
    ok = ((pos <= qpos) & (pos >= min_pos)) | (pos == qpos)          # (nl, K, cap)
    zero = torch.zeros((), device=q.device)
    mask = torch.where(ok, zero, float("-inf"))[:, None]
    out = tnn.mha_core(q.reshape(nl, rows_per_lane, K, hd),
                       k.reshape(nl, rows_per_lane, cap, hd),
                       v.reshape(nl, rows_per_lane, cap, hd), mask)
    return out.reshape(R, K, hd)
