"""Batched multi-stream streaming runtime for LS-EEND and FS-EEND — the
serving path.

Port of `fseend_tpu/serving/runtime.py`: `StreamingServer` (per-frame
semantics, frame-level latency) and `BlockStreamingServer` (K frames per
step, one block of lag, the throughput mode).  N independent audio streams
are served by one model whose stream state has a leading lane axis; a block
of K frames advances every lane at once, each lane with its own clock and
flush schedule; lanes are reset one by one when a new stream takes them.

LS-EEND: with `frame_kernel` (the default) a block runs through
`ls_eend.ls_stream_block_fused`: on the card, the encoder and the decoder
are one CUDA frame-scan launch each per block, and `step()` is a block of
one frame (`frame_kernel_enc=False` keeps the decoder's kernel and runs
the encoder as the plain per-frame scan).  With
`frame_kernel=False` a block is the plain per-frame scan of
`ls_stream_step`, the oracle the kernel path is tested against.

FS-EEND: with `fs_fast` (the default) a block runs as L-frame sub-blocks of
`fs_eend.fs_framestream_block` (per-frame-exact; L the largest divisor of K
up to 128, or `fs_fast_chunk`), and `step()` is a one-frame fast block; with
`cfg.use_flash_attn` (the port's default) every layer's cached attention is
one `cached_attention_perlane` CUDA launch.  `fs_fast=False` is the frame
scan of `fs_stream_step`, the oracle.  The blockwise FS server runs
`fs_eend.fs_blockstream_step` (its encoder through `cached_attention`).
The server's `cfg` decides the route, not the config its model was made
with.

`dtype`: float32, or bf16 (the JAX package serves in bf16): a bf16 server
keeps its stream state and a bf16 copy of the model
(`utils/convert.py:cast_model`), casts the frames to bf16 on the way in,
runs the bf16 forms of the kernels (LS: both frame scans per frame, the
retention layer or the chunkwise core blockwise; FS: the per-lane cached
attention in the fast block and `step()`, the shared-head one in the
blockwise encoder) or the plain routes in bf16, and returns probabilities
in float32.

Lane sharding (`mesh`, or `shard_server_over_mesh`; the JAX package's
`shard_server_over_mesh`): every stream-state leaf is lane-major, so a
server splits its lanes evenly over the devices of a one-process mesh
(`parallel/mesh.py:make_mesh(devices=...)`) with no collective.  Each
shard is a server of its own on its device, with its own copy of the model
and its lanes' state, running its kernels there; a block is split by
lanes and the shards' probabilities are gathered on the mesh's first
device.  The shards' kernels see fewer rows than the whole server's, and
`kernels/csrc/tc_f32.cuh` picks its split of a product's k axis from the
row count, so a sharded server equals the unsharded one to float32
rounding, not bit for bit.  A mesh with a "model" axis shards the lanes
over "data" and replicates the parameters over "model", as the JAX
function does: each data shard runs on the first device of its grid row,
so it serves what the mesh without the model axis serves.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any

import numpy as np
import torch

from fseend_tpu_torch.models import fs_eend, ls_eend
from fseend_tpu_torch.parallel.mesh import Mesh
from fseend_tpu_torch.utils.convert import cast_model

# per-lane state tensors whose lane axis is 0; every other leaf leads with
# the layer axis and has lanes (or lanes x slots) on axis 1
_LANE_AXIS0 = ("t", "emitted", "cnn_buf", "conv_buf")


def _check_dtype(dtype) -> None:
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype {dtype}: the servers serve float32 or bfloat16")


def _served_model(model, dtype):
    """The model a server runs: `model` itself in float32, a bf16 copy for
    a bf16 server (the caller's module is left as it is)."""
    if dtype == torch.float32:
        return model
    return cast_model(copy.deepcopy(model), dtype)


def _check_kind(kind: str, cfg, model) -> None:
    want = {"ls": (ls_eend.LSEENDConfig, ls_eend.LSEEND),
            "fs": (fs_eend.FSEENDConfig, fs_eend.FSEEND)}
    if kind not in want:
        raise ValueError(f"unknown model kind {kind!r}: 'ls' or 'fs'")
    if not (isinstance(cfg, want[kind][0]) and isinstance(model, want[kind][1])):
        raise TypeError(f"kind={kind!r} needs a {want[kind][0].__name__} and a "
                        f"{want[kind][1].__name__}, got {type(cfg).__name__} and "
                        f"{type(model).__name__}")


def _lane_shards(server) -> list:
    """One server per device of `server.mesh`, each over its slice of the
    lanes with its own copy of the model."""
    mesh = server.mesh
    if not isinstance(mesh, Mesh) or mesh.group is not None:
        raise TypeError(f"lane sharding runs on a one-process mesh over devices "
                        f"(parallel/mesh.py:make_mesh(devices=...)), got {mesh!r}")
    n = mesh.n_data
    if server.n_lanes % n:
        raise ValueError(f"{server.n_lanes} lanes do not split evenly over {n} devices")
    return [dataclasses.replace(server, model=copy.deepcopy(server.model),
                                n_lanes=server.n_lanes // n, device=d, mesh=None)
            for d in mesh.devices]


def _lanes_of(x, shards: list, i: int, lane_ndim: int):
    """Shard i's part of a per-call argument: its lanes when x has
    `lane_ndim` dims (lanes leading), else x itself (shared by all lanes)."""
    if x is None or np.ndim(x) < lane_ndim:
        return x
    m = len(x) // len(shards)
    return x[i * m:(i + 1) * m]


def _gathered(parts: list, device, dims: tuple):
    """The shards' results, each a tuple of tensors with lanes on `dims`,
    concatenated on `device`."""
    return tuple(torch.cat([p[j].to(device) for p in parts], dim=d) for j, d in enumerate(dims))


def _reset_sharded(shards: list, lanes, n_lanes: int) -> None:
    m = n_lanes // len(shards)
    lanes = np.asarray(lanes, np.int64).reshape(-1)
    for i, shard in enumerate(shards):
        mine = lanes[(lanes >= i * m) & (lanes < (i + 1) * m)] - i * m
        if len(mine):
            shard.reset_lanes(mine)


def shard_server_over_mesh(server, mesh: Mesh):
    """The server with its lanes sharded over the devices of `mesh` (module
    docstring); call it on a fresh server, as the JAX function.  Returns a
    new server of the same class; `server` is left as it is."""
    return dataclasses.replace(server, mesh=mesh)


@dataclasses.dataclass
class StreamingServer:
    """Multi-stream server over one model family."""

    kind: str                 # "ls" | "fs"
    cfg: Any                  # LSEENDConfig | FSEENDConfig
    model: Any                # LSEEND | FSEEND
    n_lanes: int
    n_slots: int
    dtype: Any = torch.float32
    # LS only: the frame-scan kernels.  None = on for LS; asking for it with
    # FS raises (FS per-frame serving is the fast block, `fs_fast`)
    frame_kernel: bool | None = None
    # with frame_kernel: the encoder's frame scan too (False: the plain
    # per-frame encoder scan, the decoder still one kernel call per block)
    frame_kernel_enc: bool = True
    device: Any = None        # None: the card ("cuda"); "cpu" for the tests
    mesh: Any = None          # lane sharding over a one-process mesh (module docstring)
    capacity: int = 4096      # FS only: KV positions per lane (frames per call + delay)
    fs_fast: bool = True      # FS only: the fast block; False = the frame scan
    fs_fast_chunk: int | None = None  # FS only: sub-block length L (None: auto)

    def __post_init__(self):
        _check_kind(self.kind, self.cfg, self.model)
        if self.frame_kernel is None:
            self.frame_kernel = self.kind == "ls"
        if self.frame_kernel and self.kind != "ls":
            raise ValueError(
                "frame_kernel=True is LS-only; FS per-frame serving is the exact "
                "fast block (fs_fast=True, the default) with the cached-attention "
                "kernel under cfg.use_flash_attn")
        _check_dtype(self.dtype)
        if self.mesh is not None:
            self._shards = _lane_shards(self)
            self.device, self.state = self._shards[0].device, None
            return
        self.device = ls_eend.resolve_device(self.device)
        if self.kind == "fs":
            self.model = ls_eend.with_cfg(
                _served_model(self.model.to(self.device).eval(), self.dtype), self.cfg)
            self.state = fs_eend.fs_stream_init(self.cfg, self.n_lanes, self.capacity,
                                                self.n_slots, self.dtype, self.device)
            self._packed = None
            return
        self.model = _served_model(self.model.to(self.device).eval(), self.dtype)
        self.state = ls_eend.ls_stream_init(self.cfg, self.n_lanes, self.n_slots,
                                            self.dtype, self.device)
        self._packed = (ls_eend.pack_weights(self.model) if self.frame_kernel
                        else None)

    def _probs(self, logits: torch.Tensor) -> torch.Tensor:
        """sigmoid + silence-slot drop (dia_pred.py:53-56)."""
        return torch.sigmoid(logits[..., 1:])

    def _frames(self, frames) -> torch.Tensor:
        if isinstance(frames, torch.Tensor):
            return frames.to(self.device, self.dtype)
        return torch.as_tensor(np.ascontiguousarray(frames), dtype=self.dtype,
                               device=self.device)

    def _flush(self, flush, K: int) -> torch.Tensor:
        """None, (K,) shared or (n_lanes, K) per lane -> (K, n_lanes) bool."""
        flush = np.zeros((K,), bool) if flush is None else np.asarray(flush, bool)
        if flush.ndim == 1:
            flush = np.broadcast_to(flush[:, None], (K, self.n_lanes))
        else:
            flush = flush.T
        return torch.as_tensor(np.ascontiguousarray(flush), device=self.device)

    # -- single frame ------------------------------------------------------
    def step(self, frames, flush=False):
        """frames: (n_lanes, in_size) -> (probs (n_lanes, n_slots-1),
        valid (n_lanes,))."""
        if self.mesh is not None:
            sh = self._shards
            return _gathered([s.step(_lanes_of(frames, sh, i, 2), _lanes_of(flush, sh, i, 1))
                              for i, s in enumerate(sh)], self.device, (0, 0))
        if self.frame_kernel or (self.kind == "fs" and self.fs_fast):
            # a one-frame block: the same cache layout as process_block, so
            # step() and blocks interleave on one stream (FS: one fast block
            # of one frame whatever fs_fast_chunk, as the JAX server's step)
            fl = np.broadcast_to(np.asarray(flush, bool), (self.n_lanes,))[:, None]
            xs = self._frames(frames)[:, None]
            if self.kind == "fs":
                with torch.no_grad():
                    probs, valid = self._fs_fast_block(xs, self._flush(fl, 1), 1)
            else:
                probs, valid = self.process_block(xs, fl)
            return probs[:, 0], valid[0]
        x_t = self._frames(frames)
        fl = torch.as_tensor(np.asarray(flush, bool), device=self.device)
        step = fs_eend.fs_stream_step if self.kind == "fs" else ls_eend.ls_stream_step
        self.state, out = step(self.model, self.state, x_t, self.n_slots, fl)
        return self._probs(out["logits"]), out["valid"]

    # -- block of frames (throughput path) ---------------------------------
    @torch.no_grad()
    def process_block(self, frames, flush=None):
        """frames: (n_lanes, K, in_size); flush: None, (K,) shared, or
        (n_lanes, K) per lane.  Returns (probs (n_lanes, K, n_slots-1),
        valid (K, n_lanes)) as tensors on the server's device."""
        if self.mesh is not None:
            sh = self._shards
            return _gathered([s.process_block(_lanes_of(frames, sh, i, 3),
                                              _lanes_of(flush, sh, i, 2))
                              for i, s in enumerate(sh)], self.device, (0, 1))
        xs = self._frames(frames)
        K = xs.shape[1]
        flush = self._flush(flush, K)
        if self.kind == "fs" and self.fs_fast:
            return self._fs_fast_block(xs, flush)
        if self.frame_kernel:
            self.state, (logits, valid) = ls_eend.ls_stream_block_fused(
                self.model, self.state, xs, flush, self.n_slots, self._packed,
                enc_kernel=self.frame_kernel_enc)
            return self._probs(logits.transpose(0, 1)), valid
        step = fs_eend.fs_stream_step if self.kind == "fs" else ls_eend.ls_stream_step
        logits, valid = [], []
        for k in range(K):
            self.state, out = step(self.model, self.state, xs[:, k], self.n_slots, flush[k])
            logits.append(out["logits"])
            valid.append(out["valid"])
        return self._probs(torch.stack(logits, dim=1)), torch.stack(valid)

    def _fs_fast_block(self, xs, flush, L=None):
        """L-frame sub-blocks of the exact fast block, so that the plain
        route's (lanes, C, H, L, cap) score tensor stays bounded while the
        caches are read once per sub-block, not once per frame.  L:
        `fs_fast_chunk`, else the largest divisor of K up to 128."""
        K = xs.shape[1]
        L = L or self.fs_fast_chunk or max(d for d in range(1, min(K, 128) + 1) if K % d == 0)
        if K % L:
            raise ValueError(f"block of {K} frames is not a multiple of fs_fast_chunk={L}")
        flush_bk = flush.transpose(0, 1)                         # (B, K)
        logits, valid = [], []
        for s in range(0, K, L):
            self.state, (lg, vd) = fs_eend.fs_framestream_block(
                self.model, self.state, xs[:, s:s + L], self.n_slots, flush_bk[:, s:s + L])
            logits.append(lg)
            valid.append(vd)
        return (self._probs(torch.cat(logits, dim=1)),
                torch.cat(valid, dim=1).transpose(0, 1))

    # -- lane management ---------------------------------------------------
    def reset_lanes(self, lanes) -> None:
        """Reset the given lanes to fresh-stream state: every per-lane tensor
        (LS: retention states, conv histories, the cnn window; FS: KV caches,
        the cnn window) and the lane's clocks, over the lane axis and the
        lanes x slots axis of the LS decoder.  A fresh state is all zeros, so
        a reused lane reproduces a fresh server bit for bit while its
        neighbours continue untouched."""
        if self.mesh is not None:
            return _reset_sharded(self._shards, lanes, self.n_lanes)
        idx = torch.as_tensor(np.asarray(lanes, np.int64).reshape(-1), device=self.device)
        slots = (idx[:, None] * self.n_slots
                 + torch.arange(self.n_slots, device=self.device)).reshape(-1)
        for key, t in self.state.items():
            if key in _LANE_AXIS0:
                t.index_fill_(0, idx, 0)
            elif self.kind == "fs":
                t.index_fill_(1, idx, 0)
            else:
                t.index_fill_(1, slots if key.startswith("dec_") else idx, 0)


def stream_file(server: StreamingServer, feats: np.ndarray, block: int = 128):
    """Run one recording through lane-broadcast streaming, returning
    time-aligned probabilities (T, n_slots-1) (handles the conv-delay
    flush)."""
    T, Fdim = feats.shape
    delay = server.cfg.conv_delay
    xs = np.broadcast_to(feats[None], (server.n_lanes, T, Fdim))
    pad = np.zeros((server.n_lanes, delay, Fdim), feats.dtype)
    xs = np.concatenate([xs, pad], axis=1)
    flush = np.arange(T + delay) >= T
    probs = []
    for st in range(0, T + delay, block):
        ed = min(st + block, T + delay)
        p, _ = server.process_block(xs[:, st:ed], flush[st:ed])
        probs.append(p[0].cpu().numpy())
    return np.concatenate(probs, axis=0)[delay:]


@dataclasses.dataclass
class BlockStreamingServer:
    """Blockwise streaming server: consumes fixed-size K-frame blocks per
    lane and emits the previous block's probabilities (one-block lag; see
    the blockwise sections of models/ls_eend.py and models/fs_eend.py).  The
    highest-throughput serving mode; `StreamingServer` is the one with
    frame-level latency.

    LS lanes carry O(1) chunkwise-retention state, and the result equals the
    batch chunkwise pass with chunk_size = block.  `cfg.kernel` picks the
    retention route; with "fused" (the default) every retention layer of a
    block is one `kernels/retention_layer.py` call, a CUDA kernel on the
    card.  FS lanes carry KV caches of `capacity` positions with one shared
    clock and equal the masked batch pass; with `cfg.use_flash_attn` (the
    default) the encoder's cached attention is one `cached_attention` call
    per layer.  Either family serves in float32 or bf16, LS on every
    route."""

    kind: str                 # "ls" | "fs"
    cfg: Any
    model: Any
    n_lanes: int
    n_slots: int
    block: int = 100
    dtype: Any = torch.float32
    device: Any = None        # None: the card ("cuda"); "cpu" for the tests
    capacity: int = 4096      # FS only: KV positions (frames per call)
    mesh: Any = None          # lane sharding over a one-process mesh (module docstring)

    def __post_init__(self):
        _check_kind(self.kind, self.cfg, self.model)
        _check_dtype(self.dtype)
        if self.mesh is not None:
            self._shards = _lane_shards(self)
            self.device, self.state = self._shards[0].device, None
            return
        self.device = ls_eend.resolve_device(self.device)
        # the server's config decides the route, whatever config the model came with
        self.model = ls_eend.with_cfg(
            _served_model(self.model.to(self.device).eval(), self.dtype), self.cfg)
        self.reset_all()
        self._packed = (ls_eend.pack_block_weights(self.model)
                        if self.kind == "ls" and self.cfg.kernel == "fused" else None)

    def fresh_state(self) -> dict:
        """A pristine per-stream state (what reset_all installs)."""
        if self.kind == "fs":
            return fs_eend.fs_blockstream_init(self.cfg, self.n_lanes, self.capacity,
                                               self.n_slots, self.block, self.dtype,
                                               self.device)
        return ls_eend.ls_blockstream_init(self.cfg, self.n_lanes, self.n_slots,
                                           self.block, self.dtype, self.device)

    @torch.no_grad()
    def process_block(self, frames, flush: bool = False, h_mask=None) -> torch.Tensor:
        """frames: (n_lanes, block, in_size) -> probabilities of the PREVIOUS
        block (n_lanes, block, n_slots-1), a tensor on the server's device.
        A lane's first output is warm-up garbage; with flush=True a
        zero-embedding block drains the tail.  h_mask, (block,) for all lanes
        or (n_lanes, block) per lane, marks the valid frames: pass it on a
        zero-padded final partial block for exact parity with the batch
        pass."""
        if self.mesh is not None:
            sh = self._shards
            return _gathered([(s.process_block(_lanes_of(frames, sh, i, 3), flush,
                                               _lanes_of(h_mask, sh, i, 2)),)
                              for i, s in enumerate(sh)], self.device, (0,))[0]
        if isinstance(frames, torch.Tensor):
            xs = frames.to(self.device, self.dtype)
        else:
            xs = torch.as_tensor(np.ascontiguousarray(frames), dtype=self.dtype,
                                 device=self.device)
        if tuple(xs.shape[:2]) != (self.n_lanes, self.block):
            raise ValueError(f"frames {tuple(xs.shape)}: expected "
                             f"({self.n_lanes}, {self.block}, in_size)")
        if h_mask is not None:
            h_mask = torch.as_tensor(np.asarray(h_mask, bool), device=self.device)
        if self.kind == "fs":
            if not flush:
                # the caches have a fixed capacity and a write past it is
                # clamped onto the tail: fail loudly instead (a flush block
                # skips the encoder and writes nothing to its caches)
                if self._frames_fed + self.block > self.capacity:
                    raise ValueError(
                        f"FS blockwise stream exceeds KV capacity: {self._frames_fed} "
                        f"frames fed + block {self.block} > capacity {self.capacity}; "
                        f"raise `capacity` or reset_all() between calls")
                self._frames_fed += self.block
        self.state, probs = self.block_step(self.state, xs, bool(flush), h_mask)
        return probs

    def block_step(self, state: dict, xs: torch.Tensor, flush: bool, h_mask):
        """One block as a function of the state: (state, frames (n_lanes,
        block, in_size) on the device, flush, h_mask or None) -> (new state,
        probabilities with the silence slot dropped).  `process_block` runs
        it; `serving/aot.py` exports it (once with flush, once without).
        A lane-sharded server has one state per shard: export a shard."""
        if self.mesh is not None:
            raise ValueError("block_step of a lane-sharded server: call it on a shard")
        if self.kind == "fs":
            state, logits = fs_eend.fs_blockstream_step(
                self.model, state, xs, self.n_slots, enc_bypass=flush, h_mask=h_mask)
        else:
            state, logits = ls_eend.ls_blockstream_step(
                self.model, state, xs, self.n_slots, enc_bypass=flush, h_mask=h_mask,
                packed=self._packed)
        return state, torch.sigmoid(logits[..., 1:])

    def blocks_consumed(self) -> int:
        if self.mesh is not None:
            return max(s.blocks_consumed() for s in self._shards)
        return int(self.state["m"].max())

    def reset_all(self) -> None:
        """Fresh state for every lane."""
        if self.mesh is not None:
            for s in self._shards:
                s.reset_all()
            return
        self.state = self.fresh_state()
        self._frames_fed = 0    # FS capacity guard (non-flush blocks)

    def reset_lanes(self, lanes) -> None:
        """Reset the given LS lanes to fresh-stream state (gamma = 1
        retention state does not depend on the position, so a per-lane reset
        is exact): zeros, ones for the retention scales, over both the lane
        axis and the lanes x slots axis of the decoder.  The lane's block
        counter returns to 0, so its next block is gated as a warm-up block
        again.  FS lanes share one clock: use reset_all()."""
        if self.kind != "ls":
            raise ValueError("per-lane reset is LS-only (FS KV caches are "
                             "position-dependent and share one clock); use reset_all()")
        if self.mesh is not None:
            return _reset_sharded(self._shards, lanes, self.n_lanes)
        idx = torch.as_tensor(np.asarray(lanes, np.int64).reshape(-1), device=self.device)
        slots = (idx[:, None] * self.n_slots
                 + torch.arange(self.n_slots, device=self.device)).reshape(-1)
        for key, t in self.state.items():
            fill = 1 if key.endswith("_scale") else 0
            if key in ("m", "h_prev", "h_tail2"):
                t.index_fill_(0, idx, fill)
            else:
                t.index_fill_(1, slots if key.startswith("dec_") else idx, fill)
