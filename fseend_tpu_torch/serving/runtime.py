"""Batched multi-stream streaming runtime for LS-EEND — the serving path.

Port of `fseend_tpu/serving/runtime.py` for `kind="ls"`: `StreamingServer`
(per-frame semantics, frame-level latency) and `BlockStreamingServer`
(blockwise chunkwise retention, the throughput mode).  N independent
audio streams are served by one model whose stream state has a leading lane
axis (`ls_eend.ls_stream_init`); a block of K frames advances every lane at
once, each lane with its own clock and flush schedule; lanes are reset one
by one when a new stream takes them.

With `frame_kernel` (the default) a block runs through
`ls_eend.ls_stream_block_fused`: on the card, the encoder and the decoder
are one CUDA frame-scan launch each per block, and `step()` is a block of
one frame, so no plain per-frame code serves on the card.  With
`frame_kernel=False` a block is the plain per-frame scan of
`ls_stream_step`, the oracle the kernel path is tested against.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from fseend_tpu_torch.models import ls_eend

# per-lane state tensors whose lane axis is 0; every other leaf leads with
# the layer axis and has lanes (or lanes x slots) on axis 1
_LANE_AXIS0 = ("t", "cnn_buf")


@dataclasses.dataclass
class StreamingServer:
    """Multi-stream server over one model family (LS-EEND only in the port
    so far)."""

    kind: str                 # "ls" ("fs": ROADMAP A9)
    cfg: ls_eend.LSEENDConfig
    model: ls_eend.LSEEND
    n_lanes: int
    n_slots: int
    dtype: Any = torch.float32
    frame_kernel: bool = True
    device: Any = None        # None: the card ("cuda"); "cpu" for the tests
    mesh: Any = None          # multi-GPU lane sharding: ROADMAP A11

    def __post_init__(self):
        if self.kind != "ls":
            raise NotImplementedError(
                "StreamingServer(kind='fs') is not ported yet (ROADMAP A9, "
                "FS-EEND)")
        if self.mesh is not None:
            raise NotImplementedError(
                "lane sharding over several GPUs is not ported yet (ROADMAP A11, "
                "multi-GPU)")
        if self.dtype != torch.float32:
            raise NotImplementedError(
                "the port serves float32 only so far (ROADMAP B: bf16 serving "
                "for both frame-scan kernels)")
        self.device = ls_eend.resolve_device(self.device)
        self.model = self.model.to(self.device).eval()
        self.state = ls_eend.ls_stream_init(self.cfg, self.n_lanes, self.n_slots,
                                            self.dtype, self.device)
        self._packed = ls_eend.pack_weights(self.model) if self.frame_kernel else None

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
        if self.frame_kernel:
            fl = np.broadcast_to(np.asarray(flush, bool), (self.n_lanes,))[:, None]
            probs, valid = self.process_block(self._frames(frames)[:, None], fl)
            return probs[:, 0], valid[0]
        x_t = self._frames(frames)
        fl = torch.as_tensor(np.asarray(flush, bool), device=self.device)
        self.state, out = ls_eend.ls_stream_step(self.model, self.state, x_t,
                                                 self.n_slots, fl)
        return self._probs(out["logits"]), out["valid"]

    # -- block of frames (throughput path) ---------------------------------
    @torch.no_grad()
    def process_block(self, frames, flush=None):
        """frames: (n_lanes, K, in_size); flush: None, (K,) shared, or
        (n_lanes, K) per lane.  Returns (probs (n_lanes, K, n_slots-1),
        valid (K, n_lanes)) as tensors on the server's device."""
        xs = self._frames(frames)
        K = xs.shape[1]
        flush = self._flush(flush, K)
        if self.frame_kernel:
            self.state, (logits, valid) = ls_eend.ls_stream_block_fused(
                self.model, self.state, xs, flush, self.n_slots, self._packed)
            return self._probs(logits.transpose(0, 1)), valid
        logits, valid = [], []
        for k in range(K):
            self.state, out = ls_eend.ls_stream_step(self.model, self.state, xs[:, k],
                                                     self.n_slots, flush[k])
            logits.append(out["logits"])
            valid.append(out["valid"])
        return self._probs(torch.stack(logits, dim=1)), torch.stack(valid)

    # -- lane management ---------------------------------------------------
    def reset_lanes(self, lanes) -> None:
        """Reset the given lanes to fresh-stream state: every per-lane tensor
        (retention states, conv histories, the cnn window and the lane's
        clock) over both the lane axis and the lanes x slots axis of the
        decoder.  A fresh state is all zeros, so a reused lane reproduces a
        fresh server bit for bit while its neighbours continue untouched."""
        idx = torch.as_tensor(np.asarray(lanes, np.int64).reshape(-1), device=self.device)
        slots = (idx[:, None] * self.n_slots
                 + torch.arange(self.n_slots, device=self.device)).reshape(-1)
        for key, t in self.state.items():
            if key in _LANE_AXIS0:
                t.index_fill_(0, idx, 0)
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
    the blockwise section of models/ls_eend.py).  The highest-throughput
    serving mode; `StreamingServer` is the one with frame-level latency.

    Lanes carry O(1) chunkwise-retention state, and the result equals the
    batch chunkwise pass with chunk_size = block.  `cfg.kernel` picks the
    retention route; with "fused" (the default) every retention layer of a
    block is one `kernels/retention_layer.py` call, a CUDA kernel on the
    card."""

    kind: str                 # "ls" ("fs": ROADMAP A9)
    cfg: ls_eend.LSEENDConfig
    model: ls_eend.LSEEND
    n_lanes: int
    n_slots: int
    block: int = 100
    dtype: Any = torch.float32
    device: Any = None        # None: the card ("cuda"); "cpu" for the tests

    def __post_init__(self):
        if self.kind != "ls":
            raise NotImplementedError(
                "BlockStreamingServer(kind='fs') is not ported yet (ROADMAP A9, "
                "FS-EEND)")
        if self.dtype != torch.float32:
            raise NotImplementedError(
                "the port serves float32 only so far (ROADMAP B: bf16 serving)")
        self.device = ls_eend.resolve_device(self.device)
        # the server's config decides the route, whatever config the model came with
        self.model = ls_eend.with_cfg(self.model.to(self.device).eval(), self.cfg)
        self.state = self.fresh_state()
        self._packed = (ls_eend.pack_block_weights(self.model)
                        if self.cfg.kernel == "fused" else None)

    def fresh_state(self) -> dict:
        """A pristine per-stream state (what reset_all installs)."""
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
        self.state, logits = ls_eend.ls_blockstream_step(
            self.model, self.state, xs, self.n_slots, enc_bypass=bool(flush),
            h_mask=h_mask, packed=self._packed)
        return torch.sigmoid(logits[..., 1:])       # the silence slot dropped

    def blocks_consumed(self) -> int:
        return int(self.state["m"].max())

    def reset_all(self) -> None:
        """Fresh state for every lane."""
        self.state = self.fresh_state()

    def reset_lanes(self, lanes) -> None:
        """Reset the given lanes to fresh-stream state (gamma = 1 retention
        state does not depend on the position, so a per-lane reset is
        exact): zeros, ones for the retention scales, over both the lane
        axis and the lanes x slots axis of the decoder.  The lane's block
        counter returns to 0, so its next block is gated as a warm-up block
        again."""
        idx = torch.as_tensor(np.asarray(lanes, np.int64).reshape(-1), device=self.device)
        slots = (idx[:, None] * self.n_slots
                 + torch.arange(self.n_slots, device=self.device)).reshape(-1)
        for key, t in self.state.items():
            fill = 1 if key.endswith("_scale") else 0
            if key in ("m", "h_prev", "h_tail2"):
                t.index_fill_(0, idx, fill)
            else:
                t.index_fill_(1, slots if key.startswith("dec_") else idx, fill)
