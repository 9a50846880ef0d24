"""Continuous batching for multi-stream diarization serving.

The port's own copy of `fseend_tpu/serving/scheduler.py` (the port imports
nothing of the JAX package).  A ContinuousBatcher multiplexes arbitrarily
many streams over the fixed lanes of one StreamingServer:

  * free lanes are assigned from the queue and RESET per lane (bit-exact:
    every per-lane tensor, the lane's stream clock included, resets, so a
    reused lane reproduces a fresh server);
  * each lane carries its own clock and flush schedule, so one lane can
    drain its look-ahead-conv tail while its neighbours keep consuming audio;
  * idle lanes ride along as flush lanes (state frozen, outputs invalid).

Scheduling is numpy bookkeeping on (lanes, K) blocks; the server's outputs
are copied to the host once per block.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np


@dataclasses.dataclass
class _Job:
    sid: object
    feats: np.ndarray          # (T, in_size)
    fed: int = 0               # real frames sent to the device
    got: int = 0               # valid output frames collected
    chunks: list = dataclasses.field(default_factory=list)

    @property
    def T(self):
        return len(self.feats)


class ContinuousBatcher:
    """Schedules streams over a StreamingServer.

    submit() any number of (stream_id, feats) at any time; step() advances
    every lane by one K-frame block; run() drains queue + lanes and returns
    {stream_id: probs (T, n_slots-1)} — identical to serving each stream
    alone on a fresh server."""

    def __init__(self, server, block: int = 64):
        self.srv = server
        self.K = int(block)
        self.in_size = server.cfg.in_size
        self.queue: collections.deque[_Job] = collections.deque()
        self.lanes: list[_Job | None] = [None] * server.n_lanes
        self.results: dict = {}

    def submit(self, sid, feats: np.ndarray) -> None:
        if (sid in self.results or any(j.sid == sid for j in self.queue)
                or any(j is not None and j.sid == sid for j in self.lanes)):
            raise ValueError(f"duplicate stream id {sid!r} (a same-named "
                             f"stream is queued, in flight, or finished)")
        self.queue.append(_Job(sid, np.asarray(feats, np.float32)))

    def _assign_free_lanes(self) -> None:
        taken = []
        for ln, job in enumerate(self.lanes):
            if job is None and self.queue:
                self.lanes[ln] = self.queue.popleft()
                taken.append(ln)
        if taken:
            self.srv.reset_lanes(taken)

    @property
    def active(self) -> bool:
        return bool(self.queue) or any(j is not None for j in self.lanes)

    def step(self) -> None:
        """Advance all lanes one block: feed each lane its next K stream
        frames (flush frames past its end), collect finished outputs."""
        self._assign_free_lanes()
        B, K = self.srv.n_lanes, self.K
        xs = np.zeros((B, K, self.in_size), np.float32)
        fl = np.ones((B, K), bool)          # idle / past-end -> flush
        for ln, job in enumerate(self.lanes):
            if job is None:
                continue
            take = min(K, job.T - job.fed)
            if take > 0:
                xs[ln, :take] = job.feats[job.fed:job.fed + take]
                fl[ln, :take] = False
                job.fed += take
        probs, valid = self.srv.process_block(xs, flush=fl)
        probs = probs.cpu().numpy()         # (B, K, n_slots-1)
        valid = valid.cpu().numpy().T       # (K, B) -> (B, K)
        for ln, job in enumerate(self.lanes):
            if job is None:
                continue
            out = probs[ln][valid[ln]][:job.T - job.got]
            if len(out):
                job.chunks.append(out)
                job.got += len(out)
            if job.got >= job.T:
                self.results[job.sid] = (
                    np.concatenate(job.chunks, axis=0) if job.chunks else
                    np.zeros((0, probs.shape[-1]), np.float32))
                self.lanes[ln] = None

    def run(self) -> dict:
        while self.active:
            self.step()
        out, self.results = self.results, {}
        return out
