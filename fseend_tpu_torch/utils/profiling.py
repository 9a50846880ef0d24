"""Tracing and step timing: the port's copy of `fseend_tpu/utils/profiling.py`.

  * `trace(logdir)`: a `torch.profiler` window (CPU and, where there is
    one, the card) written as a TensorBoard trace under `logdir`;
  * `annotate(name)`: a named region in that trace
    (`torch.profiler.record_function`);
  * `StepTimer`: rolling wall-clock statistics with the real-time factor at
    the 10 Hz post-subsampling frame rate.  It reads the host's clock: time
    a device step only after it has synchronized (a value read back, or
    `torch.cuda.synchronize()`).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

FRAME_RATE_HZ = 10.0  # 100 Hz features / 10x subsampling


@contextlib.contextmanager
def trace(logdir: str):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir))):
        yield


def annotate(name: str):
    return torch.profiler.record_function(name)


class StepTimer:
    """Rolling timing stats; report() returns p50/p95/mean ms and, given
    frames-per-step, the frames per second and the real-time factor."""

    def __init__(self, max_samples: int = 1000):
        self.samples: list[float] = []
        self.max_samples = max_samples
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.samples.append(time.perf_counter() - self._t0)
        if len(self.samples) > self.max_samples:
            self.samples = self.samples[-self.max_samples:]

    def report(self, frames_per_step: float | None = None) -> dict:
        if not self.samples:
            return {}
        s = np.asarray(self.samples)
        out = {
            "steps": len(s),
            "mean_ms": float(s.mean() * 1e3),
            "p50_ms": float(np.percentile(s, 50) * 1e3),
            "p95_ms": float(np.percentile(s, 95) * 1e3),
        }
        if frames_per_step:
            fps = frames_per_step / s.mean()
            out["frames_per_sec"] = float(fps)
            out["rtf"] = float(fps / FRAME_RATE_HZ)  # x real time
        return out
