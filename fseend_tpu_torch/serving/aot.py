"""Ahead-of-time serving artifacts: a `BlockStreamingServer` frozen into one
file that a serving host loads and runs without the model code, the config
system or the checkpoint machinery: torch, this loader and the custom ops
of the two blockwise kernels (`kernels/retention_layer.py`,
`kernels/cached_attention.py`).  The port's twin of
`fseend_tpu/serving/aot.py`.

    save_server(server, "ls_server.npz")            # build box (has checkpoints)
    srv = AotBlockServer("ls_server.npz")           # serving box
    probs = srv.process_block(frames)               # same API and semantics

The file is the JAX package's container: an .npz holding a `meta` JSON and
three serialized `torch.export` programs as uint8 arrays, the weights
inside:
  init   () -> a pristine per-stream state (built from `fresh_state()`,
         never from the live state);
  step   (state, frames, h_mask) -> (state, probs): a block;
  flush  the same with the encoder bypassed (the stream-end drain; the
         flush is host control flow in `BlockStreamingServer.block_step`,
         so it is a program of its own).
The programs call the kernels as `torch.ops.fseend_tpu_torch.*` ops; a CUDA
kernel is built from the repository's `kernels/csrc/` at its first launch,
as in the live server.  `meta` records the server's dtype ("float32", or
"bfloat16" for a bf16 server, whose programs carry bf16 weights and state
and call the bf16 forms of the retention layer (LS) or the cached
attention (FS) through the same ops), as the JAX package's artifact does.  An artifact is bound to the device type it was
exported on (export on the card to serve on the card).
"""

from __future__ import annotations

import io
import json

import numpy as np
import torch

# the ops the programs call: registering them is all the loader needs of the package
from fseend_tpu_torch.kernels import cached_attention as _cached_attention  # noqa: F401
from fseend_tpu_torch.kernels import retention_layer as _retention_layer  # noqa: F401


class _BlockProgram(torch.nn.Module):
    """A server's `block_step` with a fixed flush, as a module whose
    parameters are the server's model (so the export carries them)."""

    def __init__(self, server, flush: bool):
        super().__init__()
        self.model = server.model
        self._server = server
        self._flush = flush

    def forward(self, state, frames, h_mask):
        return self._server.block_step(state, frames, self._flush, h_mask)


class _InitProgram(torch.nn.Module):
    def __init__(self, server):
        super().__init__()
        self._server = server

    def forward(self):
        return self._server.fresh_state()


def _serialize(module, args) -> np.ndarray:
    with torch.no_grad():
        program = torch.export.export(module, args)
    program.example_inputs = None           # the state: gigabytes at serving widths
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return np.frombuffer(buf.getvalue(), np.uint8)


def _deserialize(blob: np.ndarray):
    return torch.export.load(io.BytesIO(blob.tobytes())).module()


def save_server(server, path: str) -> None:
    """Freeze a live `serving/runtime.py:BlockStreamingServer` to `path`.
    The exported `init` is rebuilt pristine (`fresh_state`): freezing a
    server mid-stream does not bake its state into the artifact."""
    frames = torch.zeros(server.n_lanes, server.block, server.cfg.in_size,
                         dtype=server.dtype, device=server.device)
    h_mask = torch.ones(server.block, dtype=torch.bool, device=server.device)
    programs = {"init": _serialize(_InitProgram(server), ())}
    for name, flush in (("step", False), ("flush", True)):
        programs[name] = _serialize(_BlockProgram(server, flush),
                                    (server.fresh_state(), frames, h_mask))
    meta = {
        "kind": server.kind,
        "n_lanes": int(server.n_lanes),
        "n_slots": int(server.n_slots),
        "block": int(server.block),
        "in_size": int(server.cfg.in_size),
        "conv_delay": int(server.cfg.conv_delay),
        "capacity": int(server.capacity) if server.kind == "fs" else None,
        "dtype": str(server.dtype).removeprefix("torch."),
        "device": str(server.device),
    }
    np.savez(path, meta=json.dumps(meta), **programs)


class AotBlockServer:
    """Run a frozen serving artifact; mirrors `BlockStreamingServer`'s
    process_block (one-block emission lag, flush, h_mask), reset_all and
    the FS capacity guard."""

    def __init__(self, path: str):
        with np.load(path) as z:
            self.meta = json.loads(str(z["meta"]))
            self._init, self._step, self._flush = (_deserialize(z[k])
                                                   for k in ("init", "step", "flush"))
        self.kind = self.meta["kind"]
        self.n_lanes = self.meta["n_lanes"]
        self.n_slots = self.meta["n_slots"]
        self.block = self.meta["block"]
        self.dtype = getattr(torch, self.meta["dtype"])
        self.device = torch.device(self.meta["device"])
        self.capacity = self.meta.get("capacity")
        self.reset_all()

    @torch.no_grad()
    def reset_all(self) -> None:
        self.state = self._init()
        self._frames_fed = 0

    @torch.no_grad()
    def process_block(self, frames, flush: bool = False, h_mask=None) -> torch.Tensor:
        """frames (n_lanes, block, in_size) -> the previous block's
        probabilities (n_lanes, block, n_slots - 1) on the artifact's
        device; h_mask (block,) marks a padded final block's valid frames."""
        if self.kind == "fs" and not flush and self.capacity is not None:
            # the same overflow guard as BlockStreamingServer.process_block
            if self._frames_fed + self.block > self.capacity:
                raise ValueError(
                    f"FS blockwise stream exceeds KV capacity: {self._frames_fed} frames "
                    f"fed + block {self.block} > capacity {self.capacity}; reset_all() "
                    f"or re-export with a larger capacity")
            self._frames_fed += self.block
        if h_mask is None:
            h_mask = np.ones((self.block,), bool)
        if isinstance(frames, torch.Tensor):
            xs = frames.to(self.device, self.dtype)
        else:
            xs = torch.as_tensor(np.ascontiguousarray(frames), dtype=self.dtype,
                                 device=self.device)
        h_mask = torch.as_tensor(np.asarray(h_mask, bool), device=self.device)
        program = self._flush if flush else self._step
        self.state, probs = program(self.state, xs, h_mask)
        return probs
