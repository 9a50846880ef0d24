"""The ("data", "model") mesh over torch.distributed: the port of
`fseend_tpu/parallel/mesh.py`.

JAX runs one program over a device mesh and XLA inserts the collectives.
PyTorch runs one process per card (`torchrun --nproc_per_node N`), and the
collectives are explicit (`parallel/collectives.py`):

  * "data": a mesh from `make_mesh()` is the world of torch.distributed's
    processes, one rank per card, each holding its rows of the global
    batch (`shard_batch`); the train step sums gradients, BatchNorm
    statistics and loss denominators over it (`train/trainer.py`).  The
    backend follows the device: NCCL for the card, gloo when the caller
    passes device="cpu" (the tests) or names `backend`.  Nothing falls back
    from one backend to the other.
  * A one-process mesh over a list of devices (`make_mesh(devices=...)`)
    is what lane-sharded serving runs on (`serving/runtime.py:
    shard_server_over_mesh`): every stream-state leaf is lane-major, so the
    shards need no collective.
  * "model" (tensor parallelism, `param_pspec`'s rules) is ROADMAP A11
    part 2: `make_mesh(n_model > 1)` raises.  The rules are kept, held to
    the JAX package's on the same parameter names, and used by nothing yet.

The process group is read from the environment torchrun sets (RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK) unless the caller has
initialized it already.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any

import torch
import torch.distributed as dist

from fseend_tpu_torch.models.ls_eend import resolve_device

_TP_PART_2 = ("tensor parallelism over the \"model\" axis is not ported yet (ROADMAP A11 "
              "part 2): every projection would be split into column and row halves with "
              "their all-reduces, and the B3 and B4 kernels take whole weight matrices")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """n_data x n_model.  `devices`: the devices this process drives along
    "data" (one per rank of `group` when the mesh spans processes, then
    only this rank's); `group`: the "data" axis' process group, None for a
    one-process mesh."""
    n_data: int
    n_model: int
    devices: tuple
    group: Any = None
    rank: int = 0

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def _rank_device(device) -> torch.device:
    """The card of this rank (cuda:LOCAL_RANK) unless the caller names one."""
    if device is None or str(device) == "cuda":
        resolve_device("cuda")                         # raises without a card
        local = os.environ.get("LOCAL_RANK")
        local = int(local) if local is not None else dist.get_rank() % torch.cuda.device_count()
        return torch.device("cuda", local)
    return resolve_device(device)


def make_mesh(n_data: int | None = None, n_model: int = 1, device=None, *,
              devices=None, backend: str | None = None) -> Mesh:
    """A ("data", "model") mesh; "data" takes every rank (or every device
    of `devices`) by default.  With `devices`, a one-process mesh over
    them.  Otherwise one rank per process: the process group is
    initialized from the environment when it is not yet, with NCCL for a
    CUDA device (the default) and gloo for device="cpu", or `backend`;
    this rank runs on `device` (default cuda:LOCAL_RANK)."""
    if n_model != 1:
        raise NotImplementedError(f"n_model={n_model}: {_TP_PART_2}")
    if devices is not None:
        devs = tuple(resolve_device(d) for d in devices)
        n_data = len(devs) if n_data is None else n_data
        if not 1 <= n_data <= len(devs):
            raise ValueError(f"n_data={n_data} over {len(devs)} devices")
        return Mesh(n_data, 1, devs[:n_data])
    want = backend or ("gloo" if torch.device(device or "cuda").type == "cpu" else "nccl")
    if not dist.is_initialized():
        dist.init_process_group(want, init_method="env://")
    elif dist.get_backend() != want:
        raise ValueError(f"the process group runs {dist.get_backend()}, the mesh asks for {want}")
    world = dist.get_world_size()
    n_data = world if n_data is None else n_data
    if n_data != world:
        raise ValueError(f"n_data={n_data} with {world} processes: launch one process per "
                         f"rank (torchrun --nproc_per_node {n_data})")
    dev = _rank_device(device)
    if want == "nccl":
        torch.cuda.set_device(dev)
    return Mesh(n_data, 1, (dev,), dist.group.WORLD, dist.get_rank())


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of a global batch (its leading axis split evenly
    over "data"; the JAX package's `shard_batch` places the same rows on
    the same mesh position)."""
    out = {}
    for k, v in batch.items():
        n = len(v)
        if n % mesh.n_data:
            raise ValueError(f"{k}: {n} rows do not split over {mesh.n_data} ranks")
        m = n // mesh.n_data
        out[k] = v[mesh.rank * m:(mesh.rank + 1) * m]
    return out


# Rules mapping parameter paths (the JAX layout's names, dotted) to the
# kernel's partition over "model".  Biases follow their kernel's output
# sharding.  Matched in order.  Held to `fseend_tpu/parallel/mesh.py`.
_TP_RULES = [
    (r"in_proj", (None, "model")),
    (r"(q|k|v|g)_proj.*kernel", (None, "model")),
    (r"out_proj.*kernel", ("model", None)),
    (r"linear1.*kernel", (None, "model")),
    (r"linear2.*kernel", ("model", None)),
    (r"pw1.*kernel", (None, "model")),
    (r"pw2.*kernel", ("model", None)),
]
_TP_BIAS_RULES = [
    (r"in_proj", ("model",)),
    (r"(q|k|v|g)_proj", ("model",)),
    (r"linear1", ("model",)),
    (r"pw1", ("model",)),
]


def param_pspec(path: str, ndim: int) -> tuple:
    """The partition of one parameter under tensor parallelism, as the
    tuple of a PartitionSpec: `path` is its dotted name in the JAX layout
    (`utils/convert.py:ls_params_to_jax`), () = replicated."""
    if ndim >= 2 and path.endswith("kernel"):
        for pat, spec in _TP_RULES:
            if re.search(pat, path):
                return spec
    if ndim == 1 and path.endswith("bias"):
        for pat, spec in _TP_BIAS_RULES:
            if re.search(pat, path):
                return spec
    return ()
