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
  * "model": tensor parallelism by `param_pspec`'s rules (the JAX
    package's, on the same parameter names).  The ranks form an n_data x
    n_model grid in the JAX package's device order
    (`devices.reshape(n_data, n_model)`): global rank r = d * n_model + m,
    with one process group per grid row (the "model" group of the ranks
    that share d) and one per column (the "data" group of the ranks that
    share m).  `shard_model_` leaves each rank its slice of every split
    parameter (`param_partition`; a dimension that does not divide stays
    whole, as the JAX package's `param_shardings`), and the model code runs
    the products through the model group (`parallel/collectives.py`,
    `ops/nn.py:ffn`, `ops/retention.py`); `gather_model` makes the whole
    model again (checkpoints, validation).
  * A one-process mesh over a list of devices (`make_mesh(devices=...)`)
    is what lane-sharded serving runs on (`serving/runtime.py:
    shard_server_over_mesh`): every stream-state leaf is lane-major, so the
    shards need no collective.  Its lanes are sharded over "data" and the
    parameters replicated over "model" (the JAX package's
    `shard_server_over_mesh`): a data shard runs on the first device of its
    grid row, so n_model > 1 serves what n_model = 1 serves.

The process group is read from the environment torchrun sets (RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK) unless the caller has
initialized it already.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import re
from typing import Any

import torch
import torch.distributed as dist
from torch import nn

from fseend_tpu_torch.models.ls_eend import resolve_device
from fseend_tpu_torch.parallel import collectives as C
from fseend_tpu_torch.utils import convert


@dataclasses.dataclass(frozen=True)
class Mesh:
    """n_data x n_model.  `devices`: the devices this process drives along
    "data" (one per rank of `group` when the mesh spans processes, then
    only this rank's; on a one-process mesh the first device of each grid
    row); `group` (also `data_group`): the "data" axis' process group, the
    ranks of this rank's column, None for a one-process mesh; `rank` (also
    `d`): this rank's data coordinate; `model_group` and `m`: the "model"
    axis' group (this rank's row) and coordinate; `world`: every rank's
    group."""
    n_data: int
    n_model: int
    devices: tuple
    group: Any = None
    rank: int = 0
    model_group: Any = None
    m: int = 0
    world: Any = None

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def data_group(self):
        return self.group

    @property
    def d(self) -> int:
        return self.rank

    @property
    def global_rank(self) -> int:
        return self.rank * self.n_model + self.m

    @property
    def main(self) -> bool:
        """Global rank 0: the rank that logs and writes."""
        return self.global_rank == 0


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
    of `devices`) not on "model" by default.  With `devices`, a one-process
    mesh over them.  Otherwise one rank per process, n_data x n_model of
    them: the process group is initialized from the environment when it is
    not yet, with NCCL for a CUDA device (the default) and gloo for
    device="cpu", or `backend`; this rank runs on `device` (default
    cuda:LOCAL_RANK).  Every rank makes every group, in one order."""
    if n_model < 1:
        raise ValueError(f"n_model={n_model}")
    if devices is not None:
        devs = tuple(resolve_device(d) for d in devices)
        n_data = len(devs) // n_model if n_data is None else n_data
        if n_data < 1 or n_data * n_model > len(devs):
            raise ValueError(f"{n_data} data x {n_model} model over {len(devs)} devices")
        return Mesh(n_data, n_model, devs[:n_data * n_model:n_model])
    want = backend or ("gloo" if torch.device(device or "cuda").type == "cpu" else "nccl")
    if not dist.is_initialized():
        dist.init_process_group(want, init_method="env://")
    elif dist.get_backend() != want:
        raise ValueError(f"the process group runs {dist.get_backend()}, the mesh asks for {want}")
    world = dist.get_world_size()
    n_data = world // n_model if n_data is None else n_data
    if n_data * n_model != world:
        raise ValueError(f"{n_data} data x {n_model} model with {world} processes: launch "
                         f"one process per rank (torchrun --nproc_per_node "
                         f"{n_data * n_model})")
    dev = _rank_device(device)
    if want == "nccl":
        torch.cuda.set_device(dev)
    r = dist.get_rank()
    d, m = divmod(r, n_model)
    if n_model == 1:
        return Mesh(n_data, 1, (dev,), dist.group.WORLD, d, world=dist.group.WORLD)
    data_group = model_group = None
    for j in range(n_model):                  # the columns: "data" groups
        g = dist.new_group([i * n_model + j for i in range(n_data)])
        data_group = g if j == m else data_group
    for i in range(n_data):                   # the rows: "model" groups
        g = dist.new_group([i * n_model + j for j in range(n_model)])
        model_group = g if i == d else model_group
    return Mesh(n_data, n_model, (dev,), data_group, d, model_group, m, dist.group.WORLD)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of a global batch (its leading axis split evenly
    over "data"; the JAX package's `shard_batch` places the same rows on
    the same mesh position).  The ranks of one model group take the same
    rows."""
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


# ---------------------------------------------------------------------------
# the model's partition over "model"
# ---------------------------------------------------------------------------


def param_partition(model: nn.Module, mesh: Mesh) -> dict:
    """{torch parameter name: the torch dim split over "model", or None}:
    `param_pspec` on each parameter's JAX-layout name, whole where the
    split dimension does not divide n_model (the JAX package's
    `param_shardings`)."""
    n_model = mesh.n_model
    params = dict(model.named_parameters())
    out = {}
    for name, (jax_name, axes) in convert.jax_param_layout(model).items():
        dim = None
        for axis, ax in enumerate(param_pspec(jax_name, len(axes))):
            if ax == "model":
                dim = axes[axis]
        if n_model <= 1 or (dim is not None and params[name].shape[dim] % n_model):
            dim = None
        out[name] = dim
    return out


@torch.no_grad()
def shard_model_(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Leave this rank its slice of every parameter `param_partition`
    splits (in place; the module is tagged with each `collectives.Shard`).
    A mesh without a model axis leaves the model whole.  Returns `model`."""
    if mesh.n_model == 1:
        return model
    mods = dict(model.named_modules())
    for name, dim in param_partition(model, mesh).items():
        if dim is None:
            continue
        prefix, attr = name.rsplit(".", 1)
        mod = mods[prefix]
        shard = C.Shard(dim, mesh.n_model, mesh.m)
        p = getattr(mod, attr)
        setattr(mod, attr, nn.Parameter(shard.take(p).clone(), requires_grad=p.requires_grad))
        mod.tp_shards = {**C.shards_of(mod), attr: shard}
    return model


@torch.no_grad()
def gather_full(tensors: list, shards: list, mesh: Mesh) -> list:
    """Each tensor whole: a shard's slices gathered over the model group
    (every model rank calls this, with the same tensors in the same order);
    a whole one as it is."""
    out = []
    for t, s in zip(tensors, shards):
        if s is None:
            out.append(t)
            continue
        out.append(torch.cat(C._stacked(t, mesh.model_group).unbind(0), dim=s.dim))
    return out


@torch.no_grad()
def gather_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """A whole copy of a sharded model (`shard_model_`'s inverse); the model
    itself when nothing is sharded.  Every model rank calls it."""
    shards = C.param_shards(model)
    if not any(shards.values()):
        return model
    full = copy.deepcopy(model)
    mods = dict(full.named_modules())
    names = list(shards)
    whole = gather_full([p for _, p in model.named_parameters()], list(shards.values()), mesh)
    for name, t in zip(names, whole):
        if shards[name] is None:
            continue
        prefix, attr = name.rsplit(".", 1)
        setattr(mods[prefix], attr, nn.Parameter(t))
    for mod in mods.values():
        mod.__dict__.pop("tp_shards", None)
    return full
