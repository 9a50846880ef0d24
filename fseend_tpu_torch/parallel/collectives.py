"""The collectives of one mesh axis as autograd functions, the port's
counterparts of what `fseend_tpu/parallel/sp.py` and the jitted mesh step
use: `all_gather` (tiled), `psum`, the halo `shift` (JAX's `ppermute` with
the ring's wrap-around masked to zeros) and `axis_index` / `axis_size`.

Each backward is JAX's transpose under one convention: the objective is
the sum over ranks of what each rank backpropagates.  So
  * the backward of `all_gather` gives each rank the sum over ranks of its
    slice's cotangent (an all-reduce, then the rank's slice);
  * the backward of `psum` is a `psum`;
  * the backward of a halo shift is the reverse shift.
A replicated quantity (the same value on every rank, as a loss computed
from gathered logits) is backpropagated divided by the axis size.  Every
rank must run the same collectives in the same order, forward and
backward: an output of a collective that does not reach a rank's loss
leaves that rank's backward one collective short, so callers mask with
`torch.where` (zeros that keep the graph) rather than drop a term.

They run on `all_reduce` and `all_gather_into_tensor` only, which NCCL
carries and gloo carries on CPU tensors and on CUDA tensors alike.

`data_parallel(group)` marks the extent of a data-parallel step: inside it
`ops/nn.py:batch_norm_train` takes its statistics over the whole global
batch and the losses of `train/losses.py` divide by counts summed over the
group (`batch_sum`, `batch_mean`).  Outside it they are the single-process
functions, bit for bit.

Tensor parallelism over the "model" axis needs other transposes.  There
the activations are replicated: every model rank holds the same value and
backpropagates the same full cotangent, so a sum over ranks would count it
n times.  Megatron's pair and a weight gather carry it instead:
  * *f*: the identity forward, an all-reduce backward, at the input of a
    column-parallel product (each rank's cotangent covers only its own
    columns' share); `column_linear` runs it and the product as one
    function, whose backward sums the ranks' partial input gradients in
    float32 and rounds them once, as one product does in bf16;
  * `reduce_from_model` (*g*): an all-reduce forward, the identity
    backward, at the output of a row-parallel product;
  * `gather_weight`: a parameter's shards concatenated forward; backward,
    this rank's slice of the full gradient, not summed (every rank computed
    the same full gradient).
`model_parallel(group)` names the model group for a step; a module whose
parameters are shards (`Shard`, set by `parallel/mesh.py:shard_model_`)
is run through these (`gathered`, `ops/nn.py:column_linear`, `row_linear`).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch
import torch.distributed as dist

_DATA = contextvars.ContextVar("fseend_data_parallel_group", default=None)
_MODEL = contextvars.ContextVar("fseend_model_parallel_group", default=None)


def axis_index(group=None) -> int:
    """This rank's position on the axis (JAX `axis_index`)."""
    return dist.get_rank(group)


def axis_size(group=None) -> int:
    return dist.get_world_size(group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return y


def _stacked(x: torch.Tensor, group) -> torch.Tensor:
    """(axis size, *x.shape): every rank's x in rank order."""
    n = axis_size(group)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out.view((n,) + tuple(x.shape))


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return torch.cat(_stacked(x, group).unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, ctx.group)
        n = g.shape[ctx.dim] // axis_size(ctx.group)
        return g.narrow(ctx.dim, axis_index(ctx.group) * n, n), None, None


def _shift_raw(x: torch.Tensor, offset: int, group) -> torch.Tensor:
    src = axis_index(group) - offset
    parts = _stacked(x, group)
    return parts[src] if 0 <= src < parts.shape[0] else torch.zeros_like(x)


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, offset, group):
        ctx.offset, ctx.group = offset, group
        return _shift_raw(x, offset, group)

    @staticmethod
    def backward(ctx, g):
        return _shift_raw(g, -ctx.offset, ctx.group), None, None


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over the axis, on every rank (JAX `psum`)."""
    return _PSum.apply(x, group)


def all_gather(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's x concatenated along `dim` in rank order (JAX
    `all_gather(..., tiled=True)`); `x[None]` stacks them on a new axis."""
    return _AllGather.apply(x, dim % x.ndim, group)


def shift(x: torch.Tensor, offset: int, group=None) -> torch.Tensor:
    """Rank r receives rank r - offset's x, zeros where there is no such
    rank (JAX's `ppermute` along the ring with the wrap-around masked).
    Carried as an all-gather: a halo is a few frames."""
    return _Shift.apply(x, offset, group)


def halo_exchange(h: torch.Tensor, delay: int, group=None) -> torch.Tensor:
    """(B, Tl, D) local shard -> (B, Tl + 2 delay, D): `delay` edge frames
    from each neighbour, zeros beyond the global sequence
    (`sp.py:_halo_exchange`)."""
    if delay == 0:
        return h
    left = shift(h[:, -delay:], 1, group)
    right = shift(h[:, :delay], -1, group)
    return torch.cat([left, h, right], dim=1)


def sum_scalars(values: dict, group=None) -> dict:
    """A dict of 0-dim tensors summed over the axis in one all-reduce (in
    float64), each returned in its own dtype; no gradient."""
    keys = list(values)
    flat = torch.stack([values[k].detach().to(torch.float64) for k in keys])
    flat = _all_reduce(flat, group)
    return {k: flat[i].to(values[k].dtype) for i, k in enumerate(keys)}


@torch.no_grad()
def all_reduce_(tensors: list, group=None) -> None:
    """Sum each tensor over the axis in place, through one flat buffer per
    dtype."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


# ---------------------------------------------------------------------------
# the data-parallel step's global batch
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def data_parallel(group):
    """Within: BatchNorm statistics and loss denominators over the global
    batch of `group`'s ranks (None: the single-process functions).  Keep
    it open over the backward: a recomputed block (`remat`) takes its
    statistics again there."""
    token = _DATA.set(None if group is None else (group,))
    try:
        yield
    finally:
        _DATA.reset(token)


def data_group():
    """(group,) inside `data_parallel(group)`, else None."""
    return _DATA.get()


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """A count summed over the data-parallel ranks (a loss's denominator),
    without gradient; x itself outside `data_parallel`."""
    active = _DATA.get()
    if active is None:
        return x
    return _all_reduce(x.detach(), active[0])


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """x.mean() over the global batch: the local sum over the element count
    summed over the ranks; x.mean() outside `data_parallel`."""
    active = _DATA.get()
    if active is None:
        return x.mean()
    n = _all_reduce(torch.tensor(float(x.numel()), dtype=torch.float64, device=x.device),
                    active[0])
    return x.sum() / n.to(x.dtype)


def batch_moments(x: torch.Tensor, group):
    """The mean and biased variance over every leading axis of (..., D)
    across the ranks of `group`, in two psum'd passes (mean, then squared
    deviations; `sp.py:_sp_batch_norm_train`), and the global count.  The
    sums run in float32 and the moments return in x's dtype (a bf16
    x.mean() accumulates in float32 and rounds once)."""
    axes = tuple(range(x.ndim - 1))
    n = float(_all_reduce(torch.tensor(float(x[..., 0].numel()), dtype=torch.float64,
                                       device=x.device), group))
    mean = (psum(x.sum(dim=axes, dtype=torch.float32), group) / n).to(x.dtype)
    var = (psum((x - mean).square().sum(dim=axes, dtype=torch.float32), group) / n).to(x.dtype)
    return mean, var, n


# ---------------------------------------------------------------------------
# tensor parallelism: the "model" axis
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Shard:
    """A parameter held as slice `index` of `n` equal contiguous slices
    along dim `dim` of its torch layout (0: a linear's outputs, column
    parallel; 1: its inputs, row parallel)."""
    dim: int
    n: int
    index: int

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole tensor."""
        k = full.shape[self.dim] // self.n
        return full.narrow(self.dim, self.index * k, k)


def shards_of(module) -> dict:
    """{parameter attribute: Shard} of one module ({} when whole)."""
    return getattr(module, "tp_shards", {})


def param_shards(model) -> dict:
    """{parameter name: Shard or None} over `model.named_parameters()`."""
    out = {}
    for prefix, mod in model.named_modules():
        for attr, _ in mod.named_parameters(recurse=False):
            out[f"{prefix}.{attr}" if prefix else attr] = shards_of(mod).get(attr)
    return {n: out[n] for n, _ in model.named_parameters()}


@contextlib.contextmanager
def model_parallel(group):
    """Within: sharded modules run their products over `group` (None: no
    model axis; a sharded module then raises)."""
    token = _MODEL.set(group)
    try:
        yield
    finally:
        _MODEL.reset(token)


def model_group():
    """The group of `model_parallel`; raises outside it."""
    group = _MODEL.get()
    if group is None:
        raise RuntimeError("a module holds tensor-parallel shards: run it inside "
                           "collectives.model_parallel(mesh.model_group)")
    return group


class _ColumnLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, group):
        ctx.group, ctx.has_bias = group, b is not None
        ctx.save_for_backward(x, w)
        return torch.nn.functional.linear(x, w, b)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = _all_reduce(dy.float() @ w.float(), ctx.group).to(x.dtype)
        dy2 = dy.reshape(-1, dy.shape[-1])
        dw = dy2.t() @ x.reshape(-1, x.shape[-1])
        return dx, dw, dy2.sum(0) if ctx.has_bias else None, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherWeight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, dim, group):
        ctx.dim, ctx.group = dim, group
        return torch.cat(_stacked(w, group).unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // axis_size(ctx.group)
        return g.narrow(ctx.dim, axis_index(ctx.group) * n, n).contiguous(), None, None


def column_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    """x (replicated) @ w.T + b with w, b this rank's output columns: *f*
    and the product over the model group (module docstring)."""
    return _ColumnLinear.apply(x, w, b, model_group())


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """Megatron's *g* over the model group (module docstring)."""
    return _ReduceFromModel.apply(x, model_group())


def gathered(module, name: str) -> torch.Tensor:
    """The module's parameter `name` whole: its shards gathered over the
    model group (backward: this rank's slice), or the parameter itself."""
    t = getattr(module, name)
    shard = shards_of(module).get(name)
    if shard is None:
        return t
    return _GatherWeight.apply(t, shard.dim, model_group())
