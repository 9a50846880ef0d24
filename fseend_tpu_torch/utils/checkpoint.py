"""Checkpoints in the JAX package's npz format, read and written.

`fseend_tpu/utils/checkpoint.py:save_pytree` stores every leaf of a pytree
under its "/"-joined path ("params/enc/blocks/0/ff1/linear1/kernel",
"model_state/conv_bn/0/mean", extras under "__extra__/"); static metadata
(`_n_heads`, `_groups`) is not a leaf and is not stored.  A training
checkpoint holds "params", "model_state" and "opt_state"; an averaged model
"params" and "model_state"; the legacy layout "params" alone.

The port writes "params" and "model_state" under the JAX package's own
keys (`utils/convert.py:ls_params_to_jax`, `fs_params_to_jax`,
`eda_params_to_jax`; EEND-EDA's model_state is empty and stores no leaf),
so either package reads the other's weights.  Its Adam state has the
port's own layout:
  opt_state/count                the updates applied so far
  opt_state/{mu,nu}/<name>       Adam's moments of parameter <name> (the
                                 module's dotted parameter name)
  opt_state/acc/<name>, opt_state/mini_step     gradient accumulation
The JAX package's optax state is laid out otherwise; each package resumes
with fresh moments from the other's file.  Includes the reference's uniform
checkpoint averaging.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import torch

from fseend_tpu_torch.models import eend_eda, fs_eend, ls_eend
from fseend_tpu_torch.parallel import collectives as C
from fseend_tpu_torch.utils import convert


def _flatten(tree, prefix: str, out: dict) -> dict:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}/{k}" if prefix else str(k), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{i}" if prefix else str(i), out)
    else:
        out[prefix] = np.asarray(tree)
    return out


def save_pytree(path: str | Path, tree: dict, extra: dict | None = None) -> None:
    """Every leaf of a nested dict/list tree under its "/"-joined path,
    `extra` under "__extra__/"."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    data = _flatten(tree, "", {})
    for k, v in (extra or {}).items():
        data[f"__extra__/{k}"] = np.asarray(v)
    np.savez(path, **data)


def load_flat(path: str | Path) -> dict:
    """Every array of the npz under its stored key."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load_pytree(path: str | Path, prefix: str) -> dict | list | None:
    """The subtree stored under `prefix/` as nested dicts, with a list
    wherever a level's keys are 0..n-1; None if the file has no such leaf.
    The empty prefix gives every leaf but the extras."""
    return _unflatten(_subtree(load_flat(path), prefix))


def _subtree(flat: dict, prefix: str) -> dict:
    if not prefix:
        return {k: v for k, v in flat.items() if not k.startswith("__extra__/")}
    return {k[len(prefix) + 1:]: v for k, v in flat.items() if k.startswith(prefix + "/")}


def _unflatten(flat: dict):
    if not flat:
        return None
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node) and \
                sorted(map(int, node)) == list(range(len(node))):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(tree)


def has_subtree(path: str | Path, prefix: str) -> bool:
    """True if the file stores any leaf under `prefix/`."""
    with np.load(path) as z:
        return any(k.startswith(prefix + "/") for k in z.files)


def load_extra(path: str | Path) -> dict:
    return {k[len("__extra__/"):]: v for k, v in load_flat(path).items()
            if k.startswith("__extra__/")}


def average_checkpoints(paths: list, prefix: str = "params"):
    """The uniform average of the subtree under `prefix` over several files
    (in float64, back to the stored dtype), as nested dicts/lists."""
    flats = [_subtree(load_flat(p), prefix) for p in paths]
    return _unflatten({k: np.stack([f[k].astype(np.float64) for f in flats]).mean(0)
                       .astype(v.dtype) for k, v in flats[0].items()})


def find_epoch_checkpoints(folder: str | Path, start_epoch: int | None = None,
                           end_epoch: int | None = None) -> list:
    """The npz files of `folder` whose name holds "epoch=N" (or "epochN")
    with N in [start_epoch, end_epoch], in name order."""
    out = []
    for p in sorted(Path(folder).glob("*.npz")):
        m = re.search(r"epoch=?(\d+)", p.name)
        if m is None:
            continue
        ep = int(m.group(1))
        if (start_epoch is None or ep >= start_epoch) and (end_epoch is None or ep <= end_epoch):
            out.append(p)
    return out


def opt_state_tree(model, opt_state: dict) -> dict:
    """The optimizer state in this module's checkpoint layout."""
    names = [n for n, _ in model.named_parameters()]
    tree = {"count": np.asarray(opt_state["count"], np.int64)}
    for key in ("mu", "nu", "acc"):
        if key in opt_state:
            tree[key] = {n: t.detach().cpu().numpy() for n, t in zip(names, opt_state[key])}
    if "mini_step" in opt_state:
        tree["mini_step"] = np.asarray(opt_state["mini_step"], np.int64)
    return tree


def load_opt_state(path: str | Path, model, opt_state: dict) -> dict:
    """`opt_state` (from `Optimizer.init`) filled from the file's
    "opt_state/" leaves, on the module's device.  The file holds whole
    tensors; a tensor-parallel shard of the module
    (`parallel/mesh.py:shard_model_`) takes its slice of each."""
    flat = load_flat(path)
    shards = C.param_shards(model)
    out = dict(opt_state, count=int(flat["opt_state/count"]))
    for key in ("mu", "nu", "acc"):
        if key in opt_state:
            out[key] = []
            for (n, s), t in zip(shards.items(), opt_state[key]):
                whole = torch.as_tensor(flat[f"opt_state/{key}/{n}"])
                out[key].append((whole if s is None else s.take(whole)).contiguous()
                                .to(t.device))
    if "mini_step" in opt_state:
        out["mini_step"] = int(flat["opt_state/mini_step"])
    return out


def load_ls_eend(path: str | Path, cfg: ls_eend.LSEENDConfig, device=None) -> ls_eend.LSEEND:
    """An `LSEEND` holding the checkpoint's "params" and "model_state"; a
    params-only file gets fresh BatchNorm statistics (mean 0, variance 1)."""
    params = load_pytree(path, "params")
    if params is None:
        raise KeyError(f"{path}: no leaf under 'params/'")
    model_state = load_pytree(path, "model_state")
    if model_state is None:
        D = cfg.n_units
        model_state = {"conv_bn": [{"mean": np.zeros(D, np.float32),
                                    "var": np.ones(D, np.float32)}
                                   for _ in range(cfg.enc_n_layers)]}
    return convert.ls_params_from_jax(params, model_state, cfg, device)


def load_fs_eend(path: str | Path, cfg: fs_eend.FSEENDConfig, device=None) -> fs_eend.FSEEND:
    """An `FSEEND` holding the checkpoint's "params" and "model_state"; a
    params-only file gets fresh BatchNorm statistics (mean 0, variance 1)."""
    params = load_pytree(path, "params")
    if params is None:
        raise KeyError(f"{path}: no leaf under 'params/'")
    model_state = load_pytree(path, "model_state")
    if model_state is None:
        model_state = {"bn": {"mean": np.zeros(cfg.in_size, np.float32),
                              "var": np.ones(cfg.in_size, np.float32)}}
    return convert.fs_params_from_jax(params, model_state, cfg, device)


def load_eend_eda(path: str | Path, cfg: eend_eda.EDAConfig, device=None) -> eend_eda.EENDEDA:
    """An `EENDEDA` holding the checkpoint's "params"."""
    params = load_pytree(path, "params")
    if params is None:
        raise KeyError(f"{path}: no leaf under 'params/'")
    return convert.eda_params_from_jax(params, cfg, device)
