"""Reading the JAX package's npz checkpoints into the port.

`fseend_tpu/utils/checkpoint.py:save_pytree` stores every leaf of a pytree
under its "/"-joined path ("params/enc/blocks/0/ff1/linear1/kernel",
"model_state/conv_bn/0/mean", extras under "__extra__/"); static metadata
(`_n_heads`, `_groups`) is not a leaf and is not stored.  A training
checkpoint holds "params", "model_state" and "opt_state"; an averaged model
"params" and "model_state"; the legacy layout "params" alone.  Loading
only: saving, averaging and resume come with training.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from fseend_tpu_torch.models import ls_eend
from fseend_tpu_torch.utils import convert


def load_flat(path: str | Path) -> dict:
    """Every array of the npz under its stored key."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load_pytree(path: str | Path, prefix: str) -> dict | list | None:
    """The subtree stored under `prefix/` as nested dicts, with a list
    wherever a level's keys are 0..n-1; None if the file has no such leaf."""
    flat = {k[len(prefix) + 1:]: v for k, v in load_flat(path).items()
            if k.startswith(prefix + "/")}
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
