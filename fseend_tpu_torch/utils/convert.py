"""Weights and stream states between the JAX package and the port.

The JAX package keeps its parameters as a nested dict pytree with linear
kernels in (in, out) layout, convolution kernels as (width, in/groups, out)
and the BatchNorm running statistics in a separate `model_state`; its
stream states (per-frame and blockwise) are nested dicts with per-layer
lists.  These functions take
those trees as numpy arrays (`jax.tree.map(np.asarray, tree)`) and return
the port's `LSEEND` module / flat state dict, and back (`ls_params_to_jax`
for the weights, the checkpoints and the gradient comparisons).  No JAX
import.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from fseend_tpu_torch.models import ls_eend


@torch.no_grad()
def ls_params_from_jax(params_np: dict, model_state_np: dict,
                       cfg: ls_eend.LSEENDConfig, device=None) -> ls_eend.LSEEND:
    """The port's LSEEND holding the JAX parameter pytree's values.  Static
    leaves (`_n_heads`, `_groups`) are skipped; every other leaf must land
    on a parameter of the same size, and every parameter must be set."""
    device = ls_eend.resolve_device(device)
    model = ls_eend.empty_ls_eend(cfg, "cpu")
    seen = set()

    def put(t: torch.Tensor, value, name: str):
        value = torch.as_tensor(np.array(value, dtype=np.float32))
        if tuple(value.shape) != tuple(t.shape):
            raise ValueError(f"{name}: JAX leaf {tuple(value.shape)} does not fit "
                             f"{tuple(t.shape)}")
        t.copy_(value)
        seen.add(name)

    def visit(mod: nn.Module, tree: dict, prefix: str):
        for key, sub in tree.items():
            if key.startswith("_"):
                continue                                   # static metadata
            name = f"{prefix}{key}"
            if isinstance(sub, list):
                for i, item in enumerate(sub):
                    visit(getattr(mod, key)[i], item, f"{name}.{i}.")
                continue
            child = getattr(mod, key)
            if isinstance(child, nn.Linear):
                put(child.weight, np.asarray(sub["kernel"]).T, f"{name}.weight")
                if "bias" in sub:
                    put(child.bias, sub["bias"], f"{name}.bias")
            elif isinstance(child, nn.Conv1d):
                # (width, in/groups, out) -> (out, in/groups, width)
                put(child.weight, np.asarray(sub["kernel"]).transpose(2, 1, 0),
                    f"{name}.weight")
                if "bias" in sub:
                    put(child.bias, sub["bias"], f"{name}.bias")
            elif isinstance(child, (nn.LayerNorm, nn.BatchNorm1d)):
                put(child.weight, sub["scale"], f"{name}.weight")
                put(child.bias, sub["bias"], f"{name}.bias")
            else:
                visit(child, sub, f"{name}.")

    visit(model, params_np, "")
    for i, bn_state in enumerate(model_state_np["conv_bn"]):
        bn = model.enc.blocks[i].conv.bn
        put(bn.running_mean, bn_state["mean"], f"enc.blocks.{i}.conv.bn.running_mean")
        put(bn.running_var, bn_state["var"], f"enc.blocks.{i}.conv.bn.running_var")
        bn.num_batches_tracked.zero_()
        seen.add(f"enc.blocks.{i}.conv.bn.num_batches_tracked")
    missing = [n for n, _ in list(model.named_parameters()) + list(model.named_buffers())
               if n not in seen]
    if missing:
        raise ValueError(f"JAX tree left port tensors unset: {missing[:5]}")
    return model.to(device)


def ls_state_from_jax(state_np: dict, device=None) -> dict:
    """The port's flat stream state from the JAX nested one:
    {"t", "enc": [{"ret": {"kv", "scale"}, "conv"}], "cnn_buf",
     "dec": [{"kv", "scale"}]}."""
    device = ls_eend.resolve_device(device)

    def st(xs):
        return torch.as_tensor(np.stack([np.asarray(x) for x in xs])).to(device)

    enc, dec = state_np["enc"], state_np["dec"]
    return {
        "t": torch.as_tensor(np.array(state_np["t"], np.int32)).to(device),
        "enc_kv": st([e["ret"]["kv"] for e in enc]),
        "enc_scale": st([e["ret"]["scale"] for e in enc]),
        "enc_conv": st([e["conv"] for e in enc]),
        "cnn_buf": torch.as_tensor(np.array(state_np["cnn_buf"])).to(device),
        "dec_kv": st([d["kv"] for d in dec]),
        "dec_scale": st([d["scale"] for d in dec]),
    }


def ls_state_to_numpy(state: dict) -> dict:
    """The JAX package's nested stream state (numpy leaves) from the port's."""
    n = {k: v.detach().cpu().numpy() for k, v in state.items()}
    return {
        "t": n["t"],
        "enc": [{"ret": {"kv": kv, "scale": sc}, "conv": cv}
                for kv, sc, cv in zip(n["enc_kv"], n["enc_scale"], n["enc_conv"])],
        "cnn_buf": n["cnn_buf"],
        "dec": [{"kv": kv, "scale": sc} for kv, sc in zip(n["dec_kv"], n["dec_scale"])],
    }


def ls_blockstate_from_jax(state_np: dict, device=None) -> dict:
    """The port's flat blockwise state from the JAX nested one:
    {"enc": [{"ret": {"kv", "scale"}, "conv"}], "h_prev", "h_tail2", "m",
     "dec": [{"kv", "scale"}]}."""
    device = ls_eend.resolve_device(device)

    def st(xs):
        return torch.as_tensor(np.stack([np.asarray(x) for x in xs])).to(device)

    enc, dec = state_np["enc"], state_np["dec"]
    return {
        "m": torch.as_tensor(np.array(state_np["m"], np.int32)).to(device),
        "enc_kv": st([e["ret"]["kv"] for e in enc]),
        "enc_scale": st([e["ret"]["scale"] for e in enc]),
        "enc_conv": st([e["conv"] for e in enc]),
        "h_prev": torch.as_tensor(np.array(state_np["h_prev"])).to(device),
        "h_tail2": torch.as_tensor(np.array(state_np["h_tail2"])).to(device),
        "dec_kv": st([d["kv"] for d in dec]),
        "dec_scale": st([d["scale"] for d in dec]),
    }


def ls_blockstate_to_numpy(state: dict) -> dict:
    """The JAX package's nested blockwise state (numpy leaves) from the port's."""
    n = {k: v.detach().cpu().numpy() for k, v in state.items()}
    return {
        "enc": [{"ret": {"kv": kv, "scale": sc}, "conv": cv}
                for kv, sc, cv in zip(n["enc_kv"], n["enc_scale"], n["enc_conv"])],
        "h_prev": n["h_prev"],
        "h_tail2": n["h_tail2"],
        "m": n["m"],
        "dec": [{"kv": kv, "scale": sc} for kv, sc in zip(n["dec_kv"], n["dec_scale"])],
    }


@torch.no_grad()
def ls_params_to_jax(model: ls_eend.LSEEND):
    """The JAX package's (params, model_state) pytrees, numpy leaves, from
    the port's module: linear kernels (in, out), convolution kernels (width,
    in/groups, out), BatchNorm running statistics in model_state.  Static
    leaves (`_n_heads`, `_groups`) are left out."""

    def val(t):
        return t.detach().cpu().numpy().copy()

    def tree(mod: nn.Module):
        if isinstance(mod, nn.ModuleList):
            return [tree(m) for m in mod]
        if isinstance(mod, nn.Linear):
            return {"kernel": val(mod.weight).T.copy(), "bias": val(mod.bias)}
        if isinstance(mod, nn.Conv1d):
            out = {"kernel": val(mod.weight).transpose(2, 1, 0).copy()}
            if mod.bias is not None:
                out["bias"] = val(mod.bias)
            return out
        if isinstance(mod, (nn.LayerNorm, nn.BatchNorm1d)):
            return {"scale": val(mod.weight), "bias": val(mod.bias)}
        return {name: tree(child) for name, child in mod.named_children()}

    bn = [blk.conv.bn for blk in model.enc.blocks]
    return tree(model), {"conv_bn": [{"mean": val(b.running_mean), "var": val(b.running_var)}
                                     for b in bn]}
