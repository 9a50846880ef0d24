"""Weights and stream states between the JAX package and the port.

The JAX package keeps its parameters as a nested dict pytree with linear
kernels in (in, out) layout, convolution kernels as (width, in/groups, out)
and the BatchNorm running statistics in a separate `model_state`; its
stream states (per-frame and blockwise) are nested dicts with per-layer
lists.  These functions take
those trees as numpy arrays (`jax.tree.map(np.asarray, tree)`) and return
the port's `LSEEND` / `FSEEND` / `EENDEDA` module or flat state dict, and
back (`ls_params_to_jax` for the weights, the checkpoints and the gradient
comparisons; `fs_params_to_jax` for FS-EEND, `eda_params_to_jax` for
EEND-EDA, whose LSTM weights the JAX package keeps transposed: w_ih (in,
4H), w_hh (H, 4H)).  No JAX import.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from fseend_tpu_torch.models import eend_eda, fs_eend, ls_eend
from fseend_tpu_torch.models.ls_eend import resolve_device


def _load_params(model: nn.Module, params_np: dict, seen: set):
    """Put the JAX parameter pytree's values on `model` (CPU), returning the
    `put(tensor, value, name)` helper for the caller's buffers.  Static
    leaves (`_n_heads`, `_groups`) are skipped; every other leaf must land
    on a parameter of the same size."""

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
            elif isinstance(child, eend_eda.LSTM):
                put(child.weight_ih, np.asarray(sub["w_ih"]).T, f"{name}.weight_ih")
                put(child.weight_hh, np.asarray(sub["w_hh"]).T, f"{name}.weight_hh")
                put(child.bias_ih, sub["b_ih"], f"{name}.bias_ih")
                put(child.bias_hh, sub["b_hh"], f"{name}.bias_hh")
            else:
                visit(child, sub, f"{name}.")

    visit(model, params_np, "")
    return put


def _check_all_set(model: nn.Module, seen: set) -> None:
    missing = [n for n, _ in list(model.named_parameters()) + list(model.named_buffers())
               if n not in seen]
    if missing:
        raise ValueError(f"JAX tree left port tensors unset: {missing[:5]}")


@torch.no_grad()
def ls_params_from_jax(params_np: dict, model_state_np: dict,
                       cfg: ls_eend.LSEENDConfig, device=None) -> ls_eend.LSEEND:
    """The port's LSEEND holding the JAX parameter pytree's values.  Static
    leaves (`_n_heads`, `_groups`) are skipped; every other leaf must land
    on a parameter of the same size, and every parameter must be set."""
    device = resolve_device(device)
    model = ls_eend.empty_ls_eend(cfg, "cpu")
    seen: set = set()
    put = _load_params(model, params_np, seen)
    for i, bn_state in enumerate(model_state_np["conv_bn"]):
        bn = model.enc.blocks[i].conv.bn
        put(bn.running_mean, bn_state["mean"], f"enc.blocks.{i}.conv.bn.running_mean")
        put(bn.running_var, bn_state["var"], f"enc.blocks.{i}.conv.bn.running_var")
        bn.num_batches_tracked.zero_()
        seen.add(f"enc.blocks.{i}.conv.bn.num_batches_tracked")
    _check_all_set(model, seen)
    return model.to(device)


@torch.no_grad()
def fs_params_from_jax(params_np: dict, model_state_np: dict,
                       cfg: fs_eend.FSEENDConfig, device=None) -> fs_eend.FSEEND:
    """The port's FSEEND holding the JAX parameter pytree's values and the
    input BatchNorm's running statistics (`model_state["bn"]`).  Every
    parameter must be set."""
    device = resolve_device(device)
    model = fs_eend.empty_fs_eend(cfg, "cpu")
    seen: set = set()
    put = _load_params(model, params_np, seen)
    bn = model.enc.bn
    put(bn.running_mean, model_state_np["bn"]["mean"], "enc.bn.running_mean")
    put(bn.running_var, model_state_np["bn"]["var"], "enc.bn.running_var")
    bn.num_batches_tracked.zero_()
    seen.add("enc.bn.num_batches_tracked")
    _check_all_set(model, seen)
    return model.to(device)


@torch.no_grad()
def eda_params_from_jax(params_np: dict, cfg: eend_eda.EDAConfig,
                        device=None) -> eend_eda.EENDEDA:
    """The port's EENDEDA holding the JAX `init_eend_eda` pytree's values
    (the model has no `model_state`).  Every parameter must be set."""
    device = resolve_device(device)
    model = eend_eda.empty_eend_eda(cfg, "cpu")
    seen: set = set()
    _load_params(model, params_np, seen)
    _check_all_set(model, seen)
    return model.to(device)


def ls_state_from_jax(state_np: dict, device=None) -> dict:
    """The port's flat stream state from the JAX nested one:
    {"t", "enc": [{"ret": {"kv", "scale"}, "conv"}], "cnn_buf",
     "dec": [{"kv", "scale"}]}."""
    device = resolve_device(device)

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
    device = resolve_device(device)

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


def _stack_layers(layers: list, key: str, device) -> torch.Tensor:
    return torch.as_tensor(np.stack([np.asarray(x[key]) for x in layers])).to(device)


def fs_state_from_jax(state_np: dict, device=None) -> dict:
    """The port's flat per-frame FS state from the JAX nested one:
    {"t" (B,), "emitted" (B,), "enc_kv": [{"k", "v"}], "conv_buf",
     "dec_kv": [{"k", "v"}]}."""
    device = resolve_device(device)
    enc, dec = state_np["enc_kv"], state_np["dec_kv"]
    return {
        "t": torch.as_tensor(np.array(state_np["t"], np.int32)).to(device),
        "emitted": torch.as_tensor(np.array(state_np["emitted"], np.int32)).to(device),
        "enc_k": _stack_layers(enc, "k", device),
        "enc_v": _stack_layers(enc, "v", device),
        "conv_buf": torch.as_tensor(np.array(state_np["conv_buf"])).to(device),
        "dec_k": _stack_layers(dec, "k", device),
        "dec_v": _stack_layers(dec, "v", device),
    }


def fs_state_to_numpy(state: dict) -> dict:
    """The JAX package's nested per-frame FS state (numpy leaves) from the
    port's."""
    n = {k: v.detach().cpu().numpy() for k, v in state.items()}
    return {
        "t": n["t"], "emitted": n["emitted"],
        "enc_kv": [{"k": k, "v": v} for k, v in zip(n["enc_k"], n["enc_v"])],
        "conv_buf": n["conv_buf"],
        "dec_kv": [{"k": k, "v": v} for k, v in zip(n["dec_k"], n["dec_v"])],
    }


def fs_blockstate_from_jax(state_np: dict, device=None) -> dict:
    """The port's flat blockwise FS state from the JAX nested one: scalar
    "t", "emitted", "m"; "enc_kv", "dec_kv" lists; "h_prev", "h_tail2"."""
    device = resolve_device(device)
    enc, dec = state_np["enc_kv"], state_np["dec_kv"]

    def scalar(x):
        return torch.as_tensor(np.array(x, np.int32).reshape(())).to(device)

    return {
        "t": scalar(state_np["t"]), "emitted": scalar(state_np["emitted"]),
        "m": scalar(state_np["m"]),
        "enc_k": _stack_layers(enc, "k", device),
        "enc_v": _stack_layers(enc, "v", device),
        "dec_k": _stack_layers(dec, "k", device),
        "dec_v": _stack_layers(dec, "v", device),
        "h_prev": torch.as_tensor(np.array(state_np["h_prev"])).to(device),
        "h_tail2": torch.as_tensor(np.array(state_np["h_tail2"])).to(device),
    }


def fs_blockstate_to_numpy(state: dict) -> dict:
    """The JAX package's nested blockwise FS state (numpy leaves) from the
    port's."""
    n = {k: v.detach().cpu().numpy() for k, v in state.items()}
    return {
        "t": n["t"], "emitted": n["emitted"], "m": n["m"],
        "enc_kv": [{"k": k, "v": v} for k, v in zip(n["enc_k"], n["enc_v"])],
        "dec_kv": [{"k": k, "v": v} for k, v in zip(n["dec_k"], n["dec_v"])],
        "h_prev": n["h_prev"], "h_tail2": n["h_tail2"],
    }


def _val(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _params_tree(mod: nn.Module):
    """The JAX parameter pytree of a module: linear kernels (in, out),
    convolution kernels (width, in/groups, out), norms as scale/bias; static
    leaves (`_n_heads`, `_groups`) left out."""
    if isinstance(mod, nn.ModuleList):
        return [_params_tree(m) for m in mod]
    if isinstance(mod, nn.Linear):
        return {"kernel": _val(mod.weight).T.copy(), "bias": _val(mod.bias)}
    if isinstance(mod, nn.Conv1d):
        out = {"kernel": _val(mod.weight).transpose(2, 1, 0).copy()}
        if mod.bias is not None:
            out["bias"] = _val(mod.bias)
        return out
    if isinstance(mod, (nn.LayerNorm, nn.BatchNorm1d)):
        return {"scale": _val(mod.weight), "bias": _val(mod.bias)}
    if isinstance(mod, eend_eda.LSTM):
        return {"w_ih": _val(mod.weight_ih).T.copy(), "w_hh": _val(mod.weight_hh).T.copy(),
                "b_ih": _val(mod.bias_ih), "b_hh": _val(mod.bias_hh)}
    return {name: _params_tree(child) for name, child in mod.named_children()}


@torch.no_grad()
def ls_params_to_jax(model: ls_eend.LSEEND):
    """The JAX package's (params, model_state) pytrees, numpy leaves, from
    the port's module, the conformer BatchNorm statistics in model_state."""
    bn = [blk.conv.bn for blk in model.enc.blocks]
    return _params_tree(model), {"conv_bn": [{"mean": _val(b.running_mean),
                                              "var": _val(b.running_var)} for b in bn]}


@torch.no_grad()
def fs_params_to_jax(model: fs_eend.FSEEND):
    """The JAX package's (params, model_state) pytrees, numpy leaves, from
    the port's FSEEND, the input BatchNorm statistics in model_state."""
    bn = model.enc.bn
    return _params_tree(model), {"bn": {"mean": _val(bn.running_mean),
                                        "var": _val(bn.running_var)}}


@torch.no_grad()
def eda_params_to_jax(model: eend_eda.EENDEDA):
    """The JAX package's (params, model_state) pytrees, numpy leaves, from
    the port's EENDEDA; model_state is {} (no BatchNorm)."""
    return _params_tree(model), {}
