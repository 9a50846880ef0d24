"""A reference (PyTorch LS-EEND or FS-EEND) state dict -> the port's
`LSEEND` / `FSEEND`.

The port's own copy of `fseend_tpu/utils/torch_convert.py`
(`normalize_keys`, `ls_from_state_dict`, `fs_from_state_dict` and their
helpers), so that a released reference checkpoint, or a committed golden,
reaches the port without the JAX package.  The helpers build the JAX
package's parameter pytree (numpy leaves, linear kernels (in, out));
`utils/convert.py:{ls,fs}_params_from_jax` puts it on the module.  Accepts the "model." prefix and the legacy
`dec.attractor_decoder.layers.*` keys, as the reference does.
"""

from __future__ import annotations

import numpy as np

from fseend_tpu_torch.models import fs_eend, ls_eend
from fseend_tpu_torch.utils import convert


def normalize_keys(sd: dict) -> dict:
    """Strip "model." and remap dec.attractor_decoder.layers -> dec.layers."""
    out = {}
    for k, v in sd.items():
        if k.startswith("model."):
            k = k[len("model."):]
        out[k.replace("dec.attractor_decoder.layers.", "dec.layers.")] = v
    return out


def _lin(sd, name):
    return {"kernel": np.ascontiguousarray(np.asarray(sd[f"{name}.weight"]).T),
            "bias": np.array(sd[f"{name}.bias"])}


def _ln(sd, name):
    return {"scale": np.array(sd[f"{name}.weight"]), "bias": np.array(sd[f"{name}.bias"])}


def _mha(sd, name):
    return {"in_proj": {"kernel": np.ascontiguousarray(np.asarray(sd[f"{name}.in_proj_weight"]).T),
                        "bias": np.array(sd[f"{name}.in_proj_bias"])},
            "out_proj": _lin(sd, f"{name}.out_proj")}


def _conv1d(sd, name, bias=True):
    p = {"kernel": np.ascontiguousarray(np.asarray(sd[f"{name}.weight"]).transpose(2, 1, 0))}
    if bias:
        p["bias"] = np.array(sd[f"{name}.bias"])
    return p


def _retention(sd, name):
    return {proj: _lin(sd, f"{name}.{proj}")
            for proj in ("q_proj", "k_proj", "v_proj", "g_proj", "out_proj")}


def ls_tree_from_state_dict(sd: dict, cfg: ls_eend.LSEENDConfig):
    """Reference OnlineConformerRetentionDADiarization state dict -> the JAX
    layout's (params, model_state), numpy leaves."""
    sd = normalize_keys(sd)
    blocks, conv_bn = [], []
    for i in range(cfg.enc_n_layers):
        pre = f"enc.encoder.layers.{i}.sequential"

        def ff(j):
            return {"norm": _ln(sd, f"{pre}.{j}.module.sequential.0"),
                    "linear1": _lin(sd, f"{pre}.{j}.module.sequential.1.linear"),
                    "linear2": _lin(sd, f"{pre}.{j}.module.sequential.4.linear")}

        cm = f"{pre}.2.module.sequential"
        pw1_w = np.asarray(sd[f"{cm}.2.conv.weight"])      # (2D, D, 1)
        pw2_w = np.asarray(sd[f"{cm}.7.conv.weight"])      # (D, D, 1)
        blocks.append({
            "ff1": ff(0),
            "ret_norm": _ln(sd, f"{pre}.1.module.layer_norm"),
            "ret": _retention(sd, f"{pre}.1.module.self_attn"),
            "conv": {
                "norm": _ln(sd, f"{cm}.0"),
                "pw1": {"kernel": np.ascontiguousarray(pw1_w[:, :, 0].T),
                        "bias": np.array(sd[f"{cm}.2.conv.bias"])},
                "dw": _conv1d(sd, f"{cm}.4.conv", bias=False),
                "bn": {"scale": np.array(sd[f"{cm}.5.weight"]),
                       "bias": np.array(sd[f"{cm}.5.bias"])},
                "pw2": {"kernel": np.ascontiguousarray(pw2_w[:, :, 0].T),
                        "bias": np.array(sd[f"{cm}.7.conv.bias"])},
            },
            "ff2": ff(3),
            "final_norm": _ln(sd, f"{pre}.4"),
        })
        conv_bn.append({"mean": np.array(sd[f"{cm}.5.running_mean"]),
                        "var": np.array(sd[f"{cm}.5.running_var"])})
    dec_layers = []
    for i in range(cfg.dec_n_layers):
        pre = f"dec.layers.{i}"
        dec_layers.append({
            "time_ret": _retention(sd, f"{pre}.self_attn1"),
            "spk_attn": _mha(sd, f"{pre}.self_attn2"),
            "linear1": _lin(sd, f"{pre}.linear1"),
            "linear2": _lin(sd, f"{pre}.linear2"),
            "norm11": _ln(sd, f"{pre}.norm11"),
            "norm21": _ln(sd, f"{pre}.norm21"),
            "norm22": _ln(sd, f"{pre}.norm22"),
        })
    params = {
        "enc": {"proj": _lin(sd, "enc.encoder.input_projection.linear"),
                "norm": _ln(sd, "enc.encoder.layer_norm"), "blocks": blocks},
        "cnn": _conv1d(sd, "cnn"),
        "dec": {"convert": _lin(sd, "dec.convert"), "layers": dec_layers},
    }
    return params, {"conv_bn": conv_bn}


def ls_from_state_dict(sd: dict, cfg: ls_eend.LSEENDConfig, device=None) -> ls_eend.LSEEND:
    """The port's `LSEEND` holding a reference state dict's weights and
    BatchNorm statistics, on `device` (the card unless the caller names
    another)."""
    params, model_state = ls_tree_from_state_dict(sd, cfg)
    return convert.ls_params_from_jax(params, model_state, cfg, device)


def fs_tree_from_state_dict(sd: dict, cfg: fs_eend.FSEENDConfig):
    """Reference OnlineTransformerDADiarization state dict -> the JAX
    layout's (params, model_state), numpy leaves.  Keys the model does not
    use are ignored."""
    sd = normalize_keys(sd)
    enc_layers = []
    for i in range(cfg.enc_n_layers):
        pre = f"enc.transformer_encoder.layers.{i}"
        enc_layers.append({"self_attn": _mha(sd, f"{pre}.self_attn"),
                           "linear1": _lin(sd, f"{pre}.linear1"),
                           "linear2": _lin(sd, f"{pre}.linear2"),
                           "norm1": _ln(sd, f"{pre}.norm1"),
                           "norm2": _ln(sd, f"{pre}.norm2")})
    dec_layers = []
    for i in range(cfg.dec_n_layers):
        pre = f"dec.layers.{i}"
        dec_layers.append({"time_attn": _mha(sd, f"{pre}.self_attn1"),
                           "spk_attn": _mha(sd, f"{pre}.self_attn2"),
                           "linear1": _lin(sd, f"{pre}.linear1"),
                           "linear2": _lin(sd, f"{pre}.linear2"),
                           **{n: _ln(sd, f"{pre}.{n}")
                              for n in ("norm11", "norm12", "norm21", "norm22")}})
    params = {
        "enc": {"bn": _ln(sd, "enc.bn"), "proj": _lin(sd, "enc.encoder"),
                "norm": _ln(sd, "enc.encoder_norm"), "layers": enc_layers},
        "cnn": _conv1d(sd, "cnn"),
        "dec": {"convert": _lin(sd, "dec.convert"), "layers": dec_layers},
    }
    model_state = {"bn": {"mean": np.array(sd["enc.bn.running_mean"]),
                          "var": np.array(sd["enc.bn.running_var"])}}
    return params, model_state


def fs_from_state_dict(sd: dict, cfg: fs_eend.FSEENDConfig, device=None) -> fs_eend.FSEEND:
    """The port's `FSEEND` holding a reference state dict's weights and
    input BatchNorm statistics, on `device` (the card unless the caller
    names another)."""
    params, model_state = fs_tree_from_state_dict(sd, cfg)
    return convert.fs_params_from_jax(params, model_state, cfg, device)
