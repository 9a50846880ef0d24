"""Offline EEND-EDA: a transformer encoder and LSTM encoder-decoder
attractors (the reference's FS-EEND/nnet/model/offl_tfm_enc_lstm_enc_dec.py),
also the scorer of FLEX-STB block streaming (`serving/flex_stb.py`).

Port of `fseend_tpu/models/eend_eda.py`.  Parameters live in `EENDEDA`, an
`nn.Module` whose submodule paths follow the JAX parameter pytree
(`enc.proj`, `enc.norm`, `enc.layers.{i}`, `eda.encoder`, `eda.decoder`,
`eda.counter`); the LSTMs keep torch's layout (`weight_ih` (4H, in),
`weight_hh` (4H, H), gates ordered i, f, g, o), where the JAX package keeps
the transposes (`utils/convert.py` maps one onto the other).  The model
has no BatchNorm, so its JAX `model_state` is {}.

The LSTM runs as the JAX `lax.scan` does, not through cuDNN: the input
product of all frames is one matmul, then each step is one `h @ w_hh`
product and the gate arithmetic (8 launches a step, serial in the frames;
twice that in the backward).  With `lens` the state of each sequence
stops at its last valid frame, the `torch.where` freeze of the JAX scan.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch import nn

from fseend_tpu_torch.models.ls_eend import resolve_device
from fseend_tpu_torch.ops import nn as tnn


@dataclasses.dataclass(frozen=True)
class EDAConfig:
    """The JAX package's EDAConfig."""
    in_size: int = 345
    n_units: int = 256
    n_heads: int = 4
    n_layers: int = 4
    dim_feedforward: int = 2048
    dropout: float = 0.1               # training only
    attractor_loss_ratio: float = 1.0
    max_attractors: int = 15           # eda_test's default attractor count


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


class LSTM(nn.Module):
    """One LSTM layer's weights in torch's `nn.LSTM` layout (gates i, f, g,
    o along the 4H rows)."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden, in_dim))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.bias_ih = nn.Parameter(torch.empty(4 * hidden))
        self.bias_hh = nn.Parameter(torch.empty(4 * hidden))


class Encoder(nn.Module):
    def __init__(self, cfg: EDAConfig):
        super().__init__()
        self.proj = nn.Linear(cfg.in_size, cfg.n_units)
        self.norm = nn.LayerNorm(cfg.n_units)
        self.layers = nn.ModuleList(
            tnn.TransformerLayer(cfg.n_units, cfg.n_heads, cfg.dim_feedforward)
            for _ in range(cfg.n_layers))


class EDA(nn.Module):
    def __init__(self, cfg: EDAConfig):
        super().__init__()
        self.encoder = LSTM(cfg.n_units, cfg.n_units)
        self.decoder = LSTM(cfg.n_units, cfg.n_units)
        self.counter = nn.Linear(cfg.n_units, 1)


class EENDEDA(nn.Module):
    def __init__(self, cfg: EDAConfig):
        super().__init__()
        self.cfg = cfg
        self.enc = Encoder(cfg)
        self.eda = EDA(cfg)


def empty_eend_eda(cfg: EDAConfig, device) -> EENDEDA:
    """An EENDEDA with uninitialized storage on `device` (built on the meta
    device: no random numbers are drawn from the global generator)."""
    with torch.device("meta"):
        model = EENDEDA(cfg)
    return model.to_empty(device=device).eval()


@torch.no_grad()
def init_eend_eda(cfg: EDAConfig, generator: torch.Generator | None = None,
                  device=None) -> EENDEDA:
    """Randomly initialized model, drawn on the CPU from `generator`, then
    moved to `device` (the card unless the caller names another).  The
    initializers follow the JAX package's: U(+-0.1) input projection with a
    zero bias, xavier attention in-projections with zero biases,
    torch-default linears, unit layer norms, every LSTM tensor
    U(+-1/sqrt(H))."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = empty_eend_eda(cfg, "cpu")

    def uniform_(t, bound):
        t.uniform_(-bound, bound, generator=generator)

    for m in model.modules():
        if isinstance(m, nn.Linear):
            bound = m.weight.shape[1] ** -0.5
            uniform_(m.weight, bound)
            uniform_(m.bias, bound)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, LSTM):
            for t in (m.weight_ih, m.weight_hh, m.bias_ih, m.bias_hh):
                uniform_(t, cfg.n_units ** -0.5)
        if isinstance(m, tnn.MultiheadAttention):
            uniform_(m.in_proj.weight, (6.0 / (2 * cfg.n_units)) ** 0.5)
            m.in_proj.bias.zero_()
    uniform_(model.enc.proj.weight, 0.1)
    model.enc.proj.bias.zero_()
    return model.to(device)


# ---------------------------------------------------------------------------
# LSTM
# ---------------------------------------------------------------------------


def _gates(z: torch.Tensor, c: torch.Tensor):
    """The cell update from the pre-activations z (B, 4H): (h, c).  The
    gates are `chunk` views, whose backward is one concatenation (a slice's
    would zero a whole (B, 4H) gradient for each gate)."""
    zi, zf, zg, zo = z.chunk(4, dim=1)
    c = torch.addcmul(torch.sigmoid(zf) * c, torch.sigmoid(zi), torch.tanh(zg))
    return torch.sigmoid(zo) * torch.tanh(c), c


def lstm_cell(p: LSTM, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
    """One step: x (B, in), h, c (B, H) -> (h, c)."""
    z = tnn.linear(x, p.weight_ih, p.bias_ih) + tnn.linear(h, p.weight_hh, p.bias_hh)
    return _gates(z, c)


def lstm_scan(p: LSTM, xs: torch.Tensor, h0: torch.Tensor | None = None,
              c0: torch.Tensor | None = None, lens: torch.Tensor | None = None):
    """xs (B, T, in) -> (outputs (B, T, H), (h_T, c_T)).

    The input product of all T frames is one matmul; each step adds
    h @ w_hh.  With `lens` (B,) the state stops changing at t >= len, so
    (h_T, c_T) is the state after each sequence's last valid frame (what
    torch's pack_padded_sequence gives)."""
    B, T, _ = xs.shape
    H = p.weight_hh.shape[1]
    h = xs.new_zeros(B, H) if h0 is None else h0
    c = xs.new_zeros(B, H) if c0 is None else c0
    # T tensors (B, 4H), both biases added once; `unbind`'s backward is one
    # stack, where indexing frame t would add a zeroed (T, B, 4H) gradient
    # per frame
    xw = tnn.linear(xs, p.weight_ih, p.bias_ih + p.bias_hh).transpose(0, 1).contiguous()
    xw = xw.unbind(0)
    w_hh_t = p.weight_hh.t()
    valid = None
    if lens is not None:
        t = torch.arange(T, device=xs.device)[:, None]
        valid = (t < lens.to(xs.device)[None, :])[..., None]            # (T, B, 1)
    ys = []
    for t in range(T):
        hn, cn = _gates(torch.addmm(xw[t], h, w_hh_t), c)
        if valid is not None:
            hn = torch.where(valid[t], hn, h)
            cn = torch.where(valid[t], cn, c)
        h, c = hn, cn
        ys.append(h)
    return torch.stack(ys, dim=1), (h, c)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


def encode(model: EENDEDA, xs: torch.Tensor, *, train: bool = False,
           generator: torch.Generator | None = None,
           lens: torch.Tensor | None = None) -> torch.Tensor:
    """The unmasked (offline) transformer encoder: (B, T, in) -> (B, T, D).
    With `lens` (B,) the frames at t >= len are masked out of every
    attention's keys, so the valid frames come out as if the pad were
    absent.  In training, dropout from `generator` at the JAX
    `transformer_layer`'s sites."""
    h = tnn.layer_norm(tnn.linear(xs, model.enc.proj.weight, model.enc.proj.bias),
                       model.enc.norm.weight, model.enc.norm.bias)
    mask = None
    if lens is not None:
        valid = torch.arange(xs.shape[1], device=xs.device)[None, :] < lens[:, None]
        mask = torch.where(valid, 0.0, float("-inf"))[:, None, None, :]
    rate = model.cfg.dropout if train else 0.0
    for lp in model.enc.layers:
        h = tnn.transformer_layer(lp, h, mask, rate, generator)
    return h


def eda_attractors(model: EENDEDA, emb: torch.Tensor, n_attractors: int,
                   lens: torch.Tensor | None = None):
    """The LSTM encoder over emb gives (h, c); the LSTM decoder, run from
    there on zero inputs, emits the attractors.  Returns (attractors (B, n,
    D), existence logits (B, n)); `lens` stops the encoder's state at each
    sequence's length."""
    _, (h, c) = lstm_scan(model.eda.encoder, emb, lens=lens)
    zeros = emb.new_zeros(emb.shape[0], n_attractors, emb.shape[2])
    attractors, _ = lstm_scan(model.eda.decoder, zeros, h, c)
    counter = model.eda.counter
    return attractors, tnn.linear(attractors, counter.weight, counter.bias)[..., 0]


def _check_input(model: EENDEDA, xs) -> torch.Tensor:
    xs = torch.as_tensor(xs).to(model.enc.proj.weight.device)
    if xs.dtype != torch.float32:
        raise ValueError(f"EEND-EDA input: {xs.dtype}; the port runs float32 only")
    return xs


def eda_forward(model: EENDEDA, xs, n_speakers_max: int, *, train: bool = False,
                generator: torch.Generator | None = None) -> dict:
    """The training pass with a known speaker count: n_speakers_max + 1
    attractors, the last one the "no more speakers" one.  Returns logits
    (B, T, n_speakers_max), emb, attractors and exist_logits.  train=True
    carries autograd and draws dropout from `generator` (on the model's
    device; none without one); otherwise the pass runs without autograd."""
    with contextlib.nullcontext() if train else torch.no_grad():
        xs = _check_input(model, xs)
        emb = encode(model, xs, train=train, generator=generator)
        attractors, exist = eda_attractors(model, emb, n_speakers_max + 1)
        logits = torch.einsum("btd,bcd->btc", emb, attractors[:, :-1])
        return {"logits": logits, "emb": emb, "attractors": attractors, "exist_logits": exist}


@torch.no_grad()
def eda_test(model: EENDEDA, xs, *, shuffle_generator: torch.Generator | None = None,
             n_attractors: int | None = None, lens=None) -> dict:
    """Inference.  With `shuffle_generator` the attractor LSTM reads the
    embeddings in an order `torch.randperm` draws from it (the reference's
    time shuffle; the JAX package draws another order from its key).  `lens`
    (B,) masks the pad frames out of the attention and the attractor LSTM,
    so a padded batch scores each true-length sequence exactly; the logits
    at t >= len are garbage.  The shuffle and `lens` are not taken together
    (the shuffle would scatter pad frames into the valid range).  Returns
    logits (B, T, n), emb, attractors and exist_probs (B, n); n is
    `n_attractors`, else cfg.max_attractors."""
    if shuffle_generator is not None and lens is not None:
        raise ValueError("the time shuffle would scatter pad frames into the valid range")
    xs = _check_input(model, xs)
    if lens is not None:
        lens = torch.as_tensor(lens).to(xs.device)
    emb = encode(model, xs, lens=lens)
    emb_in = emb
    if shuffle_generator is not None:
        order = torch.randperm(emb.shape[1], generator=shuffle_generator,
                               device=shuffle_generator.device)
        emb_in = emb[:, order.to(emb.device)]
    n = n_attractors if n_attractors is not None else model.cfg.max_attractors
    attractors, exist = eda_attractors(model, emb_in, n, lens=lens)
    logits = torch.einsum("btd,bcd->btc", emb, attractors)
    return {"logits": logits, "emb": emb, "attractors": attractors,
            "exist_probs": torch.sigmoid(exist)}
