"""LS-EEND per-frame streaming: the conformer-retention encoder, the
look-ahead cnn and the retention attractor decoder, O(1) state per stream.

Port of the streaming part of `fseend_tpu/models/ls_eend.py`.  Parameters
live in `LSEEND`, an `nn.Module` whose submodule paths follow the JAX
parameter pytree (`enc.proj`, `enc.blocks.{i}.ff1.linear1`,
`dec.layers.{i}.time_ret.q_proj`, ...); the BatchNorm running statistics
(the JAX `model_state`) are its buffers.

Two ways through a block of frames:
  * `ls_stream_step` / `ls_stream_scan`: the plain per-frame path, a
    Python loop of tensor ops.  It is the oracle the kernel path is held to.
  * `ls_stream_block_fused` / `ls_stream_scan_fused`: the encoder and the
    decoder each run as one frame-scan call per block (`kernels/`), CUDA
    kernels on the card; the input projection, the look-ahead cnn and the
    decoder's `convert` stay plain matmuls.

The stream state is a flat dict of stacked, lane-major tensors, the layout
the kernels read directly (no per-block repack of the ~170 MB decoder state):
  t          (B,)                  per-lane stream clock (steps, flush included)
  enc_kv     (Le, B, H, dv, dk)    encoder retention states, normalized
  enc_scale  (Le, B, H)
  enc_conv   (Le, B, k-1, D)       conformer conv history (post-GLU)
  cnn_buf    (B, 2*delay+1, D)     look-ahead cnn window
  dec_kv     (Ld, B*C, H, dv, dk)  decoder retention states, lane b's slots
  dec_scale  (Ld, B*C, H)          contiguous
`utils/convert.py` maps it to and from the JAX package's nested state.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from fseend_tpu_torch.kernels import dec_frame_scan as DFS
from fseend_tpu_torch.kernels import enc_frame_scan as EFS
from fseend_tpu_torch.ops import nn as tnn
from fseend_tpu_torch.ops import retention as R


@dataclasses.dataclass(frozen=True)
class LSEENDConfig:
    in_size: int = 345
    n_units: int = 256
    n_heads: int = 4
    enc_n_layers: int = 4
    dec_n_layers: int = 2
    ff_expansion: int = 4              # feed_forward_expansion_factor
    conv_expansion: int = 2
    conv_kernel_size: int = 16         # conformer causal depthwise conv
    dec_dim_feedforward: int = 2048
    conv_delay: int = 9                # look-ahead cnn between enc and dec
    max_nspks: int = 10                # max_speakers + 2
    half_step_residual: bool = True

    @property
    def lookahead_kernel(self) -> int:
        return 2 * self.conv_delay + 1

    @property
    def ret_cfg(self) -> R.RetentionConfig:
        return R.RetentionConfig(self.n_units, self.n_heads)

    @property
    def ff_factor(self) -> float:
        return 0.5 if self.half_step_residual else 1.0


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another.  Raises when the card is asked for and there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return device


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


class FeedForward(nn.Module):
    def __init__(self, d: int, expansion: int):
        super().__init__()
        self.norm = nn.LayerNorm(d)
        self.linear1 = nn.Linear(d, d * expansion)
        self.linear2 = nn.Linear(d * expansion, d)


class ConvModule(nn.Module):
    def __init__(self, d: int, expansion: int, kernel: int):
        super().__init__()
        self.norm = nn.LayerNorm(d)
        self.pw1 = nn.Linear(d, d * expansion)
        self.dw = nn.Conv1d(d, d, kernel, groups=d, bias=False)
        self.bn = nn.BatchNorm1d(d)
        self.pw2 = nn.Linear(d, d)


class ConformerBlock(nn.Module):
    def __init__(self, cfg: LSEENDConfig):
        super().__init__()
        D = cfg.n_units
        self.ff1 = FeedForward(D, cfg.ff_expansion)
        self.ret_norm = nn.LayerNorm(D)
        self.ret = R.Retention(cfg.ret_cfg)
        self.conv = ConvModule(D, cfg.conv_expansion, cfg.conv_kernel_size)
        self.ff2 = FeedForward(D, cfg.ff_expansion)
        self.final_norm = nn.LayerNorm(D)


class Encoder(nn.Module):
    def __init__(self, cfg: LSEENDConfig):
        super().__init__()
        self.proj = nn.Linear(cfg.in_size, cfg.n_units)
        self.norm = nn.LayerNorm(cfg.n_units)
        self.blocks = nn.ModuleList(ConformerBlock(cfg) for _ in range(cfg.enc_n_layers))


class FusionLayer(nn.Module):
    """Retention fusion decoder layer: time retention, slot attention, FFN."""

    def __init__(self, cfg: LSEENDConfig):
        super().__init__()
        D = cfg.n_units
        self.time_ret = R.Retention(cfg.ret_cfg)
        self.spk_attn = tnn.MultiheadAttention(D, cfg.n_heads)
        self.linear1 = nn.Linear(D, cfg.dec_dim_feedforward)
        self.linear2 = nn.Linear(cfg.dec_dim_feedforward, D)
        self.norm11 = nn.LayerNorm(D)
        self.norm21 = nn.LayerNorm(D)
        self.norm22 = nn.LayerNorm(D)


class Decoder(nn.Module):
    def __init__(self, cfg: LSEENDConfig):
        super().__init__()
        self.convert = nn.Linear(2 * cfg.n_units, cfg.n_units)
        self.layers = nn.ModuleList(FusionLayer(cfg) for _ in range(cfg.dec_n_layers))


class LSEEND(nn.Module):
    def __init__(self, cfg: LSEENDConfig):
        super().__init__()
        self.cfg = cfg
        self.enc = Encoder(cfg)
        self.cnn = nn.Conv1d(cfg.n_units, cfg.n_units, cfg.lookahead_kernel)
        self.dec = Decoder(cfg)


def empty_ls_eend(cfg: LSEENDConfig, device) -> LSEEND:
    """An LSEEND with uninitialized storage on `device` (built on the meta
    device, so no random numbers are drawn from the global generator)."""
    with torch.device("meta"):
        model = LSEEND(cfg)
    return model.to_empty(device=device).eval()


@torch.no_grad()
def init_ls_eend(cfg: LSEENDConfig, generator: torch.Generator | None = None,
                 device=None) -> LSEEND:
    """Randomly initialized model, drawn on the CPU from `generator` (so one
    seed gives the same weights on every device), then moved to `device`.
    The initializers follow the JAX package's: torch-default uniform linears
    and convs, xavier retention projections (gain 2^-2.5) and input
    projection, xavier slot-attention in-projection, fresh BatchNorm stats."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = empty_ls_eend(cfg, "cpu")

    def uniform_(t, bound):
        t.uniform_(-bound, bound, generator=generator)

    def torch_default(lin):
        bound = lin.weight.shape[1] ** -0.5
        uniform_(lin.weight, bound)
        uniform_(lin.bias, bound)

    def xavier(lin, gain=1.0):
        fan_out, fan_in = lin.weight.shape
        uniform_(lin.weight, gain * (6.0 / (fan_in + fan_out)) ** 0.5)
        lin.bias.zero_()

    for m in model.modules():
        if isinstance(m, nn.Linear):
            torch_default(m)
        elif isinstance(m, nn.Conv1d):
            bound = (m.weight.shape[1] * m.weight.shape[2]) ** -0.5
            uniform_(m.weight, bound)
            if m.bias is not None:
                uniform_(m.bias, bound)
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm1d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        if isinstance(m, nn.BatchNorm1d):
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
    xavier(model.enc.proj)
    for ret in [b.ret for b in model.enc.blocks] + [lp.time_ret for lp in model.dec.layers]:
        for lin in (ret.q_proj, ret.k_proj, ret.v_proj, ret.g_proj):
            xavier(lin, 2.0 ** -2.5)
        xavier(ret.out_proj)
    for lp in model.dec.layers:
        uniform_(lp.spk_attn.in_proj.weight, (6.0 / (2 * cfg.n_units)) ** 0.5)
        lp.spk_attn.in_proj.bias.zero_()
    return model.to(device)


# ---------------------------------------------------------------------------
# streaming state
# ---------------------------------------------------------------------------


def ls_stream_init(cfg: LSEENDConfig, batch: int, n_slots: int | None = None,
                   dtype=torch.float32, device=None) -> dict:
    """Zero (fresh-stream) state for `batch` lanes; O(1) in stream length."""
    C = n_slots if n_slots is not None else cfg.max_nspks
    rc = cfg.ret_cfg
    H, dv, dk = rc.num_heads, rc.head_dim, rc.key_dim
    Le, Ld, D = cfg.enc_n_layers, cfg.dec_n_layers, cfg.n_units

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "t": torch.zeros(batch, dtype=torch.int32, device=device),
        "enc_kv": z(Le, batch, H, dv, dk),
        "enc_scale": z(Le, batch, H),
        "enc_conv": z(Le, batch, cfg.conv_kernel_size - 1, D),
        "cnn_buf": z(batch, cfg.lookahead_kernel, D),
        "dec_kv": z(Ld, batch * C, H, dv, dk),
        "dec_scale": z(Ld, batch * C, H),
    }


# ---------------------------------------------------------------------------
# plain per-frame path (the oracle)
# ---------------------------------------------------------------------------


def _ln(m: nn.LayerNorm, x):
    return tnn.layer_norm(x, m.weight, m.bias)


def _lin(m: nn.Linear, x):
    return tnn.linear(x, m.weight, m.bias)


def _ff(p: FeedForward, x):
    """FeedForwardModule: LN -> Linear -> swish -> Linear."""
    return _lin(p.linear2, F.silu(_lin(p.linear1, _ln(p.norm, x))))


def _conv_module_step(p: ConvModule, x_t, cache):
    """One-step causal conv module. x_t: (B, D); cache: (B, k-1, D) post-GLU
    history -> (y (B, D), new cache)."""
    h = _lin(p.pw1, _ln(p.norm, x_t))
    a, b = h.chunk(2, dim=-1)
    h = a * torch.sigmoid(b)
    window = torch.cat([cache, h[:, None, :]], dim=1)        # (B, k, D)
    y = torch.einsum("bkd,dk->bd", window, p.dw.weight[:, 0, :])
    y = F.silu(tnn.batch_norm(y, p.bn))
    return _lin(p.pw2, y), window[:, 1:]


def _block_step(p: ConformerBlock, x_t, st: dict, cfg: LSEENDConfig):
    """One-step conformer block; st = {"ret": {"kv", "scale"}, "conv"}."""
    x_t = x_t.to(st["conv"].dtype)
    x = x_t + cfg.ff_factor * _ff(p.ff1, x_t)
    h, ret_state = R.retention_recurrent_step(p.ret, _ln(p.ret_norm, x), st["ret"],
                                              cfg.ret_cfg)
    x = x + h
    h, conv_cache = _conv_module_step(p.conv, x, st["conv"])
    x = x + h
    x = x + cfg.ff_factor * _ff(p.ff2, x)
    return _ln(p.final_norm, x), {"ret": ret_state,
                                  "conv": conv_cache.to(st["conv"].dtype)}


def _keep(keep_old, new, old):
    """Per-lane select of a (lanes, ...) tensor."""
    return torch.where(keep_old.reshape(keep_old.shape + (1,) * (new.ndim - 1)), old, new)


@torch.no_grad()
def ls_stream_step(model: LSEEND, state: dict, x_t: torch.Tensor, n_slots: int,
                   flush=False):
    """One O(1) streaming step. x_t: (B, in_size).  `flush` (scalar or
    per-lane (B,)) pushes a zero vector into the look-ahead cnn and keeps
    the lane's encoder state, so a lane can drain its conv tail while the
    others consume audio.  Returns (new_state, out) with out["logits"]
    (B, C), out["emb"] (B, D), out["valid"] (B,)."""
    cfg = model.cfg
    rc = cfg.ret_cfg
    t = state["t"]
    B = x_t.shape[0]
    C, D = n_slots, cfg.n_units
    flush = torch.as_tensor(flush, dtype=torch.bool, device=x_t.device).expand(B)

    # --- conformer encoder, one frame ---
    h = _ln(model.enc.norm, _lin(model.enc.proj, x_t))
    enc = {"enc_kv": [], "enc_scale": [], "enc_conv": []}
    for l, bp in enumerate(model.enc.blocks):
        st = {"ret": {"kv": state["enc_kv"][l], "scale": state["enc_scale"][l]},
              "conv": state["enc_conv"][l]}
        h, new = _block_step(bp, h, st, cfg)
        enc["enc_kv"].append(_keep(flush, new["ret"]["kv"], st["ret"]["kv"]))
        enc["enc_scale"].append(_keep(flush, new["ret"]["scale"], st["ret"]["scale"]))
        enc["enc_conv"].append(_keep(flush, new["conv"], st["conv"]))
    h = torch.where(flush[:, None], torch.zeros((), dtype=h.dtype, device=h.device), h)
    # --- look-ahead cnn ring ---
    cnn_buf = torch.cat([state["cnn_buf"][:, 1:], h[:, None, :]], dim=1)
    y = torch.einsum("bkd,odk->bo", cnn_buf, model.cnn.weight) + model.cnn.bias
    valid = t >= cfg.conv_delay
    emb = tnn.l2_normalize(y)
    # --- retention attractor decoder, one frame ---
    pe = tnn.sinusoidal_table(C, D, device=emb.device).to(emb.dtype)
    x = torch.cat([emb[:, None, :].expand(B, C, D), pe[None].expand(B, C, D)], dim=-1)
    x = _lin(model.dec.convert, x)                            # (B, C, D)
    valid_slots = valid.repeat_interleave(C)                  # decoder lanes are B*C
    dec = {"dec_kv": [], "dec_scale": []}
    for l, lp in enumerate(model.dec.layers):
        st = {"kv": state["dec_kv"][l], "scale": state["dec_scale"][l]}
        a, ret_state = R.retention_recurrent_step(lp.time_ret, x.reshape(B * C, D), st, rc)
        dec["dec_kv"].append(_keep(~valid_slots, ret_state["kv"], st["kv"]))
        dec["dec_scale"].append(_keep(~valid_slots, ret_state["scale"], st["scale"]))
        x = _ln(lp.norm11, x + a.reshape(B, C, D))
        x = _ln(lp.norm21, x + tnn.mha(lp.spk_attn, x, x, x))
        x = _ln(lp.norm22, x + tnn.ff_block(x, lp.linear1, lp.linear2))
    attractors = tnn.l2_normalize(x)
    logits = torch.einsum("bd,bcd->bc", emb, attractors)
    # the clock counts STEPS (real + flush): a flush step still slides the
    # conv window, so `valid` must keep advancing or a stream shorter than
    # conv_delay would never emit (its outputs all surface during flush)
    new_state = {"t": t + 1, "cnn_buf": cnn_buf.to(state["cnn_buf"].dtype)}
    new_state.update({k: torch.stack(v) for k, v in enc.items()})
    new_state.update({k: torch.stack(v) for k, v in dec.items()})
    return new_state, {"logits": logits, "emb": emb, "valid": valid}


def ls_stream_scan(model: LSEEND, state: dict, xs: torch.Tensor, n_slots: int):
    """Whole-clip plain streaming, time-aligned to the batch output: pads
    `conv_delay` flush frames and drops the first `conv_delay` outputs.
    xs (B, T, in_size) -> (logits (B, T, C), emb (B, T, D))."""
    cfg = model.cfg
    B, T, Fin = xs.shape
    seq = torch.cat([xs, xs.new_zeros(B, cfg.conv_delay, Fin)], dim=1)
    logits, embs = [], []
    for i in range(T + cfg.conv_delay):
        state, out = ls_stream_step(model, state, seq[:, i], n_slots, flush=i >= T)
        logits.append(out["logits"])
        embs.append(out["emb"])
    d = cfg.conv_delay
    return torch.stack(logits[d:], dim=1), torch.stack(embs[d:], dim=1)


# ---------------------------------------------------------------------------
# kernel path
# ---------------------------------------------------------------------------


def pack_weights(model: LSEEND):
    """The frame-scan kernels' stacked weights (pack once per model)."""
    return (EFS.pack_enc_weights(model.enc.blocks),
            DFS.pack_dec_weights(model.dec.layers))


@torch.no_grad()
def ls_stream_block_fused(model: LSEEND, state: dict, xs: torch.Tensor,
                          flush: torch.Tensor, n_slots: int, packed=None):
    """A K-frame block with per-frame streaming semantics, the encoder and
    the decoder each in one frame-scan call (`kernels/`); the same result as
    scanning `ls_stream_step` over the block, per-lane flush and clocks
    included.  xs (B, K, in_size); flush (K, B) bool; `packed` is
    `pack_weights(model)` (computed here when None).

    The state's retention tensors and conv history are updated IN PLACE (the
    decoder state alone is ~170 MB at 128 lanes); the returned state shares
    them.  Returns (new_state, (logits (K, B, C) f32, valid (K, B)))."""
    cfg = model.cfg
    B, T, _ = xs.shape
    C, D = n_slots, cfg.n_units
    ew, dw = pack_weights(model) if packed is None else packed
    dt = state["cnn_buf"].dtype
    flush_bt = flush.T.contiguous()                            # (B, T)

    # --- encoder: one frame-scan over all conformer blocks ---
    h0 = _ln(model.enc.norm, _lin(model.enc.proj, xs)).to(dt).contiguous()
    h = EFS.enc_frame_scan(h0, flush_bt.to(dt), ew, state["enc_kv"],
                           state["enc_scale"], state["enc_conv"], ffac=cfg.ff_factor)
    h = torch.where(flush_bt[..., None], torch.zeros((), dtype=h.dtype, device=h.device), h)

    # --- look-ahead cnn as one valid conv over the carried window ---
    win = torch.cat([state["cnn_buf"][:, 1:].to(h.dtype), h], dim=1)  # (B, k-1+T, D)
    y = tnn.conv1d(win, model.cnn.weight, model.cnn.bias)             # (B, T, D)
    new_cnn_buf = win[:, T - 1:T - 1 + cfg.lookahead_kernel].to(dt).contiguous()
    emb = tnn.l2_normalize(y).contiguous()

    t0 = state["t"]
    valid = (t0[None, :] + torch.arange(T, device=t0.device)[:, None]) >= cfg.conv_delay

    # --- decoder: one frame-scan; `convert` split into emb and slot parts ---
    wc = model.dec.convert.weight                                     # (D, 2D)
    embp = tnn.linear(emb, wc[:, :D]).contiguous()
    pe = tnn.sinusoidal_table(C, D, device=emb.device).to(emb.dtype)
    pe_part = tnn.linear(pe, wc[:, D:], model.dec.convert.bias).contiguous()
    logits = DFS.dec_frame_scan(embp, emb, valid.T.to(emb.dtype).contiguous(), pe_part,
                                dw, state["dec_kv"], state["dec_scale"])
    new_state = dict(state, t=t0 + T, cnn_buf=new_cnn_buf)
    return new_state, (logits.transpose(0, 1), valid)


def ls_stream_scan_fused(model: LSEEND, state: dict, xs: torch.Tensor, n_slots: int,
                         packed=None) -> torch.Tensor:
    """Whole-clip streaming through the frame-scan kernels; the same
    conv-delay alignment as `ls_stream_scan`.  Returns logits (B, T, C)."""
    cfg = model.cfg
    B, T, Fin = xs.shape
    seq = torch.cat([xs, xs.new_zeros(B, cfg.conv_delay, Fin)], dim=1)
    flush = (torch.arange(T + cfg.conv_delay, device=xs.device) >= T)[:, None].expand(-1, B)
    _, (logits, _) = ls_stream_block_fused(model, state, seq, flush, n_slots, packed)
    return logits[cfg.conv_delay:].transpose(0, 1)
