"""LS-EEND: the conformer-retention encoder, the look-ahead cnn and the
retention attractor decoder, in three modes over one `LSEEND`.

Port of `fseend_tpu/models/ls_eend.py`.  Parameters
live in `LSEEND`, an `nn.Module` whose submodule paths follow the JAX
parameter pytree (`enc.proj`, `enc.blocks.{i}.ff1.linear1`,
`dec.layers.{i}.time_ret.q_proj`, ...); the BatchNorm running statistics
(the JAX `model_state`) are its buffers.

1. Batch (`ls_forward`, `ls_test`): whole recordings, padded to a multiple
   of `chunk_size`; retention in `time_mode` "chunkwise" (the default, with
   the route `LSEENDConfig.kernel` picks), "recurrent" (reproduces
   streaming) or "parallel".  `ls_forward(train=True)` is the training
   pass: dropout drawn from the caller's `torch.Generator`, BatchNorm on
   batch statistics (the updated running statistics are returned, the
   buffers left as they were), `remat` recomputing each conformer block in
   the backward, and with `use_fused_dec` the decoder run slot-major through
   the fusion-layer kernels (`kernels/dec_train_fusion.py`, forward and
   hand-written backward).
2. Blockwise streaming (`ls_blockstream_init/step/run`): K frames per step
   through the chunkwise retention with the state carried across blocks,
   every op a (B, K, D) matmul; emits the previous block (one-block lag);
   equals the batch chunkwise pass with `chunk_size = K`.  With the "fused"
   route every retention layer is one `kernels/retention_layer.py` call.
3. Per-frame streaming, two ways through a block of frames:
   * `ls_stream_step` / `ls_stream_scan`: the plain per-frame path, a
     Python loop of tensor ops.  It is the oracle the kernel path is held to.
   * `ls_stream_block_fused` / `ls_stream_scan_fused`: the encoder and the
     decoder each run as one frame-scan call per block (`kernels/`), CUDA
     kernels on the card; the input projection, the look-ahead cnn and the
     decoder's `convert` stay plain matmuls.

Both stream states are flat dicts of stacked, lane-major tensors
(`utils/convert.py` maps them to and from the JAX package's nested states).
Per-frame (`ls_stream_init`), in the layout the frame-scan kernels read
directly (no per-block repack of the ~170 MB decoder state):
  t          (B,)                  per-lane stream clock (steps, flush included)
  enc_kv     (Le, B, H, dv, dk)    encoder retention states, normalized
  enc_scale  (Le, B, H)
  enc_conv   (Le, B, k-1, D)       conformer conv history (post-GLU)
  cnn_buf    (B, 2*delay+1, D)     look-ahead cnn window
  dec_kv     (Ld, B*C, H, dv, dk)  decoder retention states, lane b's slots
  dec_scale  (Ld, B*C, H)          contiguous
Blockwise (`ls_blockstream_init`), with the chunk state of
`ops/retention.py:chunk_state_init` (kv transposed against the recurrent
one, unnormalized, scale ones when fresh):
  m          (B,)                  per-lane count of blocks consumed
  enc_kv     (Le, B, H, dk, dv)    enc_scale (Le, B, H, 1, 1)
  enc_conv   (Le, B, k-1, D)
  h_prev     (B, K, D)             encoder output of the previous block
  h_tail2    (B, delay, D)         tail of the block before that
  dec_kv     (Ld, B*C, H, dk, dv)  dec_scale (Ld, B*C, H, 1, 1)
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from fseend_tpu_torch.kernels import dec_frame_scan as DFS
from fseend_tpu_torch.kernels import dec_train_fusion as DTF
from fseend_tpu_torch.kernels import enc_frame_scan as EFS
from fseend_tpu_torch.kernels import retention_layer as RL
from fseend_tpu_torch.ops import nn as tnn
from fseend_tpu_torch.ops import retention as R


@dataclasses.dataclass(frozen=True)
class LSEENDConfig:
    in_size: int = 345
    n_units: int = 256
    n_heads: int = 4
    enc_n_layers: int = 4
    dec_n_layers: int = 2
    chunk_size: int = 500              # retention recurrent_chunk_size
    ff_expansion: int = 4              # feed_forward_expansion_factor
    conv_expansion: int = 2
    conv_kernel_size: int = 16         # conformer causal depthwise conv
    dec_dim_feedforward: int = 2048
    conv_delay: int = 9                # look-ahead cnn between enc and dec
    max_nspks: int = 10                # max_speakers + 2
    pe_max_len: int = 5000
    half_step_residual: bool = True
    kernel: str = "fused"              # chunkwise route, see R.RetentionConfig
    dropout: float = 0.1               # training only
    use_fused_dec: bool = False        # chunkwise decoder through the fusion-layer kernels
    fused_dec_chunk: int | None = None  # their internal chunk; None: chunk_size (exact)
    remat: bool = False                # training: recompute each conformer block

    def __post_init__(self):
        self.ret_cfg                   # validates `kernel`

    @property
    def lookahead_kernel(self) -> int:
        return 2 * self.conv_delay + 1

    @property
    def ret_cfg(self) -> R.RetentionConfig:
        return R.RetentionConfig(self.n_units, self.n_heads, 1, self.chunk_size,
                                 kernel=self.kernel)

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


def with_cfg(model: nn.Module, cfg) -> nn.Module:
    """`model`'s weights (shared, not copied) under another config of the
    same sizes (either family): another chunkwise route or chunk size, the
    other cached-attention route."""
    other = copy.copy(model)
    other.cfg = cfg
    return other


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
# batch mode (offline inference)
# ---------------------------------------------------------------------------


def _ln(m: nn.LayerNorm, x):
    return tnn.layer_norm(x, m.weight, m.bias)


def _lin(m: nn.Linear, x):
    return tnn.linear(x, m.weight, m.bias)


def _ff(p: FeedForward, x, rate: float = 0.0, gen=None):
    """FeedForwardModule: LN -> Linear -> swish -> dropout -> Linear ->
    dropout (dropout in training only)."""
    h = tnn.dropout(F.silu(_lin(p.linear1, _ln(p.norm, x))), rate, gen)
    return tnn.dropout(_lin(p.linear2, h), rate, gen)


def _conv_module(p: ConvModule, x, cache=None, *, train: bool = False, rate: float = 0.0,
                 gen=None):
    """ConformerConvModule over (B, T, D): LN -> pointwise(2D) -> GLU ->
    causal depthwise(k) -> BatchNorm -> swish -> pointwise -> dropout.
    `cache` (B, k-1, D) is the post-GLU history before x (None: zeros, the
    batch form).  Returns (y, the history after x, the BatchNorm's updated
    running statistics in training, else None)."""
    h = _lin(p.pw1, _ln(p.norm, x))
    a, b = h.chunk(2, dim=-1)
    h = a * torch.sigmoid(b)
    k = p.dw.weight.shape[-1]
    if cache is None:
        cache = h.new_zeros(h.shape[0], k - 1, h.shape[2])
    y = tnn.causal_depthwise_conv(h, p.dw.weight, cache)
    bn_state = None
    if train:
        y, bn_state = tnn.batch_norm_train(y, p.bn)
    else:
        y = tnn.batch_norm(y, p.bn)
    y = tnn.dropout(_lin(p.pw2, F.silu(y)), rate, gen)
    return y, torch.cat([cache, h], dim=1)[:, -(k - 1):], bn_state


def _retention_seq(p: R.Retention, x, cfg: LSEENDConfig, time_mode: str):
    """Whole-sequence retention in the requested mode: `chunkwise` (the
    default), `recurrent` (reproduces streaming exactly) or `parallel`."""
    rc = cfg.ret_cfg
    if time_mode == "chunkwise":
        return R.retention_chunkwise(p, x, rc)
    if time_mode == "recurrent":
        return R.retention_recurrent(p, x, rc)
    if time_mode == "parallel":
        return R.retention_parallel(p, x, rc)
    raise ValueError(f"unknown time_mode: {time_mode}")


def _block(p: ConformerBlock, x, cfg: LSEENDConfig, time_mode: str = "chunkwise",
           train: bool = False, gen=None):
    """ConformerEncoderBlock over (B, T, D) -> (y, the BatchNorm's updated
    running statistics in training, else None)."""
    rate = cfg.dropout if train else 0.0
    x = x + cfg.ff_factor * _ff(p.ff1, x, rate, gen)
    x = x + tnn.dropout(_retention_seq(p.ret, _ln(p.ret_norm, x), cfg, time_mode), rate, gen)
    h, _, bn_state = _conv_module(p.conv, x, train=train, rate=rate, gen=gen)
    x = x + h
    x = x + cfg.ff_factor * _ff(p.ff2, x, rate, gen)
    return _ln(p.final_norm, x), bn_state


def _block_remat(p: ConformerBlock, x, cfg: LSEENDConfig, time_mode: str, gen):
    """_block in training, its activations recomputed in the backward
    (`torch.utils.checkpoint`).  The recompute draws the same dropout masks
    from a copy of `gen` as it was; `gen` itself advances once."""
    start = gen.get_state() if gen is not None else None
    end = []

    def run(h):
        g = None
        if start is not None:
            g = torch.Generator(device=gen.device)
            g.set_state(start)
        y, bn = _block(p, h, cfg, time_mode, True, g)
        if g is not None and not end:
            end.append(g.get_state())
        return y, bn["mean"], bn["var"]

    y, mean, var = torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False)
    if end:
        gen.set_state(end[0])
    return y, {"mean": mean, "var": var}


def encode(model: LSEEND, xs: torch.Tensor, time_mode: str = "chunkwise",
           train: bool = False, gen=None):
    """xs: (B, T, in_size) with T % chunk_size == 0 (pad upstream).
    Returns (h, the BatchNorm states: updated in training, else the
    running statistics)."""
    cfg = model.cfg
    h = _ln(model.enc.norm, _lin(model.enc.proj, xs))
    bn = []
    for bp in model.enc.blocks:
        if train and cfg.remat:
            h, st = _block_remat(bp, h, cfg, time_mode, gen)
        else:
            h, st = _block(bp, h, cfg, time_mode, train, gen)
        bn.append(st or {"mean": bp.conv.bn.running_mean, "var": bp.conv.bn.running_var})
    return h, bn


def fusion_layer(p: FusionLayer, x: torch.Tensor, cfg: LSEENDConfig,
                 time_mode: str = "chunkwise", train: bool = False, gen=None) -> torch.Tensor:
    """x: (B, T, C, D).  Retention over T per slot; MHA over C per frame;
    FFN; post-norm; dropout after each sublayer and on the attention
    weights in training."""
    rate = cfg.dropout if train else 0.0
    B, T, C, D = x.shape
    xt = x.transpose(1, 2).reshape(B * C, T, D)
    a = tnn.dropout(_retention_seq(p.time_ret, xt, cfg, time_mode), rate, gen)
    xt = _ln(p.norm11, xt + a)
    x = xt.reshape(B, C, T, D).transpose(1, 2)
    a = tnn.dropout(tnn.mha(p.spk_attn, x, x, x, rate, gen), rate, gen)
    x = _ln(p.norm21, x + a)
    return _ln(p.norm22, x + tnn.ff_block(x, p.linear1, p.linear2, rate, gen))


def _slot_queries(model: LSEEND, emb: torch.Tensor, n_slots: int) -> torch.Tensor:
    """The decoder's input: every frame's embedding beside each slot's
    positional code, through `convert`.  emb (B, T, D) -> (B, T, C, D)."""
    cfg = model.cfg
    B, T, D = emb.shape
    pe = tnn.sinusoidal_table(cfg.pe_max_len, D, device=emb.device)[:n_slots].to(emb.dtype)
    x = torch.cat([emb[:, :, None, :].expand(B, T, n_slots, D),
                   pe[None, None].expand(B, T, n_slots, D)], dim=-1)
    return _lin(model.dec.convert, x)


def decode(model: LSEEND, emb: torch.Tensor, n_slots: int, time_mode: str = "chunkwise",
           train: bool = False, gen=None) -> torch.Tensor:
    if model.cfg.use_fused_dec and time_mode == "chunkwise":
        return _decode_fused(model, emb, n_slots, train, gen)
    x = _slot_queries(model, emb, n_slots)
    for lp in model.dec.layers:
        x = fusion_layer(lp, x, model.cfg, time_mode, train, gen)
    return x


def _decode_fused(model: LSEEND, emb: torch.Tensor, n_slots: int, train: bool, gen):
    """The decoder slot-major (B, C, T, D), each fusion layer one call of
    `kernels/dec_train_fusion.py` (forward and hand-written backward, the
    dropout hashed inside).  T is end-padded to the internal chunk
    (`fused_dec_chunk`, default `chunk_size`): every per-frame op is causal,
    so the first T frames are exact.  Each layer's dropout seed is one draw
    from `gen`; eval and rate 0 run with seed 0 and rate 0.  Returns
    (B, T, C, D), the `decode` contract."""
    cfg = model.cfg
    B, T, D = emb.shape
    pe = tnn.sinusoidal_table(cfg.pe_max_len, D, device=emb.device)[:n_slots].to(emb.dtype)
    x = torch.cat([emb[:, None].expand(B, n_slots, T, D),
                   pe[None, :, None].expand(B, n_slots, T, D)], dim=-1)
    x = _lin(model.dec.convert, x)                           # (B, C, T, D)
    L = cfg.fused_dec_chunk or cfg.chunk_size
    pad = (-T) % L
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    for lp in model.dec.layers:
        seed, rate = 0, 0.0
        if train and gen is not None and cfg.dropout > 0.0:
            seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen, device=gen.device))
            rate = cfg.dropout
        x = DTF.fused_fusion_layer(x.contiguous(), DTF.pack_fusion(lp), seed, cfg.n_heads, L,
                                   rate)
    return x[:, :, :T].transpose(1, 2)


def pad_to_chunk(xs: torch.Tensor, chunk: int) -> torch.Tensor:
    pad = (-xs.shape[1]) % chunk
    return F.pad(xs, (0, 0, 0, pad)) if pad else xs


def ls_forward(model: LSEEND, xs, lens, n_slots: int, *, train: bool = False,
               generator: torch.Generator | None = None,
               time_mode: str = "chunkwise") -> dict:
    """Full batch pass on the device that holds `model`.  xs (B, T, F) is
    padded to a chunk multiple internally, zeroed past each recording's
    `lens` entry before the encoder and again before the cnn, as the
    reference does.  Returns logits (B, T, C), emb (B, T, D), attractors
    (B, T, C, D) and "state", {"conv_bn": [{"mean", "var"}]}: the BatchNorm
    running statistics, updated from this batch in training.

    train=True is the training pass (differentiable; dropout from
    `generator`, which lives on the model's device, none without one);
    otherwise the pass runs without autograd."""
    with contextlib.nullcontext() if train else torch.no_grad():
        return _ls_forward(model, xs, lens, n_slots, train, generator, time_mode)


def _ls_forward(model, xs, lens, n_slots, train, gen, time_mode):
    cfg = model.cfg
    device = model.cnn.weight.device
    xs = torch.as_tensor(xs).to(device)
    if xs.dtype != torch.float32:
        raise ValueError(f"ls_forward: xs is {xs.dtype}; the port runs float32 only")
    lens = torch.as_tensor(lens).to(device)
    T0 = xs.shape[1]
    xs = pad_to_chunk(xs, cfg.chunk_size)
    len_mask = (torch.arange(xs.shape[1], device=device)[None, :] < lens[:, None])[..., None]
    zero = xs.new_zeros(())
    xs = torch.where(len_mask, xs, zero)
    h, bn = encode(model, xs, time_mode, train, gen)
    h = torch.where(len_mask, h, zero)              # re-pad with zeros before the cnn
    emb = tnn.l2_normalize(tnn.lookahead_conv(h, model.cnn.weight, model.cnn.bias,
                                              cfg.conv_delay))
    attractors = tnn.l2_normalize(decode(model, emb, n_slots, time_mode, train, gen))
    logits = torch.einsum("btd,btcd->btc", emb, attractors)
    return {"logits": logits[:, :T0], "emb": emb[:, :T0], "attractors": attractors[:, :T0],
            "state": {"conv_bn": bn}}


def ls_test(model: LSEEND, xs, lens, max_nspks: int | None = None) -> dict:
    n_slots = max_nspks if max_nspks is not None else model.cfg.max_nspks
    return ls_forward(model, xs, lens, n_slots)


# ---------------------------------------------------------------------------
# streaming state
# ---------------------------------------------------------------------------


def ls_stream_init(cfg: LSEENDConfig, batch: int, n_slots: int | None = None,
                   dtype=torch.float32, device=None) -> dict:
    """Zero (fresh-stream) state for `batch` lanes; O(1) in stream length.
    On the card unless the caller names another device."""
    device = resolve_device(device)
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


# ---------------------------------------------------------------------------
# blockwise streaming: K frames per step through the chunkwise retention
# ---------------------------------------------------------------------------
#
# Every op is a (B, K, D)-shaped matmul instead of K per-frame vector ops:
# the throughput serving mode (it adds K frames of batching latency); the
# per-frame path above stays the low-latency mode.  Numerically it is the
# batch pass in chunkwise time_mode with chunk_size = K.


def _block_ret_cfg(cfg: LSEENDConfig, K: int) -> R.RetentionConfig:
    return dataclasses.replace(cfg.ret_cfg, chunk_size=K)


def ls_blockstream_init(cfg: LSEENDConfig, batch: int, n_slots: int | None = None,
                        block: int = 100, dtype=torch.float32, device=None) -> dict:
    """O(1) state for blockwise streaming with one-block emission lag.

    The step consuming block m emits the logits of block m-1: the look-ahead
    conv needs `conv_delay` future encoder frames, which are the head of
    block m.  This keeps the decoder's time axis aligned from frame 0 of the
    stream, so the result equals the batch chunkwise pass exactly.  Requires
    block >= conv_delay.  On the card unless the caller names another
    device."""
    if block < cfg.conv_delay:
        raise ValueError(f"block={block} must be >= conv_delay={cfg.conv_delay}")
    device = resolve_device(device)
    C = n_slots if n_slots is not None else cfg.max_nspks
    rc = cfg.ret_cfg
    H, dk, dv = rc.num_heads, rc.key_dim, rc.head_dim
    Le, Ld, D = cfg.enc_n_layers, cfg.dec_n_layers, cfg.n_units

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        # per lane: the m == 0 gate keeps the warm-up block's emission out of
        # the decoder state, and a reset lane is gated again
        "m": torch.zeros(batch, dtype=torch.int32, device=device),
        "enc_kv": z(Le, batch, H, dk, dv),
        "enc_scale": z(Le, batch, H, 1, 1) + 1,
        "enc_conv": z(Le, batch, cfg.conv_kernel_size - 1, D),
        "h_prev": z(batch, block, D),
        "h_tail2": z(batch, cfg.conv_delay, D),
        "dec_kv": z(Ld, batch * C, H, dk, dv),
        "dec_scale": z(Ld, batch * C, H, 1, 1) + 1,
    }


@torch.no_grad()
def pack_block_weights(model: LSEEND):
    """The retention layers' stacked projections for the "fused" route
    (pack once per model): (encoder layers, decoder layers)."""
    return ([RL.pack_retention(bp.ret) for bp in model.enc.blocks],
            [RL.pack_retention(lp.time_ret) for lp in model.dec.layers])


def _enc_block_blockstream(p: ConformerBlock, x, st: dict, cfg: LSEENDConfig,
                           rc: R.RetentionConfig, packed=None):
    """One conformer block over a K-frame block; st = {"ret", "conv"}."""
    x = x + cfg.ff_factor * _ff(p.ff1, x)
    h, ret_state = R.retention_chunkwise_stateful(p.ret, _ln(p.ret_norm, x), st["ret"],
                                                  rc, packed)
    x = x + h
    h, conv_cache, _ = _conv_module(p.conv, x, st["conv"])
    x = x + h
    x = x + cfg.ff_factor * _ff(p.ff2, x)
    return _ln(p.final_norm, x), {"ret": ret_state, "conv": conv_cache}


@torch.no_grad()
def ls_blockstream_step(model: LSEEND, state: dict, xs: torch.Tensor, n_slots: int,
                        enc_bypass: bool = False, h_mask: torch.Tensor | None = None,
                        packed=None):
    """Consume block m (B, K, in_size); emit logits (B, K, n_slots) of block
    m-1 (garbage for m = 0: the caller discards a lane's first emission).

    enc_bypass=True feeds zero embeddings and keeps the encoder state (the
    stream-end flush that drains the last real block; the encoder is not
    run).  h_mask, (K,) for all lanes or (B, K) per lane, zeroes this block's
    embeddings frame by frame (padding frames, as the batch pass re-pads).
    `packed` is `pack_block_weights(model)` for the "fused" route.  `state`
    is left as it was."""
    cfg = model.cfg
    B, K, _ = xs.shape
    C, D = n_slots, cfg.n_units
    rc = _block_ret_cfg(cfg, K)
    enc_packed, dec_packed = packed if packed is not None else (
        [None] * cfg.enc_n_layers, [None] * cfg.dec_n_layers)
    new_state = dict(state)
    # --- encoder on block m ---
    if enc_bypass:
        h = xs.new_zeros(B, K, D)
    else:
        h = _ln(model.enc.norm, _lin(model.enc.proj, xs))
        enc = {"enc_kv": [], "enc_scale": [], "enc_conv": []}
        for l, bp in enumerate(model.enc.blocks):
            st = {"ret": {"kv": state["enc_kv"][l], "scale": state["enc_scale"][l]},
                  "conv": state["enc_conv"][l]}
            h, new = _enc_block_blockstream(bp, h, st, cfg, rc, enc_packed[l])
            enc["enc_kv"].append(new["ret"]["kv"])
            enc["enc_scale"].append(new["ret"]["scale"])
            enc["enc_conv"].append(new["conv"])
        new_state.update({k: torch.stack(v) for k, v in enc.items()})
        if h_mask is not None:
            h = h * h_mask.to(h.dtype).reshape(-1, K, 1)
    # --- look-ahead cnn emits block m-1 ---
    window = torch.cat([state["h_tail2"], state["h_prev"], h[:, :cfg.conv_delay]], dim=1)
    emb = tnn.l2_normalize(tnn.conv1d(window, model.cnn.weight, model.cnn.bias))
    # --- decoder block (time axis aligned from frame 0 of the stream) ---
    x = _slot_queries(model, emb, C)                               # (B, K, C, D)
    first_slots = (state["m"] == 0).repeat_interleave(C)           # decoder rows are B*C
    dec = {"dec_kv": [], "dec_scale": []}
    for l, lp in enumerate(model.dec.layers):
        st = {"kv": state["dec_kv"][l], "scale": state["dec_scale"][l]}
        xt = x.transpose(1, 2).reshape(B * C, K, D)
        a, ret_state = R.retention_chunkwise_stateful(lp.time_ret, xt, st, rc,
                                                      dec_packed[l])
        # a lane's block 0 emission is garbage: keep it out of the decoder state
        dec["dec_kv"].append(_keep(first_slots, ret_state["kv"], st["kv"]))
        dec["dec_scale"].append(_keep(first_slots, ret_state["scale"], st["scale"]))
        xt = _ln(lp.norm11, xt + a)
        x = xt.reshape(B, C, K, D).transpose(1, 2)
        x = _ln(lp.norm21, x + tnn.mha(lp.spk_attn, x, x, x))
        x = _ln(lp.norm22, x + tnn.ff_block(x, lp.linear1, lp.linear2))
    logits = torch.einsum("bkd,bkcd->bkc", emb, tnn.l2_normalize(x))
    new_state.update({k: torch.stack(v) for k, v in dec.items()})
    new_state.update(h_prev=h, h_tail2=state["h_prev"][:, -cfg.conv_delay:],
                     m=state["m"] + 1)
    return new_state, logits


def ls_blockstream_run(model: LSEEND, xs: torch.Tensor, n_slots: int, block: int,
                       lens: torch.Tensor | None = None) -> torch.Tensor:
    """Whole-clip blockwise streaming, time-aligned logits (B, T, n_slots):
    equals ls_forward(time_mode="chunkwise") with chunk_size = block.  `lens`
    (B,) gives each recording's length (default: all T)."""
    B, T, Fin = xs.shape
    packed = pack_block_weights(model) if model.cfg.kernel == "fused" else None
    state = ls_blockstream_init(model.cfg, B, n_slots, block, xs.dtype, xs.device)
    lens = torch.full((B,), T, device=xs.device) if lens is None else lens.to(xs.device)
    xs_p = pad_to_chunk(xs, block)
    outs = []
    for st_i in range(0, xs_p.shape[1], block):
        h_mask = torch.arange(st_i, st_i + block, device=xs.device)[None, :] < lens[:, None]
        state, logits = ls_blockstream_step(model, state, xs_p[:, st_i:st_i + block],
                                            n_slots, h_mask=h_mask, packed=packed)
        outs.append(logits)                  # block st_i/block - 1; the first is garbage
    # drain the final real block with one enc-bypass call
    state, logits = ls_blockstream_step(model, state, xs.new_zeros(B, block, Fin), n_slots,
                                        enc_bypass=True, packed=packed)
    outs.append(logits)
    return torch.cat(outs[1:], dim=1)[:, :T]
