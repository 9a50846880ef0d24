"""PyTorch port, bf16 mixed-precision training: B3's bf16 form (the fusion
layer's training forward and backward, `kernels/dec_train_fusion.py`) in its
plain version against the JAX package's Pallas kernel in interpret mode on
the same bf16 weights; a float32 body as the control that the rounding
rule can fail; `compute_loss` with `compute_dtype="bf16"` and its gradients
for LS-EEND (the fused decoder and the plain route), FS-EEND and EEND-EDA
against the JAX package's on the same weights; a few bf16 steps and a bf16
`run_training` epoch; the bf16 gradients of B4 and B5 (the "fused" and
"core" retention routes) against JAX's recompute.

Tolerances, as tests/test_torch_port_bf16.py:

* the drift rule of the JAX package's bf16 tests: max |port bf16 - JAX
  float32| <= 3 max |JAX bf16 - JAX float32| + 1e-3;
* B3's rounding points: mean |port bf16 - JAX bf16| <= ROUND_SHARE * mean
  |JAX bf16 - JAX float32|, each output and each of the 14 weight
  gradients; a float32 body rounded once at its output sits about as far
  from JAX bf16 as JAX float32 does, and fails it;
* the train pass at dropout 0: the loss by the drift rule, every gradient
  float32, and the cosine of the port's bf16 gradient with JAX's bf16
  gradient at least JAX's own bf16-vs-float32 cosine less 0.01 (JAX's rule
  `tests/test_trainer.py:87-92` holds that one above 0.98);
* B4 and B5: the drift rule and the cosine rule above on each gradient
  (both packages differentiate a pure route whose every op rounds to bf16,
  but torch's and XLA's backward rules round at other points, so the two
  bf16 gradients are about as far apart as each is from float32);
* the unfused LS decoder in bf16, which no kernel runs: the cosine of its
  bf16 gradient with its own float32 one above 0.98 (JAX's rule).

The float32 oracle is the port's float32 path on the same bf16 values
(held to the JAX package's float32 path by test_torch_port_dec_train,
test_torch_port_train, test_torch_port_fs_train and test_torch_port_eda);
each JAX program here is bf16, compiled with `xla_allow_excess_precision`
off (tests/test_torch_port_bf16.py:28-32).  Widths: D 32, two heads, one
layer of each kind (none in FS-EEND's encoder), T a few chunks; the JAX
compiles are most of the time (38-39 s on one core of a shared machine,
the imports included)."""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fseend_tpu.kernels import dec_train_fusion_pallas as JDT
from fseend_tpu.kernels import retention_layer_pallas as JRLP
from fseend_tpu.kernels import retention_pallas as JRP
from fseend_tpu.models import eend_eda as JE
from fseend_tpu.models import fs_eend as JF
from fseend_tpu.models import ls_eend as JL
from fseend_tpu.ops import retention as JR
from fseend_tpu.ops.nn import static_int
from fseend_tpu.train import trainer as JTRN
from fseend_tpu_torch.kernels import chunk_retention as CR
from fseend_tpu_torch.kernels import dec_train_fusion as DT
from fseend_tpu_torch.kernels import retention_layer as RL
from fseend_tpu_torch.models import eend_eda as TE
from fseend_tpu_torch.models import fs_eend as TF
from fseend_tpu_torch.models import ls_eend as TL
from fseend_tpu_torch.train import loop as LOOP
from fseend_tpu_torch.train import optim as TO
from fseend_tpu_torch.train import trainer as TRN
from fseend_tpu_torch.utils import checkpoint as CK
from fseend_tpu_torch.utils import convert as CV

torch.set_num_threads(1)
BF = torch.bfloat16
NO_EXCESS = {"xla_allow_excess_precision": False}
# compile time is most of this file's: XLA's older CPU fusion path compiles
# these programs in less than half the time of its fusion emitters
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True,
        "xla_cpu_use_fusion_emitters": False}
ROUND_SHARE = 0.05
RATE = 0.1                     # B3's dropout, its masks included in the comparison
# B3: one fusion layer, slot-major (B, C, T, D)
B3, C3, T3, D3, H3, F3, L3 = 2, 2, 16, 32, 2, 32, 8
SEED = 1234
# the train pass: batch (B, T) of S speakers
B, T, S = 2, 16, 2


def _f32(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _drift_ok(port, ref, yard, what):
    err = float(np.abs(_f32(port) - _f32(ref)).max())
    err_y = float(np.abs(_f32(yard) - _f32(ref)).max())
    assert err <= 3.0 * err_y + 1e-3, (what, err, err_y)


def _share(port, jax16, jax32) -> float:
    near = float(np.abs(_f32(port) - _f32(jax16)).mean())
    drift = float(np.abs(_f32(jax16) - _f32(jax32)).mean())
    assert drift > 0
    return near / drift


def _cast(tree, dt=jnp.bfloat16):
    """The JAX package's cast of every float leaf (bench.py:508-511)."""
    return jax.tree.map(lambda x: x.astype(dt) if hasattr(x, "dtype")
                        and x.dtype in (jnp.float32, jnp.bfloat16) else x, tree)


def _as_jax_tree(tree, shapes):
    """A converter's numpy tree as the JAX init's pytree (`shapes`, from
    `jax.eval_shape`), so that its static metadata leaves are the JAX
    package's own."""
    def leaf(path, _):
        node = tree
        for p in path:
            node = node[p.key if hasattr(p, "key") else p.idx]
        return jnp.asarray(node)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _cos(a, b) -> float:
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


# ---------------------------------------------------------------------------
# B3: the fusion layer's bf16 form
# ---------------------------------------------------------------------------


def _port_weights(lp) -> DT.FusionWeights:
    """The JAX kernel's packed bf16 operands in the port's (out, in) layout."""
    ops = [np.asarray(o.astype(jnp.float32)) for o in JDT._pack(lp, jnp.bfloat16)]
    wq, bq, wro, bro, wmi, bmi, wmo, bmo, wf1, bf1, wf2, bf2, lns, lnb = ops
    return DT.FusionWeights(*(torch.as_tensor(np.array(a)).to(BF) for a in (
        wq.T, bq[0], wro.T, bro[0], wmi.T, bmi[0], wmo.T, bmo[0], wf1.T, bf1[0], wf2.T,
        bf2[0], lns[:, 0], lnb[:, 0])))


@pytest.fixture(scope="module")
def fusion():
    """One fusion layer's bf16 weights, input and output cotangent, the JAX
    kernel's y, dx and weight gradients (its custom VJP) in bf16, and the
    port's float32 plain forward and backward on the same values."""
    cfg = TL.LSEENDConfig(in_size=8, n_units=D3, n_heads=H3, enc_n_layers=1, dec_n_layers=1,
                          dec_dim_feedforward=F3, chunk_size=L3, conv_kernel_size=4,
                          conv_delay=2, max_nspks=C3)
    model = TL.init_ls_eend(cfg, torch.Generator().manual_seed(0), device="cpu")
    lp = jax.tree.map(jnp.asarray, CV.ls_params_to_jax(model)[0]["dec"]["layers"][0])
    lp["spk_attn"]["_n_heads"] = static_int(H3)
    # larger q/k weights: the row sums and carried scales leave their clamp at 1
    for name in ("q_proj", "k_proj"):
        lp["time_ret"][name]["kernel"] = lp["time_ret"][name]["kernel"] * 6
    rng = np.random.default_rng(0)
    lp16 = _cast(lp)
    x16 = jnp.asarray(rng.standard_normal((B3, C3, T3, D3)), jnp.bfloat16)
    dy16 = jnp.asarray(rng.standard_normal((B3, C3, T3, D3)), jnp.bfloat16)

    def run(p, x, dy):
        y, vjp = jax.vjp(lambda p_, x_: JDT.fused_fusion_layer(
            p_, x_, jnp.array([[SEED]], jnp.int32), H3, L3, RATE, True), p, x)
        return (y, *vjp(dy)[::-1])

    y16, dx16, gp16 = jax.jit(run).lower(lp16, x16, dy16).compile(dict(NO_EXCESS, **FAST))(
        lp16, x16, dy16)
    w = _port_weights(lp16)
    x, dy = (torch.as_tensor(_f32(t)).to(BF) for t in (x16, dy16))
    w32 = DT.FusionWeights(*(t.float() for t in w))
    y32, kvs, ss = DT.fusion_layer_fwd(x.float(), w32, SEED, H3, L3, RATE)
    dx32, dw32 = DT.fusion_layer_bwd(x.float(), dy.float(), kvs, ss, w32, SEED, H3, L3, RATE)
    want16 = [("y", y16), ("dx", dx16)] + list(zip(DT.FusionWeights._fields,
                                                  _port_weights(gp16)))
    want32 = [("y", y32), ("dx", dx32)] + list(zip(DT.FusionWeights._fields, dw32))
    return w, x, dy, want16, want32


def test_fusion_layer_bf16_plain_rounds_like_the_jax_kernel(fusion):
    w, x, dy, want16, want32 = fusion
    y, kvs, ss = DT.fusion_layer_fwd(x, w, SEED, H3, L3, RATE)
    assert y.dtype == BF and kvs.dtype == ss.dtype == torch.float32
    assert float(ss[:, 1:].max()) > 1.0                  # the carried scale is live
    dx, dw = DT.fusion_layer_bwd(x, dy, kvs, ss, w, SEED, H3, L3, RATE)
    assert dx.dtype == BF and all(t.dtype == BF for t in dw)
    got = [("y", y), ("dx", dx)] + list(zip(DT.FusionWeights._fields, dw))
    for (name, g), (_, j16), (_, j32) in zip(got, want16, want32):
        _drift_ok(g, j32, j16, name)
        assert _share(g, j16, j32) <= ROUND_SHARE, (name, _share(g, j16, j32))
    # the autograd Function takes the bf16 backward and returns bf16 gradients
    xa = x.clone().requires_grad_(True)
    wa = DT.FusionWeights(*(t.clone().requires_grad_(True) for t in w))
    (DT.fused_fusion_layer(xa, wa, SEED, H3, L3, RATE).float() * dy.float()).sum().backward()
    assert torch.equal(xa.grad, dx) and torch.equal(wa.wf1.grad, dw.wf1)


def test_a_float32_body_fails_the_rounding_rule(fusion):
    """The control: the float32 plain version on the same bf16 values,
    rounded to bf16 once at its outputs, is about as far from the JAX bf16
    kernel as float32 is (a share near 1), so ROUND_SHARE tells a bf16 form
    from a float32 one: each of its 16 outputs breaks the rule, most by 15
    times or more (bf2, the column sums of dy's gradient through one
    LayerNorm, comes nearest, at about 0.3)."""
    w, x, dy, want16, want32 = fusion
    shares = [_share(g.to(BF), j16, g) for (_, g), (_, j16) in zip(want32, want16)]
    assert min(shares) > ROUND_SHARE and np.median(shares) > 15 * ROUND_SHARE, shares


# ---------------------------------------------------------------------------
# B3's bf16 order of work at the production width (csrc/dtf_tc16.cuh): a
# plain mirror, held to the plain version and to the JAX kernel
# ---------------------------------------------------------------------------

MIRROR_TILE = 3     # rows of the mirror's key and query tiles: L3 = 8 cuts into 3 + 3 + 2


def _rnd(t):
    return t.to(BF).float()


def _mirror_core_fwd(q, k, v, L, tile=MIRROR_TILE, rnd=_rnd):
    """dtf_tc16.cuh's core forward on q, k~, v (B, H, C, T, d), bf16 values
    in float32: every chunk's summary k~^T v / sqrt(L) at once
    (core_state16), the state and its scale carried over them in chunk order,
    then every chunk's output from the state it reads (core_out16): the
    row sums of |S| over the key tiles added tile by tile, S / inner
    rounded (`rnd`) before it multiplies v, the cross read q (KV / c).  The
    row sums and scales are constants, as the reference detaches them.
    Returns (oh, the row sums, kvs (B, N, H, C, d, d), ss (B, N, H, C, 1,
    1))."""
    B, H, C, T, d = q.shape
    N = T // L
    qc, kc, vc = (t.reshape(B, H, C, N, L, d) for t in (q, k, v))
    mask, idec, wlast = DT._consts(L, q.device)
    summary = (kc.transpose(-1, -2) @ vc) * wlast               # (B, H, C, N, d, d)
    kv, s = q.new_zeros(B, H, C, d, d), q.new_ones(B, H, C, 1, 1)
    kvs, ss = [], []
    for n in range(N):
        kvs.append(kv)
        ss.append(s)
        kv = kv + summary[:, :, :, n]
        s = kv.detach().abs().sum(-2, keepdim=True).amax(-1, keepdim=True).clamp(min=1.0)
    KV, c = torch.stack(kvs, dim=3), torch.stack(ss, dim=3)     # the state each chunk reads
    qk = (qc @ kc.transpose(-1, -2)) * mask                      # (B, H, C, N, L, L)
    inner = sum(qk[..., j0:j0 + tile].detach().abs().sum(-1, keepdim=True)
                for j0 in range(0, L, tile)).clamp(min=1.0)
    o_in = rnd(qk / inner) @ vc
    cross = (qc @ (KV / c)) * idec
    all_ = torch.maximum(inner, c)
    oh = o_in * (inner / all_) + cross * (c / all_)
    return (oh.reshape(B, H, C, T, d), inner.reshape(B, H, C, T, 1), torch.stack(kvs, dim=1),
            torch.stack(ss, dim=1))


def _mirror_core_bwd(q, k, v, doh, inner, kvs, ss, L, rnd, tile=MIRROR_TILE):
    """dtf_tc16.cuh's core backward: every chunk's increment q_id^T dcross /
    c at once, the state cotangent after each chunk by the reverse prefix
    over them (core_bwd_ds16), then every chunk's dq (query tiles) and dk,
    dv (key tiles) from dS_n (core_bwd_chunk16), each tile's sum over the
    other side's tiles added tile by tile, `rnd` at the core's bf16
    rounding points.  All (B, H, C, T, d) but inner
    (B, H, C, T, 1) and the checkpoints; returns dq, dk (before the k
    scale), dv and the dS_n (B, H, C, N, d, d)."""
    B, H, C, T, d = q.shape
    N = T // L
    qc, kc, vc, dc, ic = (t.reshape(B, H, C, N, L, -1) for t in (q, k, v, doh, inner))
    KV = kvs.permute(0, 2, 3, 1, 4, 5)                           # (B, H, C, N, d, d)
    c = ss.permute(0, 2, 3, 1, 4, 5)
    mask, idec, wlast = DT._consts(L, q.device)
    all_ = torch.maximum(ic, c)
    din, dcr = rnd(dc * (ic / all_)), rnd(dc * (c / all_))
    inc = (rnd(qc * idec).transpose(-1, -2) @ dcr) / c            # every chunk's increment
    dS = torch.zeros_like(inc)
    for n in range(N - 2, -1, -1):                                # dS_n: the chunks after n
        dS[:, :, :, n] = dS[:, :, :, n + 1] + inc[:, :, :, n + 1]
    dSr = rnd(dS)
    S = (qc @ kc.transpose(-1, -2)) * mask
    innin = rnd(S / ic)                                           # (.., i, j)
    dqk = rnd((din @ vc.transpose(-1, -2)) / ic * mask)
    tiles = range(0, L, tile)
    dq = (dcr @ rnd(KV / c).transpose(-1, -2)) * idec + sum(
        dqk[..., j0:j0 + tile] @ kc[..., j0:j0 + tile, :] for j0 in tiles)
    dv = (kc @ dSr) * wlast + sum(innin[..., i0:i0 + tile, :].transpose(-1, -2)
                                  @ din[..., i0:i0 + tile, :] for i0 in tiles)
    dk = (vc @ dSr.transpose(-1, -2)) * wlast + sum(dqk[..., i0:i0 + tile, :].transpose(-1, -2)
                                                     @ qc[..., i0:i0 + tile, :] for i0 in tiles)
    return (*(t.reshape(B, H, C, T, d) for t in (dq, dk, dv)), dS)


def _relu_bits(mask: np.ndarray) -> np.ndarray:
    """relu' of an (M, F) hidden layer packed as dtf_tc16.cuh's FF1 epilogue
    packs it: per 128 x 128 tile (blockIdx (F / 128 columns, M / 128 rows),
    the last tile of each cut short here, where F is no multiple of 128)
    a word per thread and row half, bit 2 j + e for the thread's column
    8 j + 2 t + e; thread tid = 128 wgi + 32 warp + 4 g + t holds rows
    64 wgi + 16 warp + g (+ 8)."""
    M, F = mask.shape
    m, n = np.meshgrid(np.arange(M), np.arange(F), indexing="ij")
    r, cc = m % 128, n % 128
    tid = 128 * (r // 64) + 32 * ((r % 64) // 16) + 4 * (r % 8) + (cc % 8) // 2
    nx = (F + 127) // 128
    word = (((m // 128) * nx + n // 128) * 256 + tid) * 2 + (r % 16) // 8
    bit = (2 * (cc // 8) + cc % 2).astype(np.uint32)
    words = np.zeros(((M + 127) // 128) * nx * 512, np.uint32)
    np.bitwise_or.at(words, word.ravel(), mask.ravel().astype(np.uint32) << bit.ravel())
    assert len(np.unique(word * 32 + bit)) == M * F      # every element its own bit
    return (words[word] >> bit) & 1                      # as the FF2 epilogue reads it back


def _mirror_fwd(x, w, seed, H, L, rate):
    """The layer forward in dtf_tc16.cuh's order: q | k | v for every chunk,
    the chunk states from the summaries (the mirror core), then each chunk's
    layer from the state it reads.  Returns (y, kvs, ss, the core's oh and
    row sums)."""
    B, C, T, D = x.shape
    xw = DT.FusionWeights(*(t.float() for t in w))
    qkvg = x.float() @ xw.wqkvg.T + xw.bqkvg
    dk = D // H
    q = _rnd(DT._heads(qkvg[..., :D], H))
    k = _rnd(_rnd(DT._heads(qkvg[..., D:2 * D], H)) * DT._kscale(dk, BF))
    v = _rnd(DT._heads(qkvg[..., 2 * D:3 * D], H))
    oh, inner, kvs, ss = _mirror_core_fwd(q, k, v, L)
    ys = [DT._chunk_fwd(x[:, :, n * L:(n + 1) * L], kvs[:, n], ss[:, n], w, seed, n, H, rate)[0]
          for n in range(T // L)]
    return torch.cat(ys, dim=2).to(BF), kvs, ss, oh, inner


def _mirror_bwd(x, dy, kvs, ss, w, seed, H, L, rate):
    """The layer backward in dtf_tc16.cuh's order: every chunk recomputed
    from its checkpoint, relu' read back from the packed bits (as the FF2
    epilogue reads it), every chunk's state increment from a pass at dS = 0
    (no chunk's increment reads another's dS), the reverse prefix, then
    every chunk's gradients from its dS_n, in chunk order."""
    B, C, T, D = x.shape
    N, dk = T // L, D // H
    w32 = DT.FusionWeights(*(t.float() for t in w))
    stash = []
    for n in range(N):
        st = DT._chunk_fwd(x[:, :, n * L:(n + 1) * L], kvs[:, n], ss[:, n], w, seed, n, H, rate,
                           collect=True)[3]
        hpre = st["hpre"]
        relu = (hpre > 0).reshape(-1, hpre.shape[-1]).numpy()
        bits = _relu_bits(relu)
        assert np.array_equal(bits.astype(bool), relu)
        st["hpre"] = torch.as_tensor(bits.astype(np.float32)).reshape(hpre.shape)
        stash.append(st)
    zero = x.new_zeros(B, H, C, dk, dk, dtype=torch.float32)
    junk = [torch.zeros_like(t) for t in w32]
    inc = [DT._chunk_bwd(dy[:, :, n * L:(n + 1) * L].float(), stash[n], w32, zero, junk, H, BF)[1]
           for n in range(N)]
    dS = [zero] * N
    for n in range(N - 2, -1, -1):
        dS[n] = dS[n + 1] + inc[n + 1]
    acc = [torch.zeros_like(t) for t in w32]
    dx = torch.cat([DT._chunk_bwd(dy[:, :, n * L:(n + 1) * L].float(), stash[n], w32, dS[n], acc,
                                  H, BF)[0] for n in range(N)], dim=2)
    return dx.to(BF), DT.FusionWeights(*(a.to(BF) for a in acc))


def test_chunk_parallel_order_of_work_matches_plain_and_the_jax_kernel(fusion):
    """The mirror of dtf_tc16.cuh's order of work against the bf16 plain
    version (which walks the chunks in sequence) and the JAX kernel in
    interpret mode: the chunk states from the summaries and their prefix
    equal the plain version's checkpoints to float32 rounding, the core's
    tiled row sums and output its stash, and y, dx and the 14 weight
    gradients meet the rounding rule against both; relu' from the packed
    bits is the plain version's hpre > 0, which hdrop != 0 is not (a
    positive float32 at or below 2^-134 rounds to a bf16 zero)."""
    w, x, dy, want16, want32 = fusion
    y16, kvs16, ss16 = DT.fusion_layer_fwd(x, w, SEED, H3, L3, RATE)
    y, kvs, ss, oh, inner = _mirror_fwd(x, w, SEED, H3, L3, RATE)
    torch.testing.assert_close(kvs, kvs16, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(ss, ss16, rtol=1e-6, atol=1e-6)
    assert float(ss[:, 1:].max()) > 1.0
    st = DT._chunk_fwd(x[:, :, L3:2 * L3], kvs16[:, 1], ss16[:, 1], w, SEED, 1, H3, RATE,
                       collect=True)[3]
    torch.testing.assert_close(inner[:, :, :, L3:2 * L3], st["is_"], rtol=1e-6, atol=0)
    ohn = oh[:, :, :, L3:2 * L3]
    ohn = (ohn - ohn.mean(-1, keepdim=True)) * st["grs"]
    assert float((_rnd(ohn) - st["ohn"]).abs().max()) <= 2 ** -7 * float(st["ohn"].abs().max())
    dx16, dw16 = DT.fusion_layer_bwd(x, dy, kvs16, ss16, w, SEED, H3, L3, RATE)
    dx, dw = _mirror_bwd(x, dy, kvs, ss, w, SEED, H3, L3, RATE)
    plain16 = [("y", y16), ("dx", dx16)] + list(zip(DT.FusionWeights._fields, dw16))
    got = [("y", y), ("dx", dx)] + list(zip(DT.FusionWeights._fields, dw))
    for (name, g), (_, p16), (_, j16), (_, j32) in zip(got, plain16, want16, want32):
        _drift_ok(g, j32, j16, name)
        assert _share(g, j16, j32) <= ROUND_SHARE, (name, _share(g, j16, j32))
        assert _share(g, p16, j32) <= ROUND_SHARE, (name, _share(g, p16, j32))
    tiny = torch.tensor([2.0 ** -140])
    assert float(tiny) > 0 and float(tiny.to(BF)) == 0.0


def test_mirror_core_backward_is_its_forward_s_gradient():
    """Without the roundings, the mirror's chunk-parallel core backward (the
    increments at once, the reverse prefix, tiles of 3 rows over 8-row
    chunks) is the gradient torch takes of its core forward through the
    carried state, in float64: the order of work computes the reference's
    backward."""
    rng = np.random.default_rng(7)
    B, H, C, T, d, L = 1, 2, 2, 24, 8, 8
    q, k, v = (torch.tensor(rng.standard_normal((B, H, C, T, d)) * 1.5, requires_grad=True)
               for _ in range(3))
    doh = torch.tensor(rng.standard_normal((B, H, C, T, d)))
    same = lambda t: t                                          # noqa: E731
    oh, inner, kvs, ss = _mirror_core_fwd(q, k, v, L, rnd=same)
    assert float(ss[:, 1:].max()) > 1.0 and float(inner.max()) > 1.0
    (oh * doh).sum().backward()
    with torch.no_grad():
        dq, dk, dv, dS = _mirror_core_bwd(q, k, v, doh, inner, kvs, ss, L, rnd=same)
    for got, want in ((dq, q.grad), (dk, k.grad), (dv, v.grad)):
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)
    assert float(dS[:, :, :, -1].abs().max()) == 0.0 and float(dS[:, :, :, 0].abs().max()) > 0


# ---------------------------------------------------------------------------
# compute_loss in bf16, every family, against the JAX package's
# ---------------------------------------------------------------------------


def _batch(in_size):
    rng = np.random.default_rng(5)
    labels = (rng.uniform(size=(B, T, S)) > 0.6).astype(np.float32)
    lens = np.array([T, 12], np.int32)
    labels[1, 12:] = 0
    feats = rng.standard_normal((B, T, in_size)).astype(np.float32)
    return {"feats": feats, "labels": labels, "lens": lens, "n_spk": np.array([2, 1], np.int32)}


@functools.lru_cache(maxsize=None)
def _init_shapes(init, jcfg):
    """The JAX init's pytree structure (`jax.eval_shape`), once per config."""
    return jax.eval_shape(lambda k: init(k, jcfg), jax.random.PRNGKey(0))


def _family(name):
    """(port task, port model, JAX task, JAX config, JAX params, JAX model
    state, tree -> named port gradients)."""
    if name.startswith("ls"):
        fused = name == "ls_fused"
        jcfg = JL.LSEENDConfig(in_size=8, n_units=32, n_heads=2, enc_n_layers=1,
                               dec_n_layers=1, chunk_size=8, ff_expansion=2, conv_kernel_size=4,
                               dec_dim_feedforward=32, conv_delay=2, max_nspks=S + 2,
                               dropout=0.0, use_fused_dec=fused)
        tcfg = TL.LSEENDConfig(**{f.name: getattr(jcfg, f.name)
                                  for f in dataclasses.fields(TL.LSEENDConfig)
                                  if hasattr(jcfg, f.name)}, kernel="plain")
        model = TL.init_ls_eend(tcfg, torch.Generator().manual_seed(3), device="cpu")
        tree, mstate = CV.ls_params_to_jax(model)
        shapes, _ = _init_shapes(JL.init_ls_eend, jcfg)

        def names(g):
            m = CV.ls_params_from_jax(jax.tree.map(np.asarray, g), mstate, tcfg, "cpu")
            return {n: p.detach().numpy() for n, p in m.named_parameters()}
        kw = dict(model="ls", masked_emb_loss=True)
    elif name == "fs":
        # no encoder layer (the same post-norm layer as EEND-EDA's below): the
        # JAX compile is the cost
        jcfg = JF.FSEENDConfig(in_size=8, n_units=32, n_heads=2, enc_n_layers=0, dec_n_layers=1,
                               enc_dim_feedforward=32, dec_dim_feedforward=32, conv_delay=2,
                               max_nspks=S + 2, dropout=0.0)
        tcfg = TF.FSEENDConfig(**{f.name: getattr(jcfg, f.name)
                                  for f in dataclasses.fields(jcfg)})
        model = TF.init_fs_eend(tcfg, torch.Generator().manual_seed(3), device="cpu")
        g = torch.Generator().manual_seed(4)
        with torch.no_grad():                      # live running statistics
            model.enc.bn.running_mean.normal_(0, 0.2, generator=g)
            model.enc.bn.running_var.uniform_(0.5, 2.0, generator=g)
        tree, mstate = CV.fs_params_to_jax(model)
        shapes, _ = _init_shapes(JF.init_fs_eend, jcfg)

        def names(g):
            m = CV.fs_params_from_jax(jax.tree.map(np.asarray, g), mstate, tcfg, "cpu")
            return {n: p.detach().numpy() for n, p in m.named_parameters()}
        kw = dict(model="fs")
    else:
        jcfg = JE.EDAConfig(in_size=8, n_units=32, n_heads=2, n_layers=1, dim_feedforward=32,
                            dropout=0.0)
        tcfg = TE.EDAConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
        model = TE.init_eend_eda(tcfg, torch.Generator().manual_seed(3), device="cpu")
        tree, mstate = CV.eda_params_to_jax(model)
        shapes, _ = _init_shapes(JE.init_eend_eda, jcfg)

        def names(g):
            m = CV.eda_params_from_jax(jax.tree.map(np.asarray, g), tcfg, "cpu")
            return {n: p.detach().numpy() for n, p in m.named_parameters()}
        kw = dict(model="eda", label_mode="pit")
    return (TRN.TaskConfig(compute_dtype="bf16", **kw), model, kw, jcfg,
            _as_jax_tree(tree, shapes), jax.tree.map(jnp.asarray, mstate), names)


def _loss_and_grads(task, model, batch):
    """The port's loss and flat gradient (parameters in name order; zeros
    where a parameter gets none), the BatchNorm state, at dropout 0."""
    for p in model.parameters():
        p.grad = None
    loss, (bn_state, _) = TRN.compute_loss(task, model, {k: torch.as_tensor(v)
                                                         for k, v in batch.items()},
                                           None, train=True)
    loss.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    assert all(g.dtype == torch.float32 for g in grads.values())
    return loss, np.concatenate([g.numpy().ravel() for _, g in sorted(grads.items())]), bn_state


@pytest.mark.parametrize("name", ["ls_fused", "fs", "eda"])
def test_compute_loss_bf16_matches_jax(name):
    """LS-EEND as configs/ls_simu.yaml trains it (the fused decoder on the
    plain retention route), FS-EEND and EEND-EDA."""
    task, model, kw, jcfg, params, mstate, names = _family(name)
    batch = _batch(jcfg.in_size)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jtask = JTRN.TaskConfig(compute_dtype="bf16", **kw)
    vg = jax.value_and_grad(lambda p: JTRN.compute_loss(jtask, jcfg, p, mstate, jb, None,
                                                        train=True)[0])
    j16, g16 = jax.jit(vg).lower(params).compile(dict(NO_EXCESS, **FAST))(params)
    assert all(g.dtype == jnp.float32 for g in jax.tree.leaves(g16))

    loss, got, bn_state = _loss_and_grads(task, model, batch)
    loss32, got32, _ = _loss_and_grads(dataclasses.replace(task, compute_dtype="f32"), model,
                                       batch)
    assert loss.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(v.dtype == torch.float32 for v in jax.tree.leaves(bn_state))
    _drift_ok(loss, loss32, j16, "loss")
    w16 = names(g16)
    want = np.concatenate([np.ravel(w16[n]) for n in sorted(w16)])
    c_port, c_jax = _cos(got, want), _cos(want, got32)
    assert c_port >= c_jax - 0.01, (c_port, c_jax)


def test_bf16_steps_lower_the_loss_and_keep_float32(tmp_path):
    """The unfused LS decoder on every retention route in bf16; a few bf16
    Adam steps (FS, as tests/test_trainer.py:95-103) lower the loss with
    the parameters and moments float32; one bf16
    `run_training` epoch of the fused-decoder LS model writes float32
    checkpoints in the JAX package's layout, which reload bit for bit and
    resume."""
    # the unfused LS decoder at dropout 0, on the plain, "fused" (B4) and
    # "core" (B5) retention routes: JAX's rule against their float32 gradients
    task, model, _, jcfg, *_ = _family("ls_fused")
    batch = _batch(jcfg.in_size)
    for route in ("plain", "fused", "core"):
        unfused = TL.with_cfg(model, dataclasses.replace(model.cfg, use_fused_dec=False,
                                                         kernel=route))
        _, g16, _ = _loss_and_grads(task, unfused, batch)
        _, g32, _ = _loss_and_grads(dataclasses.replace(task, compute_dtype="f32"), unfused,
                                    batch)
        assert _cos(g16, g32) > 0.98, route

    task, model, _, jcfg, *_ = _family("fs")
    tx = TO.build_optimizer("adam", lr=1e-3, grad_clip=5.0)
    state = TRN.TrainState.create(model, tx)
    step = TRN.make_train_step(task, model.cfg, tx, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in _batch(jcfg.in_size).items()}
    losses = [float(step(state, batch, 1)[1]["tot_loss"]) for _ in range(12)]
    assert losses[-1] < 0.9 * losses[0], losses
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(t.dtype == torch.float32 for t in state.opt_state["mu"] + state.opt_state["nu"])
    assert model.enc.bn.running_mean.dtype == torch.float32

    cfg = dataclasses.replace(_family("ls_fused")[1].cfg, dropout=0.1)
    data = [(np.asarray(batch["feats"][i, :, :8]), np.asarray(batch["labels"][i]), f"r{i}")
            for i in range(B)]
    logger = LOOP.MetricsLogger(str(tmp_path), "bf16")
    run = dict(task=TRN.TaskConfig(compute_dtype="bf16", masked_emb_loss=True), model_cfg=cfg,
               train_dataset=data, val_dataset=data, tx=TO.build_optimizer("adam", lr=1e-3),
               logger=logger, batch_size=B, chunk_size=T, max_speakers=S, input_dim=8,
               seed=0, device="cpu")
    st, ckpt_dir = LOOP.run_training(max_epochs=1, **run)
    saved = np.load(ckpt_dir / "ckpt_epoch=0.npz")
    assert all(saved[k].dtype == np.float32 for k in saved.files
               if not k.startswith(("__extra__", "opt_state/count")))
    fresh = CK.load_ls_eend(ckpt_dir / "ckpt_epoch=0.npz", cfg, "cpu")
    for (n, a), b in zip(st.model.state_dict().items(), fresh.state_dict().values()):
        assert n.endswith("num_batches_tracked") or torch.equal(a, b), n
    st2, _ = LOOP.run_training(max_epochs=2, resume_from=str(ckpt_dir / "ckpt_epoch=0.npz"),
                               **run)
    assert st2.step == 2 * st.step
    logger.close()


# ---------------------------------------------------------------------------
# B4 and B5: their bf16 gradients by recompute
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["fused", "core"])
def test_retention_kernel_routes_bf16_gradients_match_jax(route):
    """B4 (the whole layer) and B5 (the core) in bf16 under autograd: the
    forward is the kernel's (its bf16 plain version here), the gradient the
    recompute of the pure route JAX differentiates; against
    `jax.vjp(fused_retention_layer)` and `jax.vjp(chunkwise_retention)`."""
    from fseend_tpu_torch.ops import retention as TR

    D, H, L, Tn = 32, 2, 8, 24
    rc = TR.RetentionConfig(embed_dim=D, num_heads=H, chunk_size=L, kernel=route)
    with torch.random.fork_rng():                    # torch's initializer, seeded
        torch.manual_seed(6)
        ret = TR.Retention(rc)
    tree = {n: {"kernel": jnp.asarray(getattr(ret, n).weight.detach().numpy().T),
                "bias": jnp.asarray(getattr(ret, n).bias.detach().numpy())}
            for n in ("q_proj", "k_proj", "v_proj", "g_proj", "out_proj")}
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.standard_normal((B, Tn, D)), jnp.bfloat16)
    dy = jnp.asarray(rng.standard_normal((B, Tn, D)), jnp.bfloat16)
    jrc = JR.RetentionConfig(embed_dim=D, num_heads=H, chunk_size=L, use_fused_ret=True)
    dk = D // H
    if route == "fused":
        def fn(p, x_):
            return JRLP.fused_retention_layer(p, x_, None, jrc, True)[0]
    else:
        def fn(p, x_):                      # the core on the projections, as the model runs it
            q, k, v, _ = JR._project_qkv(p, x_, jrc)
            return JRP.chunkwise_retention(q.reshape(B * H, Tn, dk), k.reshape(B * H, Tn, dk),
                                           v.reshape(B * H, Tn, dk), L, True)

    def run(p, x_, dy_):
        y, vjp = jax.vjp(fn, p, x_)
        return vjp(dy_.reshape(y.shape))
    p16 = _cast(tree)
    gp16, gx16 = jax.jit(run).lower(p16, x, dy).compile(dict(NO_EXCESS, **FAST))(p16, x, dy)

    def port(dt):
        """(y, {name: gradient}) of the port's route on the bf16 values in dt"""
        m = copy.deepcopy(ret)
        for p in m.parameters():
            p.data = p.data.to(dt)
        xt = torch.as_tensor(_f32(x)).to(dt).requires_grad_(True)
        gam = TR.decay_gammas(rc)
        if route == "fused":
            y, _, _ = RL.retention_layer(gam, xt, RL.pack_retention(m),
                                         torch.zeros(B, H, dk, dk, dtype=dt),
                                         torch.ones(B, H, 1, 1, dtype=dt), L)
        else:
            q, k, v, _ = TR._project_qkv(m, xt, rc)
            y = CR.chunk_retention(gam.repeat(B), *(t.reshape(B * H, Tn, dk) for t in (q, k, v)),
                                   torch.zeros(B * H, dk, dk, dtype=dt),
                                   torch.ones(B * H, 1, 1, dtype=dt), L)[0]
        y.backward(torch.as_tensor(_f32(dy)).to(dt).reshape(y.shape))
        g = {"x": xt.grad}
        for n in tree:
            if route == "fused" or n in ("q_proj", "k_proj", "v_proj"):
                g[n + ".kernel"] = getattr(m, n).weight.grad.T
                g[n + ".bias"] = getattr(m, n).bias.grad
        return y, g

    for p in ret.parameters():                         # the bf16 values, in float32 too
        p.data = p.data.to(BF).float()
    y, got = port(BF)
    _, got32 = port(torch.float32)
    assert y.dtype == BF
    for name, g in got.items():
        n, _, k = name.partition(".")
        j16 = gx16 if name == "x" else gp16[n][k]
        assert g.dtype == BF, name
        _drift_ok(g, got32[name], j16, name)
        a, b = _f32(j16).ravel(), _f32(got32[name]).ravel()
        assert _cos(_f32(g).ravel(), a) >= _cos(a, b) - 0.01, name
