"""CUDA kernels of the PyTorch port (the two frame scans, the chunkwise
retention core, the retention layer and the fusion layer's training forward
and backward) against their plain PyTorch versions, and one train step, on
the card.  Marked `gpu`: they skip where there is no CUDA
device.  On a machine with one (and without JAX, which tests/conftest.py
imports), run them with

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py

Tolerance: float32 with another summation order than the batched plain
version (2e-4, as the JAX package's fused-vs-scan tests)."""

import dataclasses

import numpy as np
import pytest
import torch

from fseend_tpu_torch.kernels import chunk_retention as CR
from fseend_tpu_torch.kernels import dec_frame_scan as DFS
from fseend_tpu_torch.kernels import dec_train_fusion as DTF
from fseend_tpu_torch.kernels import enc_frame_scan as EFS
from fseend_tpu_torch.kernels import retention_layer as RL
from fseend_tpu_torch.models import ls_eend
from fseend_tpu_torch.ops import retention as TR
from fseend_tpu_torch.serving.runtime import BlockStreamingServer, StreamingServer
from fseend_tpu_torch.serving.scheduler import ContinuousBatcher
from fseend_tpu_torch.train import optim
from fseend_tpu_torch.train import trainer as TRN

pytestmark = pytest.mark.gpu

CFG = ls_eend.LSEENDConfig(
    in_size=20, n_units=64, n_heads=4, enc_n_layers=2, dec_n_layers=2,
    conv_kernel_size=4, dec_dim_feedforward=48, conv_delay=2, max_nspks=3)
B, C = 4, 3
ATOL = 2e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _model(dev):
    model = ls_eend.init_ls_eend(CFG, torch.Generator().manual_seed(5), device=dev)
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for blk in model.enc.blocks:
            blk.conv.bn.running_mean.copy_(torch.as_tensor(rng.normal(0, 0.2, 64)))
            blk.conv.bn.running_var.copy_(torch.as_tensor(rng.uniform(0.5, 2.0, 64)))
    return model


def _captured_block(dev, K):
    """Kernel-call arguments of the second block of a fused run (non-zero
    incoming state, staggered clocks, per-lane flush)."""
    model = _model(dev)
    rng = np.random.default_rng(9)
    state = ls_eend.ls_stream_init(CFG, B, C, device=dev)
    xs = torch.as_tensor(rng.standard_normal((B, K, CFG.in_size)), dtype=torch.float32,
                         device=dev)
    state, _ = ls_eend.ls_stream_block_fused(model, state, xs, torch.zeros(
        K, B, dtype=torch.bool, device=dev), C)
    state["t"] = torch.tensor([0, 1, CFG.conv_delay, 7], dtype=torch.int32, device=dev)
    fl = np.zeros((K, B), bool)
    fl[K // 2:, 0] = True
    fl[K - 1:, 1] = True
    got = {}
    orig = (EFS.enc_frame_scan, DFS.dec_frame_scan)

    def rec(name, fn):
        def f(*a, **kw):
            got[name] = ([t.clone() if torch.is_tensor(t) else t for t in a], kw)
            return fn(*a, **kw)
        return f

    EFS.enc_frame_scan, DFS.dec_frame_scan = rec("enc", orig[0]), rec("dec", orig[1])
    try:
        ls_eend.ls_stream_block_fused(model, state, xs.flip(1).contiguous(),
                                      torch.as_tensor(fl, device=dev), C)
    finally:
        EFS.enc_frame_scan, DFS.dec_frame_scan = orig
    return got


def _both(fn_k, fn_p, args, kw):
    ak = [t.clone() if torch.is_tensor(t) else t for t in args]
    ap = [t.clone() if torch.is_tensor(t) else t for t in args]
    yk, yp = fn_k(*ak, **kw), fn_p(*ap, **kw)
    torch.cuda.synchronize()
    return [yk] + [t for t in ak if torch.is_tensor(t)], [yp] + [t for t in ap if torch.is_tensor(t)]


@pytest.mark.parametrize("K", [1, 6])
def test_enc_kernel_matches_plain(cuda, K):
    args, kw = _captured_block(cuda, K)["enc"]
    n0 = EFS.launches
    got, want = _both(EFS.enc_frame_scan, EFS.enc_frame_scan_plain, args, kw)
    assert EFS.launches == n0 + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("K", [1, 6])
def test_dec_kernel_matches_plain(cuda, K):
    args, kw = _captured_block(cuda, K)["dec"]
    n0 = DFS.launches
    got, want = _both(DFS.dec_frame_scan, DFS.dec_frame_scan_plain, args, kw)
    assert DFS.launches == n0 + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


def test_server_kernel_path_matches_plain_server(cuda):
    model = _model(cuda)
    rng = np.random.default_rng(11)
    streams = {f"s{i}": rng.standard_normal((t, CFG.in_size)).astype(np.float32)
               for i, t in enumerate([7, 15, 4, 11])}

    def run(fk):
        srv = StreamingServer(kind="ls", cfg=CFG, model=model, n_lanes=2, n_slots=C,
                              frame_kernel=fk, device=cuda)
        cb = ContinuousBatcher(srv, block=6)
        for sid, feats in streams.items():
            cb.submit(sid, feats)
        return srv, cb.run()

    n_enc, n_dec = EFS.launches, DFS.launches
    srv, got = run(True)
    assert EFS.launches > n_enc and DFS.launches > n_dec
    _, ref = run(False)
    for sid in streams:
        np.testing.assert_allclose(got[sid], ref[sid], atol=ATOL)
    # a reset lane serves a stream again bit for bit (lane 0 held "s0")
    srv.reset_lanes([0, 1])
    cb = ContinuousBatcher(srv, block=6)
    cb.submit("s0", streams["s0"])
    np.testing.assert_array_equal(cb.run()["s0"], got["s0"])


def test_wrappers_raise_on_unsupported_dtype(cuda):
    args, kw = _captured_block(cuda, 2)["enc"]
    bad = list(args)
    bad[0] = bad[0].double()
    with pytest.raises(ValueError, match="float32"):
        EFS.enc_frame_scan(*bad, **kw)


# ---------------------------------------------------------------------------
# the chunkwise retention kernels
# ---------------------------------------------------------------------------


def _randn(rng, *shape, scale=1.0, dev=None):
    return torch.as_tensor(rng.standard_normal(shape) * scale, dtype=torch.float32, device=dev)


@pytest.mark.parametrize("gamma", [1.0, 0.95])
@pytest.mark.parametrize("L", [24, 75, 150])      # under one tile, two tiles, three
def test_chunk_retention_kernel_matches_plain(cuda, gamma, L):
    rng = np.random.default_rng(21)
    BH, T, dk, dv = 10, 2 * L, 16, 32
    args = [torch.full((BH,), gamma, device=cuda), _randn(rng, BH, T, dk, dev=cuda),
            _randn(rng, BH, T, dk, scale=0.5, dev=cuda), _randn(rng, BH, T, dv, dev=cuda),
            _randn(rng, BH, dk, dv, dev=cuda),
            torch.as_tensor(rng.uniform(1, 9, (BH, 1, 1)), dtype=torch.float32, device=cuda)]
    given = [a.clone() for a in args]
    n0 = CR.launches
    got = CR.chunk_retention(*args, L)
    torch.cuda.synchronize()
    assert CR.launches == n0 + 1
    want = CR.chunk_retention_plain(*args, L)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=1e-5)
    for a, b in zip(args, given):                 # inputs, the state included, untouched
        assert torch.equal(a, b)


@pytest.mark.parametrize("use_decay", [False, True])
def test_retention_layer_kernel_matches_plain(cuda, use_decay):
    """Two calls in a row (the second from a carried state), two chunks per
    call, value_factor 2."""
    rng = np.random.default_rng(22)
    B, L, D, H = 6, 40, 64, 4
    cfg = TR.RetentionConfig(D, H, 2, L, use_decay=use_decay)
    ret = TR.Retention(cfg).to(cuda)
    with torch.no_grad():
        for prm in ret.parameters():
            prm.copy_(_randn(rng, *prm.shape, scale=0.1, dev=cuda))
    w = RL.pack_retention(ret)
    gam = TR.decay_gammas(cfg, cuda)
    st = TR.chunk_state_init(cfg, B, device=cuda)
    kv0, s0 = st["kv"], st["scale"]
    for _ in range(2):
        x = _randn(rng, B, 2 * L, D, scale=2.0, dev=cuda)
        n0 = RL.launches
        got = RL.retention_layer(gam, x, w, kv0, s0, L)
        torch.cuda.synchronize()
        assert RL.launches == n0 + 1
        want = RL.retention_layer_plain(gam, x, w, kv0, s0, L)
        for g, wv in zip(got, want):
            torch.testing.assert_close(g, wv, atol=ATOL, rtol=1e-5)
        kv0, s0 = want[1], want[2]
    assert float(s0.max()) > 1.0


def test_kernel_routes_match_plain_route_end_to_end(cuda):
    """Blockwise server on the "fused" route and ls_test on the "core"
    route against the "plain" route; both kernels must have launched."""
    model = _model(cuda)
    rng = np.random.default_rng(23)
    K = 8
    xs = rng.standard_normal((4, B, K, CFG.in_size)).astype(np.float32)

    def serve(kernel):
        srv = BlockStreamingServer(kind="ls", cfg=dataclasses.replace(CFG, kernel=kernel),
                                   model=model, n_lanes=B, n_slots=C, block=K, device=cuda)
        outs = [srv.process_block(xs[i]) for i in range(3)]
        outs.append(srv.process_block(xs[3], flush=True))
        return torch.cat(outs[1:], dim=1)

    n_rl, n_cr = RL.launches, CR.launches
    torch.testing.assert_close(serve("fused"), serve("plain"), atol=ATOL, rtol=0)
    assert RL.launches == n_rl + 3 * 4 + 2       # 2 enc + 2 dec layers, dec only on flush

    x = torch.as_tensor(xs.transpose(1, 0, 2, 3).reshape(B, 4 * K, -1), device=cuda)
    lens = torch.tensor([32, 9, 20, 27], device=cuda)

    def batch(kernel):
        m = ls_eend.with_cfg(model, dataclasses.replace(CFG, kernel=kernel, chunk_size=K))
        return ls_eend.ls_test(m, x, lens)["logits"]

    torch.testing.assert_close(batch("core"), batch("plain"), atol=ATOL, rtol=0)
    assert CR.launches == n_cr + 4


def test_chunk_kernels_are_forward_only(cuda):
    """The kernels have no backward of their own: with a gradient wanted,
    the forward still launches the kernel and the backward recomputes the
    plain version (the gradients equal the plain route's autograd)."""
    rng = np.random.default_rng(24)
    args = [_randn(rng, 2, 16, 16, dev=cuda).requires_grad_(True) for _ in range(3)]
    kv0, s0 = torch.zeros(2, 16, 16, device=cuda), torch.ones(2, 1, 1, device=cuda)
    gam = torch.ones(2, device=cuda)
    n0 = CR.launches
    out = CR.chunk_retention(gam, *args, kv0, s0, 8)
    assert CR.launches == n0 + 1
    (out[0] * out[0]).sum().backward()
    got = [a.grad.clone() for a in args]
    for a in args:
        a.grad = None
    ref = CR.chunk_retention_plain(gam, *args, kv0, s0, 8)
    (ref[0] * ref[0]).sum().backward()
    for g, a in zip(got, args):
        torch.testing.assert_close(g, a.grad, atol=ATOL, rtol=1e-5)


# ---------------------------------------------------------------------------
# the fusion layer's training kernels
# ---------------------------------------------------------------------------


def _fusion_case(dev, rate, L=40, T=80):
    """Production-like proportions at a small width: D 128, 4 heads (head
    dim 32), F 96, 3 slots; L = 40 leaves a partial 64-frame tile."""
    rng = np.random.default_rng(31)
    B, C, D, F = 2, 3, 128, 96
    cfg = ls_eend.LSEENDConfig(in_size=8, n_units=D, n_heads=4, dec_n_layers=1,
                               dec_dim_feedforward=F, chunk_size=L)
    layer = ls_eend.init_ls_eend(cfg, torch.Generator().manual_seed(3), device=dev).dec.layers[0]
    with torch.no_grad():
        w = DTF.FusionWeights(*(t.detach().clone() for t in DTF.pack_fusion(layer)))
        w = w._replace(wqkvg=w.wqkvg * 4)       # renormalizers and carried scales above 1
        # the FFN bias at +-5: no hidden unit within float32 rounding of the
        # ReLU's kink, where two summation orders could disagree on its sign
        sign = torch.as_tensor(rng.integers(0, 2, F) * 2 - 1, dtype=torch.float32, device=dev)
        w = w._replace(bf1=sign * 5.0)
    x = _randn(rng, B, C, T, D, dev=dev)
    return x, w, 1234, 4, L, rate


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fusion_forward_kernel_matches_plain(cuda, rate):
    x, w, seed, H, L, rate = _fusion_case(cuda, rate)
    n0 = DTF.fwd_launches
    got = DTF.fusion_layer_fwd(x, w, seed, H, L, rate)
    torch.cuda.synchronize()
    assert DTF.fwd_launches == n0 + 1
    want = DTF.fusion_layer_fwd_plain(x, w, seed, H, L, rate)
    assert float(want[2].max()) > 1.0
    for g, wv in zip(got, want):
        torch.testing.assert_close(g, wv, atol=1e-3, rtol=0)
    y, kvs, ss = DTF.fusion_layer_fwd(x, w, seed, H, L, rate, checkpoints=False)
    assert kvs is None and ss is None
    torch.testing.assert_close(y, got[0], atol=0, rtol=0)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fusion_backward_kernel_matches_plain(cuda, rate):
    x, w, seed, H, L, rate = _fusion_case(cuda, rate)
    _, kvs, ss = DTF.fusion_layer_fwd_plain(x, w, seed, H, L, rate)
    dy = _randn(np.random.default_rng(32), *x.shape, dev=cuda)
    n0 = DTF.bwd_launches
    dx, dw = DTF.fusion_layer_bwd(x, dy, kvs, ss, w, seed, H, L, rate)
    torch.cuda.synchronize()
    assert DTF.bwd_launches == n0 + 1
    dx_p, dw_p = DTF.fusion_layer_bwd_plain(x, dy, kvs, ss, w, seed, H, L, rate)
    torch.testing.assert_close(dx, dx_p, atol=1e-3, rtol=0)
    for name, g, gp in zip(DTF.FusionWeights._fields, dw, dw_p):
        tol = 2e-3 * float(gp.abs().max())
        assert float((g - gp).abs().max()) <= tol, name


def test_train_step_runs_the_fusion_kernels(cuda):
    cfg = dataclasses.replace(CFG, n_units=128, in_size=16, use_fused_dec=True,
                              fused_dec_chunk=16, chunk_size=24, dropout=0.1)
    model = ls_eend.init_ls_eend(cfg, torch.Generator().manual_seed(6), device=cuda)
    rng = np.random.default_rng(33)
    Bt, Tt, S = 2, 40, C - 2
    batch = {"feats": _randn(rng, Bt, Tt, cfg.in_size, dev=cuda),
             "labels": torch.as_tensor(rng.uniform(size=(Bt, Tt, S)) > 0.6,
                                       dtype=torch.float32, device=cuda),
             "lens": torch.tensor([40, 31], device=cuda),
             "n_spk": torch.tensor([1, 1], device=cuda)}
    task = TRN.TaskConfig(label_mode="fixed", masked_emb_loss=True)
    tx = optim.build_optimizer("noam", 1.0, d_model=128, warmup_steps=100, grad_clip=5.0)
    state = TRN.TrainState.create(model, tx)
    step = TRN.make_train_step(task, cfg, tx)
    n_f, n_b = DTF.fwd_launches, DTF.bwd_launches
    state, metrics = step(state, batch, 0)
    torch.cuda.synchronize()
    assert DTF.fwd_launches == n_f + cfg.dec_n_layers
    assert DTF.bwd_launches == n_b + cfg.dec_n_layers
    assert np.isfinite(float(metrics["tot_loss"])) and state.step == 1
