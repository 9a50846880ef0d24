"""CUDA kernels of the PyTorch port (the two frame scans, the chunkwise
retention core and the retention layer) against their plain PyTorch
versions, on the card.  Marked `gpu`: they skip where there is no CUDA
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
from fseend_tpu_torch.kernels import enc_frame_scan as EFS
from fseend_tpu_torch.kernels import retention_layer as RL
from fseend_tpu_torch.models import ls_eend
from fseend_tpu_torch.ops import retention as TR
from fseend_tpu_torch.serving.runtime import BlockStreamingServer, StreamingServer
from fseend_tpu_torch.serving.scheduler import ContinuousBatcher

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
    q = torch.zeros(2, 8, 16, device=cuda, requires_grad=True)
    z = torch.zeros(2, 8, 16, device=cuda)
    with pytest.raises(NotImplementedError, match="forward only"):
        CR.chunk_retention(torch.ones(2, device=cuda), q, z, z,
                           torch.zeros(2, 16, 16, device=cuda),
                           torch.ones(2, 1, 1, device=cuda), 8)
