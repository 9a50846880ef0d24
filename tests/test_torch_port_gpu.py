"""CUDA frame-scan kernels of the PyTorch port against their plain PyTorch
versions, on the card.  Marked `gpu`: they skip where there is no CUDA
device.  On a machine with one (and without JAX, which tests/conftest.py
imports), run them with

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py

Tolerance: float32 with another summation order than the batched plain
version (2e-4, as the JAX package's fused-vs-scan tests)."""

import numpy as np
import pytest
import torch

from fseend_tpu_torch.kernels import dec_frame_scan as DFS
from fseend_tpu_torch.kernels import enc_frame_scan as EFS
from fseend_tpu_torch.models import ls_eend
from fseend_tpu_torch.serving.runtime import StreamingServer
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
