"""CUDA kernels of the PyTorch port (the two frame scans, the chunkwise
retention core, the retention layer, the fusion layer's training forward
and backward, and the two cached-attention kernels) against their plain
PyTorch versions, one train step, FS-EEND serving on both cached-attention
routes, and the EEND-EDA train pass and FLEX-STB against the CPU, on the
card.  Marked `gpu`: they skip where there is no CUDA
device.  On a machine with one (and without JAX, which tests/conftest.py
imports), run them with

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py

Tolerance: float32 with another summation order than the batched plain
version (2e-4, as the JAX package's fused-vs-scan tests); the products of
both frame scans, of both cached-attention kernels (the per-lane one's
K = 1 path sums on the FMA pipe) and of the fusion layer's forward and
backward run on the tensor cores in three TF32 passes, float32-exact to
about 1e-6 relative (`fseend_tpu_torch/kernels/csrc/tc_f32.cuh`): the frame
scans, the per-lane cached attention, the forward's y and the backward's dx
are held within TC_ATOL = 1e-4.  The bf16 forms of both frame scans and of
the retention layer against their bf16 plain versions by chip_smoke.py's
bf16 guards (`_bf16_close`): the drift rule of the JAX package's bf16 test
from the float32 plain version, not a float32 computation, and on one-frame
calls and the retention layer at most half as far from bf16 plain (mean
abs) as bf16 plain is from float32; the fusion layer's bf16 forward and
backward by the same guards at chip_smoke.py's H7 shares (B3_BF16_CLOSE:
0.6 forward, 0.8 backward), and a bf16 train step through both."""

import dataclasses

import numpy as np
import pytest
import torch

from fseend_tpu_torch.kernels import cached_attention as CA
from fseend_tpu_torch.kernels import chunk_retention as CR
from fseend_tpu_torch.kernels import dec_frame_scan as DFS
from fseend_tpu_torch.kernels import dec_train_fusion as DTF
from fseend_tpu_torch.kernels import enc_frame_scan as EFS
from fseend_tpu_torch.kernels import retention_layer as RL
from fseend_tpu_torch.models import eend_eda, fs_eend, ls_eend
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
TC_ATOL = 1e-4


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
        torch.testing.assert_close(g, w, atol=TC_ATOL, rtol=0)


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


def _dec_case(dev, D, F, C, K, seed):
    """Random fusion-layer weights and one call's inputs: lane 0 valid
    throughout, lane 1 invalid in the middle of the block, lane 2 before
    warm-up for its first frames, lane 3 never valid; incoming counts 0, 3,
    40 and 1000 per lane (shared by the lane's slots and heads)."""
    rng = np.random.default_rng(seed)
    nl, H = 2, 4

    def r(*shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape) * scale, dtype=torch.float32,
                               device=dev)

    w = DFS.DecWeights(
        w_qkvg=r(nl, D, 4 * D, scale=D ** -0.5), b_qkvg=r(nl, 4 * D, scale=0.1),
        w_ro=r(nl, D, D, scale=D ** -0.5), b_ro=r(nl, D, scale=0.1),
        w_mi=r(nl, D, 3 * D, scale=D ** -0.5), b_mi=r(nl, 3 * D, scale=0.1),
        w_mo=r(nl, D, D, scale=D ** -0.5), b_mo=r(nl, D, scale=0.1),
        w_f1=r(nl, D, F, scale=D ** -0.5), b_f1=r(nl, F, scale=0.1),
        w_f2=r(nl, F, D, scale=F ** -0.5), b_f2=r(nl, D, scale=0.1),
        ln_s=1.0 + r(nl, 3, D, scale=0.1), ln_b=r(nl, 3, D, scale=0.1))
    lanes = 4
    valid = np.ones((lanes, K), np.float32)
    valid[1, K // 3:2 * K // 3 + 1] = 0.0
    valid[2, :min(3, K - 1)] = 0.0
    valid[3] = 0.0
    embn = r(lanes, K, D)
    s0 = np.repeat(np.array([0.0, 3.0, 40.0, 1000.0], np.float32), C)
    s = torch.as_tensor(np.broadcast_to(s0[None, :, None], (nl, lanes * C, H)).copy(),
                        device=dev)
    args = [r(lanes, K, D), embn / embn.norm(dim=-1, keepdim=True),
            torch.as_tensor(valid, device=dev), r(C, D, scale=0.5), w,
            r(nl, lanes * C, H, D // H, D // H, scale=0.2), s]
    return args


@pytest.mark.parametrize("D,F", [(64, 48), (256, 2048)])
@pytest.mark.parametrize("C", [6, 10])
@pytest.mark.parametrize("K", [1, 7, 128, 200])
def test_dec_frame_scan_kernel_matches_plain_over_two_calls(cuda, D, F, C, K):
    """The layer-major kernel against the frame-by-frame plain version:
    logits and the state after each of two consecutive calls (the second
    reads the state the first left); K 200 walks two slices."""
    args = _dec_case(cuda, D, F, C, K, seed=D + C + K)
    ak = [t.clone() if torch.is_tensor(t) else t for t in args]
    ap = [t.clone() if torch.is_tensor(t) else t for t in args]
    for call in range(2):
        if call:
            ak[0] = ap[0] = args[0].flip(1).contiguous()
        n0 = DFS.launches
        got = DFS.dec_frame_scan(*ak)
        torch.cuda.synchronize()
        assert DFS.launches == n0 + 1
        want = DFS.dec_frame_scan_plain(*ap)
        torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
        torch.testing.assert_close(ak[5], ap[5], atol=ATOL, rtol=0)
        torch.testing.assert_close(ak[6], ap[6], atol=0, rtol=0)


def test_dec_frame_scan_refuses_what_it_does_not_take(cuda):
    args = _dec_case(cuda, 32, 48, 3, 4, seed=0)
    with pytest.raises(ValueError, match="multiple of 64"):
        DFS.dec_frame_scan(*args)
    args = _dec_case(cuda, 64, 48, 3, 4, seed=0)
    args[0] = args[0].double()
    with pytest.raises(ValueError, match="float32"):
        DFS.dec_frame_scan(*args)


def _enc_case(dev, D, kc, K, seed, lanes=5):
    """Random conformer-block weights (2 layers, F 4D, 4 heads, BatchNorm
    folded to a non-trivial (a, b)) and one call's inputs over `lanes`
    lanes: lane 0 never flushed, lane 1 flushed for its first frames, lane 2
    in the middle, lane 3 from a frame to the end, lane 4 and any further
    lanes in random patterns; incoming counts 0, 3, 40, 1000 and 1, then 7
    per lane."""
    rng = np.random.default_rng(seed)
    nl, H, Fh = 2, 4, 4 * D

    def r(*shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape) * scale, dtype=torch.float32,
                               device=dev)

    def ff():
        return (r(nl, D, Fh, scale=D ** -0.5), r(nl, Fh, scale=0.1),
                r(nl, Fh, D, scale=Fh ** -0.5), r(nl, D, scale=0.1))

    w = EFS.EncWeights(
        1.0 + r(nl, 5, D, scale=0.1), r(nl, 5, D, scale=0.1), *ff(),
        r(nl, D, 4 * D, scale=D ** -0.5), r(nl, 4 * D, scale=0.1),
        r(nl, D, D, scale=D ** -0.5), r(nl, D, scale=0.1),
        r(nl, D, 2 * D, scale=D ** -0.5), r(nl, 2 * D, scale=0.1),
        r(nl, kc, D, scale=kc ** -0.5), 1.0 + r(nl, D, scale=0.2), r(nl, D, scale=0.1),
        r(nl, D, D, scale=D ** -0.5), r(nl, D, scale=0.1), *ff())
    fl = np.zeros((lanes, K), np.float32)
    fl[1, :min(3, K)] = 1.0
    fl[2, K // 3:2 * K // 3 + 1] = 1.0
    fl[3, K // 2:] = 1.0
    fl[4:] = rng.integers(0, 2, (lanes - 4, K))
    s0 = np.array([0.0, 3.0, 40.0, 1000.0, 1.0] + [7.0] * (lanes - 5), np.float32)
    s = torch.as_tensor(np.broadcast_to(s0[None, :, None], (nl, lanes, H)).copy(), device=dev)
    return [r(lanes, K, D), torch.as_tensor(fl, device=dev), w,
            r(nl, lanes, H, D // H, D // H, scale=0.2), s,
            r(nl, lanes, kc - 1, D, scale=0.5)]


@pytest.mark.parametrize("D,kc", [(64, 4), (192, 4), (256, 16)])
@pytest.mark.parametrize("K", [1, 7, 128, 200])
def test_enc_frame_scan_kernel_matches_plain_over_two_calls(cuda, D, kc, K):
    """The layer-major kernel against the frame-by-frame plain version: h and
    the state (kv, s, ring) after each of two consecutive calls (the second
    reads the state the first left, with other flush patterns); K 200 walks
    two slices.  D 192 takes the conv's channels 64 a block (three groups,
    not a power of two)."""
    args = _enc_case(cuda, D, kc, K, seed=D + K)
    ak = [t.clone() if torch.is_tensor(t) else t for t in args]
    ap = [t.clone() if torch.is_tensor(t) else t for t in args]
    for call in range(2):
        if call:
            ak[0] = ap[0] = args[0].flip(1).contiguous()
            ak[1] = ap[1] = args[1].flip(0).contiguous()
        n0 = EFS.launches
        got = EFS.enc_frame_scan(*ak, ffac=0.5)
        torch.cuda.synchronize()
        assert EFS.launches == n0 + 1
        want = EFS.enc_frame_scan_plain(*ap, ffac=0.5)
        torch.testing.assert_close(got, want, atol=TC_ATOL, rtol=0)
        torch.testing.assert_close(ak[3], ap[3], atol=TC_ATOL, rtol=0)
        torch.testing.assert_close(ak[4], ap[4], atol=0, rtol=0)
        torch.testing.assert_close(ak[5], ap[5], atol=TC_ATOL, rtol=0)


def test_enc_frame_scan_refuses_what_it_does_not_take(cuda):
    args = _enc_case(cuda, 32, 4, 4, seed=0)       # D 32, head dim 8
    with pytest.raises(ValueError, match="multiple of 64"):
        EFS.enc_frame_scan(*args, ffac=0.5)
    args = _enc_case(cuda, 64, 4, 4, seed=0)
    args[0] = args[0].double()
    with pytest.raises(ValueError, match="float32"):
        EFS.enc_frame_scan(*args, ffac=0.5)


def _bf16(args, mask: int):
    """A case's float tensors and weight tuple in bf16; the 0/1 mask (at
    `mask`) stays float32."""
    def cast(t):
        if isinstance(t, tuple):
            return type(t)(*(u.to(torch.bfloat16) for u in t))
        return t.to(torch.bfloat16)

    return [t if i == mask else cast(t) for i, t in enumerate(args)]


def _bf16_close(got, want16, want32, what, close):
    """The bf16 guards of chip_smoke.py's `bf16_guard`: the drift rule from
    float32 (max abs), not a float32 path (mean |got - want32| at least half
    the bf16 plain version's), and closer to bf16 plain than the share
    `close` of its distance from float32 (mean abs): 0.5 for one-frame
    calls and the retention layer; 1.0 for 128-frame blocks, over which
    these random layers compound every rounding flip of another summation
    order until even the bf16 plain version run on the CPU sits well over
    half as far from itself on the card as from float32, while a form
    whose rounding differs from the plain version's has errors of its own
    and reads about 1 or more."""
    g, w16, w32 = (t.float() for t in (got, want16, want32))
    mean = lambda a, b: float((a - b).abs().mean())          # noqa: E731
    assert float((g - w32).abs().max()) <= 3 * float((w16 - w32).abs().max()) + 1e-3, what
    assert mean(g, w32) >= 0.5 * mean(w16, w32), what
    assert mean(g, w16) <= close * mean(w16, w32), (what, mean(g, w16), mean(w16, w32))


@pytest.mark.parametrize("D,F", [(64, 48), (256, 2048)])
@pytest.mark.parametrize("K", [1, 7, 125, 128])
def test_dec_frame_scan_bf16_kernel_matches_plain(cuda, D, F, K):
    """B1's bf16 form against its bf16 plain version over two calls: logits,
    the stored state bf16 (the counts the same).  K 1 and 7 (40 and 280
    rows) run the sequence a step() runs; K 125 and 128 (5,000 and 5,120
    rows, over kFusedRows) the layer with the fused epilogues: a partial
    retention chunk, a row tile cut short, F 48 in one partial column
    tile, head dims 16 and 64."""
    a32 = _dec_case(cuda, D, F, 10, K, seed=D + K)
    a16 = _bf16(a32, 2)
    a32 = [t.float() if torch.is_tensor(t) else DFS.DecWeights(*(u.float() for u in t))
           for t in a16]
    ak, ap = ([t.clone() if torch.is_tensor(t) else t for t in a16] for _ in range(2))
    for call in range(2):
        if call:
            ak[0] = ap[0] = a16[0].flip(1).contiguous()
            a32[0] = a16[0].flip(1).float().contiguous()
        got = DFS.dec_frame_scan(*ak)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and ak[5].dtype == torch.bfloat16
        want16 = DFS.dec_frame_scan_plain(*ap)
        want32 = DFS.dec_frame_scan_plain(*a32)
        close = 0.5 if K == 1 else 1.0
        _bf16_close(got, want16, want32, "logits", close)
        _bf16_close(ak[5], ap[5], a32[5], "kv", close)
        torch.testing.assert_close(ak[6], ap[6], atol=0, rtol=0)


def _enc_bf16_case(dev, D, kc, K, seed, lanes=5):
    """_enc_case in bf16 (the flush float32), and the same values in float32."""
    a16 = _bf16(_enc_case(dev, D, kc, K, seed, lanes), 1)
    a32 = [t.float() if torch.is_tensor(t) else EFS.EncWeights(*(u.float() for u in t))
           for t in a16]
    return a16, a32


@pytest.mark.parametrize("D,kc,K,lanes", [(64, 4, 1, 5), (64, 4, 128, 5), (192, 4, 1, 5),
                                          (192, 4, 128, 5), (256, 16, 1, 5), (256, 16, 128, 5),
                                          (256, 16, 125, 17), (256, 16, 125, 40),
                                          (256, 16, 125, 70)])
def test_enc_frame_scan_bf16_kernel_matches_plain(cuda, D, kc, K, lanes):
    """B2's bf16 form (K = 1: its bf16 CUDA graph) against its bf16 plain
    version over two calls: h and the stored state (kv, ring; the counts
    the same).  At D 256 every call runs the layer on scan16.cuh's kernels;
    on an H100's 132 SMs the half FFs take 16, 16, 4, 2 and 1 runs of their
    hidden slices at K 1 (the graph replayed on the second call), 5 x 128
    (640 rows), 17 x 125, 40 x 125 and 70 x 125 (8,750 rows: the whole
    hidden layer a block), the last three with a partial 128-row tile and a
    partial retention chunk, every flush pattern.  D 64 and D 192 (the
    conv's channels 64 a block) run the earlier sequence."""
    a16, a32 = _enc_bf16_case(cuda, D, kc, K, seed=D + K, lanes=lanes)
    ak, ap = ([t.clone() if torch.is_tensor(t) else t for t in a16] for _ in range(2))
    for call in range(2):
        if call:
            ak[0] = ap[0] = a16[0].flip(1).contiguous()
            a32[0] = a16[0].flip(1).float().contiguous()
        got = EFS.enc_frame_scan(*ak, ffac=0.5)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16
        want16 = EFS.enc_frame_scan_plain(*ap, ffac=0.5)
        want32 = EFS.enc_frame_scan_plain(*a32, ffac=0.5)
        close = 0.5 if K == 1 else 1.0
        _bf16_close(got, want16, want32, "h", close)
        _bf16_close(ak[3], ap[3], a32[3], "kv", close)
        _bf16_close(ak[5], ap[5], a32[5], "ring", close)
        torch.testing.assert_close(ak[4], ap[4], atol=0, rtol=0)


def test_enc_frame_scan_bf16_step_gives_the_same_bits_twice(cuda):
    """A step()'s bf16 call at the production width (128 lanes, D 256, kc
    16): its CUDA graph replayed twice from the same state and inputs gives
    the same h, kv, s and ring bit for bit (the FFN's runs are added in a
    fixed order)."""
    a16, _ = _enc_bf16_case(cuda, 256, 16, 1, seed=3, lanes=128)
    h0, fl, w, kv0, s0, ring0 = a16
    kv, s, ring = kv0.clone(), s0.clone(), ring0.clone()
    outs = []
    for _ in range(3):                           # the first call captures the graph
        kv.copy_(kv0), s.copy_(s0), ring.copy_(ring0)
        h = EFS.enc_frame_scan(h0, fl, w, kv, s, ring, ffac=0.5)
        torch.cuda.synchronize()
        outs.append([t.clone() for t in (h, kv, s, ring)])
    for a, b in zip(outs[1], outs[2]):
        assert torch.equal(a, b)
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)


def test_enc_frame_scan_bf16_step_alternating_weights_matches_plain(cuda):
    """Two weight sets of one shape in turns at K 1, each with the
    workspace (and graph) of its own that holds its transposed weights,
    then a third set, which may take a freed set's memory and must not read
    the old copies."""
    cases = [_enc_bf16_case(cuda, 256, 16, 1, seed=20 + i) for i in range(2)]
    for rnd in range(2):
        for a16, a32 in cases:
            ak, ap = ([t.clone() if torch.is_tensor(t) else t for t in a16] for _ in range(2))
            got = EFS.enc_frame_scan(*ak, ffac=0.5)
            torch.cuda.synchronize()
            want16 = EFS.enc_frame_scan_plain(*ap, ffac=0.5)
            want32 = EFS.enc_frame_scan_plain(*[t.clone() if torch.is_tensor(t) else t
                                                for t in a32], ffac=0.5)
            _bf16_close(got, want16, want32, f"h, round {rnd}", 0.5)
            _bf16_close(ak[3], ap[3], a32[3], f"kv, round {rnd}", 0.5)
    del cases
    a16, a32 = _enc_bf16_case(cuda, 256, 16, 1, seed=30)       # may take a freed set's memory
    ak, ap = ([t.clone() if torch.is_tensor(t) else t for t in a16] for _ in range(2))
    got = EFS.enc_frame_scan(*ak, ffac=0.5)
    want16 = EFS.enc_frame_scan_plain(*ap, ffac=0.5)
    want32 = EFS.enc_frame_scan_plain(*a32, ffac=0.5)
    _bf16_close(got, want16, want32, "h, a new set", 0.5)


def test_enc_frame_scan_bf16_steps_match_plain_past_256(cuda):
    """300 step() calls (K 1, D 256, one graph replayed) against the bf16
    plain version frame by frame: the counts stop at 256, bf16's last exact
    integer, on both (lane 3 starts at 1,000, which bf16 keeps); h over all
    steps and the state at the end by the bf16 guards at the 128-frame
    blocks' share, over which the recurrence compounds rounding flips."""
    n = 300
    a16, a32 = _enc_bf16_case(cuda, 256, 16, 1, seed=11)
    rng = np.random.default_rng(11)
    xs = torch.as_tensor(rng.standard_normal((n, 5, 1, 256)), dtype=torch.float32, device=cuda)
    fl = torch.as_tensor(rng.random((n, 5, 1)) < 0.1, dtype=torch.float32, device=cuda)
    fl[:, :4] = 0.0                                # lane 4 flushes a tenth of its steps
    ak, ap, a3 = ([t.clone() if torch.is_tensor(t) else t for t in a] for a in (a16, a16, a32))
    hs = ([], [], [])
    for k in range(n):
        x16 = xs[k].to(torch.bfloat16)
        hs[0].append(EFS.enc_frame_scan(x16, fl[k], ak[2], *ak[3:], ffac=0.5))
        hs[1].append(EFS.enc_frame_scan_plain(x16, fl[k], ap[2], *ap[3:], ffac=0.5))
        hs[2].append(EFS.enc_frame_scan_plain(x16.float(), fl[k], a3[2], *a3[3:], ffac=0.5))
    torch.cuda.synchronize()
    got, want16, want32 = (torch.cat(h, dim=1) for h in hs)
    _bf16_close(got, want16, want32, "h", 1.0)
    _bf16_close(ak[3], ap[3], a3[3], "kv", 1.0)
    _bf16_close(ak[5], ap[5], a3[5], "ring", 1.0)
    torch.testing.assert_close(ak[4], ap[4], atol=0, rtol=0)
    assert bool((ak[4][:, :3] == 256.0).all()) and bool((ak[4][:, 3] == 1000.0).all())


_SILU_SWEEP = r"""
#include "frame_ret.cuh"
#include "tc_f32.cuh"
#include "scan16.cuh"

// every float h: mismatches of d16::silu_rn against fs::silu's bits where
// h >= -86.5, and values other than -0 below it
__global__ void silu_sweep(unsigned long long* bad) {
  const unsigned long long n = 1ull << 32, step = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const float h = __uint_as_float((unsigned)i);
    if (h != h) continue;
    const float want = h < -86.5f ? -0.f : fs::silu(h);
    if (__float_as_uint(d16::silu_rn(h)) != __float_as_uint(want)) atomicAdd(bad, 1ull);
  }
}

extern "C" int silu_rn_mismatches(unsigned long long* out) {
  unsigned long long* bad = nullptr;
  cudaError_t e = cudaMalloc(&bad, sizeof *bad);
  if (e == cudaSuccess) e = cudaMemset(bad, 0, sizeof *bad);
  if (e == cudaSuccess) {
    silu_sweep<<<132 * 16, 256>>>(bad);
    e = cudaMemcpy(out, bad, sizeof *bad, cudaMemcpyDeviceToHost);
  }
  cudaFree(bad);
  return e;
}
"""


def test_ffn16_silu_has_the_plain_silu_bits(cuda, tmp_path):
    """The encoder's half FF takes silu through `d16::silu_rn` (the IEEE
    reciprocal's fast path without its branch): the same bits as
    `fs::silu`, the plain form's, at every float h >= -86.5 (below it
    |silu| < 2^-118 and silu_rn gives -0), built as the kernels are."""
    import ctypes
    import subprocess

    from fseend_tpu_torch.kernels import _build

    src, lib = tmp_path / "silu_sweep.cu", tmp_path / "libsilu_sweep.so"
    src.write_text(_SILU_SWEEP)
    subprocess.run([_build._nvcc()] + _build.NVCC_FLAGS
                   + ["-I", str(_build.CSRC), "-DDTF_D=256", "-DCR_DK=64", "-DCR_DV=64",
                      "-DFS_BF16=1", "-o", str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).silu_rn_mismatches
    fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_ulonglong)], ctypes.c_int
    bad = ctypes.c_ulonglong(1)
    assert fn(ctypes.byref(bad)) == 0
    assert bad.value == 0


def test_retention_layer_bf16_kernel_matches_plain(cuda):
    """B4's bf16 form against its bf16 plain version: two calls in a row
    (the second from the carried bf16 state), two chunks per call, at the
    LS decoder's head dims."""
    rng = np.random.default_rng(23)
    B, L, D, H = 6, 64, 256, 4
    cfg = TR.RetentionConfig(D, H, 1, L)
    ret = TR.Retention(cfg).to(cuda)
    with torch.no_grad():
        for prm in ret.parameters():
            prm.copy_(_randn(rng, *prm.shape, scale=0.1, dev=cuda))
    w32 = RL.pack_retention(ret)
    w16 = RL.RetLayerWeights(*(t.detach().to(torch.bfloat16) for t in w32))
    w32 = RL.RetLayerWeights(*(t.float() for t in w16))
    gam = TR.decay_gammas(cfg, cuda)
    st = TR.chunk_state_init(cfg, B, torch.bfloat16, cuda)
    kv0, s0 = st["kv"], st["scale"]
    for _ in range(2):
        x = _randn(rng, B, 2 * L, D, scale=2.0, dev=cuda).to(torch.bfloat16)
        with torch.no_grad():
            got = RL.retention_layer(gam, x, w16, kv0, s0, L)
        torch.cuda.synchronize()
        want16 = RL.retention_layer_plain(gam, x, w16, kv0, s0, L)
        want32 = RL.retention_layer_plain(gam, x.float(), w32, kv0.float(), s0.float(), L)
        assert all(t.dtype == torch.bfloat16 for t in got)
        for g, a, b, what in zip(got, want16, want32, ("y", "kv", "scale")):
            _bf16_close(g, a, b, what, 0.5)
        kv0, s0 = want16[1], want16[2]


@pytest.mark.parametrize("D,vf,L,N", [
    (256, 1, 128, 1),    # the main-path form: T = L = 128, csrc/ret16.cuh's layer
    (256, 1, 128, 2),    # T = 2L: the chunks' summaries and the scan
    (256, 1, 75, 2),     # a partial second k/v tile in each chunk
    (256, 1, 150, 2),    # three k/v tiles a chunk, the last partial
    (256, 1, 500, 1),    # four 128-query blocks, the last one partial, writing the state
    (192, 1, 128, 1),    # D 192: the mma.sync form (its out projection is no 128 multiple)
    (256, 2, 128, 1)])   # dv 128: the mma.sync form
@pytest.mark.parametrize("use_decay", [False, True])
def test_retention_layer_bf16_forms_match_plain(cuda, D, vf, L, N, use_decay):
    """B4's bf16 form on either path (`RL._ret16` says which) against its
    bf16 and float32 plain versions from a carried bf16 state, gamma = 1
    and gamma < 1; two calls give the same bits and leave the incoming
    state untouched."""
    rng = np.random.default_rng(D + L + N + 7 * vf + use_decay)
    B, H = 3, 4 if D == 256 else 3
    cfg = TR.RetentionConfig(D, H, vf, L, use_decay=use_decay)
    ret = TR.Retention(cfg).to(cuda)
    with torch.no_grad():
        for prm in ret.parameters():
            prm.copy_(_randn(rng, *prm.shape, scale=0.1, dev=cuda))
    w16 = RL.RetLayerWeights(*(t.detach().to(torch.bfloat16) for t in RL.pack_retention(ret)))
    w32 = RL.RetLayerWeights(*(t.float() for t in w16))
    gam = TR.decay_gammas(cfg, cuda)
    dk, dv = cfg.key_dim, cfg.head_dim
    assert RL._ret16(torch.bfloat16, D, dk, dv) == (D == 256 and vf == 1)
    kv0 = _randn(rng, B, H, dk, dv, scale=0.5, dev=cuda).to(torch.bfloat16)
    s0 = (1.0 + 3 * torch.rand(B, H, 1, 1, device=cuda)).to(torch.bfloat16)
    given = (kv0.clone(), s0.clone())
    x = _randn(rng, B, N * L, D, scale=2.0, dev=cuda).to(torch.bfloat16)
    n0 = RL.launches_bf16
    with torch.no_grad():
        got = RL.retention_layer(gam, x, w16, kv0, s0, L)
        again = RL.retention_layer(gam, x, w16, kv0, s0, L)
    torch.cuda.synchronize()
    assert RL.launches_bf16 == n0 + 2
    assert torch.equal(kv0, given[0]) and torch.equal(s0, given[1])
    want16 = RL.retention_layer_plain(gam, x, w16, kv0, s0, L)
    want32 = RL.retention_layer_plain(gam, x.float(), w32, kv0.float(), s0.float(), L)
    for g, a, b, c, what in zip(got, again, want16, want32, ("y", "kv", "scale")):
        assert g.dtype == torch.bfloat16 and torch.equal(g, a), what
        _bf16_close(g, b, c, what, 0.5)


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


@pytest.mark.parametrize("gamma", [1.0, 0.97])
def test_chunk_retention_kernel_over_odd_chunks_matches_plain(cuda, gamma):
    """Four chunks of 75 frames (64 + 11: the second tile of each chunk
    zero-padded) at the production head dims from a carried state: the
    state scanned over the chunks' summaries.  out within TC_ATOL, the new
    state within TC_ATOL of its scale; a second call gives the same bits."""
    rng = np.random.default_rng(25)
    BH, L, dk = 6, 75, 64
    T = 4 * L
    kv0 = _randn(rng, BH, dk, dk, scale=2.0, dev=cuda)
    args = [torch.full((BH,), gamma, device=cuda), _randn(rng, BH, T, dk, dev=cuda),
            _randn(rng, BH, T, dk, scale=dk ** -0.5, dev=cuda), _randn(rng, BH, T, dk, dev=cuda),
            kv0, kv0.abs().sum(1, keepdim=True).amax(2, keepdim=True).clamp(min=1)]
    got = CR.chunk_retention(*args, L)
    again = CR.chunk_retention(*args, L)
    torch.cuda.synchronize()
    want = CR.chunk_retention_plain(*args, L)
    torch.testing.assert_close(got[0], want[0], atol=TC_ATOL, rtol=0)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, atol=TC_ATOL * max(1.0, w.abs().max().item()), rtol=0)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.parametrize("gamma", [1.0, 0.95])
@pytest.mark.parametrize("L", [24, 150])
def test_chunk_retention_bf16_kernel_matches_plain(cuda, gamma, L):
    """B5's bf16 form against its bf16 plain version, two chunks a call,
    from a carried bf16 state (the blockwise "core" route)."""
    rng = np.random.default_rng(int(L + 100 * gamma))
    BH, dk = 10, 64
    sd = torch.bfloat16
    gam = torch.full((BH,), gamma, device=cuda)
    q, k, v = (_randn(rng, BH, 2 * L, dk, scale=s, dev=cuda).to(torch.bfloat16)
               for s in (1.0, 0.125, 1.0))
    kv0 = _randn(rng, BH, dk, dk, scale=0.5, dev=cuda).to(sd)
    s0 = (1.0 + torch.rand(BH, 1, 1, device=cuda)).to(sd)
    n0 = CR.launches_bf16
    got = CR.chunk_retention(gam, q, k, v, kv0, s0, L)
    torch.cuda.synchronize()
    assert CR.launches_bf16 == n0 + 1
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == got[2].dtype == sd
    want16 = CR.chunk_retention_plain(gam, q, k, v, kv0, s0, L)
    want32 = CR.chunk_retention_plain(gam, q.float(), k.float(), v.float(), kv0.float(),
                                      s0.float(), L)
    for g, a, b, what in zip(got, want16, want32, ("out", "kv", "scale")):
        _bf16_close(g, a, b, what, 0.5)
    assert torch.equal(CR.chunk_retention(gam, q, k, v, kv0, s0, L)[0], got[0])


@pytest.mark.parametrize("L,N", [(128, 1), (128, 2), (75, 1), (75, 2), (500, 2)])
@pytest.mark.parametrize("gamma", [1.0, 0.97])
def test_chunk_retention_bf16_ret16_matches_plain(cuda, gamma, L, N):
    """B5's bf16 form at head dims 64 (csrc/ret16.cuh) against its bf16 and
    float32 plain versions from a carried bf16 state: T = L (one launch
    writes the output and the state: L 128, the blockwise calls' form, and
    L 75, one query block cut short), T = 2L (the summaries and the scan),
    L 500 (four query blocks, the last one partial, reading KV_1 as three
    terms); two calls give the same bits, the incoming state untouched."""
    rng = np.random.default_rng(int(L + 10 * N + 100 * gamma))
    BH, dk = 12, 64
    bf = torch.bfloat16
    gam = torch.full((BH,), gamma, device=cuda)
    q, k, v = (_randn(rng, BH, N * L, dk, scale=s, dev=cuda).to(bf) for s in (1.0, 0.125, 1.0))
    kv0 = _randn(rng, BH, dk, dk, scale=0.5, dev=cuda).to(bf)
    s0 = (1.0 + 3 * torch.rand(BH, 1, 1, device=cuda)).to(bf)
    given = (kv0.clone(), s0.clone())
    n0 = CR.launches_bf16
    got = CR.chunk_retention(gam, q, k, v, kv0, s0, L)
    again = CR.chunk_retention(gam, q, k, v, kv0, s0, L)
    torch.cuda.synchronize()
    assert CR.launches_bf16 == n0 + 2
    assert torch.equal(kv0, given[0]) and torch.equal(s0, given[1])
    want16 = CR.chunk_retention_plain(gam, q, k, v, kv0, s0, L)
    want32 = CR.chunk_retention_plain(gam, q.float(), k.float(), v.float(), kv0.float(),
                                      s0.float(), L)
    for g, a, b, c, what in zip(got, again, want16, want32, ("out", "kv", "scale")):
        assert g.dtype == bf and torch.equal(g, a), what
        _bf16_close(g, b, c, what, 0.5)


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


def _fusion_case(dev, rate, L=40, T=80, C=3, D=128, F=96):
    """Production-like proportions at a small width: D 128, 4 heads (head
    dim 32), F 96, 3 slots; L = 40 leaves a partial 64-frame tile.  D 192
    (head dim 48) is a width no 128-wide tile divides; D 256 with F a
    multiple of 128 is the production width, where the bf16 forms run
    csrc/dtf_tc16.cuh (with F 96 they keep forward_seq16's sequence)."""
    rng = np.random.default_rng(31)
    B = 2
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


@pytest.mark.parametrize("D", [128, 192])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fusion_forward_kernel_matches_plain(cuda, rate, D):
    x, w, seed, H, L, rate = _fusion_case(cuda, rate, D=D)
    n0 = DTF.fwd_launches
    got = DTF.fusion_layer_fwd(x, w, seed, H, L, rate)
    torch.cuda.synchronize()
    assert DTF.fwd_launches == n0 + 1
    want = DTF.fusion_layer_fwd_plain(x, w, seed, H, L, rate)
    assert float(want[2].max()) > 1.0
    # products on the tensor cores: y at TC_ATOL; the checkpoints, sums over
    # a chunk's frames, at TC_ATOL times their scale, never looser than 1e-3
    torch.testing.assert_close(got[0], want[0], atol=TC_ATOL, rtol=0)
    for g, wv in zip(got[1:], want[1:]):
        tol = min(1e-3, TC_ATOL * max(1.0, float(wv.abs().max())))
        torch.testing.assert_close(g, wv, atol=tol, rtol=0)
    y, kvs, ss = DTF.fusion_layer_fwd(x, w, seed, H, L, rate, checkpoints=False)
    assert kvs is None and ss is None
    torch.testing.assert_close(y, got[0], atol=0, rtol=0)


@pytest.mark.parametrize("D", [128, 192])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fusion_backward_kernel_matches_plain(cuda, rate, D):
    x, w, seed, H, L, rate = _fusion_case(cuda, rate, D=D)
    _, kvs, ss = DTF.fusion_layer_fwd_plain(x, w, seed, H, L, rate)
    dy = _randn(np.random.default_rng(32), *x.shape, dev=cuda)
    n0 = DTF.bwd_launches
    dx, dw = DTF.fusion_layer_bwd(x, dy, kvs, ss, w, seed, H, L, rate)
    torch.cuda.synchronize()
    assert DTF.bwd_launches == n0 + 1
    dx_p, dw_p = DTF.fusion_layer_bwd_plain(x, dy, kvs, ss, w, seed, H, L, rate)
    torch.testing.assert_close(dx, dx_p, atol=TC_ATOL, rtol=0)
    for name, g, gp in zip(DTF.FusionWeights._fields, dw, dw_p):
        tol = 2e-3 * float(gp.abs().max())
        assert float((g - gp).abs().max()) <= tol, name
    # the weight gradients are row slices added in a fixed order: a second
    # call gives the same bits
    dx2, dw2 = DTF.fusion_layer_bwd(x, dy, kvs, ss, w, seed, H, L, rate)
    torch.cuda.synchronize()
    assert torch.equal(dx2, dx)
    for name, g, g2 in zip(DTF.FusionWeights._fields, dw, dw2):
        assert torch.equal(g2, g), name


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


# the bf16 forms (-DFS_BF16) against their bf16 plain version, as H7 holds
# them (chip_smoke.py:B3_BF16_CLOSE): a layer chains about 30 bf16 rounding
# points each way, over which another float32 summation order's rounding
# flips compound; a float32 body reads about 1 backward, 0.75 on y
B3_BF16_CLOSE = {"fwd": 0.6, "bwd": 0.8}


@pytest.mark.parametrize("C,L,T,D,F", [(3, 40, 80, 128, 96), (10, 64, 192, 128, 96),
                                         (3, 40, 80, 192, 96), (3, 40, 80, 256, 96),
                                         (3, 40, 80, 256, 256), (10, 128, 256, 256, 256),
                                         (3, 200, 400, 256, 256)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fusion_bf16_kernels_match_their_bf16_plain_version(cuda, C, L, T, D, F, rate):
    """Head dims 32, 48 and 64; at D 256 with F 256 the production path
    (dtf_tc16.cuh: L 40 leaves a partial 64-row tile, L 128 and C 10 are
    the main path's, L 200 is four tiles, the last partial), with F 96 the
    forward_seq16 sequence; every column of every output is compared, so a
    tile that skips columns fails."""
    x, w, seed, H, L, rate = _fusion_case(cuda, rate, L=L, T=T, C=C, D=D, F=F)
    bf = torch.bfloat16
    x16, w16 = x.to(bf), DTF.FusionWeights(*(t.to(bf) for t in w))
    w32 = DTF.FusionWeights(*(t.float() for t in w16))
    dy16 = _randn(np.random.default_rng(34), *x.shape, dev=cuda).to(bf)
    n0, b0 = DTF.fwd_launches_bf16, DTF.bwd_launches_bf16
    got = DTF.fusion_layer_fwd(x16, w16, seed, H, L, rate)
    torch.cuda.synchronize()
    assert DTF.fwd_launches_bf16 == n0 + 1
    assert got[0].dtype == bf and got[1].dtype == got[2].dtype == torch.float32
    want16 = DTF.fusion_layer_fwd_plain(x16, w16, seed, H, L, rate)
    want32 = DTF.fusion_layer_fwd_plain(x16.float(), w32, seed, H, L, rate)
    for what, g, a, b in zip(("y", "kvs", "ss"), got, want16, want32):
        _bf16_close(g, a, b, what, B3_BF16_CLOSE["fwd"])
    _, kvs, ss = want16
    dx, dw = DTF.fusion_layer_bwd(x16, dy16, kvs, ss, w16, seed, H, L, rate)
    torch.cuda.synchronize()
    assert DTF.bwd_launches_bf16 == b0 + 1
    assert dx.dtype == bf and all(g.dtype == bf for g in dw)
    dx16, dw16 = DTF.fusion_layer_bwd_plain(x16, dy16, kvs, ss, w16, seed, H, L, rate)
    dx32, dw32 = DTF.fusion_layer_bwd_plain(x16.float(), dy16.float(), want32[1], want32[2],
                                            w32, seed, H, L, rate)
    for what, g, a, b in zip(("dx",) + DTF.FusionWeights._fields, (dx, *dw), (dx16, *dw16),
                             (dx32, *dw32)):
        _bf16_close(g, a, b, what, B3_BF16_CLOSE["bwd"])
    dx2, dw2 = DTF.fusion_layer_bwd(x16, dy16, kvs, ss, w16, seed, H, L, rate)
    torch.cuda.synchronize()
    assert torch.equal(dx2, dx) and all(torch.equal(a, b) for a, b in zip(dw2, dw))


def test_bf16_train_step_runs_the_fusion_kernels_bf16_forms(cuda):
    cfg = dataclasses.replace(CFG, n_units=128, in_size=16, use_fused_dec=True,
                              fused_dec_chunk=16, chunk_size=24, dropout=0.1, kernel="plain")
    model = ls_eend.init_ls_eend(cfg, torch.Generator().manual_seed(6), device=cuda)
    rng = np.random.default_rng(35)
    Bt, Tt, S = 2, 40, C - 2
    batch = {"feats": _randn(rng, Bt, Tt, cfg.in_size, dev=cuda),
             "labels": torch.as_tensor(rng.uniform(size=(Bt, Tt, S)) > 0.6,
                                       dtype=torch.float32, device=cuda),
             "lens": torch.tensor([40, 31], device=cuda),
             "n_spk": torch.tensor([1, 1], device=cuda)}
    task = TRN.TaskConfig(label_mode="fixed", masked_emb_loss=True, compute_dtype="bf16")
    tx = optim.build_optimizer("adam", 1e-3, grad_clip=5.0)
    state = TRN.TrainState.create(model, tx)
    step = TRN.make_train_step(task, cfg, tx)
    counts = (DTF.fwd_launches, DTF.bwd_launches, DTF.fwd_launches_bf16,
              DTF.bwd_launches_bf16)
    state, metrics = step(state, batch, 0)
    torch.cuda.synchronize()
    n = cfg.dec_n_layers
    assert (DTF.fwd_launches, DTF.bwd_launches, DTF.fwd_launches_bf16,
            DTF.bwd_launches_bf16) == (counts[0], counts[1], counts[2] + n, counts[3] + n)
    assert np.isfinite(float(metrics["tot_loss"])) and state.step == 1
    assert all(p.dtype == torch.float32 for p in model.parameters())


# ---------------------------------------------------------------------------
# the cached-attention kernels and FS-EEND serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hd", [6, 8, 12, 16, 64])
@pytest.mark.parametrize("K,cap,start", [(1, 200, 0), (1, 200, 199), (70, 200, 60),
                                         (125, 256, 131), (128, 200, 150),
                                         (128, 2048, 1920), (128, 2048, 0), (200, 256, 10)])
def test_cached_attention_kernel_matches_plain(cuda, hd, K, cap, start):
    """Shared head: K not a multiple of the query tile and more than one
    tile, a cache not a multiple of the 64-position tile, dead tiles, start
    + K past the capacity (the clamped write's queries read the whole
    cache), and the blockwise encoder's full 2048-position cache; head dims
    padded to the mma's 8 (6, 12) and rows that are not 16-byte multiples
    (6)."""
    rng = np.random.default_rng(hd + K + start)
    q, k, v = (_randn(rng, 6, n, hd, dev=cuda) for n in (K, cap, cap))
    n0 = CA.launches
    got = CA.cached_attention(q, k, v, start)
    torch.cuda.synchronize()
    assert CA.launches == n0 + 1
    torch.testing.assert_close(got, CA.cached_attention_plain(q, k, v, start),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("hd", [8, 64])
@pytest.mark.parametrize("K,min_pos,lanes,cap", [
    (1, 0, 7, 260), (1, 9, 7, 260), (125, 0, 7, 260), (125, 9, 7, 260), (64, 3, 7, 260),
    (128, 0, 7, 260), (129, 9, 7, 260), (1, 9, 64, 2048), (1, 0, 64, 2048)])
def test_cached_attention_perlane_kernel_matches_plain(cuda, hd, K, min_pos, lanes, cap):
    """Per-lane heads with lanes before warm-up (start < min_pos), mid-way,
    near the capacity and past it; 4 rows a lane.  K > 1 on the tensor cores
    (one query tile, two at K 129); K = 1 split over the cache (256 rows and
    a 2048-position cache: the FS encoder's step()), whose fixed-order
    combine gives the same bits on a second call."""
    rng = np.random.default_rng(hd + K + min_pos)
    starts = [0, 2, 8, 9, 70, cap - 5, cap + 40]
    starts += list(rng.integers(0, cap, lanes - len(starts)))
    starts = torch.tensor(starts, dtype=torch.int32, device=cuda)
    R = 4 * lanes
    q, k, v = (_randn(rng, R, n, hd, dev=cuda) for n in (K, cap, cap))
    n0 = CA.perlane_launches
    got = CA.cached_attention_perlane(q, k, v, starts, 4, min_pos)
    torch.cuda.synchronize()
    assert CA.perlane_launches == n0 + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, CA.cached_attention_perlane_plain(q, k, v, starts, 4,
                                                                      min_pos),
                               atol=TC_ATOL, rtol=0)
    if K == 1:
        assert torch.equal(CA.cached_attention_perlane(q, k, v, starts, 4, min_pos), got)


def test_cached_attention_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(2, 4, 160, device=cuda)
    k = torch.zeros(2, 16, 160, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        CA.cached_attention(q, k, k, 0)
    with pytest.raises(ValueError, match="float32"):
        CA.cached_attention_perlane(q.double(), k.double(), k.double(),
                                    torch.zeros(2, dtype=torch.int32, device=cuda), 1)
    with pytest.raises(ValueError, match="multiple of 16"):
        CA.cached_attention(*(t[..., :8].to(torch.bfloat16) for t in (q, k, k)), 0)
    with pytest.raises(ValueError, match="mixed dtypes"):
        CA.cached_attention(q[..., :64].to(torch.bfloat16), k[..., :64], k[..., :64], 0)


# the bf16 cached attention against its plain version over the kernel's own
# tiles and splits (`CA.kernel_tiling`): the two differ only in float32
# summation order (chip_smoke.py's CA_BF16_CLOSE says why this share); the
# plain versions' normalized-weight form (`mha=True`) must fail it
CA_CLOSE = 0.01


@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("K,cap,start", [(1, 300, 299), (7, 260, 64), (8, 200, 150),
                                         (125, 256, 131), (128, 2048, 1920), (200, 256, 10)])
def test_cached_attention_bf16_kernel_matches_plain(cuda, hd, K, cap, start):
    """B7's bf16 form against its bf16 plain version (the Pallas kernel's
    arithmetic over the kernel's tiles; the normalized-weight form fails
    the same guard): one and seven queries, a cache not a multiple of the
    tile (the ring's last tile short), more tiles than the ring's stages,
    more than one query tile, start + K past the capacity, the blockwise
    encoder's 2048-position cache."""
    rng = np.random.default_rng(hd + K + start)
    q, k, v = (_randn(rng, 6, n, hd, dev=cuda).to(torch.bfloat16) for n in (K, cap, cap))
    n0 = CA.launches_bf16
    got = CA.cached_attention(q, k, v, start)
    torch.cuda.synchronize()
    assert CA.launches_bf16 == n0 + 1 and got.dtype == torch.bfloat16
    want16 = CA.cached_attention_plain(q, k, v, start, **CA.kernel_tiling(
        6, K, cap, torch.bfloat16, perlane=False))
    want32 = CA.cached_attention_plain(q.float(), k.float(), v.float(), start)
    _bf16_close(got, want16, want32, "out", CA_CLOSE)
    with pytest.raises(AssertionError):
        _bf16_close(CA.cached_attention_plain(q, k, v, start, mha=True), want16, want32,
                    "normalized weights", CA_CLOSE)


@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("K,min_pos,lanes,cap", [
    (1, 0, 7, 260), (1, 9, 7, 260), (1, 300, 7, 2048), (7, 9, 7, 260), (125, 9, 7, 260),
    (128, 0, 7, 2048), (129, 0, 7, 260), (1, 9, 64, 2048)])
def test_cached_attention_perlane_bf16_kernel_matches_plain(cuda, hd, K, min_pos, lanes, cap):
    """B6's bf16 form against its bf16 plain version over the kernel's
    tiles and splits (the normalized-weight form fails the same guard):
    lanes before warm-up, mid-way, near the capacity and past it; K > 1 on
    the bf16 tensor cores (7, 125, 128 and 129 queries, a cache not a
    multiple of the tile, more tiles than the ring's stages); K = 1 at 28
    rows (the cache split over blocks: splits with no readable position,
    and at min_pos 300 splits whose positions are all masked) and at 256
    rows, two calls the same bits."""
    rng = np.random.default_rng(hd + K + min_pos + 1)
    starts = [0, 2, 8, 9, 70, cap - 5, cap + 40]
    starts += list(rng.integers(0, cap, lanes - len(starts)))
    starts = torch.tensor(starts, dtype=torch.int32, device=cuda)
    R = 4 * lanes
    q, k, v = (_randn(rng, R, n, hd, dev=cuda).to(torch.bfloat16) for n in (K, cap, cap))
    n0 = CA.perlane_launches_bf16
    got = CA.cached_attention_perlane(q, k, v, starts, 4, min_pos)
    torch.cuda.synchronize()
    assert CA.perlane_launches_bf16 == n0 + 1 and got.dtype == torch.bfloat16
    want16 = CA.cached_attention_perlane_plain(q, k, v, starts, 4, min_pos,
                                              **CA.kernel_tiling(R, K, cap, torch.bfloat16))
    want32 = CA.cached_attention_perlane_plain(q.float(), k.float(), v.float(), starts, 4,
                                              min_pos)
    _bf16_close(got, want16, want32, "out", CA_CLOSE)
    with pytest.raises(AssertionError):
        _bf16_close(CA.cached_attention_perlane_plain(q, k, v, starts, 4, min_pos, mha=True),
                    want16, want32, "normalized weights", CA_CLOSE)
    if K == 1:
        assert torch.equal(CA.cached_attention_perlane(q, k, v, starts, 4, min_pos), got)


@pytest.mark.parametrize("rows_per_lane", [4, 24])
def test_cached_attention_perlane_bf16_step_gives_the_same_bits_twice(cuda, rows_per_lane):
    """B6's bf16 K = 1 call at the FS per-frame server's step() shapes (64
    lanes, capacity 2048, hd 64: the encoder's 256 rows split the cache,
    the decoder's 1,536 do not), lanes at different starts: two calls give
    the same bits (the splits combined in a fixed order), and the result
    passes the guard."""
    rng = np.random.default_rng(rows_per_lane)
    lanes, cap, hd = 64, 2048, 64
    R = lanes * rows_per_lane
    starts = torch.as_tensor(rng.integers(0, cap, lanes), dtype=torch.int32, device=cuda)
    starts[0] = 1519
    q, k, v = (_randn(rng, R, n, hd, dev=cuda).to(torch.bfloat16) for n in (1, cap, cap))
    got = CA.cached_attention_perlane(q, k, v, starts, rows_per_lane, 9)
    again = CA.cached_attention_perlane(q, k, v, starts, rows_per_lane, 9)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want16 = CA.cached_attention_perlane_plain(q, k, v, starts, rows_per_lane, 9,
                                              **CA.kernel_tiling(R, 1, cap, torch.bfloat16))
    want32 = CA.cached_attention_perlane_plain(q.float(), k.float(), v.float(), starts,
                                              rows_per_lane, 9)
    _bf16_close(got, want16, want32, "out", CA_CLOSE)


FS_CFG = fs_eend.FSEENDConfig(in_size=23, n_units=32, n_heads=4, enc_n_layers=2,
                              dec_n_layers=2, enc_dim_feedforward=64,
                              dec_dim_feedforward=64, conv_delay=3, max_nspks=4)


def test_fs_servers_kernel_route_match_plain_route(cuda):
    """The per-frame FS server (fast block, sub-blocks of 5) and the
    blockwise FS server on the kernel route against the plain route;
    every layer launches its kernel."""
    model = fs_eend.init_fs_eend(FS_CFG, torch.Generator().manual_seed(7), device=cuda)
    plain_cfg = dataclasses.replace(FS_CFG, use_flash_attn=False)
    rng = np.random.default_rng(12)
    streams = {f"s{i}": rng.standard_normal((t, FS_CFG.in_size)).astype(np.float32)
               for i, t in enumerate([7, 23, 2, 16])}

    def serve(cfg):
        srv = StreamingServer(kind="fs", cfg=cfg, model=model, n_lanes=2, n_slots=4,
                              capacity=48, device=cuda)
        cb = ContinuousBatcher(srv, block=10)
        for sid, feats in streams.items():
            cb.submit(sid, feats)
        return cb.run()

    n0 = CA.perlane_launches
    got = serve(FS_CFG)
    assert CA.perlane_launches - n0 > 0
    n1 = CA.perlane_launches
    ref = serve(plain_cfg)
    assert CA.perlane_launches == n1
    for sid in streams:
        np.testing.assert_allclose(got[sid], ref[sid], atol=ATOL)

    xs = rng.standard_normal((3, 24, FS_CFG.in_size)).astype(np.float32)
    outs = {}
    for label, cfg in (("kernel", FS_CFG), ("plain", plain_cfg)):
        srv = BlockStreamingServer(kind="fs", cfg=cfg, model=model, n_lanes=3, n_slots=4,
                                   block=8, capacity=24, device=cuda)
        n0 = CA.launches
        ys = [srv.process_block(xs[:, i:i + 8]) for i in range(0, 24, 8)]
        ys.append(srv.process_block(np.zeros_like(xs[:, :8]), flush=True))
        assert CA.launches - n0 == (3 * FS_CFG.enc_n_layers if label == "kernel" else 0)
        outs[label] = torch.cat(ys[1:], dim=1)
    torch.testing.assert_close(outs["kernel"], outs["plain"], atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# FS-EEND training, the device front end, the FLAC helper's build
# ---------------------------------------------------------------------------


def test_fs_train_step_gradients_on_cuda_match_cpu(cuda):
    """One FS training pass (train-mode BatchNorm over padded frames,
    dropout 0): the loss, the new BatchNorm statistics and every gradient
    on the card against the same pass on the CPU."""
    cfg = dataclasses.replace(FS_CFG, dropout=0.0)
    rng = np.random.default_rng(21)
    Bt, Tt, S = 3, 40, 2
    batch = {"feats": rng.standard_normal((Bt, Tt, cfg.in_size)).astype(np.float32),
             "labels": (rng.uniform(size=(Bt, Tt, S)) > 0.6).astype(np.float32),
             "lens": np.array([40, 29, 13]), "n_spk": np.array([2, 2, 1])}
    task = TRN.TaskConfig(model="fs")
    out = {}
    for dev in ("cpu", cuda):
        model = fs_eend.init_fs_eend(cfg, torch.Generator().manual_seed(8), device=dev)
        loss, (bn, metrics) = TRN.compute_loss(
            task, model, {k: torch.as_tensor(v, device=dev) for k, v in batch.items()},
            train=True)
        loss.backward()
        out[str(dev)] = (float(loss.detach()), bn["bn"]["var"].cpu(),
                         {n: p.grad.cpu() for n, p in model.named_parameters()
                          if p.grad is not None})
    (l_c, v_c, g_c), (l_g, v_g, g_g) = out["cpu"], out[str(cuda)]
    assert abs(l_c - l_g) <= 1e-5 * abs(l_c)
    torch.testing.assert_close(v_g, v_c, atol=1e-5, rtol=0)
    assert g_c.keys() == g_g.keys()
    for name, g in g_c.items():
        torch.testing.assert_close(g_g[name], g, atol=1e-5, rtol=1e-3, msg=name)


EDA_CFG = eend_eda.EDAConfig(in_size=23, n_units=32, n_heads=4, n_layers=2,
                             dim_feedforward=64, dropout=0.0)


def test_eda_train_step_gradients_on_cuda_match_cpu(cuda):
    """One EEND-EDA training pass (PIT + the attractor-existence loss,
    dropout 0, a ragged batch): the loss and every gradient on the card
    against the same pass on the CPU."""
    rng = np.random.default_rng(22)
    Bt, Tt, S = 3, 50, 3
    batch = {"feats": rng.standard_normal((Bt, Tt, EDA_CFG.in_size)).astype(np.float32),
             "labels": (rng.uniform(size=(Bt, Tt, S)) > 0.6).astype(np.float32),
             "lens": np.array([50, 37, 21]), "n_spk": np.array([3, 2, 1])}
    task = TRN.TaskConfig(model="eda", label_mode="pit")
    out = {}
    for dev in ("cpu", cuda):
        model = eend_eda.init_eend_eda(EDA_CFG, torch.Generator().manual_seed(9), device=dev)
        loss, (_, metrics) = TRN.compute_loss(
            task, model, {k: torch.as_tensor(v, device=dev) for k, v in batch.items()},
            train=True)
        loss.backward()
        out[str(dev)] = (float(loss.detach()), float(metrics["emb_loss"]),
                         {n: p.grad.cpu() for n, p in model.named_parameters()})
    (l_c, a_c, g_c), (l_g, a_g, g_g) = out["cpu"], out[str(cuda)]
    assert abs(l_c - l_g) <= 1e-5 * abs(l_c) and abs(a_c - a_g) <= 1e-5 * abs(a_c)
    assert g_c.keys() == g_g.keys()
    for name, g in g_c.items():
        torch.testing.assert_close(g_g[name], g, atol=1e-5, rtol=1e-3, msg=name)


def test_flex_stb_fifo_on_cuda_matches_cpu(cuda):
    """FLEX-STB with the FIFO buffer (deterministic) over 230 frames in
    40-frame blocks with a 100-frame buffer: the probabilities with the
    model on the card within 1e-3 of the model on the CPU."""
    from fseend_tpu_torch.serving.flex_stb import FlexSTB

    rng = np.random.default_rng(23)
    feats = rng.standard_normal((230, EDA_CFG.in_size)).astype(np.float32)
    got = {}
    for dev in ("cpu", cuda):
        model = eend_eda.init_eend_eda(EDA_CFG, torch.Generator().manual_seed(10), device=dev)
        got[str(dev)] = FlexSTB(model, EDA_CFG, 3, buf_size=100, block_size=40,
                                buffer_weights="fifo").run(feats)
    np.testing.assert_allclose(got[str(cuda)], got["cpu"], atol=1e-3, rtol=0)


def test_logmel_frontend_on_cuda_matches_the_host_pipeline(cuda):
    """The device front end on the card, every transform and the streaming
    form with a ragged end, against the host pipeline (2e-4, the JAX
    package's bound)."""
    from fseend_tpu_torch.ops import features as F
    from fseend_tpu_torch.ops import features_tpu as FT

    rng = np.random.default_rng(4)
    n = 8 * 800 + 37
    audio = (0.2 * rng.standard_normal((2, n))).astype(np.float32)
    audio[:, :1000] = 0.0                                   # silence: log10 of the floor
    for tf in ("logmel23", "logmel23_mn", "logmel23_mvn", "logmel23_cummn"):
        got = FT.logmel_frontend(audio, input_transform=tf, device=cuda).cpu().numpy()
        for b in range(2):
            host = F.subsample(F.splice(F.transform(F.stft(audio[b], 200, 80), tf), 7),
                               subsampling=10)
            np.testing.assert_allclose(got[b], host, atol=2e-4, err_msg=tf)
    sl = FT.StreamingLogmel(2, 800, input_transform="logmel23_cummn", device=cuda)
    outs = [sl.process_block(audio[:, i * 800:(i + 1) * 800]) for i in range(8)]
    outs.append(sl.flush(audio[:, 8 * 800:]))
    got = torch.cat(outs, dim=1).cpu().numpy()
    for b in range(2):
        host = F.subsample(F.splice(F.transform(F.stft(audio[b], 200, 80), "logmel23_cummn"),
                                    7), subsampling=10)
        np.testing.assert_allclose(got[b], host, atol=2e-4)


def _rice_bits(values, param: int) -> bytes:
    """A one-partition Rice-coded residual section (partition order 0, a
    4-bit parameter) of `values`, as FLAC writes it."""
    bits = [0, 0, 0, 0] + [int(c) for c in format(param, "04b")]
    for v in values:
        z = (v << 1) ^ (v >> 63)                         # zigzag
        bits += [0] * (z >> param) + [1]
        bits += [int(c) for c in format(z & ((1 << param) - 1), f"0{param}b")]
    bits += [0] * (-len(bits) % 8)
    return bytes(int("".join(map(str, bits[i:i + 8])), 2) for i in range(0, len(bits), 8))


def test_native_flac_helper_builds_into_build():
    """The FLAC decoder's C hot path compiles with the system compiler into
    the repository's build/ (no card needed) and decodes a Rice residual
    as the pure-Python path does."""
    from fseend_tpu_torch.data import _native as NAT
    from fseend_tpu_torch.data import flac as FL
    from fseend_tpu_torch.kernels._build import BUILD_DIR

    assert NAT.load() is not None, "no working C compiler"
    assert NAT.lib_path().parent == BUILD_DIR and NAT.lib_path().exists()
    values = [int(v) for v in np.random.default_rng(2).integers(-40, 40, 64)]
    data = _rice_bits(values, 3)
    bits = FL._Bits(data)
    got = NAT.rice_residual(bits, 64, 0, 4)
    assert got.tolist() == values
    nat = FL._nat
    FL._nat = None
    try:
        assert FL._rice_residual(FL._Bits(data), 64, 0, 4).tolist() == values
    finally:
        FL._nat = nat


def test_custom_ops_on_cuda_match_their_cpu_implementation(cuda):
    """`torch.ops.fseend_tpu_torch.retention_layer` (B4) and
    `.cached_attention` (B7) on the card: the same bits as the direct
    launch (the op's CUDA implementation is that launch, counted once),
    within ATOL of the op's CPU implementation (the plain version), and
    through `opcheck` (schema, fake implementation)."""
    rng = np.random.default_rng(31)
    B, T, D, H, L = 3, 32, 64, 4, 16
    args = [torch.ones(H, device=cuda), _randn(rng, B, T, D, dev=cuda),
            _randn(rng, D, 4 * D, scale=0.1, dev=cuda), _randn(rng, 4 * D, dev=cuda),
            _randn(rng, D, D, scale=0.1, dev=cuda), _randn(rng, D, dev=cuda),
            _randn(rng, B, H, D // H, D // H, dev=cuda),
            _randn(rng, B, H, 1, 1, dev=cuda).abs() + 1, L]
    n0 = RL.launches
    got = RL.retention_layer_op(*args)
    direct = RL._launch(args[0], args[1], RL.RetLayerWeights(*args[2:6]), args[6], args[7], L)
    torch.cuda.synchronize()
    assert RL.launches == n0 + 2
    cpu = RL.retention_layer_op(*[a.cpu() if torch.is_tensor(a) else a for a in args])
    for g, d, c in zip(got, direct, cpu):
        assert torch.equal(g, d)
        torch.testing.assert_close(g.cpu(), c, atol=ATOL, rtol=1e-5)
    torch.library.opcheck(RL.retention_layer_op, args)

    q, k, v = (_randn(rng, 8, n, 64, dev=cuda) for n in (128, 512, 512))
    start = torch.tensor([300], dtype=torch.int32, device=cuda)
    n0 = CA.launches
    got = CA.cached_attention_op(q, k, v, start)
    direct = CA._launch(q, k, v, start, q.shape[0], 0, perlane=False)
    torch.cuda.synchronize()
    assert CA.launches == n0 + 2 and torch.equal(got, direct)
    torch.testing.assert_close(got.cpu(), CA.cached_attention_op(q.cpu(), k.cpu(), v.cpu(),
                                                                 start.cpu()), atol=ATOL, rtol=0)
    torch.library.opcheck(CA.cached_attention_op, (q, k, v, start))


def test_aot_artifact_on_cuda_launches_both_ops(cuda, tmp_path):
    """An LS ("fused" route) and an FS (kernel route) blockwise server
    exported on the card and reloaded: the live servers' bits, B4 and B7
    launched by the artifact."""
    from fseend_tpu_torch.serving.aot import AotBlockServer, save_server

    rng = np.random.default_rng(32)
    fcfg = fs_eend.FSEENDConfig(in_size=20, n_units=64, n_heads=4, enc_n_layers=2,
                                dec_n_layers=1, enc_dim_feedforward=64,
                                dec_dim_feedforward=64, conv_delay=2, max_nspks=3)
    for kind, cfg, model, counter in (
            ("ls", dataclasses.replace(CFG, chunk_size=8), _model(cuda), "RL"),
            ("fs", fcfg, fs_eend.init_fs_eend(fcfg, torch.Generator().manual_seed(6),
                                              device=cuda), "CA")):
        live = BlockStreamingServer(kind=kind, cfg=cfg, model=model, n_lanes=B, n_slots=C,
                                    block=8, capacity=64, device=cuda)
        save_server(live, str(tmp_path / f"{kind}.npz"))
        aot = AotBlockServer(str(tmp_path / f"{kind}.npz"))
        mod = RL if counter == "RL" else CA
        n0 = mod.launches
        for i in range(3):
            x = _randn(rng, B, 8, cfg.in_size, dev=cuda)
            assert torch.equal(aot.process_block(x), live.process_block(x))
        z = torch.zeros(B, 8, cfg.in_size, device=cuda)
        assert torch.equal(aot.process_block(z, flush=True), live.process_block(z, flush=True))
        assert mod.launches > n0
