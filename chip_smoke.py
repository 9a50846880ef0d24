#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`fseend_tpu_torch`) on one NVIDIA
GPU: builds the CUDA kernels from the sources in the checkout, holds each
kernel against its plain PyTorch version at the production LS-EEND width,
drives the port's three LS-EEND inference paths (per-frame streaming server,
blockwise streaming server, batch pass) and its training path (the train
step and the epoch loop), and times the kernels, the servers and the step.

    python3 chip_smoke.py            (--profile adds a torch.profiler window
                                      over the blockwise server's process_block)

Phases (any failure raises; the script exits non-zero and prints no result):
  1. device: the card's name and power limit (nvidia-smi); no card -> exit 1
  2. build: the six kernels with nvcc into build/, all started together
  3. frame-scan kernels vs plain: B=128 lanes, K=64 frames, C=10 slots, the
     full LSEENDConfig(); random weights from a seed with non-trivial
     BatchNorm statistics; non-zero incoming state; staggered per-lane
     clocks and lanes that flush part-way; every output and state leaf
  4. serve: 6 streams through ContinuousBatcher(block=64) over a
     128-lane StreamingServer on the kernel path, against the plain
     per-frame server; then two lanes are reset and one stream is served
     again, bit for bit; both kernels must have launched on the main path
  5. chunkwise kernels vs plain at production width, from a carried state:
     chunk_retention at (BH 512, T 1000, L 500) and (BH 5120, T = L = 128),
     gamma = 1 and gamma < 1; retention_layer at the encoder shape (128,
     128, 256) and the decoder shape (1280, 128, 256), two calls in a row
  6. blockwise serve: BlockStreamingServer(block=128) over 128 lanes on the
     "fused" route, streams of four lengths with per-lane h_mask tails and
     one flush, against the "plain" route and against the batch pass at
     chunk_size = 128; two lanes reset and served again, bit for bit;
     retention_layer launches counted, its largest call held against plain
  7. batch: ls_test on 2 recordings of 2900 frames, chunk_size 500, on the
     "core" route against the "plain" route; chunk_retention launches
     counted, its largest call held against plain
  8. T1, fusion-layer kernels vs plain: the training forward and backward
     of one decoder layer at production width (D 256, H 4, F 2048, C 10),
     B 2, T 256, L 128, dropout 0 and 0.1: forward y, kvs, ss within 1e-3;
     backward dx within 1e-3 and every weight gradient within 2e-3 of its
     leaf max; at rate 0 the plain backward against torch autograd of the
     plain forward
  9. T2, the reference's production-shape gradients
     (tests/goldens/ls_train_prod.npz: B 4, T 1000-1500, chunk 500, dropout
     0) through the port's converter, compute_loss and backward, with the
     fused decoder (internal chunk = chunk_size) and the plain one: losses
     rtol 1e-4, each gradient leaf within max(2e-3 leaf max, 5e-6)
 10. T3, training: LSEENDConfig() with dropout 0.1, the fused decoder at
     chunk 128, Noam-Adam (lr 1, warm-up 100000, clip 5), run_training for
     one epoch of 4 steps at batch 8 x 1000 frames x 8 speakers (a synthetic
     in-memory dataset from the seed) and one validation batch; the
     fusion-layer launches counted (2 forward + 2 backward per step, 2
     forward for validation); the last checkpoint reloaded bit for bit;
     then ms per step, frames/s and peak memory on the fused and the plain
     decoder route, the fused step's parts, and a torch.profiler window
     over two fused steps (device idle share, top kernels)
 11. times: CUDA events after warm-up: process_block of both servers at
     B=128, K=128 (and step(), K=1), every kernel alone beside its plain
     version and its bound

The last line is {"ok": true, "device": {...}}; the kernels' JSON line and
the timing lines come before it.  Float32 throughout, TF32 off.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
LANES, SLOTS = 128, 10
CHECK_K, TIME_K = 64, 128
BLOCK = 128                                  # blockwise server's block, = its chunk
BLOCK_LENS = (300, 77, 512, 130)             # lane i serves a stream of BLOCK_LENS[i % 4]
BATCH_T, BATCH_LENS, BATCH_CHUNK = 2900, (2900, 2611), 500
HEAD = {"CR_DK": 64, "CR_DV": 64}            # LSEENDConfig(): 256 units / 4 heads
DTF = dict(HEAD, DTF_D=256)                  # the fusion-layer kernels at that width
DEC_SEED, DEC_B, DEC_T, DEC_L = 1234, 2, 256, 128   # T1
TRAIN_B, TRAIN_T, TRAIN_SPK, TRAIN_STEPS = 8, 1000, 8, 4   # T3; ls_simu.yaml trains at batch 32
TRAIN_L = 128                                # fused_dec_chunk of every LS train config
# kernel vs plain over the fusion layer's forward and backward: float32, weight
# gradients summed over 5120+ rows with atomics in another order
GRAD_RTOL = 2e-3
# the reference's production-shape gradients (tests/test_train_parity.py:151-163)
GOLDEN_RTOL, GOLDEN_ATOL = 2e-3, 5e-6
STREAM_LENS = (137, 5, 50, 512, 777, 1000)  # lane 0 gets the 137-frame stream
# kernel vs plain: float32 with another summation order, over 64 frames of
# 4 encoder / 2 decoder layers; a wrong gate or term shows at O(0.1)
KERNEL_ATOL = 1e-3
# kernel server vs plain server, probabilities after the sigmoid
SERVE_ATOL = 1e-3
# published H100 SXM peaks (float32 outside the tensor cores; HBM3)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def log(*a):
    print(*a, flush=True)


def phase_device():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"tf32: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return card


def phase_build():
    from fseend_tpu_torch.kernels import _build

    secs = _build.build([("enc_frame_scan", {}), ("dec_frame_scan", {"FS_NSLOTS": SLOTS}),
                         ("chunk_retention", HEAD), ("retention_layer", HEAD),
                         ("dec_train_fusion_fwd", DTF), ("dec_train_fusion_bwd", DTF)],
                        verbose=True)
    log(f"build: {secs:.1f} s")


def make_model(cfg, rng):
    from fseend_tpu_torch.models import ls_eend

    model = ls_eend.init_ls_eend(cfg, torch.Generator().manual_seed(SEED), device="cuda")
    with torch.no_grad():
        for blk in model.enc.blocks:
            bn = blk.conv.bn
            D = bn.running_mean.numel()
            bn.running_mean.copy_(torch.as_tensor(rng.normal(0, 0.2, D), dtype=torch.float32))
            bn.running_var.copy_(torch.as_tensor(rng.uniform(0.5, 2.0, D), dtype=torch.float32))
            bn.weight.copy_(torch.as_tensor(rng.uniform(0.5, 1.5, D), dtype=torch.float32))
            bn.bias.copy_(torch.as_tensor(rng.normal(0, 0.1, D), dtype=torch.float32))
    return model


def frame_scans():
    from fseend_tpu_torch.kernels import dec_frame_scan as DFS
    from fseend_tpu_torch.kernels import enc_frame_scan as EFS

    return ((EFS, "enc_frame_scan"), (DFS, "dec_frame_scan"))


def capture_kernel_inputs(fn, targets=None):
    """Run fn() with the kernel wrappers `targets` ((module, name) pairs,
    default the two frame scans) wrapped so that each call's arguments are
    cloned before the kernel runs (the frame scans update their state in
    place).  Keeps the last call of each wrapper."""
    got = {}

    def wrap(mod, name):
        orig = getattr(mod, name)

        def wrapped(*args, **kw):
            got[name] = ([a.clone() if torch.is_tensor(a) else a for a in args], kw)
            return orig(*args, **kw)
        return orig, wrapped

    saved = []
    try:
        for mod, name in targets or frame_scans():
            orig, wrapped = wrap(mod, name)
            saved.append((mod, name, orig))
            setattr(mod, name, wrapped)
        fn()
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)
    return got


def randn(rng, *shape, scale=1.0):
    return torch.as_tensor(rng.standard_normal(shape) * scale, dtype=torch.float32,
                           device="cuda")


def clone_args(args):
    return [a.clone() if torch.is_tensor(a) else a for a in args]


def compare(name, kernel_out, plain_out, labels):
    worst = 0.0
    for lab, a, b in zip(labels, kernel_out, plain_out):
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"{name}.{lab}: shape {tuple(a.shape)} vs "
                                 f"{tuple(b.shape)} or non-finite values")
        err = (a - b).abs().max().item()
        worst = max(worst, err)
        log(f"  {name}.{lab}: max abs diff {err:.3e} (tol {KERNEL_ATOL:g})")
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"{name}.{lab}: kernel differs from plain by {err}")
    return worst


def run_kernels(got, cuda_fns, plain_fns):
    """Kernel and plain version on clones of the same captured inputs ->
    {name: (kernel outputs, plain outputs)}; outputs = (result, *state)."""
    res = {}
    for name, (args, kw) in got.items():
        outs = []
        for fn in (cuda_fns[name], plain_fns[name]):
            a = clone_args(args)
            y = fn(*a, **kw)
            torch.cuda.synchronize()
            state = [t for t in a if torch.is_tensor(t)][-(3 if name.startswith("enc") else 2):]
            outs.append([y] + state)
        res[name] = outs
    return res


def phase_kernel_vs_plain(cfg, model, rng):
    from fseend_tpu_torch.kernels import dec_frame_scan as DFS
    from fseend_tpu_torch.kernels import enc_frame_scan as EFS
    from fseend_tpu_torch.models import ls_eend

    B, K = LANES, CHECK_K
    packed = ls_eend.pack_weights(model)
    state = ls_eend.ls_stream_init(cfg, B, SLOTS, device="cuda")
    xs = torch.as_tensor(rng.standard_normal((B, K, cfg.in_size)), dtype=torch.float32,
                         device="cuda")
    no_flush = torch.zeros(K, B, dtype=torch.bool, device="cuda")
    state, _ = ls_eend.ls_stream_block_fused(model, state, xs, no_flush, SLOTS, packed)
    # staggered clocks: valid flips mid-block on lanes whose t < conv_delay;
    # a third of the lanes flush from a frame inside the block on
    t = rng.integers(0, 2 * cfg.conv_delay, B)
    state["t"] = torch.as_tensor(t, dtype=torch.int32, device="cuda")
    fl = np.zeros((K, B), bool)
    for b in range(0, B, 3):
        fl[rng.integers(1, K):, b] = True
    xs2 = torch.as_tensor(rng.standard_normal((B, K, cfg.in_size)), dtype=torch.float32,
                          device="cuda")
    flush = torch.as_tensor(fl, device="cuda")
    log(f"incoming state: enc scale max {state['enc_scale'].max().item():.0f}, "
        f"dec kv max abs {state['dec_kv'].abs().max().item():.3f}; "
        f"{int((t < cfg.conv_delay).sum())} lanes start invalid, "
        f"{int(fl.any(0).sum())} lanes flush part-way")
    got = capture_kernel_inputs(
        lambda: ls_eend.ls_stream_block_fused(model, state, xs2, flush, SLOTS, packed))
    res = run_kernels(got,
                      {"enc_frame_scan": EFS.enc_frame_scan,
                       "dec_frame_scan": DFS.dec_frame_scan},
                      {"enc_frame_scan": EFS.enc_frame_scan_plain,
                       "dec_frame_scan": DFS.dec_frame_scan_plain})
    errs = {
        "enc_frame_scan": compare("enc_frame_scan", *res["enc_frame_scan"],
                                  ("h", "kv", "s", "ring")),
        "dec_frame_scan": compare("dec_frame_scan", *res["dec_frame_scan"],
                                  ("logits", "kv", "s")),
    }
    return errs


def serve(server, streams, block=64):
    from fseend_tpu_torch.serving.scheduler import ContinuousBatcher

    cb = ContinuousBatcher(server, block=block)
    for sid, feats in streams.items():
        cb.submit(sid, feats)
    return cb.run()


def phase_serve(cfg, model, rng):
    from fseend_tpu_torch.kernels import dec_frame_scan as DFS
    from fseend_tpu_torch.kernels import enc_frame_scan as EFS
    from fseend_tpu_torch.serving.runtime import StreamingServer

    streams = {f"s{i}_{n}": rng.standard_normal((n, cfg.in_size)).astype(np.float32)
               for i, n in enumerate(STREAM_LENS)}
    server = StreamingServer(kind="ls", cfg=cfg, model=model, n_lanes=LANES,
                             n_slots=SLOTS, device="cuda")
    plain = StreamingServer(kind="ls", cfg=cfg, model=model, n_lanes=LANES,
                            n_slots=SLOTS, device="cuda", frame_kernel=False)
    EFS.launches = 0
    DFS.launches = 0
    t0 = time.perf_counter()
    got = serve(server, streams)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {"enc_frame_scan": EFS.launches, "dec_frame_scan": DFS.launches}
    log(f"serve: {len(streams)} streams, {sum(STREAM_LENS)} frames in {secs:.2f} s; "
        f"launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    ref = serve(plain, streams)
    for sid, feats in streams.items():
        p, r = got[sid], ref[sid]
        if p.shape != (len(feats), SLOTS - 1) or not np.isfinite(p).all():
            raise AssertionError(f"{sid}: probs {p.shape} not finite / wrong shape")
        err = float(np.abs(p - r).max())
        log(f"  {sid}: probs {p.shape}, max abs diff vs plain server {err:.3e} "
            f"(tol {SERVE_ATOL:g})")
        if not err <= SERVE_ATOL:
            raise AssertionError(f"{sid}: kernel server differs from plain by {err}")
    # lane reuse: reset two lanes, serve the lane-0 stream again
    sid0 = next(iter(streams))
    server.reset_lanes([0, 1])
    again = serve(server, {sid0: streams[sid0]})[sid0]
    if not np.array_equal(again, got[sid0]):
        raise AssertionError(f"{sid0}: re-served stream differs after lane reset "
                             f"(max {np.abs(again - got[sid0]).max():.3e})")
    log(f"  lane reset: {sid0} re-served on lane 0 bit for bit")
    return launches


def chunk_kernels():
    from fseend_tpu_torch.kernels import chunk_retention as CR
    from fseend_tpu_torch.kernels import retention_layer as RL

    return {"chunk_retention": (CR, CR.chunk_retention, CR.chunk_retention_plain),
            "retention_layer": (RL, RL.retention_layer, RL.retention_layer_plain)}


def compare_chunk_kernel(name, args, label):
    """One chunkwise kernel and its plain version on the same arguments
    (neither writes to them) -> (max abs diff over out, kv and scale, the
    plain version's results)."""
    _, kern, plain = chunk_kernels()[name]
    got = kern(*args)
    torch.cuda.synchronize()
    want = plain(*args)
    return compare(f"{name}[{label}]", got, want, ("out", "kv", "scale")), want


def with_route(model, kernel, **changes):
    """The same weights under a config with another chunkwise route."""
    from fseend_tpu_torch.models import ls_eend

    return ls_eend.with_cfg(model, dataclasses.replace(model.cfg, kernel=kernel, **changes))


def phase_chunk_kernels_vs_plain(cfg, model, rng):
    """Both chunkwise kernels at production width, each case two calls in a
    row, the second from the state the first left."""
    from fseend_tpu_torch.kernels import retention_layer as RL
    from fseend_tpu_torch.ops import retention as R

    rc = cfg.ret_cfg
    dk, dv, H = rc.key_dim, rc.head_dim, rc.num_heads
    decay = R.decay_gammas(dataclasses.replace(rc, use_decay=True), "cuda")
    errs = {"chunk_retention": 0.0, "retention_layer": 0.0}
    for BH, T, L in ((512, 1000, 500), (5120, 128, 128)):
        for glabel, gam in (("gamma=1", torch.ones(BH, device="cuda")),
                            ("gamma<1", decay.repeat(BH // H))):
            kv, sc = torch.zeros(BH, dk, dv, device="cuda"), torch.ones(BH, 1, 1, device="cuda")
            for call in range(2):
                args = (gam, randn(rng, BH, T, dk), randn(rng, BH, T, dk, scale=dk ** -0.5),
                        randn(rng, BH, T, dv), kv, sc, L)
                err, (_, kv, sc) = compare_chunk_kernel(
                    "chunk_retention", args, f"BH={BH} T={T} L={L} {glabel} call {call}")
                errs["chunk_retention"] = max(errs["chunk_retention"], err)
            log(f"  carried scale max {sc.max().item():.2f}")
    for label, B, ret in (("encoder", LANES, model.enc.blocks[0].ret),
                          ("decoder", LANES * SLOTS, model.dec.layers[0].time_ret)):
        # four times the initial weights, so that the clamped renormalizers
        # and the carried scale are above 1 as after training
        w = RL.pack_retention(ret)
        w = w._replace(wqkvg=w.wqkvg * 4)
        for glabel, gam in (("gamma=1", torch.ones(H, device="cuda")), ("gamma<1", decay)):
            st = R.chunk_state_init(rc, B, device="cuda")
            kv, sc = st["kv"], st["scale"]
            for call in range(2):
                args = (gam, randn(rng, B, BLOCK, cfg.n_units), w, kv, sc, BLOCK)
                err, (_, kv, sc) = compare_chunk_kernel(
                    "retention_layer", args, f"{label} B={B} T=L={BLOCK} {glabel} call {call}")
                errs["retention_layer"] = max(errs["retention_layer"], err)
            log(f"  carried scale max {sc.max().item():.2f}")
    return errs


def check_probs(label, got, want, lens, atol):
    """Per-lane probabilities (lanes, T, slots-1) against a reference on each
    lane's own length."""
    worst = 0.0
    for b, n in enumerate(lens):
        g, w = got[b, :n], want[b, :n]
        if g.shape != (n, SLOTS - 1) or not torch.isfinite(g).all():
            raise AssertionError(f"{label}: lane {b} probs {tuple(g.shape)} not finite / "
                                 f"wrong shape")
        worst = max(worst, (g - w).abs().max().item())
    log(f"  {label}: {len(lens)} lanes, max abs diff {worst:.3e} (tol {atol:g})")
    if not worst <= atol:
        raise AssertionError(f"{label}: differs by {worst}")


def phase_block_serve(cfg, model, rng):
    """The blockwise server on the "fused" route over 128 lanes: lane i
    serves a stream of BLOCK_LENS[i % 4] frames; the lanes share the blocks
    and one flush, each with its own h_mask tail."""
    from fseend_tpu_torch.kernels import retention_layer as RL
    from fseend_tpu_torch.models import ls_eend
    from fseend_tpu_torch.serving.runtime import BlockStreamingServer

    lens = np.array([BLOCK_LENS[i % len(BLOCK_LENS)] for i in range(LANES)])
    n_blocks = -(-int(lens.max()) // BLOCK)
    xs = rng.standard_normal((LANES, n_blocks * BLOCK, cfg.in_size)).astype(np.float32)

    def run(server):
        outs = []
        for st in range(0, n_blocks * BLOCK, BLOCK):
            mask = np.arange(st, st + BLOCK)[None, :] < lens[:, None]
            outs.append(server.process_block(xs[:, st:st + BLOCK], h_mask=mask))
        outs.append(server.process_block(np.zeros_like(xs[:, :BLOCK]), flush=True))
        return torch.cat(outs[1:], dim=1)        # a lane's first emission is warm-up

    def make(kernel):
        return BlockStreamingServer(kind="ls", cfg=dataclasses.replace(cfg, kernel=kernel),
                                    model=model, n_lanes=LANES, n_slots=SLOTS, block=BLOCK,
                                    device="cuda")

    server = make("fused")
    res = {}
    RL.launches = 0
    t0 = time.perf_counter()
    captured = capture_kernel_inputs(lambda: res.update(probs=run(server)),
                                     [(RL, "retention_layer")])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = RL.launches
    n_layers = cfg.enc_n_layers + cfg.dec_n_layers
    log(f"block serve: {LANES} lanes x {n_blocks} blocks of {BLOCK} + 1 flush, "
        f"{int(lens.sum())} frames in {secs:.2f} s; retention_layer launches {launches} "
        f"({n_layers} per block, {cfg.dec_n_layers} on the flush)")
    if launches != n_blocks * n_layers + cfg.dec_n_layers:
        raise AssertionError(f"retention_layer launched {launches} times on the main path")
    got = res["probs"]
    check_probs("fused route vs plain route", got, run(make("plain")), lens, SERVE_ATOL)
    if RL.launches != launches:
        raise AssertionError("the plain route launched retention_layer")
    # blockwise == the batch chunkwise pass at chunk_size = block (first 8 lanes)
    batch = ls_eend.ls_forward(with_route(model, "plain", chunk_size=BLOCK),
                               torch.as_tensor(xs[:8], device="cuda"),
                               torch.as_tensor(lens[:8], device="cuda"), SLOTS)
    check_probs("fused route vs batch pass", got[:8], torch.sigmoid(batch["logits"][..., 1:]),
                lens[:8], SERVE_ATOL)
    # lane reuse: after the flush, reset two lanes and serve the same blocks again
    server.reset_lanes([0, 1])
    again = run(server)
    for b in (0, 1):
        if not torch.equal(again[b, :lens[b]], got[b, :lens[b]]):
            raise AssertionError(f"lane {b}: re-served stream differs after reset_lanes")
    if torch.equal(again[2, :lens[2]], got[2, :lens[2]]):
        raise AssertionError("lane 2 was not reset and yet repeats its first stream")
    log("  lane reset: lanes 0 and 1 re-served bit for bit")
    args, _ = captured["retention_layer"]
    err, _ = compare_chunk_kernel("retention_layer", args, "last call of the main path")
    return launches, err, args


def phase_batch(cfg, model, rng):
    """ls_test on two long recordings, the "core" route against "plain"."""
    from fseend_tpu_torch.kernels import chunk_retention as CR
    from fseend_tpu_torch.models import ls_eend

    xs = torch.as_tensor(rng.standard_normal((len(BATCH_LENS), BATCH_T, cfg.in_size)),
                         dtype=torch.float32, device="cuda")
    lens = torch.as_tensor(BATCH_LENS, device="cuda")
    res = {}
    CR.launches = 0
    t0 = time.perf_counter()
    captured = capture_kernel_inputs(
        lambda: res.update(ls_eend.ls_test(with_route(model, "core", chunk_size=BATCH_CHUNK),
                                           xs, lens)),
        [(CR, "chunk_retention")])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = CR.launches
    n_layers = cfg.enc_n_layers + cfg.dec_n_layers
    log(f"batch: ls_test on {len(BATCH_LENS)} recordings of {BATCH_LENS} frames, chunk "
        f"{BATCH_CHUNK}, in {secs:.2f} s; chunk_retention launches {launches}")
    if launches != n_layers:
        raise AssertionError(f"chunk_retention launched {launches} times on the main path")
    ref = ls_eend.ls_test(with_route(model, "plain", chunk_size=BATCH_CHUNK), xs, lens)
    for key in ("logits", "emb"):
        a, b = res[key], ref[key]
        if a.shape != b.shape or a.shape[:2] != (len(BATCH_LENS), BATCH_T) \
                or not torch.isfinite(a).all():
            raise AssertionError(f"batch {key}: shape {tuple(a.shape)} or non-finite values")
        err = (a - b).abs().max().item()
        log(f"  {key} {tuple(a.shape)}: core route vs plain route max abs diff {err:.3e} "
            f"(tol {SERVE_ATOL:g})")
        if not err <= SERVE_ATOL:
            raise AssertionError(f"batch {key}: core route differs from plain by {err}")
    args, _ = captured["chunk_retention"]
    err, _ = compare_chunk_kernel("chunk_retention", args, "last call of the main path")
    return launches, err, args


# ---------------------------------------------------------------------------
# training: T1 the fusion-layer kernels, T2 the reference's gradients, T3 the loop
# ---------------------------------------------------------------------------


def kink_free(w, seed):
    """`w` with the FFN's first bias at +-5 (a random sign per hidden unit),
    for comparing gradients: no hidden unit then lies within float32
    rounding of the ReLU's kink (|x2 W1^T| stays below 4 at these widths).
    Where one does, two summation orders can put it on either side, and
    that unit's whole gradient (dy-sized, O(1) against leaf maxima of
    O(10-100) here) appears in one result and not in the other: a property
    of ReLU, not of either implementation."""
    g = torch.Generator(device=w.bf1.device).manual_seed(seed)
    sign = torch.randint(0, 2, w.bf1.shape, generator=g, device=w.bf1.device) * 2 - 1
    return w._replace(bf1=sign.to(w.bf1.dtype) * 5.0)


def dec_layer_weights(model):
    """Decoder layer 0's packed weights with the q | k | v | g rows four
    times their initial size, so that the row sums and the carried scales
    are above 1 as after training, and `kink_free`."""
    from fseend_tpu_torch.kernels import dec_train_fusion as DT

    with torch.no_grad():
        w = DT.FusionWeights(*(t.detach().clone() for t in DT.pack_fusion(model.dec.layers[0])))
    return kink_free(w._replace(wqkvg=w.wqkvg * 4), SEED)


def compare_grads(label, got, want):
    """(dx, weight gradients) against a reference: dx within KERNEL_ATOL,
    each weight gradient within GRAD_RTOL of its leaf max.  Returns the
    largest absolute difference."""
    from fseend_tpu_torch.kernels import dec_train_fusion as DT

    (dx, dw), (dx_r, dw_r) = got, want
    worst = compare(label, [dx], [dx_r], ("dx",))
    for name, g, r in zip(DT.FusionWeights._fields, dw, dw_r):
        err, tol = (g - r).abs().max().item(), GRAD_RTOL * r.abs().max().item()
        worst = max(worst, err)
        if not (torch.isfinite(g).all() and err <= tol):
            raise AssertionError(f"{label}.{name}: differs by {err} > {tol}")
    log(f"  {label}: 14 weight gradients within {GRAD_RTOL:g} of their leaf max "
        f"(largest abs diff {worst:.3e})")
    return worst


def phase_dec_train_vs_plain(cfg, model, rng):
    """T1: the fusion layer's forward and backward kernels against their
    plain versions at production width, dropout off and on."""
    from fseend_tpu_torch.kernels import dec_train_fusion as DT

    w = dec_layer_weights(model)
    H = cfg.n_heads
    x = randn(rng, DEC_B, SLOTS, DEC_T, cfg.n_units)
    dy = randn(rng, DEC_B, SLOTS, DEC_T, cfg.n_units)
    errs = {"dec_train_fusion_fwd": 0.0, "dec_train_fusion_bwd": 0.0}
    for rate in (0.0, 0.1):
        args = (w, DEC_SEED, H, DEC_L, rate)
        got = DT.fusion_layer_fwd(x, *args)
        torch.cuda.synchronize()
        want = DT.fusion_layer_fwd_plain(x, *args)
        errs["dec_train_fusion_fwd"] = max(errs["dec_train_fusion_fwd"], compare(
            f"dec_train_fusion_fwd[rate={rate}]", got, want, ("y", "kvs", "ss")))
        log(f"  carried scale max {want[2].max().item():.2f}")
        kvs, ss = want[1], want[2]
        got = DT.fusion_layer_bwd(x, dy, kvs, ss, *args)
        torch.cuda.synchronize()
        plain = DT.fusion_layer_bwd_plain(x, dy, kvs, ss, *args)
        errs["dec_train_fusion_bwd"] = max(errs["dec_train_fusion_bwd"], compare_grads(
            f"dec_train_fusion_bwd[rate={rate}]", got, plain))
        if rate == 0.0:
            xa = x.clone().requires_grad_(True)
            wa = DT.FusionWeights(*(t.clone().requires_grad_(True) for t in w))
            ya, _, _ = DT.fusion_layer_fwd_plain(xa, wa, DEC_SEED, H, DEC_L, rate)
            (ya * dy).sum().backward()
            compare_grads("plain backward vs autograd of the plain forward", plain,
                          (xa.grad, DT.FusionWeights(*(t.grad for t in wa))))
            del xa, wa, ya
    return errs


def phase_train_golden(cfg):
    """T2: the reference's own production-shape losses and gradients, on
    the fused decoder (internal chunk = chunk_size, exact) and the plain
    one.  Returns the fused run's fusion-layer launches."""
    from fseend_tpu_torch.kernels import dec_train_fusion as DT
    from fseend_tpu_torch.train import trainer as TRN
    from fseend_tpu_torch.utils import torch_convert as TC

    g = np.load(Path(__file__).resolve().parent / "tests" / "goldens" / "ls_train_prod.npz")
    sd = {k[4:]: np.asarray(g[k], np.float32) for k in g.files if k.startswith("sd__")}
    gr = {k[4:]: np.asarray(g[k], np.float32) for k in g.files if k.startswith("gr__")}
    batch = {"feats": torch.as_tensor(np.asarray(g["feats"], np.float32), device="cuda"),
             **{k: torch.as_tensor(g[k], device="cuda") for k in ("labels", "lens", "n_spk")}}
    gcfg = dataclasses.replace(cfg, dropout=0.0, kernel="plain")
    full = {k: np.zeros_like(v) for k, v in sd.items()}
    full.update(gr)
    ref = dict(TC.ls_from_state_dict(full, gcfg, "cuda").named_parameters())
    task = TRN.TaskConfig(label_mode="fixed", masked_emb_loss=True)
    launches = None
    for label, fused in (("fused decoder", True), ("plain decoder", False)):
        model = TC.ls_from_state_dict(sd, dataclasses.replace(gcfg, use_fused_dec=fused), "cuda")
        DT.fwd_launches = DT.bwd_launches = 0
        t0 = time.perf_counter()
        loss, (_, metrics) = TRN.compute_loss(task, model, batch, None, train=True)
        loss.backward()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = (DT.fwd_launches, DT.bwd_launches)
        if fused:
            launches = n
            if min(n) <= 0:
                raise AssertionError(f"golden, fused decoder: fusion-layer launches {n}")
        elif max(n) > 0:
            raise AssertionError(f"golden, plain decoder launched the fusion layer {n}")
        for i, k in enumerate(("pit_loss", "emb_loss", "tot_loss")):
            got, want = float(metrics[k]), float(g["losses"][i])
            if not abs(got - want) <= 1e-4 * abs(want):
                raise AssertionError(f"golden {label}: {k} {got} vs the reference's {want}")
        worst = 0.0
        for name, p in model.named_parameters():
            r = ref[name].detach()
            err = (p.grad - r).abs().max().item()
            tol = max(GOLDEN_RTOL * r.abs().max().item(), GOLDEN_ATOL)
            worst = max(worst, err / tol)
            if not err <= tol:
                raise AssertionError(f"golden {label}: gradient of {name} differs by {err} > {tol}")
        log(f"golden ({label}): B {tuple(batch['feats'].shape)}, losses "
            f"{[round(float(metrics[k]), 6) for k in ('pit_loss', 'emb_loss', 'tot_loss')]} "
            f"(reference {[round(float(v), 6) for v in g['losses']]}), {len(ref)} gradient "
            f"leaves, worst at {worst:.3f} of its bound; fusion-layer launches {n}; {secs:.2f} s")
        del model, loss
    return launches


class SyntheticSpeech:
    """An in-memory dataset of `n` recordings of T frames: features from
    a normal distribution and S speakers' activity as a few turns each,
    made with numpy from `seed`."""

    def __init__(self, n, seed, T, F, S):
        rng = np.random.default_rng(seed)
        self.items = []
        for i in range(n):
            labels = np.zeros((T, S), np.float32)
            for s in range(S):
                for start in rng.integers(0, T, 3):
                    labels[start:start + rng.integers(20, 200), s] = 1.0
            self.items.append((rng.standard_normal((T, F)).astype(np.float32), labels,
                               f"synth{i}"))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def phase_train(cfg, card):
    """T3: run_training for one epoch, then the train step timed on both
    decoder routes.  Returns (fusion-layer launches, the arguments of one
    training forward and one backward call, the step rows)."""
    import tempfile

    from fseend_tpu_torch.data.loader import pad_collate
    from fseend_tpu_torch.kernels import dec_train_fusion as DT
    from fseend_tpu_torch.models import ls_eend
    from fseend_tpu_torch.train import loop as LOOP
    from fseend_tpu_torch.train import optim
    from fseend_tpu_torch.train import trainer as TRN
    from fseend_tpu_torch.utils import checkpoint as CK

    tcfg = dataclasses.replace(cfg, dropout=0.1, use_fused_dec=True, fused_dec_chunk=TRAIN_L,
                               kernel="plain")                   # configs/ls_simu.yaml
    task = TRN.TaskConfig(label_mode="fixed", masked_emb_loss=True)
    tx = optim.build_optimizer("noam", 1.0, d_model=cfg.n_units, warmup_steps=100_000,
                               grad_clip=5.0)
    train = SyntheticSpeech(TRAIN_B * TRAIN_STEPS, SEED, TRAIN_T, cfg.in_size, TRAIN_SPK)
    val = SyntheticSpeech(TRAIN_B, SEED + 1, TRAIN_T, cfg.in_size, TRAIN_SPK)
    calls = {}

    def first_training_call(name):
        orig = getattr(DT, name)

        def wrapped(*args, **kw):
            if name not in calls and args[-1] > 0.0:            # rate: a training call
                calls[name] = ([a.clone() if torch.is_tensor(a) else a for a in args], kw)
            return orig(*args, **kw)
        return orig, wrapped

    res = {}
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        logger = LOOP.MetricsLogger(tmp, "smoke")
        saved = [(name, *first_training_call(name))
                 for name in ("fusion_layer_fwd", "fusion_layer_bwd")]
        try:
            for name, _, wrapped in saved:
                setattr(DT, name, wrapped)
            DT.fwd_launches = DT.bwd_launches = 0
            t0 = time.perf_counter()
            state, ckpt_dir = LOOP.run_training(
                task=task, model_cfg=tcfg, train_dataset=train, val_dataset=val, tx=tx,
                logger=logger, batch_size=TRAIN_B, chunk_size=TRAIN_T, max_speakers=TRAIN_SPK,
                input_dim=cfg.in_size, max_epochs=1, seed=SEED, log_every=1)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = {"dec_train_fusion_fwd": DT.fwd_launches,
                        "dec_train_fusion_bwd": DT.bwd_launches}
        finally:
            for name, orig, _ in saved:
                setattr(DT, name, orig)
            logger.close()
        n_layers = cfg.dec_n_layers
        log(f"train: run_training, {TRAIN_STEPS} steps of {TRAIN_B} x {TRAIN_T} frames x "
            f"{TRAIN_SPK} speakers + 1 validation batch in {secs:.2f} s; launches {launches}")
        if state.step != TRAIN_STEPS:
            raise AssertionError(f"run_training took {state.step} steps")
        if launches != {"dec_train_fusion_fwd": n_layers * (TRAIN_STEPS + 1),
                        "dec_train_fusion_bwd": n_layers * TRAIN_STEPS}:
            raise AssertionError(f"fusion-layer launches {launches} on the main path")
        recs = [json.loads(ln) for ln in (ckpt_dir / "metrics.jsonl").read_text().splitlines()]
        losses = [r["train/tot_loss"] for r in recs if "train/tot_loss" in r]
        der = [r["val/DER"] for r in recs if "val/DER" in r]
        if len(losses) != TRAIN_STEPS or not np.isfinite(losses + der).all():
            raise AssertionError(f"train losses {losses}, validation DER {der}")
        log(f"  losses {[round(v, 4) for v in losses]}, validation DER {der[0]:.4f}")
        fresh = CK.load_ls_eend(ckpt_dir / "ckpt_epoch=0.npz", tcfg, "cuda")
        for (name, a), b in zip(state.model.state_dict().items(), fresh.state_dict().values()):
            if not name.endswith("num_batches_tracked") and not torch.equal(a, b):
                raise AssertionError(f"checkpoint reload: {name} differs")
        log("  checkpoint saved and reloaded into a fresh model bit for bit")
        del state, fresh

    # the train step alone, both decoder routes, the same weights and batch
    items = [train[i] for i in range(TRAIN_B)]
    batch = pad_collate(items, TRAIN_T, TRAIN_SPK, cfg.in_size)
    batch.pop("recs")
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    rows = {}
    for route, fused in (("fused decoder", True), ("plain decoder", False)):
        rcfg = dataclasses.replace(tcfg, use_fused_dec=fused)
        model = ls_eend.init_ls_eend(rcfg, torch.Generator().manual_seed(SEED), device="cuda")
        state = TRN.TrainState.create(model, tx)
        step = TRN.make_train_step(task, rcfg, tx)
        step(state, batch, SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: step(state, batch, SEED), reps=3)
        peak = torch.cuda.max_memory_allocated()
        rows[route] = {"route": route, "B": TRAIN_B, "T": TRAIN_T, "ms": ms,
                       "frames_per_s": TRAIN_B * TRAIN_T / (ms / 1e3),
                       "max_memory_allocated": peak}
        if fused:
            # the step's parts: loss forward + backward without the
            # optimizer, and the encoder's forward + backward alone
            gen = TRN.step_generator(SEED, 0, "cuda")
            rcfg_model = ls_eend.with_cfg(model, rcfg)

            def loss_backward():
                loss, _ = TRN.compute_loss(task, rcfg_model, batch, gen, train=True)
                loss.backward()

            xs = ls_eend.pad_to_chunk(batch["feats"], rcfg.chunk_size)

            def encoder_backward():
                h, _ = ls_eend.encode(rcfg_model, xs, "chunkwise", True, gen)
                h.square().mean().backward()

            rows[route].update(loss_backward_ms=cuda_ms(loss_backward, reps=3),
                               encoder_backward_ms=cuda_ms(encoder_backward, reps=3))
            profile_window(lambda: step(state, batch, SEED), 2, card)
        log(json.dumps({"train_step": rows[route], "card": card}))
        del model, state, step
    return launches, calls, rows


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_bound(name, args, cfg):
    """(bound_ms, bound_by, operations, bytes, design bytes): the bound is the
    larger of the bytes the call must move (each input read once, each output
    written once) over HBM bandwidth and its float32 operations (the matrix
    products; the elementwise work is of lower order) over the FMA-pipe
    peak.  Design bytes are what this kernel's design moves."""
    tensors = [a for a in args if torch.is_tensor(a)]
    weights = [t for a in args if isinstance(a, tuple) for t in a]
    nbytes = sum(t.numel() * t.element_size() for t in tensors + weights)
    D, H = cfg.n_units, cfg.n_heads
    dk = D // H
    if name == "enc_frame_scan":
        B, K, _ = args[0].shape
        L = args[3].shape[0]
        Fh = cfg.n_units * cfg.ff_expansion
        kc = cfg.conv_kernel_size
        per = 8 * D * Fh + 16 * D * D + 4 * D * dk + 2 * kc * D
        flops = B * K * L * per
        state = args[3:6]
        nbytes += args[0].numel() * 4 + sum(t.numel() * 4 for t in state)  # h out + state out
    elif name == "dec_frame_scan":
        B, K, _ = args[0].shape
        C = args[3].shape[0]
        L = args[5].shape[0]
        Fh = cfg.dec_dim_feedforward
        per_row = 18 * D * D + 4 * D * Fh + 4 * D * dk + 4 * C * D
        flops = B * K * (L * C * per_row + 4 * C * D)
        state = args[5:7]
        nbytes += B * K * C * 4 + sum(t.numel() * 4 for t in state)  # logits + state out
    elif name == "chunk_retention":
        # per row and frame: the causal half of q k^T and of (q k^T) v,
        # (L + 1)(dk + dv), the state read 2 dk dv and the state update 2 dk dv
        _, q, _, v, kv0, s0, L = args
        BH, T, dk = q.shape
        dv = v.shape[-1]
        flops = BH * T * ((L + 1) * (dk + dv) + 4 * dk * dv)
        nbytes += (v.numel() + kv0.numel() + s0.numel()) * 4         # out + state out
        tiles = -(-L // 64)                     # a k/v tile is read by every q tile after it
        design = nbytes + BH * T * (dk + dv) * 4 * (tiles - 1) / 2
    elif name.startswith("dec_train_fusion"):
        # per (frame, slot) row: the products 2 D (4D + D + 3D + D) + 4 D F,
        # the core H ((L + 1)(dk + dv) + 4 dk dv), the slot attention 4 C D;
        # the backward recomputes the forward and takes two products (input
        # and weight gradient) for each of the forward's: 3x
        bwd = name.endswith("bwd")
        x, w = args[0], args[4 if bwd else 1]
        B, C, T, D = x.shape
        L = args[-2]
        Fh = w.wf1.shape[0]
        R = B * C * T
        fwd = R * (2 * D * 9 * D + 4 * D * Fh + H * ((L + 1) * 2 * dk + 4 * dk * dk) + 4 * C * D)
        flops = 3 * fwd if bwd else fwd
        wbytes = sum(t.numel() * 4 for t in weights)
        if bwd:
            nbytes += x.numel() * 4 + wbytes                              # dx + weight grads
            work = 27 * D + 3 * Fh                   # the recompute's and the gradients' buffers
        else:
            nbytes += x.numel() * 4 + B * (T // L) * H * C * (dk * dk + 1) * 4   # y + kvs, ss
            work = 15 * D + Fh
        # every buffer of the workspace written once and read once
        design = nbytes + 2 * R * work * 4
    else:
        # per frame: the four input projections 2 D (2D + 2F), the out
        # projection 2 F D, and the core as above for each head
        _, x, w, kv0, s0, L = args
        B, T, _ = x.shape
        Fv = w.wo.shape[1]
        dv = Fv // H
        flops = B * T * (2 * D * (2 * D + 2 * Fv) + 2 * Fv * D
                         + H * ((L + 1) * (dk + dv) + 4 * dk * dv))
        nbytes += (x.numel() + kv0.numel() + s0.numel()) * 4         # y + state out
        # q | k | v | g written once and read once, g written again and read again
        design = nbytes + B * T * (2 * (2 * D + 2 * Fv) + 2 * Fv) * 4
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    if name.endswith("frame_scan"):
        # every weight once per lane-frame (from L2), the retention state read
        # and written once per frame (device memory)
        design = (sum(t.numel() * 4 for t in weights) * B * K + 2 * K * state[0].numel() * 4)
    return (max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes"), flops,
            nbytes, design)


def time_kernel(name, label, kern, plain, args, kw, cfg, card, plain_reps=1):
    """One kernel beside its plain version and its bound; the frame scans
    update their state in place, so each side runs on its own clones."""
    a_k, a_p = clone_args(args), clone_args(args)
    ms = cuda_ms(lambda: kern(*a_k, **kw), reps=5)
    plain_ms = cuda_ms(lambda: plain(*a_p, **kw), reps=plain_reps)
    bound_ms, bound_by, flops, nbytes, design = kernel_bound(name, args, cfg)
    log(json.dumps({"timing": name, "shape": label, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "flop": flops,
                    "bytes": nbytes, "achieved_tflops": flops / ms / 1e9,
                    "design_bytes": design, "design_tb_per_s": design / ms / 1e9,
                    "card": card}))
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def profile_window(fn, reps, card):
    """A torch.profiler trace of fn() called 1 + reps times (the first call
    absorbs the tracer's start-up): over the train step always, over the
    blockwise server's process_block with `--profile`;
    prints the device's busy share of a call and the device kernels that
    take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
    call_ms = start.elapsed_time(end) / reps
    rows = [(e.key, e.self_device_time_total / 1e3 / (reps + 1), e.count / (reps + 1))
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    log(json.dumps({"profile": {"calls": reps, "ms_per_call": call_ms,
                                "device_busy_ms_per_call": busy,
                                "device_idle_share": 1 - busy / call_ms,
                                "device_kernels_per_call": sum(r[2] for r in rows),
                                "top": [{"kernel": k[:72], "ms_per_call": ms,
                                         "launches_per_call": n} for k, ms, n in rows[:16]]},
                    "card": card}))


def phase_times(cfg, model, rng, card, main_path_args):
    from fseend_tpu_torch.ops import retention as R
    from fseend_tpu_torch.serving.runtime import BlockStreamingServer, StreamingServer

    B, K = LANES, TIME_K
    server = StreamingServer(kind="ls", cfg=cfg, model=model, n_lanes=B, n_slots=SLOTS,
                             device="cuda")
    xs = torch.as_tensor(rng.standard_normal((B, K, cfg.in_size)), dtype=torch.float32,
                         device="cuda")
    server.process_block(xs)                          # non-zero state
    got = capture_kernel_inputs(lambda: server.process_block(xs))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fps_ms = cuda_ms(lambda: server.process_block(xs), reps=5)
    peak = torch.cuda.max_memory_allocated()
    rows = {}
    for mod, name in frame_scans():
        args, kw = got[name]
        rows[name] = time_kernel(name, f"B={B} K={K}", getattr(mod, name),
                                 getattr(mod, name + "_plain"), args, kw, cfg, card)
    # frame latency of the single-frame path: step() is a K=1 block
    step_ms = cuda_ms(lambda: server.step(xs[:, 0]), reps=20)
    log(json.dumps({"step": {"lanes": B, "ms": step_ms, "frames_per_s": B / (step_ms / 1e3)},
                    "card": card}))
    fps = B * K / (fps_ms / 1e3)
    other_ms = fps_ms - rows["enc_frame_scan"]["ms"] - rows["dec_frame_scan"]["ms"]
    log(json.dumps({"process_block": {"server": "per-frame", "lanes": B, "K": K, "ms": fps_ms,
                                      "frames_per_s": fps, "outside_kernels_ms": other_ms,
                                      "max_memory_allocated": peak},
                    "card": card}))
    del server, got

    # the chunkwise kernels: the main path's largest calls (these make the
    # kernels line), then the other production shapes
    for name, (_, kern, plain) in chunk_kernels().items():
        args = main_path_args[name]
        shape = tuple(args[1].shape) + (f"L={args[-1]}",)
        rows[name] = time_kernel(name, f"main path {shape}", kern, plain, args, {}, cfg, card,
                                 plain_reps=3)
    rc = cfg.ret_cfg
    dk, dv, H = rc.key_dim, rc.head_dim, rc.num_heads
    _, kern, plain = chunk_kernels()["chunk_retention"]
    for BH, T, L in ((LANES * H, 1000, 500), (LANES * H, BLOCK, BLOCK),
                     (LANES * SLOTS * H, BLOCK, BLOCK)):
        args = (torch.ones(BH, device="cuda"),
                *(torch.as_tensor(rng.standard_normal((BH, T, d)) * s, dtype=torch.float32,
                                  device="cuda")
                  for d, s in ((dk, 1.0), (dk, dk ** -0.5), (dv, 1.0))),
                torch.zeros(BH, dk, dv, device="cuda"), torch.ones(BH, 1, 1, device="cuda"), L)
        time_kernel("chunk_retention", f"BH={BH} T={T} L={L}", kern, plain, args, {}, cfg,
                    card, plain_reps=3)
    dec_args = main_path_args["retention_layer"]
    st = R.chunk_state_init(rc, LANES, device="cuda")
    enc_args = (dec_args[0], dec_args[1][:LANES].contiguous(), dec_args[2], st["kv"],
                st["scale"], BLOCK)
    _, kern, plain = chunk_kernels()["retention_layer"]
    enc_row = time_kernel("retention_layer", f"encoder B={LANES} T=L={BLOCK}", kern, plain,
                          enc_args, {}, cfg, card, plain_reps=3)

    # the blockwise server, "fused" route then "plain" route
    blocks = {}
    for kernel in ("fused", "plain"):
        bsrv = BlockStreamingServer(kind="ls", cfg=dataclasses.replace(cfg, kernel=kernel),
                                    model=model, n_lanes=B, n_slots=SLOTS, block=BLOCK,
                                    device="cuda")
        xb = xs[:, :BLOCK]
        bsrv.process_block(xb)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        blocks[kernel] = cuda_ms(lambda: bsrv.process_block(xb), reps=5)
        peak = torch.cuda.max_memory_allocated()
        line = {"server": f"blockwise, {kernel} route", "lanes": B, "K": BLOCK,
                "ms": blocks[kernel], "frames_per_s": B * BLOCK / (blocks[kernel] / 1e3),
                "max_memory_allocated": peak}
        if kernel == "fused" and "--profile" in sys.argv[1:]:
            profile_window(lambda: bsrv.process_block(xb), 3, card)
        if kernel == "fused":
            in_kernel = (cfg.enc_n_layers * enc_row["ms"]
                         + cfg.dec_n_layers * rows["retention_layer"]["ms"])
            line.update(retention_layer_ms=in_kernel,
                        outside_kernels_ms=blocks[kernel] - in_kernel)
        log(json.dumps({"process_block": line, "card": card}))
        del bsrv
    return rows


def phase_train_times(cfg, card, calls):
    """The fusion layer's forward and backward kernels at the T3 shape, on
    the arguments of a training call of the main path: held against their
    plain versions once, then timed beside them and their bound."""
    from fseend_tpu_torch.kernels import dec_train_fusion as DT

    rows, errs = {}, {}
    for name, kern, plain in (("dec_train_fusion_fwd", DT.fusion_layer_fwd,
                               DT.fusion_layer_fwd_plain),
                              ("dec_train_fusion_bwd", DT.fusion_layer_bwd,
                               DT.fusion_layer_bwd_plain)):
        args, kw = calls["fusion_layer_" + name[-3:]]
        # the main path's call held against plain with `kink_free` weights
        # (the forward's checkpoints made again for them)
        w_i = 4 if name.endswith("bwd") else 1
        check = list(args)
        check[w_i] = kink_free(args[w_i], SEED)
        if name.endswith("bwd"):
            _, check[2], check[3] = DT.fusion_layer_fwd_plain(check[0], check[w_i], *check[5:])
        got = kern(*check, **kw)
        torch.cuda.synchronize()
        want = plain(*check, **kw)
        label = f"{name}[main path {tuple(args[0].shape)}]"
        errs[name] = (compare(label, got, want, ("y", "kvs", "ss")) if name.endswith("fwd")
                      else compare_grads(label, got, want))
        del got, want
        rows[name] = time_kernel(name, f"main path {tuple(args[0].shape)} L={args[-2]}", kern,
                                 plain, args, kw, cfg, card)
    log("library_ms: null for all six kernels -- no single PyTorch call computes a frame "
        "scan, the chunkwise core with its carried state, the whole retention layer, or a "
        "fusion layer's forward or backward")
    return rows, errs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from fseend_tpu_torch.models import ls_eend

    t0 = time.perf_counter()
    card = phase_device()
    phase_build()
    cfg = ls_eend.LSEENDConfig()
    rng = np.random.default_rng(SEED)
    model = make_model(cfg, rng)
    log(f"config: {cfg}")
    errs = phase_kernel_vs_plain(cfg, model, rng)
    launches = phase_serve(cfg, model, rng)
    chunk_errs = phase_chunk_kernels_vs_plain(cfg, model, rng)
    main_path_args = {}
    for name, phase in (("retention_layer", phase_block_serve), ("chunk_retention", phase_batch)):
        launches[name], err, main_path_args[name] = phase(cfg, model, rng)
        errs[name] = max(chunk_errs[name], err)
    dec_errs = phase_dec_train_vs_plain(cfg, model, rng)
    phase_train_golden(cfg)
    train_launches, train_calls, _ = phase_train(cfg, card)
    launches.update(train_launches)
    rows = phase_times(cfg, model, rng, card, main_path_args)
    train_rows, train_errs = phase_train_times(cfg, card, train_calls)
    rows.update(train_rows)
    for name in dec_errs:
        errs[name] = max(dec_errs[name], train_errs[name])
    sources = {
        "enc_frame_scan": ("fseend_tpu_torch/kernels/csrc/enc_frame_scan.cu",
                           "fseend_tpu/kernels/enc_frame_scan_pallas.py:140"),
        "dec_frame_scan": ("fseend_tpu_torch/kernels/csrc/dec_frame_scan.cu",
                           "fseend_tpu/kernels/dec_frame_scan_pallas.py:186"),
        "chunk_retention": ("fseend_tpu_torch/kernels/csrc/chunk_retention.cu",
                            "fseend_tpu/kernels/retention_pallas.py:131"),
        "retention_layer": ("fseend_tpu_torch/kernels/csrc/retention_layer.cu",
                            "fseend_tpu/kernels/retention_layer_pallas.py:172"),
        "dec_train_fusion_fwd": ("fseend_tpu_torch/kernels/csrc/dec_train_fusion_fwd.cu",
                                 "fseend_tpu/kernels/dec_train_fusion_pallas.py:574"),
        "dec_train_fusion_bwd": ("fseend_tpu_torch/kernels/csrc/dec_train_fusion_bwd.cu",
                                 "fseend_tpu/kernels/dec_train_fusion_pallas.py:620"),
    }
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], "max_abs_err": errs[name], **rows[name],
                "library_ms": None}
               for name, (src, rep) in sources.items()]
    log(f"total: {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
