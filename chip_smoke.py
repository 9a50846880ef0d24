#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`fseend_tpu_torch`) on one NVIDIA
GPU: builds the CUDA kernels from the sources in the checkout, holds each
kernel against its plain PyTorch version at the production width, drives
the port's three LS-EEND inference paths (per-frame streaming server,
blockwise streaming server, batch pass), its LS training path (the train
step and the epoch loop) and FS-EEND serving (per-frame fast-block server,
blockwise server, the batch pass against the reference), and times the
kernels, the servers and the step.

    python3 chip_smoke.py            (--profile adds a torch.profiler window
                                      over the blockwise server's process_block;
                                      --parent DIR builds the cached_attention.cu,
                                      dec_train_fusion_fwd.cu and
                                      dec_train_fusion_bwd.cu found in DIR, an
                                      earlier commit's kernels/csrc whose
                                      per-lane cached attention takes no scratch
                                      and whose fusion-layer forward takes the
                                      weights in torch's layout (others are
                                      refused), and times them against this
                                      tree's in turns)

Phases (any failure raises; the script exits non-zero and prints no result):
  1. device: the card's name and power limit (nvidia-smi); no card -> exit 1
  2. build: the seven CUDA sources (eight kernels) with nvcc into build/,
     all started together
  3. frame-scan kernels vs plain: B=128 lanes, K=64 frames, C=10 slots, the
     full LSEENDConfig(); random weights from a seed with non-trivial
     BatchNorm statistics; non-zero incoming state; staggered per-lane
     clocks; lanes that flush from a frame on, lanes with a flushed gap in
     the middle of the block; every output and state leaf
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
     B 2, T 256, L 128, dropout 0 and 0.1: forward y within 1e-4, kvs and
     ss within `checkpoint_atol`, y without checkpoints the same bits;
     backward dx within 1e-4 and every weight gradient within 2e-3 of its
     leaf max; at rate 0 the plain backward against torch autograd of the
     plain forward; two backward calls give the same bits
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
     over two fused steps (device idle share, top kernels); with --parent,
     the step on the earlier fusion-layer forward and backward in turns
 11. times: both frame scans first held against their plain versions on
     the per-frame server's own calls at B=128, K=128 and step()'s K=1; then
     CUDA events after warm-up: process_block of both servers at B=128,
     K=128 (and step(), K=1, with a torch.profiler window), every kernel
     alone beside its plain version and its bound (the tensor-core bound
     for the kernels on the tensor cores, with the FMA-pipe bound beside
     it), both frame scans at K=1, the device time by kernel of one call of
     each frame scan and of the fusion layer's forward and backward (the
     *_parts lines); with --parent, the earlier fusion-layer forward and
     backward alone against this tree's (earlier, this, this, earlier)
 12. F1, cached-attention kernels vs plain at FSEENDConfig() width (hd 64):
     cached_attention at (R 256, K 128, cap 2048), start 0 / 960 / 1920;
     cached_attention_perlane at R 256 and 1536, K 125, 128, 129 and 1,
     skewed lane starts with lanes before warm-up and lanes whose start + K
     passes the capacity, min_pos 0 and 9, two K = 1 calls bit for bit;
     every row within 1e-4
 13. F2, FS per-frame serve: StreamingServer(kind="fs") over 64 lanes,
     capacity 2048, 6 streams through ContinuousBatcher(block=500)
     (sub-blocks of 125) on the kernel route, against the plain route and
     fs_forward (1e-3); lane reset bit for bit; 24 launches per block, 6 per
     step(); the fast block against the frame scan at 8 lanes, capacity 256,
     200 frames
 14. F3, FS blockwise serve: BlockStreamingServer(kind="fs") over 64 lanes,
     K 128, 16 blocks to the last in-capacity block and a flush, kernel
     route vs plain route vs fs_forward (first 4 lanes), 4 launches per
     block; the last in-capacity block timed on both routes (with
     --parent, also on the earlier cached_attention, in turns)
 15. F4, tests/goldens/fs_model_prod.npz (1500 frames) through the port's
     own state-dict reader and fs_test: logits and emb within 1e-4
 16. F5, FS times: the per-frame server as bench.py:_mode_fs (three
     500-frame blocks from a fresh state) on both routes, its step() (with
     a torch.profiler window and the per-lane kernel's share of it), the
     kernel's device share of a block under torch.profiler; both kernels at
     their main-path shapes (the per-lane one also at step()'s K = 1)
     beside their plain versions, bounds and scaled_dot_product_attention
     (the library yardstick, never on the path); with --parent, in turns
     against the earlier cached_attention.cu: the per-lane kernel at those
     four shapes, the three blocks, step() (five rounds), and the shared
     head at the blockwise encoder's shape

The last line is {"ok": true, "device": {...}}; the kernels' JSON line and
the timing lines come before it.  Float32 throughout, TF32 off.  Kernels
are held within 1e-3 of their plain versions, the six on the tensor cores
(both frame scans, both cached-attention kernels, the fusion layer's
forward: its y, and backward: its dx) within 1e-4.
"""

from __future__ import annotations

import ctypes
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
# kernel vs plain over the fusion layer's backward: float32 weight gradients
# summed over 5120+ rows, in row slices added in a fixed order, against
# torch's sums in another order
GRAD_RTOL = 2e-3
# the reference's production-shape gradients (tests/test_train_parity.py:151-163)
GOLDEN_RTOL, GOLDEN_ATOL = 2e-3, 5e-6
STREAM_LENS = (137, 5, 50, 512, 777, 1000)  # lane 0 gets the 137-frame stream
# kernel vs plain: float32 with another summation order, over 64 frames of
# 4 encoder / 2 decoder layers; a wrong gate or term shows at O(0.1)
KERNEL_ATOL = 1e-3
# the kernels whose products run on the tensor cores in three TF32 passes
# (csrc/tc_f32.cuh), against their plain versions: float32-exact to ~1e-6
# relative, so held tighter than the FMA-pipe kernels (the fusion layer's
# backward on dx; its weight gradients at GRAD_RTOL)
TC_ATOL = 1e-4
# kernel server vs plain server, probabilities after the sigmoid
SERVE_ATOL = 1e-3
# FS-EEND serving at FSEENDConfig() and bench.py:435-437's sizes: 64 lanes,
# capacity 2048, blockwise K = 128; per-frame blocks of 500 frames (sub-blocks
# of 125)
FS_LANES, FS_CAP, FS_K, FS_BLOCK = 64, 2048, 128, 500
FS_HD = 64                                   # 256 units / 4 heads
# per-frame streams; each length + conv_delay stays within the capacity at
# sub-block granularity (a write past it is clamped onto the tail)
FS_STREAM_LENS = (1900, 1200, 777, 500, 137, 5)
FS_SCAN_LANES, FS_SCAN_CAP, FS_SCAN_T = 8, 256, 200   # fast block vs frame scan
FS_GOLDEN_ATOL = 1e-4                        # tests/test_torch_convert.py:85-95 drift 2.3e-5
# published H100 SXM peaks (float32 outside the tensor cores; TF32 dense on
# the tensor cores; HBM3)
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
TC_PASSES = 3                      # 3xTF32: three TF32 products per float32 product
PEAK_BYTES = 3.35e12
# the kernels whose products run on the tensor cores (csrc/tc_f32.cuh); the
# per-lane cached attention's K = 1 calls run on the FMA pipe (bound by bytes)
TENSOR_CORE_KERNELS = ("enc_frame_scan", "dec_frame_scan", "cached_attention",
                       "cached_attention_perlane", "dec_train_fusion_fwd",
                       "dec_train_fusion_bwd")


def checkpoint_atol(want):
    """The fusion-layer forward's checkpoints (kvs, ss) against plain: sums
    over a chunk's frames whose size grows with the chunk, so TC_ATOL times
    their leaf's max |value| where that exceeds 1, and never looser than
    KERNEL_ATOL, the FMA-pipe forward's guard (y is held at TC_ATOL)."""
    return min(KERNEL_ATOL, TC_ATOL * max(1.0, want.abs().max().item()))


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

    t0 = time.perf_counter()
    src = parent_dir()
    procs = start_parent_build(src) if src else None
    secs = _build.build([("enc_frame_scan", DTF), ("dec_frame_scan", DTF),
                         ("chunk_retention", HEAD), ("retention_layer", HEAD),
                         ("dec_train_fusion_fwd", DTF), ("dec_train_fusion_bwd", DTF),
                         ("cached_attention", {"CA_HD": FS_HD})],
                        verbose=True)
    log(f"build: {secs:.1f} s")
    if procs:
        finish_parent_build(procs)
        log(f"build with the earlier sources: {time.perf_counter() - t0:.1f} s")


# --parent DIR: an earlier commit's kernel sources (with the headers beside
# them), built beside this tree's and timed against them in turns; their C
# entry points as that commit had them, recognised by these signatures (B6
# on the FMA pipe with no scratch, B3 forward taking the weights in torch's
# (out, in) layout)
PARENT_SOURCES = {
    "cached_attention": ({"CA_HD": FS_HD}, (
        "const int* start, float* out, int R, int K, int cap, int rows_per_lane, int min_pos, "
        "void* stream", "const int* start, float* out, int R, int K, int cap, void* stream")),
    "dec_train_fusion_fwd": (DTF, ("dtf_forward(const float* x, const float* wqkvg, "
                                   "const float* bqkvg",)),
    "dec_train_fusion_bwd": (DTF, ("unsigned seed, unsigned thr, float mult, void* stream_",)),
}
PARENT = {}


def parent_dir():
    argv = sys.argv[1:]
    return Path(argv[argv.index("--parent") + 1]).resolve() if "--parent" in argv else None


def start_parent_build(src):
    """One nvcc per earlier source into build/parent/, started now; refuses a
    source whose entry points are not the ones this script calls."""
    from fseend_tpu_torch.kernels import _build

    out = _build.BUILD_DIR / "parent"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (defines, signatures) in PARENT_SOURCES.items():
        text = " ".join((src / f"{name}.cu").read_text().split())
        for signature in signatures:
            if signature not in text:
                raise SystemExit(f"--parent: {src}/{name}.cu lacks the entry point this "
                                 f"script calls (... {signature})")
        lib = out / f"lib{name}.so"
        cmd = ([_build._nvcc()] + _build.NVCC_FLAGS + [f"-D{k}={v}" for k, v in defines.items()]
               + ["-o", str(lib), str(src / f"{name}.cu")])
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    return procs


def finish_parent_build(procs):
    """Wait for the earlier sources' builds and fill PARENT with callables of
    the port's wrapper signatures (no launch counts; the transposed weights
    `wt` that this tree's wrappers take are ignored)."""
    from fseend_tpu_torch.kernels import dec_train_fusion as DT

    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"earlier {name}.cu: nvcc exit {proc.returncode}\n{out}")
        libs[name] = ctypes.CDLL(str(lib))
    P, I, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

    def entry(lib, fn, argtypes, restype=ctypes.c_int):
        f = getattr(libs[lib], fn)
        f.argtypes, f.restype = argtypes, restype
        return f

    fwd = entry("dec_train_fusion_fwd", "dtf_forward",
                [P] * 19 + [I] * 5 + [ctypes.c_uint, ctypes.c_uint, F32, P])
    fwd_ws = entry("dec_train_fusion_fwd", "dtf_fwd_workspace", [I] * 4, ctypes.c_size_t)
    bwd = entry("dec_train_fusion_bwd", "dtf_backward",
                [P] * 40 + [I] * 5 + [ctypes.c_uint, ctypes.c_uint, F32, P])
    bwd_ws = entry("dec_train_fusion_bwd", "dtf_bwd_workspace", [I] * 5, ctypes.c_size_t)
    att = entry("cached_attention", "cached_attention_launch", [P] * 5 + [I] * 3 + [P])
    att_pl = entry("cached_attention", "cached_attention_perlane_launch", [P] * 5 + [I] * 5 + [P])

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def check(what, err):
        if err:
            raise RuntimeError(f"earlier {what}: CUDA error {err}")

    def ptrs(ts):
        return [t.data_ptr() for t in ts]

    def fusion_layer_fwd(x, w, seed, n_heads, chunk, rate, checkpoints=True, wt=None):
        B, C, T, D = x.shape
        H, dk, N, Fh = n_heads, D // n_heads, T // chunk, w.wf1.shape[0]
        x = x.contiguous()
        w = [t.contiguous() for t in w]
        y = torch.empty_like(x)
        kvs = x.new_empty(B, N, H, C, dk, dk) if checkpoints else None
        ss = x.new_empty(B, N, H, C, 1, 1) if checkpoints else None
        ws = x.new_empty(fwd_ws(B * C, T, H, Fh))
        check("dec_train_fusion_fwd", fwd(*ptrs((x, *w, y)),
                                          kvs.data_ptr() if checkpoints else None,
                                          ss.data_ptr() if checkpoints else None,
                                          ws.data_ptr(), B, C, T, chunk, Fh,
                                          *DT._rate_args(seed, rate), stream()))
        return y, kvs, ss

    def fusion_layer_bwd(x, dy, kvs, ss, w, seed, n_heads, chunk, rate, wt=None):
        B, C, T, _ = x.shape
        Fh = w.wf1.shape[0]
        x, dy, kvs, ss = (t.contiguous() for t in (x, dy, kvs, ss))
        w = [t.contiguous() for t in w]
        wt = [w[i].T.contiguous() for i in (0, 2, 4, 6, 8, 10)]
        dx = torch.empty_like(x)
        grads = [torch.zeros_like(t) for t in w]
        ws = x.new_empty(bwd_ws(B * C, T, chunk, n_heads, Fh))
        check("dec_train_fusion_bwd", bwd(*ptrs((x, dy, kvs, ss, *w, *wt, dx, *grads, ws)),
                                          B, C, T, chunk, Fh, *DT._rate_args(seed, rate),
                                          stream()))
        return dx, DT.FusionWeights(*grads)

    def cached_attention(q, k, v, start):
        R, K, _ = q.shape
        st = torch.as_tensor(start, device=q.device).to(torch.int32).reshape(1)
        out = torch.empty_like(q)
        check("cached_attention", att(*ptrs((q, k, v, st, out)), R, K, k.shape[1], stream()))
        return out

    def cached_attention_perlane(q, k, v, start, rows_per_lane, min_pos=0):
        R, K, _ = q.shape
        q, k, v = (t.contiguous() for t in (q, k, v))
        st = torch.as_tensor(start, device=q.device).to(torch.int32).contiguous()
        out = torch.empty_like(q)
        check("cached_attention_perlane", att_pl(*ptrs((q, k, v, st, out)), R, K, k.shape[1],
                                                 rows_per_lane, min_pos, stream()))
        return out

    PARENT.update(dec_train_fusion_fwd=fusion_layer_fwd, dec_train_fusion_bwd=fusion_layer_bwd,
                  cached_attention=cached_attention,
                  cached_attention_perlane=cached_attention_perlane)


def via(mod, name, fn, call):
    """call() with mod.name replaced by fn for its duration."""
    def run():
        orig = getattr(mod, name)
        setattr(mod, name, fn)
        try:
            return call()
        finally:
            setattr(mod, name, orig)
    return run


def in_turns(what, earlier, this, reps, card, rounds=1):
    """The earlier kernel's and this tree's, timed earlier, this, this,
    earlier on one card (CUDA events over reps calls each), `rounds` times;
    the medians of each side's readings.  A host-bound call (`step()`)
    spreads by 15 % between readings, so it takes several rounds."""
    ms = []
    for _ in range(rounds):
        ms += [cuda_ms(earlier, reps), cuda_ms(this, reps), cuda_ms(this, reps),
               cuda_ms(earlier, reps)]
    log(json.dumps({"earlier_vs_this": {"what": what, "ms_in_turns": ms,
                                        "earlier_ms": float(np.median(ms[0::4] + ms[3::4])),
                                        "this_ms": float(np.median(ms[1::4] + ms[2::4]))},
                    "card": card}))


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


def compare(name, kernel_out, plain_out, labels, atol=KERNEL_ATOL):
    """Each output within `atol` of the plain one (a tolerance, or one per
    label); returns the largest difference."""
    worst = 0.0
    atols = atol if isinstance(atol, tuple) else (atol,) * len(labels)
    for lab, a, b, atol in zip(labels, kernel_out, plain_out, atols):
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"{name}.{lab}: shape {tuple(a.shape)} vs "
                                 f"{tuple(b.shape)} or non-finite values")
        err = (a - b).abs().max().item()
        worst = max(worst, err)
        log(f"  {name}.{lab}: max abs diff {err:.3e} (tol {atol:g}; plain's max |value| "
            f"{b.abs().max().item():.3g})")
        if not err <= atol:
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
    # a third of the lanes flush from a frame inside the block on, a third
    # have a flushed gap in the middle (the encoder reads its conv ring as it
    # stands there, then takes frames again)
    t = rng.integers(0, 2 * cfg.conv_delay, B)
    state["t"] = torch.as_tensor(t, dtype=torch.int32, device="cuda")
    fl = np.zeros((K, B), bool)
    for b in range(0, B, 3):
        fl[rng.integers(1, K):, b] = True
    for b in range(1, B, 3):
        start = rng.integers(0, K - 1)
        fl[start:rng.integers(start + 1, K), b] = True
    xs2 = torch.as_tensor(rng.standard_normal((B, K, cfg.in_size)), dtype=torch.float32,
                          device="cuda")
    flush = torch.as_tensor(fl, device="cuda")
    log(f"incoming state: enc scale max {state['enc_scale'].max().item():.0f}, "
        f"dec kv max abs {state['dec_kv'].abs().max().item():.3f}; "
        f"{int((t < cfg.conv_delay).sum())} lanes start invalid, "
        f"{int(fl[-1].sum())} lanes flush to the end of the block, "
        f"{int((fl.any(0) & ~fl[-1]).sum())} have a flushed gap")
    got = capture_kernel_inputs(
        lambda: ls_eend.ls_stream_block_fused(model, state, xs2, flush, SLOTS, packed))
    res = run_kernels(got,
                      {"enc_frame_scan": EFS.enc_frame_scan,
                       "dec_frame_scan": DFS.dec_frame_scan},
                      {"enc_frame_scan": EFS.enc_frame_scan_plain,
                       "dec_frame_scan": DFS.dec_frame_scan_plain})
    errs = {
        "enc_frame_scan": compare("enc_frame_scan", *res["enc_frame_scan"],
                                  ("h", "kv", "s", "ring"), atol=TC_ATOL),
        "dec_frame_scan": compare("dec_frame_scan", *res["dec_frame_scan"],
                                  ("logits", "kv", "s"), atol=TC_ATOL),
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


def compare_grads(label, got, want, dx_atol=TC_ATOL):
    """(dx, weight gradients) against a reference: dx within dx_atol, each
    weight gradient within GRAD_RTOL of its leaf max.  Returns the largest
    absolute difference."""
    from fseend_tpu_torch.kernels import dec_train_fusion as DT

    (dx, dw), (dx_r, dw_r) = got, want
    worst = compare(label, [dx], [dx_r], ("dx",), atol=dx_atol)
    share = 0.0                                  # the largest error over its bound
    for name, g, r in zip(DT.FusionWeights._fields, dw, dw_r):
        err, tol = (g - r).abs().max().item(), GRAD_RTOL * r.abs().max().item()
        worst = max(worst, err)
        share = max(share, err / tol)
        if not (torch.isfinite(g).all() and err <= tol):
            raise AssertionError(f"{label}.{name}: differs by {err} > {tol}")
    log(f"  {label}: 14 weight gradients within {GRAD_RTOL:g} of their leaf max "
        f"(largest abs diff {worst:.3e}, the worst at {share:.3f} of its bound)")
    return worst


def same_bits(label, got, again):
    """Two backward calls on the same inputs: dx and every weight gradient
    the same to the bit (no atomics: row slices added in a fixed order)."""
    from fseend_tpu_torch.kernels import dec_train_fusion as DT

    torch.cuda.synchronize()
    for name, a, b in zip(("dx",) + DT.FusionWeights._fields, (got[0], *got[1]),
                          (again[0], *again[1])):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: a second call gives other bits in {name} "
                                 f"(max {(a - b).abs().max().item():.3e})")
    log(f"  {label}: a second call gives dx and the 14 weight gradients bit for bit")


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
            f"dec_train_fusion_fwd[rate={rate}]", got, want, ("y", "kvs", "ss"),
            atol=(TC_ATOL, checkpoint_atol(want[1]), checkpoint_atol(want[2]))))
        # the no-checkpoint call (validation) runs the same sequence: the same y
        y_val = DT.fusion_layer_fwd(x, *args, checkpoints=False)[0]
        if not torch.equal(y_val, got[0]):
            raise AssertionError(f"dec_train_fusion_fwd[rate={rate}]: y without checkpoints "
                                 f"differs by {(y_val - got[0]).abs().max().item():.3e}")
        log(f"  carried scale max {want[2].max().item():.2f}")
        kvs, ss = want[1], want[2]
        got = DT.fusion_layer_bwd(x, dy, kvs, ss, *args)
        torch.cuda.synchronize()
        plain = DT.fusion_layer_bwd_plain(x, dy, kvs, ss, *args)
        errs["dec_train_fusion_bwd"] = max(errs["dec_train_fusion_bwd"], compare_grads(
            f"dec_train_fusion_bwd[rate={rate}]", got, plain))
        same_bits(f"dec_train_fusion_bwd[rate={rate}]", got,
                  DT.fusion_layer_bwd(x, dy, kvs, ss, *args))
        if rate == 0.0:
            xa = x.clone().requires_grad_(True)
            wa = DT.FusionWeights(*(t.clone().requires_grad_(True) for t in w))
            ya, _, _ = DT.fusion_layer_fwd_plain(xa, wa, DEC_SEED, H, DEC_L, rate)
            (ya * dy).sum().backward()
            compare_grads("plain backward vs autograd of the plain forward", plain,
                          (xa.grad, DT.FusionWeights(*(t.grad for t in wa))),
                          dx_atol=KERNEL_ATOL)
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
            if PARENT:  # the step on the earlier fusion-layer forward and backward
                earlier = via(DT, "_launch_fwd", PARENT["dec_train_fusion_fwd"],
                              via(DT, "_launch_bwd", PARENT["dec_train_fusion_bwd"],
                                  lambda: step(state, batch, SEED)))
                in_turns("T3 train step, fused decoder", earlier,
                         lambda: step(state, batch, SEED), 3, card)
                profile_window(earlier, 2, card, "fused train step, earlier fusion layer")
            profile_window(lambda: step(state, batch, SEED), 2, card, "fused train step")
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


def pipe_bounds(name, t_bytes, flops, tensor_cores=None):
    """(bound_ms, bound_by, pipe, fma_bound_ms): the operations over the
    peak of the pipe the kernel's products run on -- the FMA pipe's float32
    peak, or for the kernels on the tensor cores (TENSOR_CORE_KERNELS, or
    `tensor_cores` where given) the TF32 peak over the three passes of a
    float32-exact product -- against the bytes; fma_bound_ms is the
    operations over the FMA pipe's peak."""
    fma = flops / PEAK_F32_FLOPS * 1e3
    if name in TENSOR_CORE_KERNELS if tensor_cores is None else tensor_cores:
        t_ops, pipe = flops * TC_PASSES / PEAK_TF32_FLOPS * 1e3, "tensor cores (3xTF32)"
    else:
        t_ops, pipe = fma, "FMA (float32)"
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes"), pipe, fma


def kernel_bound(name, args, cfg):
    """(bound_ms, bound_by, operations, bytes, design bytes, pipe,
    fma_bound_ms): the bound is the larger of the bytes the call must move
    (each input read once, each output written once) over HBM bandwidth and
    its float32 operations (the matrix products; the elementwise work is of
    lower order) over the peak of its pipe (`pipe_bounds`).  Design bytes
    are what this kernel's design moves."""
    if name.startswith("cached_attention"):
        return attention_bound(name, args)
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
    wbytes = sum(t.numel() * 4 for t in weights)
    if name == "enc_frame_scan":
        # layer-major: the weights once per slice of 128 frames, the state
        # once per layer (in nbytes), and per layer and (lane, frame) row the
        # workspace buffers written and read: about 42 D + 4 F floats
        design = nbytes + wbytes * -(-K // 128) + L * B * K * (42 * D + 4 * Fh) * 4
    elif name == "dec_frame_scan":
        # layer-major: the weights once per slice of 128 frames, the state
        # once per layer (in nbytes), and per layer and (lane, slot, frame)
        # row every workspace buffer written and read once: 35 D + 2 F floats
        design = nbytes + wbytes * -(-K // 128) + L * B * C * K * (35 * D + 2 * Fh) * 4
    bound_ms, bound_by, pipe, fma_ms = pipe_bounds(name, t_bytes, flops)
    return bound_ms, bound_by, flops, nbytes, design, pipe, fma_ms


def time_kernel(name, label, kern, plain, args, kw, cfg, card, plain_reps=1, library=None):
    """One kernel beside its plain version, its bound and, where one PyTorch
    call computes the same function, that call (`library`, a function of no
    arguments); the frame scans update their state in place, so each side
    runs on its own clones."""
    a_k, a_p = clone_args(args), clone_args(args)
    ms = cuda_ms(lambda: kern(*a_k, **kw), reps=5)
    plain_ms = cuda_ms(lambda: plain(*a_p, **kw), reps=plain_reps)
    library_ms = cuda_ms(library, reps=5) if library is not None else None
    bound_ms, bound_by, flops, nbytes, design, pipe, fma_ms = kernel_bound(name, args, cfg)
    log(json.dumps({"timing": name, "shape": label, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                    "bound_pipe": pipe, "fma_bound_ms": fma_ms,
                    "flop": flops, "bytes": nbytes, "achieved_tflops": flops / ms / 1e9,
                    "design_bytes": design, "design_tb_per_s": design / ms / 1e9,
                    "card": card}))
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def profile_window(fn, reps, card, what, part=None):
    """A torch.profiler trace of fn() called 1 + reps times (the first call
    absorbs the tracer's start-up): over the train step and both servers'
    step() always, over the blockwise server's process_block with
    `--profile`; prints the device's busy share of a call, its device
    kernels and those that take most of it, and with `part` the device time
    of the kernels whose names hold it and their share of the call."""
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
    line = {"what": what, "calls": reps, "ms_per_call": call_ms,
            "device_busy_ms_per_call": busy, "device_idle_share": 1 - busy / call_ms,
            "device_kernels_per_call": sum(r[2] for r in rows),
            "top": [{"kernel": k[:72], "ms_per_call": ms, "launches_per_call": n}
                    for k, ms, n in rows[:16]]}
    if part:
        mine = sum(ms for k, ms, _ in rows if part in k)
        line["part"] = {"kernels": part, "device_ms_per_call": mine,
                        "share_of_busy": mine / busy, "share_of_call": mine / call_ms}
    log(json.dumps({"profile": line, "card": card}))


FRAME_SCAN_LEAVES = {"enc_frame_scan": ("h", "kv", "s", "ring"),
                     "dec_frame_scan": ("logits", "kv", "s")}


def hold_on_main_path(server, xs, got):
    """Both frame scans against their plain versions on the per-frame
    server's own calls: the process_block call captured in `got` (K = 128:
    two retention chunks, the state carried between them) and a step() (K =
    1: live row groups, products split along k).  Returns the larger error
    of each and step()'s arguments."""
    from fseend_tpu_torch.kernels import dec_frame_scan as DFS
    from fseend_tpu_torch.kernels import enc_frame_scan as EFS

    step_got = capture_kernel_inputs(lambda: server.step(xs[:, 0]))
    fns = ({"enc_frame_scan": EFS.enc_frame_scan, "dec_frame_scan": DFS.dec_frame_scan},
           {"enc_frame_scan": EFS.enc_frame_scan_plain,
            "dec_frame_scan": DFS.dec_frame_scan_plain})
    errs = dict.fromkeys(FRAME_SCAN_LEAVES, 0.0)
    for label, g in (("process_block", got), ("step()", step_got)):
        res = run_kernels(g, *fns)
        for name, leaves in FRAME_SCAN_LEAVES.items():
            B, K, _ = g[name][0][0].shape
            errs[name] = max(errs[name], compare(f"{name}[main path {label} B={B} K={K}]",
                                                 *res[name], leaves, atol=TC_ATOL))
    return errs, step_got


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
    scan_errs, step_got = hold_on_main_path(server, xs, got)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fps_ms = cuda_ms(lambda: server.process_block(xs), reps=5)
    peak = torch.cuda.max_memory_allocated()
    rows = {}
    for mod, name in frame_scans():
        args, kw = got[name]
        rows[name] = time_kernel(name, f"B={B} K={K}", getattr(mod, name),
                                 getattr(mod, name + "_plain"), args, kw, cfg, card)
        rows[name]["max_abs_err"] = scan_errs[name]
        args, kw = step_got[name]
        time_kernel(name, f"step() B={B} K=1", getattr(mod, name),
                    getattr(mod, name + "_plain"), args, kw, cfg, card)
        # where the scan's time goes: device time by kernel of one call
        a = clone_args(got[name][0])
        busy = device_ms_by_kernel(lambda: getattr(mod, name)(*a, **got[name][1]))
        log(json.dumps({f"{name}_parts": {"device_busy_ms": sum(busy.values()),
                                          "top": top_kernels(busy, 1, n=12)},
                        "card": card}))
        del a
    # frame latency of the single-frame path: step() is a K=1 block
    step_ms = cuda_ms(lambda: server.step(xs[:, 0]), reps=20)
    log(json.dumps({"step": {"lanes": B, "ms": step_ms, "frames_per_s": B / (step_ms / 1e3)},
                    "card": card}))
    profile_window(lambda: server.step(xs[:, 0]), 5, card, "per-frame step()")
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
            profile_window(lambda: bsrv.process_block(xb), 3, card,
                           "blockwise process_block, fused route")
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
        # the wrapper makes the transposed weights itself: its time includes them
        kw = {k: v for k, v in kw.items() if k != "wt"}
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
        if name.endswith("fwd"):
            errs[name] = compare(label, got, want, ("y", "kvs", "ss"),
                                 atol=(TC_ATOL, checkpoint_atol(want[1]),
                                       checkpoint_atol(want[2])))
        else:
            errs[name] = compare_grads(label, got, want)
            same_bits(label, got, kern(*check, **kw))
        del got, want
        rows[name] = time_kernel(name, f"main path {tuple(args[0].shape)} L={args[-2]}", kern,
                                 plain, args, kw, cfg, card)
    # where each direction's time goes: device time by kernel of one call
    # (and of the earlier kernel's, with --parent), then the two in turns
    for name in ("dec_train_fusion_fwd", "dec_train_fusion_bwd"):
        fn_name = "fusion_layer_" + name[-3:]
        args, kw = calls[fn_name]
        kw = {k: v for k, v in kw.items() if k != "wt"}
        this = getattr(DT, fn_name)
        versions = [("this", this)]
        if PARENT:
            versions.insert(0, ("earlier", PARENT[name]))
        for which, fn in versions:
            busy = device_ms_by_kernel(lambda: fn(*args, **kw))
            log(json.dumps({f"{name}_parts": {
                "kernel": which, "device_busy_ms": sum(busy.values()),
                "top": top_kernels(busy, 1, n=16)}, "card": card}))
        if PARENT:
            old = PARENT[name]
            diff = (old(*args, **kw)[0] - this(*args, **kw)[0]).abs().max()
            log(f"  earlier {name} vs this: {'y' if name.endswith('fwd') else 'dx'} max abs "
                f"diff {diff.item():.3e}")
            in_turns(f"{name} main path {tuple(args[0].shape)}", lambda: old(*args, **kw),
                     lambda: this(*args, **kw), 3, card)
    log("library_ms: null for the six LS kernels -- no single PyTorch call computes a "
        "frame scan, the chunkwise core with its carried state, the whole retention layer, "
        "or a fusion layer's forward or backward")
    return rows, errs


# ---------------------------------------------------------------------------
# FS-EEND serving: F1 the cached-attention kernels, F2 the per-frame server,
# F3 the blockwise server, F4 the reference at full width, F5 times
# ---------------------------------------------------------------------------


def attention_bound(name, args):
    """The cached-attention kernels' bound from this call's inputs: each
    query reads the positions its mask admits (its own, or [min_pos,
    min(qpos, cap - 1)]), 4 hd operations apiece (q.k and p.v); the bytes
    are q and the output once each and every row's cache prefix that any of
    its queries reads (k and v), once."""
    q, k, _, start = args[:4]
    R, K, hd = q.shape
    cap = k.shape[1]
    if name == "cached_attention_perlane":
        rpl, min_pos = args[4], args[5]
        st = start.to(torch.int64).repeat_interleave(rpl)
    else:
        min_pos = 0
        st = start.to(torch.int64).reshape(1).expand(R)
    qpos = st[:, None] + torch.arange(K, device=q.device)[None, :]
    reads = torch.where(qpos < min_pos, torch.ones_like(qpos),
                        qpos.clamp(max=cap - 1) - min_pos + 1)
    flops = 4 * hd * int(reads.sum())
    prefix = int(((st + K - 1).clamp(max=cap - 1) + 1).sum())
    nbytes = 4 * (2 * q.numel() + 2 * prefix * hd) + start.numel() * 4
    t_bytes = nbytes / PEAK_BYTES * 1e3
    # the design reads every kv tile up to the tile's last readable position
    # once per 128-query tile; at K = 1 (the per-lane form's split over the
    # cache, on the FMA pipe, bound by bytes) once, and writes and reads the
    # splits' partials
    design = nbytes + 4 * 2 * prefix * hd * (-(-K // 128) - 1)
    if name == "cached_attention_perlane" and K == 1:
        from fseend_tpu_torch.kernels import _build

        lib = _build.load("cached_attention", {"CA_HD": hd})
        lib.cached_attention_perlane_scratch.argtypes = [ctypes.c_int] * 3
        lib.cached_attention_perlane_scratch.restype = ctypes.c_size_t
        design += 4 * 2 * lib.cached_attention_perlane_scratch(R, K, cap)
    bound_ms, bound_by, pipe, fma_ms = pipe_bounds(name, t_bytes, flops, tensor_cores=K > 1)
    return bound_ms, bound_by, flops, nbytes, design, pipe, fma_ms


def sdpa_call(args, name):
    """The library yardstick: torch's scaled_dot_product_attention with the
    same boolean mask (per lane, broadcast over the lane's rows).  Returns
    a function of no arguments; the mask is built outside it."""
    import torch.nn.functional as F

    q, k, v, start = args[:4]
    R, K, hd = q.shape
    cap = k.shape[1]
    rpl, min_pos = (args[4], args[5]) if name == "cached_attention_perlane" else (R, 0)
    nl = R // rpl
    pos = torch.arange(cap, device=q.device)[None, None, :]
    st = start.to(torch.int64).reshape(-1).expand(nl)
    qpos = st[:, None, None] + torch.arange(K, device=q.device)[None, :, None]
    ok = (((pos <= qpos) & (pos >= min_pos)) | (pos == qpos))[:, None]  # (nl, 1, K, cap)
    qv, kv, vv = (t.reshape(nl, rpl, t.shape[1], hd) for t in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qv, kv, vv, attn_mask=ok).reshape(R, K, hd)


def fs_make_model(fcfg, rng):
    """FSEENDConfig() with random weights from the seed, random attention
    in-projection biases and BatchNorm statistics, on the card."""
    from fseend_tpu_torch.models import fs_eend
    from fseend_tpu_torch.ops import nn as tnn

    model = fs_eend.init_fs_eend(fcfg, torch.Generator().manual_seed(SEED), device="cuda")
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, tnn.MultiheadAttention):
                m.in_proj.bias.copy_(randn(rng, *m.in_proj.bias.shape, scale=0.1))
        bn = model.enc.bn
        bn.running_mean.copy_(randn(rng, fcfg.in_size, scale=0.2))
        bn.running_var.copy_(torch.as_tensor(rng.uniform(0.5, 2.0, fcfg.in_size),
                                             dtype=torch.float32))
    return model


def phase_fs_kernels_vs_plain(fcfg, rng):
    """F1: both kernels against their plain versions at production width:
    the shared head at the encoder's blockwise shape (R 256, K 128) at
    start 0, mid-way and cap - K; the per-lane heads at the fast block's
    encoder (R 256) and decoder (R 1536) shapes, K 125 (the fast block's
    sub-block), 128, 129 (two query tiles) and 1 (step(): the split over
    the cache at R 256, the rows alone at R 1536), skewed lane starts with
    lanes before warm-up and lanes whose start + K passes the capacity,
    min_pos 0 and 9; at K = 1 a second call gives the same bits.  Every row
    is compared, all at TC_ATOL."""
    from fseend_tpu_torch.kernels import cached_attention as CA

    H, C = fcfg.n_heads, fcfg.max_nspks
    errs = {"cached_attention": 0.0, "cached_attention_perlane": 0.0}
    R = FS_LANES * H
    q = randn(rng, R, FS_K, FS_HD)
    k, v = randn(rng, R, FS_CAP, FS_HD), randn(rng, R, FS_CAP, FS_HD)
    for start in (0, FS_CAP // 2 - 64, FS_CAP - FS_K):
        got = CA.cached_attention(q, k, v, start)
        torch.cuda.synchronize()
        want = CA.cached_attention_plain(q, k, v, start)
        errs["cached_attention"] = max(errs["cached_attention"], compare(
            f"cached_attention[R={R} K={FS_K} cap={FS_CAP} start={start}]", [got], [want],
            ("out",), atol=TC_ATOL))
    del q, k, v
    for label, rpl in (("encoder", H), ("decoder", C * H)):
        R = FS_LANES * rpl
        k, v = randn(rng, R, FS_CAP, FS_HD), randn(rng, R, FS_CAP, FS_HD)
        for K in (FS_BLOCK // 4, 128, 129, 1):
            starts = rng.integers(0, FS_CAP - K, FS_LANES)
            starts[:6] = (0, 1, 4, 8, 9, 10)                  # around warm-up
            starts[6:9] = (FS_CAP - K + 1, FS_CAP - 1, FS_CAP + 3)   # start + K past cap
            start = torch.as_tensor(starts, dtype=torch.int32, device="cuda")
            q = randn(rng, R, K, FS_HD)
            for min_pos in (0, fcfg.conv_delay):
                got = CA.cached_attention_perlane(q, k, v, start, rpl, min_pos)
                torch.cuda.synchronize()
                want = CA.cached_attention_perlane_plain(q, k, v, start, rpl, min_pos)
                errs["cached_attention_perlane"] = max(
                    errs["cached_attention_perlane"], compare(
                        f"cached_attention_perlane[{label} R={R} K={K} min_pos={min_pos}]",
                        [got], [want], ("out",), atol=TC_ATOL))
                if K == 1 and not torch.equal(
                        CA.cached_attention_perlane(q, k, v, start, rpl, min_pos), got):
                    raise AssertionError(f"cached_attention_perlane[{label} K=1]: a second "
                                         f"call gives other bits")
                del got, want
            del q
        log(f"  cached_attention_perlane[{label} K=1]: a second call gives the same bits")
        del k, v
    return errs


def fs_check(label, got, want, atol):
    err = float(np.abs(got - want).max())
    log(f"  {label}: max abs diff {err:.3e} (tol {atol:g})")
    if not (np.isfinite(got).all() and err <= atol):
        raise AssertionError(f"{label}: differs by {err} or non-finite")


def phase_fs_serve(fcfg, model, rng):
    """F2: StreamingServer(kind="fs") over 64 lanes, capacity 2048, through
    ContinuousBatcher in 500-frame blocks (sub-blocks of 125) on the kernel
    route: the streams held against the plain route and the batch pass;
    lane reuse bit for bit; the launches counted.  Then the fast block
    against the frame scan at a reduced size."""
    from fseend_tpu_torch.kernels import cached_attention as CA
    from fseend_tpu_torch.models import fs_eend
    from fseend_tpu_torch.serving.runtime import StreamingServer
    from fseend_tpu_torch.serving.scheduler import ContinuousBatcher

    C = fcfg.max_nspks
    streams = {f"fs{i}_{n}": rng.standard_normal((n, fcfg.in_size)).astype(np.float32)
               for i, n in enumerate(FS_STREAM_LENS)}

    def make(flash, **kw):
        kw.setdefault("n_lanes", FS_LANES)
        kw.setdefault("capacity", FS_CAP)
        return StreamingServer(kind="fs", cfg=dataclasses.replace(fcfg, use_flash_attn=flash),
                               model=model, n_slots=C, device="cuda", **kw)

    def run(server, todo):
        cb = ContinuousBatcher(server, block=FS_BLOCK)
        for sid, feats in todo.items():
            cb.submit(sid, feats)
        blocks = 0
        while cb.active:
            cb.step()
            blocks += 1
        return cb.results, blocks

    server = make(True)
    CA.perlane_launches = 0
    t0 = time.perf_counter()
    got, blocks = run(server, streams)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = CA.perlane_launches
    per_block = (FS_BLOCK // 125) * (fcfg.enc_n_layers + fcfg.dec_n_layers)
    log(f"fs serve: {len(streams)} streams ({sum(FS_STREAM_LENS)} frames) over {FS_LANES} "
        f"lanes, capacity {FS_CAP}, {blocks} blocks of {FS_BLOCK} in {secs:.2f} s; "
        f"cached_attention_perlane launches {launches} ({per_block} per block)")
    if launches != blocks * per_block:
        raise AssertionError(f"cached_attention_perlane launched {launches} times on the "
                             f"main path, expected {blocks * per_block}")
    plain = make(False)
    ref, _ = run(plain, streams)
    if CA.perlane_launches != launches:
        raise AssertionError("the plain route launched cached_attention_perlane")
    del plain
    for sid, feats in streams.items():
        if got[sid].shape != (len(feats), C - 1):
            raise AssertionError(f"{sid}: probs {got[sid].shape}")
        fs_check(f"{sid} kernel route vs plain route", got[sid], ref[sid], SERVE_ATOL)
        out = fs_eend.fs_forward(model, torch.as_tensor(feats[None], device="cuda"),
                                 torch.tensor([len(feats)], device="cuda"), C)
        fs_check(f"{sid} kernel route vs fs_forward", got[sid],
                 torch.sigmoid(out["logits"][0, :, 1:]).cpu().numpy(), SERVE_ATOL)
    sid0 = next(iter(streams))
    server.reset_lanes([0, 1])
    again, _ = run(server, {sid0: streams[sid0]})
    if not np.array_equal(again[sid0], got[sid0]):
        raise AssertionError(f"{sid0}: re-served stream differs after lane reset")
    log(f"  lane reset: {sid0} re-served on lane 0 bit for bit")
    # step() is a one-frame fast block: one launch per layer
    CA.perlane_launches = 0
    server.step(np.zeros((FS_LANES, fcfg.in_size), np.float32))
    if CA.perlane_launches != fcfg.enc_n_layers + fcfg.dec_n_layers:
        raise AssertionError(f"step() launched {CA.perlane_launches} kernels")
    del server

    # the fast block against the frame scan (fs_stream_step, plain) at a
    # reduced size: 8 lanes, capacity 256, 200 frames + 9 flush frames
    B, T = FS_SCAN_LANES, FS_SCAN_T
    xs = rng.standard_normal((B, T, fcfg.in_size)).astype(np.float32)
    seq = np.concatenate([xs, np.zeros((B, fcfg.conv_delay, fcfg.in_size), np.float32)], 1)
    flush = np.arange(T + fcfg.conv_delay) >= T
    outs = {}
    for label, kw in (("fast", {}), ("scan", {"fs_fast": False})):
        srv = make(True, n_lanes=B, capacity=FS_SCAN_CAP, **kw)
        t0 = time.perf_counter()
        p, valid = srv.process_block(seq, flush)
        torch.cuda.synchronize()
        outs[label] = (p.cpu().numpy(), valid.cpu().numpy())
        log(f"  {label}: {B} lanes x {T + fcfg.conv_delay} frames in "
            f"{time.perf_counter() - t0:.2f} s")
    if not np.array_equal(outs["fast"][1], outs["scan"][1]):
        raise AssertionError("fast block and frame scan disagree on valid frames")
    v = outs["scan"][1].T                                         # (B, K)
    fs_check(f"fast block vs frame scan ({B} lanes, capacity {FS_SCAN_CAP})",
             outs["fast"][0][v], outs["scan"][0][v], SERVE_ATOL)
    return launches


def phase_fs_block_serve(fcfg, model, rng, card):
    """F3: BlockStreamingServer(kind="fs") over 64 lanes, K = 128, capacity
    2048: 16 blocks fill the caches to the last in-capacity block, then a
    flush; the kernel route against the plain route and the batch pass
    (first 4 lanes); launches counted.  Then each route's last in-capacity
    block timed again from its state.  Returns (launches, the arguments of
    the last encoder call)."""
    from fseend_tpu_torch.kernels import cached_attention as CA
    from fseend_tpu_torch.models import fs_eend
    from fseend_tpu_torch.serving.runtime import BlockStreamingServer

    C = fcfg.max_nspks
    n_blocks = FS_CAP // FS_K
    xs = torch.as_tensor(rng.standard_normal((FS_LANES, FS_CAP, fcfg.in_size)),
                         dtype=torch.float32, device="cuda")
    probs, launches, captured = {}, None, None
    for flash in (True, False):
        srv = BlockStreamingServer(kind="fs", cfg=dataclasses.replace(fcfg, use_flash_attn=flash),
                                   model=model, n_lanes=FS_LANES, n_slots=C, block=FS_K,
                                   capacity=FS_CAP, device="cuda")
        outs, snap = [], None
        CA.launches = 0
        t0 = time.perf_counter()
        for i in range(n_blocks):
            if i == n_blocks - 1:
                snap = (dict(srv.state), srv._frames_fed)
            outs.append(srv.process_block(xs[:, i * FS_K:(i + 1) * FS_K]))
        outs.append(srv.process_block(torch.zeros_like(xs[:, :FS_K]), flush=True))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        probs[flash] = torch.cat(outs[1:], dim=1)
        route = "kernel" if flash else "plain"
        if flash:
            launches = CA.launches
            log(f"fs block serve: {FS_LANES} lanes x {n_blocks} blocks of {FS_K} + 1 flush "
                f"in {secs:.2f} s; cached_attention launches {launches} "
                f"({fcfg.enc_n_layers} per block, none on the flush)")
            if launches != n_blocks * fcfg.enc_n_layers:
                raise AssertionError(f"cached_attention launched {launches} times on the "
                                     f"main path")
        elif CA.launches:
            raise AssertionError("the plain route launched cached_attention")

        def last_block():
            srv.state, srv._frames_fed = dict(snap[0]), snap[1]
            return srv.process_block(xs[:, -FS_K:])

        if flash:
            captured = capture_kernel_inputs(last_block, [(CA, "cached_attention")])
            captured = captured["cached_attention"][0]
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(last_block, reps=5)
        if flash and PARENT:
            in_turns("fs blockwise process_block, last in capacity",
                     via(CA, "cached_attention", PARENT["cached_attention"], last_block),
                     last_block, 5, card)
        line = {"server": f"fs blockwise, {route} route", "lanes": FS_LANES, "K": FS_K,
                "capacity": FS_CAP, "block": "last in capacity", "ms": ms,
                "frames_per_s": FS_LANES * FS_K / (ms / 1e3),
                "max_memory_allocated": torch.cuda.max_memory_allocated()}
        if flash:
            busy = device_ms_by_kernel(last_block)
            kern = sum(ms for name, ms in busy.items() if name.startswith("ca::"))
            line.update(cached_attention_ms=kern, outside_kernels_ms=ms - kern,
                        device_busy_ms=sum(busy.values()), top=top_kernels(busy, 1))
        log(json.dumps({"process_block": line, "card": card}))
        del srv, snap, outs
    fs_check("kernel route vs plain route", probs[True].cpu().numpy(),
             probs[False].cpu().numpy(), SERVE_ATOL)
    n = 4
    out = fs_eend.fs_forward(model, xs[:n], torch.full((n,), FS_CAP, device="cuda"), C)
    fs_check(f"kernel route vs fs_forward ({n} lanes x {FS_CAP} frames)",
             probs[True][:n].cpu().numpy(),
             torch.sigmoid(out["logits"][..., 1:]).cpu().numpy(), SERVE_ATOL)
    return launches, captured


def device_ms_by_kernel(fn, warm=True):
    """Device time by kernel name of one call of fn() under torch.profiler
    (after one call outside it, if `warm`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def top_kernels(busy, calls, n=8):
    """The n device kernels that take most of the time, ms per call."""
    rows = sorted(busy.items(), key=lambda kv: -kv[1])[:n]
    return [{"kernel": k[:72], "ms_per_call": ms / calls} for k, ms in rows]


def phase_fs_golden(fcfg):
    """F4: the reference's production-shape FS outputs
    (tests/goldens/fs_model_prod.npz: 1500 frames, f16-shipped weights)
    through the port's own state-dict reader and fs_test on the card."""
    from fseend_tpu_torch.models import fs_eend
    from fseend_tpu_torch.utils import torch_convert as TC

    g = np.load(Path(__file__).resolve().parent / "tests" / "goldens" / "fs_model_prod.npz")
    sd = {k[4:]: np.asarray(g[k], np.float32) for k in g.files if k.startswith("sd__")}
    model = TC.fs_from_state_dict(sd, fcfg, "cuda")
    x = torch.as_tensor(np.asarray(g["x"], np.float32), device="cuda")
    out = fs_eend.fs_test(model, x, torch.tensor([x.shape[1]], device="cuda"))
    drift = {}
    for key in ("logits", "emb"):
        got = out[key].cpu().numpy()
        if got.shape != g[key].shape or not np.isfinite(got).all():
            raise AssertionError(f"fs golden {key}: shape {got.shape} or non-finite values")
        drift[key] = float(np.abs(got - g[key]).max())
        log(f"fs golden (fs_model_prod.npz, {tuple(x.shape)}): {key} max abs diff "
            f"{drift[key]:.3e} (tol {FS_GOLDEN_ATOL:g})")
        if not drift[key] <= FS_GOLDEN_ATOL:
            raise AssertionError(f"fs golden {key} differs by {drift[key]}")
    return drift


def phase_fs_times(fcfg, model, rng, card, block_args):
    """F5: the per-frame server timed as bench.py:_mode_fs times it (64
    lanes, three 500-frame blocks from a fresh state, CUDA events), and its
    step(); both kernels at their main-path shapes beside their plain
    versions, their bounds and scaled_dot_product_attention."""
    from fseend_tpu_torch.kernels import cached_attention as CA
    from fseend_tpu_torch.serving.runtime import StreamingServer

    C = fcfg.max_nspks
    xs = [torch.as_tensor(rng.standard_normal((FS_LANES, FS_BLOCK, fcfg.in_size)),
                          dtype=torch.float32, device="cuda") for _ in range(3)]
    lanes = np.arange(FS_LANES)
    rows = {}
    for flash in (True, False):
        route = "kernel" if flash else "plain"
        srv = StreamingServer(kind="fs", cfg=dataclasses.replace(fcfg, use_flash_attn=flash),
                              model=model, n_lanes=FS_LANES, n_slots=C, capacity=FS_CAP,
                              device="cuda")
        srv.process_block(xs[0])                        # warm-up, then a fresh state
        srv.reset_lanes(lanes)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for x in xs:
            srv.process_block(x)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / len(xs)
        line = {"server": f"fs per-frame, {route} route", "lanes": FS_LANES,
                "K": FS_BLOCK, "sub_block": 125, "capacity": FS_CAP, "ms": ms,
                "frames_per_s": FS_LANES * FS_BLOCK / (ms / 1e3),
                "max_memory_allocated": torch.cuda.max_memory_allocated()}
        if flash:
            # the same three blocks from a fresh state under the profiler:
            # the kernel's device time against the rest of the block
            srv.reset_lanes(lanes)
            busy = device_ms_by_kernel(lambda: [srv.process_block(x) for x in xs], warm=False)
            kern = sum(v for k, v in busy.items() if k.startswith("ca::")) / len(xs)
            line.update(cached_attention_ms=kern, outside_kernels_ms=ms - kern,
                        device_busy_ms=sum(busy.values()) / len(xs),
                        top=top_kernels(busy, len(xs)))
            # the third block's kernel calls recorded (after the first two),
            # then those of the step() after it (K = 1)
            srv.reset_lanes(lanes)
            for x in xs[:2]:
                srv.process_block(x)
            calls, orig = {}, CA.cached_attention_perlane

            def rec(*a, **kw):
                calls[tuple(a[0].shape[:2])] = ([t.clone() if torch.is_tensor(t) else t for t in a], kw)
                return orig(*a, **kw)

            CA.cached_attention_perlane = rec
            try:
                srv.process_block(xs[2])
                srv.step(xs[0][:, 0])
            finally:
                CA.cached_attention_perlane = orig
            step_ms = cuda_ms(lambda: srv.step(xs[0][:, 0]), reps=20)
            log(json.dumps({"step": {"server": "fs per-frame", "lanes": FS_LANES,
                                     "ms": step_ms,
                                     "frames_per_s": FS_LANES / (step_ms / 1e3)},
                            "card": card}))
            profile_window(lambda: srv.step(xs[0][:, 0]), 5, card, "fs per-frame step()",
                           part="ca::")
            if PARENT:
                # bench.py's three blocks from a fresh state, then step() from
                # there, on the earlier B6 and on this tree's, in turns
                def three_blocks():
                    srv.reset_lanes(lanes)
                    for x in xs:
                        srv.process_block(x)

                def earlier(call):
                    return via(CA, "cached_attention_perlane",
                               PARENT["cached_attention_perlane"], call)

                in_turns("fs per-frame process_block, three 500-frame blocks",
                         earlier(three_blocks), three_blocks, 1, card)
                in_turns(f"fs per-frame step() {FS_LANES} lanes",
                         earlier(lambda: srv.step(xs[0][:, 0])),
                         lambda: srv.step(xs[0][:, 0]), 20, card, rounds=5)
        log(json.dumps({"process_block": line, "card": card}))
        del srv

    H, err = fcfg.n_heads, 0.0
    for label, (R, K) in (("decoder", (FS_LANES * C * H, 125)), ("encoder", (FS_LANES * H, 125)),
                          ("step() decoder", (FS_LANES * C * H, 1)),
                          ("step() encoder", (FS_LANES * H, 1))):
        args, _ = calls[(R, K)]
        got = CA.cached_attention_perlane(*args)
        torch.cuda.synchronize()
        err = max(err, compare(f"cached_attention_perlane[main path {label}]", [got],
                               [CA.cached_attention_perlane_plain(*args)], ("out",),
                               atol=TC_ATOL))
        lib = sdpa_call(args, "cached_attention_perlane")
        log(f"  sdpa vs plain: max abs diff "
            f"{(lib() - CA.cached_attention_perlane_plain(*args)).abs().max().item():.3e}")
        shape = (f"R={R} K={K} start={int(args[3][0])} min_pos={args[5]}")
        if PARENT:
            old = PARENT["cached_attention_perlane"]
            log(f"  earlier cached_attention_perlane vs this: max abs diff "
                f"{(old(*args) - got).abs().max().item():.3e}")
            in_turns(f"cached_attention_perlane {label} {shape}", lambda: old(*args),
                     lambda: CA.cached_attention_perlane(*args), 20, card)
        row = time_kernel("cached_attention_perlane", f"main path {label} {shape}",
                          CA.cached_attention_perlane, CA.cached_attention_perlane_plain,
                          args, {}, None, card, library=lib)
        if label == "decoder":
            rows["cached_attention_perlane"] = row
    rows["cached_attention_perlane"]["max_abs_err"] = err
    got = CA.cached_attention(*block_args)
    torch.cuda.synchronize()
    err = compare("cached_attention[main path encoder]", [got],
                  [CA.cached_attention_plain(*block_args)], ("out",), atol=TC_ATOL)
    lib = sdpa_call(block_args, "cached_attention")
    if PARENT:
        old = PARENT["cached_attention"]
        log(f"  earlier cached_attention vs this: max abs diff "
            f"{(old(*block_args) - got).abs().max().item():.3e}")
        in_turns(f"cached_attention R={block_args[0].shape[0]} K={block_args[0].shape[1]} "
                 f"start={int(block_args[3])}", lambda: old(*block_args),
                 lambda: CA.cached_attention(*block_args), 20, card)
    rows["cached_attention"] = dict(time_kernel(
        "cached_attention", f"main path encoder R={block_args[0].shape[0]} "
        f"K={block_args[0].shape[1]} start={int(block_args[3])}", CA.cached_attention,
        CA.cached_attention_plain, block_args, {}, None, card, library=lib), max_abs_err=err)
    return rows



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from fseend_tpu_torch.models import fs_eend, ls_eend

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
    for name in FRAME_SCAN_LEAVES:
        errs[name] = max(errs[name], rows[name].pop("max_abs_err"))
    train_rows, train_errs = phase_train_times(cfg, card, train_calls)
    rows.update(train_rows)
    for name in dec_errs:
        errs[name] = max(dec_errs[name], train_errs[name])
    del model
    torch.cuda.empty_cache()

    fcfg = fs_eend.FSEENDConfig()
    log(f"config: {fcfg}")
    fs_errs = phase_fs_kernels_vs_plain(fcfg, rng)
    fmodel = fs_make_model(fcfg, rng)
    launches["cached_attention_perlane"] = phase_fs_serve(fcfg, fmodel, rng)
    launches["cached_attention"], block_args = phase_fs_block_serve(fcfg, fmodel, rng, card)
    phase_fs_golden(fcfg)
    fs_rows = phase_fs_times(fcfg, fmodel, rng, card, block_args)
    for name, row in fs_rows.items():
        errs[name] = max(fs_errs[name], row.pop("max_abs_err"))
        rows[name] = row
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
        "cached_attention_perlane": ("fseend_tpu_torch/kernels/csrc/cached_attention.cu",
                                     "fseend_tpu/kernels/cached_attention_pallas.py:223"),
        "cached_attention": ("fseend_tpu_torch/kernels/csrc/cached_attention.cu",
                             "fseend_tpu/kernels/cached_attention_pallas.py:101"),
    }
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], "max_abs_err": errs[name], **rows[name]}
               for name, (src, rep) in sources.items()]
    log(f"total: {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
