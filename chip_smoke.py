#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`fseend_tpu_torch`) on one NVIDIA
GPU: builds the CUDA kernels from the sources in the checkout, holds each
kernel against its plain PyTorch version at the production width, drives
the port's three LS-EEND inference paths (per-frame streaming server,
blockwise streaming server, batch pass), its LS training path (the train
step and the epoch loop), FS-EEND serving (per-frame fast-block server,
blockwise server, the batch pass against the reference), FS-EEND training
(the reference's train golden, a production-width step, the epoch loop on
a Kaldi data directory), raw-audio serving (the device front end before
both blockwise servers) and EEND-EDA (its train step, the epoch loop on a
Kaldi data directory, FLEX-STB block streaming and the DER of what it
streams), and times the kernels, the servers and the steps.

    python3 chip_smoke.py            (--profile adds a torch.profiler window
                                      over the blockwise server's process_block;
                                      --parent DIR builds the cached_attention.cu,
                                      dec_train_fusion_{fwd,bwd}.cu,
                                      chunk_retention.cu and retention_layer.cu
                                      found in DIR, an earlier commit's
                                      kernels/csrc with PR 7's entry points
                                      (others are refused), times them against
                                      this tree's in turns, and holds B3's
                                      outputs to theirs bit for bit)
    python3 chip_smoke.py --one-pass (a control: phases 5 and 8 on a copy of
                                      the sources whose 3xTF32 product takes
                                      one TF32 pass; each check that fails is
                                      counted, not raised; prints no result)

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
     128, 256), the decoder shape (1280, 128, 256) and a batch decoder (20,
     1000, 256) in 500-frame chunks, two calls in a row; out / y within
     1e-4 (`compare_exact`), the new state within `checkpoint_atol`; each
     case's first call made twice, bit for bit
  6. blockwise serve: BlockStreamingServer(block=128) over 128 lanes on the
     "fused" route, streams of four lengths with per-lane h_mask tails and
     one flush, against the "plain" route and against the batch pass at
     chunk_size = 128; two lanes reset and served again, bit for bit;
     retention_layer launches counted, its largest call held against plain
  7. batch: ls_test on 2 recordings of 2900 frames, chunk_size 500, on the
     "core" route against the "plain" route; chunk_retention launches
     counted (4 encoder calls of 8 rows, 2 decoder calls of 80), the last
     call of each held against plain
  8. T1, fusion-layer kernels vs plain: the training forward and backward
     of one decoder layer at production width (D 256, H 4, F 2048, C 10),
     B 2, T 256, L 128, dropout 0 and 0.1: forward y within 1e-4, kvs and
     ss within `checkpoint_atol`, y without checkpoints the same bits;
     backward dx row by row within 1e-4 of the plain backward in float64
     (plus a row's own float32 error where that exceeds 1e-5,
     `compare_exact`), every weight gradient within
     2e-3 of its leaf max; at rate 0 the plain backward against torch
     autograd of the plain forward; two backward calls give the same bits
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
     it), both frame scans at K=1, the device time by kernel per call (over
     five profiled calls) of each frame scan, of both chunkwise kernels and
     of the fusion layer's forward and backward (the *_parts lines); with
     --parent, the earlier
     fusion-layer forward and backward (the same bits) and both chunkwise
     kernels at each of their main-path shapes against this tree's
     (earlier, this, this, earlier)
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
 17. F6, tests/goldens/fs_train_ref.npz (the reference's FS training run,
     B 2, T 16) through the port's state-dict reader on the card: step-0
     losses rtol 1e-4, every gradient atol 1e-5 + rtol 1e-3, its three Adam
     steps' losses rtol 2e-4, weights after them 1e-4, BatchNorm statistics
     1e-5
 18. F7, FS training at production width: configs/fs_simu.yaml's model
     (FSEENDConfig(), dropout 0.1) and Noam-Adam, batch 32 x 500 frames x
     4 speakers of synthetic features from the seed, 4 steps (finite
     losses, moving BatchNorm statistics), then the step timed (CUDA
     events), its peak memory and a torch.profiler window
 19. A1, run_training(TaskConfig(model="fs")) at FSEENDConfig() width on a
     Kaldi data directory synthesized with the stdlib wave (4 recordings of
     40 s, 2-3 speakers, a piped wav.scp entry): DiarizationDataset for
     training and validation, 2 epochs of 2 steps at batch 4 x 200 frames;
     the last checkpoint reloaded through load_fs_eend bit for bit
 20. A2, raw-audio serving: RawAudioPipeline over
     BlockStreamingServer(kind="ls") (128 lanes, K 128, "fused" route:
     retention_layer) and over BlockStreamingServer(kind="fs") (64 lanes,
     K 128, capacity 2048, kernel route: cached_attention), 8 kHz audio
     from the seed in blocks of K x 80 x 10 samples, three blocks and a
     ragged remainder: the streamed features within 2e-4 of the host
     pipeline, the probabilities within 1e-3 of the same server fed the
     host features, each kernel launched on this path (counted from 0) and
     its last call held against plain; the front end's ms per audio block
     alone and the pipeline's (CUDA events)
 21. E1, the EEND-EDA train step at configs/eda_offline.yaml (read by the
     port's utils/config.py: EDAConfig(in 345, 256 units, 4 heads, 4
     layers, FFN 2048, dropout 0.1), Noam-Adam, batch 32 x 500 frames x 4
     speakers of synthetic features from the seed): the loss and every
     gradient at dropout 0 within atol 1e-5 + rtol 1e-3 of the same pass
     on the CPU (4 of the 32 samples); 3 steps with finite losses; two
     seeded steps at dropout 0.1 the same bits; the step and the attractor
     LSTMs' forward + backward timed in turns (their share of the step),
     peak memory, a torch.profiler window over each (device busy, kernels)
 22. E2, run_training(TaskConfig(model="eda")) on a Kaldi directory of 3
     recordings of 150 s (500-frame chunks, batch 4, 2 epochs), the last
     checkpoint reloaded through load_eend_eda bit for bit; FlexSTB with
     configs/stb.yaml's buffer 1000, block 100 and "v1" weights over a
     1,500-frame recording with the trained model (two runs the same bits;
     ms per block, the real-time factor), its "fifo" probabilities within
     1e-3 of the model on the CPU, the scorer and its LSTMs at buffer +
     block timed in turns, eda_test on stb.yaml's 10,000-frame chunk
 23. E3, E2's probabilities through make_rttm and read_rttm (the turns
     written read back), der_components against the directory's turns
     (segments, utt2spk) with a 0.5 s collar, the reference against itself
     DER 0, score_frames on the 100 Hz labels, oracle-SAD rescoring

The last line is {"ok": true, "device": {...}}; the kernels' JSON line and
the timing lines come before it.  E1-E3 launch none of the port's kernels
(the JAX package has no Pallas kernel on EEND-EDA's path).  Float32 throughout, TF32 off.  Every
kernel but the per-lane cached attention at K = 1 runs its products on the
tensor cores, and every kernel is held within 1e-4 of its plain version
(the fusion layer's forward on y, its backward on dx, the chunkwise kernels
on out and y), carried states within `checkpoint_atol`; the chunkwise
kernels' out and y and the fusion layer's dx at T1 row by row against the
plain version in float64, with a row's own float32 error (sampled at the
inputs and three nudged copies) added only where that exceeds 1e-5
(`compare_exact`).  `--one-pass` shows that a build whose products take one
TF32 pass fails these checks.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import shutil
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
# float32 with another summation order, over 64 frames of 4 encoder / 2
# decoder layers (a wrong gate or term shows at O(0.1)): the guard the
# FMA-pipe kernels had, now the plain backward against autograd and the cap
# of `checkpoint_atol`
KERNEL_ATOL = 1e-3
# every kernel's products run on the tensor cores in three TF32 passes
# (csrc/tc_f32.cuh): against their plain versions float32-exact to ~1e-6
# relative, so held at 1e-4 (the fusion layer's backward on dx; its weight
# gradients at GRAD_RTOL; carried states at `checkpoint_atol`)
TC_ATOL = 1e-4
# `compare_exact`: a row whose float32 plain version is off float64 by more
# than this (at the call's inputs or at one of COND_SAMPLES nudged copies)
# is ill-conditioned in float32
COND_ATOL, COND_SAMPLES = 1e-5, 3
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
PARTS_REPS = 5                               # calls profiled for each *_parts line
FS_GOLDEN_ATOL = 1e-4                        # tests/test_torch_convert.py:85-95 drift 2.3e-5
# F7: configs/fs_simu.yaml's batch 32 x 500-frame chunks, 4 speakers (6 slots)
FS_TRAIN_B, FS_TRAIN_T, FS_TRAIN_SPK, FS_TRAIN_STEPS = 32, 500, 4, 4
# A1: a Kaldi directory of 4 recordings of 40 s, chunks of 200 frames, batch 4
KALDI_RECS, KALDI_DUR, KALDI_CHUNK, KALDI_B = 4, 40.0, 200, 4
# A2: audio blocks of one model block (K x 80 x 10 samples), and a ragged end
RAW_BLOCKS, RAW_RAGGED = 3, 12_345
# E1-E3: configs/eda_offline.yaml's model and batch, configs/stb.yaml's
# buffer and block.  E1: steps timed and checked; its gradients against the
# CPU on the first EDA_CPU_B samples of the batch (the CPU's share of the run)
EDA_TRAIN_STEPS, EDA_CPU_B = 3, 4
# E2: 3 recordings of 150 s (1,500 frames: the 1,000-frame buffer overflows
# from the 11th 100-frame block on), trained at batch 4; eda_test on
# stb.yaml's chunk_size
EDA_KALDI_RECS, EDA_KALDI_DUR, EDA_KALDI_B = 3, 150.0, 4
# E3: the reference's collar, 250 ms each side of a boundary
EDA_COLLAR_S = 0.5
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
                       "dec_train_fusion_bwd", "chunk_retention", "retention_layer")


def checkpoint_atol(want):
    """A carried retention state (the fusion-layer forward's checkpoints kvs,
    ss; the chunkwise kernels' new kv and scale) against plain: sums over a
    chunk's frames whose size grows with the chunk, so TC_ATOL times their
    leaf's max |value| where that exceeds 1, and never looser than
    KERNEL_ATOL."""
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
# entry points as PR 7 had them, recognised by these signatures (B3, B6 and
# B7 as this tree's; the chunkwise kernels without scratch, B4 on weights
# in torch's (out, in) layout)
PARENT_SOURCES = {
    "cached_attention": ({"CA_HD": FS_HD}, (
        "const int* start, float* out, float* part, int R, int K, int cap, int rows_per_lane, "
        "int min_pos, void* stream",
        "const int* start, float* out, int R, int K, int cap, void* stream")),
    "dec_train_fusion_fwd": (DTF, ("dtf_forward(const float* x, const float* tqkvg, "
                                   "const float* bqkvg",)),
    "dec_train_fusion_bwd": (DTF, ("unsigned seed, unsigned thr, float mult, void* stream_",)),
    "chunk_retention": (HEAD, ("float* kvf, float* sf, int BH, int T, int L, void* stream)",)),
    "retention_layer": (HEAD, ("float* ws, float* y, const float* kv0",)),
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
    the port's wrapper signatures.  B3, B6 and B7 run this tree's wrappers
    on the earlier libraries (same entry points; their launch counts move,
    after the main path's were read); the chunkwise kernels get callables
    of their own (no launch counts)."""
    from fseend_tpu_torch.kernels import _build
    from fseend_tpu_torch.kernels import cached_attention as CA
    from fseend_tpu_torch.kernels import dec_train_fusion as DT

    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"earlier {name}.cu: nvcc exit {proc.returncode}\n{out}")
        libs[name] = ctypes.CDLL(str(lib))
        libs[name].fs_error_string.argtypes = [ctypes.c_int]
        libs[name].fs_error_string.restype = ctypes.c_char_p
    P, I, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

    def on(name, fn):
        """fn, with the wrappers' library loads answered by the earlier one"""
        def call(*a, **kw):
            return via(_build, "load", lambda *_, **__: libs[name], lambda: fn(*a, **kw))()
        return call

    def entry(lib, fn, argtypes):
        f = getattr(libs[lib], fn)
        f.argtypes, f.restype = argtypes, ctypes.c_int
        return f

    cret = entry("chunk_retention", "chunk_retention_launch", [P] * 9 + [I] * 3 + [P])
    rlay = entry("retention_layer", "retention_layer_launch", [P] * 12 + [I] * 4 + [F32, P])

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def check(what, err):
        if err:
            raise RuntimeError(f"earlier {what}: CUDA error {err}")

    def ptrs(ts):
        return [t.data_ptr() for t in ts]

    def chunk_retention(gammas, q, k, v, kv0, s0, chunk):
        BH, T, _ = q.shape
        gammas, q, k, v, kv0, s0 = (t.contiguous() for t in (gammas, q, k, v, kv0, s0))
        out = torch.empty_like(v)
        kv_f, s_f = torch.empty_like(kv0), torch.empty_like(s0)
        check("chunk_retention", cret(*ptrs((gammas, q, k, v, out, kv0, s0, kv_f, s_f)), BH, T,
                                      chunk, stream()))
        return out, kv_f, s_f

    def retention_layer(gammas, x, w, kv0, s0, chunk):
        """`w` in torch's (out, in) layout (`torch_layout`), as PR 7 took it."""
        B, T, D = x.shape
        H = gammas.shape[0]
        gammas, x, kv0, s0 = (t.contiguous() for t in (gammas, x, kv0, s0))
        ws = x.new_empty(B * T, w.wqkvg.shape[0])
        y = torch.empty_like(x)
        kv_f, s_f = torch.empty_like(kv0), torch.empty_like(s0)
        check("retention_layer", rlay(*ptrs((gammas, x, *w, ws, y, kv0, s0, kv_f, s_f)), B, T,
                                      chunk, H, (D // H) ** -0.5, stream()))
        return y, kv_f, s_f

    # the launch functions themselves (the T3 step swaps them for these)
    launch_fwd, launch_bwd = DT._launch_fwd, DT._launch_bwd

    def fusion_layer_fwd(x, w, seed, n_heads, chunk, rate, checkpoints=True, wt=None):
        return launch_fwd(x, w, seed, n_heads, chunk, rate, checkpoints, wt)

    PARENT.update(dec_train_fusion_fwd=on("dec_train_fusion_fwd", fusion_layer_fwd),
                  dec_train_fusion_bwd=on("dec_train_fusion_bwd", launch_bwd),
                  cached_attention=on("cached_attention", CA.cached_attention),
                  cached_attention_perlane=on("cached_attention", CA.cached_attention_perlane),
                  chunk_retention=chunk_retention, retention_layer=retention_layer)


def torch_layout(w):
    """A retention layer's weights in torch's (out, in) layout, for PR 7's
    retention_layer.cu."""
    return type(w)(w.wqkvg.T.contiguous(), w.bqkvg, w.wo.T.contiguous(), w.bo)


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


def capture_kernel_inputs(fn, targets=None, key=lambda name, args: name):
    """Run fn() with the kernel wrappers `targets` ((module, name) pairs,
    default the two frame scans) wrapped so that each call's arguments are
    cloned before the kernel runs (the frame scans update their state in
    place).  Keeps the last call under each key(name, args) (default: the
    wrapper's name)."""
    got = {}

    def wrap(mod, name):
        orig = getattr(mod, name)

        def wrapped(*args, **kw):
            got[key(name, args)] = (clone_args(args), kw)
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


def nudged(args, seed):
    """`args` with every float tensor (and every weight of a packed tuple)
    moved by one unit in the last place, up or down at random per element:
    a nearby input of the same float32 function."""
    def nudge(t):
        if not (torch.is_tensor(t) and t.is_floating_point()):
            return t
        g = torch.Generator(device=t.device).manual_seed(seed)
        up = torch.randint(0, 2, t.shape, generator=g, device=t.device).bool()
        return torch.nextafter(t, torch.where(up, torch.inf, -torch.inf).to(t.dtype))
    return [type(a)(*(nudge(t) for t in a)) if isinstance(a, tuple) else nudge(a)
            for a in args]


def compare_exact(label, got, fn, args, atol=TC_ATOL):
    """A kernel's output `got` against its plain version `fn` on `args`
    evaluated in float64, row by row (a row: one frame's features, the last
    axis).  A row is ill-conditioned where float32 evaluation is itself off
    float64 by more than COND_ATOL: its own error, the largest
    |fn in float32 - fn in float64| over `args` and COND_SAMPLES nudged
    copies of them (one sample can cancel by luck).  On every other row --
    nearly all -- the kernel is held within `atol` of float64; on an
    ill-conditioned row -- a group norm over a head whose core output is
    near zero, at the first frame from a fresh state (B4's y; B3's dx
    through its gate) -- within `atol` plus that row's own error.  Returns
    the difference from fn in float32."""
    def rows(t):
        return t.double().flatten(0, -2)

    want = fn(*args)
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: shape {tuple(got.shape)} vs {tuple(want.shape)} "
                             f"or non-finite values")
    exact = rows(fn(*in_float64(args)))
    err = (rows(got) - exact).abs().amax(-1)
    own = (rows(want) - exact).abs().amax(-1)
    for seed in range(COND_SAMPLES):
        near = nudged(args, seed)
        own = torch.maximum(own, (rows(fn(*near)) - rows(fn(*in_float64(near)))).abs().amax(-1))
    ill = own > COND_ATOL
    tol = torch.where(ill, atol + own, torch.full_like(own, atol))
    err32 = (got - want).abs().max().item()
    well = err[~ill].max().item() if (~ill).any() else 0.0
    line = (f"  {label}: max abs diff {err32:.3e} from plain; from plain in float64 "
            f"{well:.3e} on {int((~ill).sum())} well-conditioned rows (tol {atol:g})")
    if ill.any():
        j = int(torch.where(ill, err - tol, -1.0).argmax())
        line += (f", on {int(ill.sum())} ill-conditioned rows up to {err[ill].max().item():.3e}"
                 f" (the nearest its bound {err[j].item():.3e}, tol {atol:g} + float32's own "
                 f"{own[j].item():.3e})")
    log(line + f"; plain's max |value| {want.abs().max().item():.3g}")
    j = int((err - tol).argmax())
    if not err[j] <= tol[j]:
        raise AssertionError(f"{label}: row {j} differs from plain in float64 by "
                             f"{err[j].item():.3e} > {tol[j].item():.3e} (float32's own "
                             f"{own[j].item():.3e})")
    return err32


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


def in_float64(args):
    """A chunkwise kernel's arguments with every tensor (and every weight of
    a packed tuple) in float64."""
    return [type(a)(*(t.double() for t in a)) if isinstance(a, tuple)
            else a.double() if torch.is_tensor(a) else a for a in args]


def compare_chunk_kernel(name, args, label):
    """One chunkwise kernel and its plain version on the same arguments
    (neither writes to them) -> (max abs diff, the plain version's results):
    out (y) by `compare_exact`, the new state within `checkpoint_atol`."""
    _, kern, plain = chunk_kernels()[name]
    got = kern(*args)
    torch.cuda.synchronize()
    want = plain(*args)
    lab = "out" if name == "chunk_retention" else "y"
    err = compare_exact(f"{name}[{label}].{lab}", got[0], lambda *a: plain(*a)[0], args)
    return max(err, compare(f"{name}[{label}]", got[1:], want[1:], ("kv", "scale"),
                            atol=(checkpoint_atol(want[1]), checkpoint_atol(want[2])))), want


def same_bits_chunk(name, args, label):
    """Two calls of a chunkwise kernel on the same arguments: the same bits
    (no atomics; the chunks' state is scanned in a fixed order)."""
    _, kern, _ = chunk_kernels()[name]
    got, again = kern(*args), kern(*args)
    torch.cuda.synchronize()
    for leaf, a, b in zip(("out", "kv", "scale"), got, again):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}[{label}]: a second call gives other bits in {leaf} "
                                 f"(max {(a - b).abs().max().item():.3e})")
    log(f"  {name}[{label}]: a second call gives the same bits")


def with_route(model, kernel, **changes):
    """The same weights under a config with another chunkwise route."""
    from fseend_tpu_torch.models import ls_eend

    return ls_eend.with_cfg(model, dataclasses.replace(model.cfg, kernel=kernel, **changes))


def phase_chunk_kernels_vs_plain(cfg, model, rng):
    """Both chunkwise kernels at production width, each case two calls in a
    row, the second from the state the first left; the first call of each
    case made twice, bit for bit."""
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
                label = f"BH={BH} T={T} L={L} {glabel} call {call}"
                err, (_, kv, sc) = compare_chunk_kernel("chunk_retention", args, label)
                errs["chunk_retention"] = max(errs["chunk_retention"], err)
                if call == 0:
                    same_bits_chunk("chunk_retention", args, label)
            log(f"  carried scale max {sc.max().item():.2f}")
    # the two blockwise shapes (one chunk a call), and the decoder of a batch
    # pass on the "fused" route (2 recordings x 10 slots, two 500-frame chunks)
    for label, B, T, L, ret in (("encoder", LANES, BLOCK, BLOCK, model.enc.blocks[0].ret),
                                ("decoder", LANES * SLOTS, BLOCK, BLOCK,
                                 model.dec.layers[0].time_ret),
                                ("batch decoder", 2 * SLOTS, 1000, 500,
                                 model.dec.layers[0].time_ret)):
        # four times the initial weights, so that the clamped renormalizers
        # and the carried scale are above 1 as after training
        w = RL.pack_retention(ret)
        w = w._replace(wqkvg=w.wqkvg * 4)
        for glabel, gam in (("gamma=1", torch.ones(H, device="cuda")), ("gamma<1", decay)):
            st = R.chunk_state_init(rc, B, device="cuda")
            kv, sc = st["kv"], st["scale"]
            for call in range(2):
                args = (gam, randn(rng, B, T, cfg.n_units), w, kv, sc, L)
                clabel = f"{label} B={B} T={T} L={L} {glabel} call {call}"
                err, (_, kv, sc) = compare_chunk_kernel("retention_layer", args, clabel)
                errs["retention_layer"] = max(errs["retention_layer"], err)
                if call == 0:
                    same_bits_chunk("retention_layer", args, clabel)
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
    # the last call of each row count: the encoder's layers and the decoder's
    got = capture_kernel_inputs(
        lambda: res.update(ls_eend.ls_test(with_route(model, "core", chunk_size=BATCH_CHUNK),
                                           xs, lens)),
        [(CR, "chunk_retention")], key=lambda name, args: args[1].shape[0])
    calls = {BH: args for BH, (args, _) in got.items()}
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
    err = 0.0
    for BH in sorted(calls):
        args = calls[BH]
        e, _ = compare_chunk_kernel(
            "chunk_retention", args,
            f"main path, the last {'decoder' if BH > len(BATCH_LENS) * cfg.n_heads else 'encoder'}"
            f" call {tuple(args[1].shape)}")
        err = max(err, e)
    # the decoder's call (the most rows) makes the kernels line; the
    # encoder's (8 rows) is timed beside it
    return launches, err, calls


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


def compare_grads(label, got, want, dx_atol=TC_ATOL, dx_of=None):
    """(dx, weight gradients) against a reference: dx within dx_atol (of
    the plain dx `dx_of` = (fn, args) in float64, row by row,
    `compare_exact`, where given), each weight gradient within GRAD_RTOL of
    its leaf max.  Returns the largest absolute difference."""
    from fseend_tpu_torch.kernels import dec_train_fusion as DT

    (dx, dw), (dx_r, dw_r) = got, want
    if dx_of is None:
        worst = compare(label, [dx], [dx_r], ("dx",), atol=dx_atol)
    else:
        worst = compare_exact(f"{label}.dx", dx, *dx_of, atol=dx_atol)
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


def fusion_dx_plain(x, dy, w, seed, n_heads, chunk, rate):
    """dx of the fusion layer's plain backward from the plain forward's
    checkpoints, in the arguments' dtype."""
    from fseend_tpu_torch.kernels import dec_train_fusion as DT

    _, kvs, ss = DT.fusion_layer_fwd_plain(x, w, seed, n_heads, chunk, rate)
    return DT.fusion_layer_bwd_plain(x, dy, kvs, ss, w, seed, n_heads, chunk, rate)[0]


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
            f"dec_train_fusion_bwd[rate={rate}]", got, plain,
            dx_of=(fusion_dx_plain, (x, dy, *args))))
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


def core_reread_bytes(BH, T, L, dk, dv):
    """What chunk_retention_tc.cuh moves beyond reading q, k, v and the state
    once and writing the output and the new state once: the state pass
    reads k and v again, the output pass reads each k/v tile once for every
    64-query tile at or after it, and with more than one chunk the chunks'
    summaries are written, scanned (read and written) and read by every
    query tile of their chunk."""
    nqt, N = -(-L // 64), T // L
    rows = BH * T * (dk + dv) * 4 * (nqt + 1) / 2       # (a) once, (c) (nqt + 1) / 2 times
    scan = BH * N * dk * dv * 4 * (3 + nqt) if N > 1 else 0
    return rows + scan


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
        design = nbytes + core_reread_bytes(BH, T, L, dk, dv)
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
        Fv = w.wo.shape[0]
        dv = Fv // H
        flops = B * T * (2 * D * (2 * D + 2 * Fv) + 2 * Fv * D
                         + H * ((L + 1) * (dk + dv) + 4 * dk * dv))
        nbytes += (x.numel() + kv0.numel() + s0.numel()) * 4         # y + state out
        # q | k | v | g written once and read by the core, g written again
        # and read again, and the core's own re-reads
        design = (nbytes + B * T * (2 * (2 * D + 2 * Fv) + 2 * Fv) * 4
                  + core_reread_bytes(B * H, T, L, dk, dv))
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
    return line


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
    from fseend_tpu_torch.kernels import chunk_retention as CR
    from fseend_tpu_torch.kernels import retention_layer as RL
    from fseend_tpu_torch.models import ls_eend
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
        # where the scan's time goes: device time by kernel per call
        a = clone_args(got[name][0])
        busy = device_ms_by_kernel(lambda: getattr(mod, name)(*a, **got[name][1]),
                                   reps=PARTS_REPS)
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
    # kernels line), the LS encoder's calls beside them, then the other
    # production shapes; with --parent each row of PERF.md's table also
    # against PR 7's kernel in turns, and one decoder call of each kernel by
    # kernel (the *_parts lines)
    rc = cfg.ret_cfg
    dk, dv, H = rc.key_dim, rc.head_dim, rc.num_heads
    st = R.chunk_state_init(rc, LANES, device="cuda")
    rl_dec = main_path_args["retention_layer"]
    rl_enc = (rl_dec[0], rl_dec[1][:LANES].contiguous(), rl_dec[2], st["kv"], st["scale"], BLOCK)
    cr_calls = main_path_args["chunk_retention"]

    def cr_args(BH, T, L):
        return (torch.ones(BH, device="cuda"),
                *(torch.as_tensor(rng.standard_normal((BH, T, d)) * s, dtype=torch.float32,
                                  device="cuda")
                  for d, s in ((dk, 1.0), (dk, dk ** -0.5), (dv, 1.0))),
                torch.zeros(BH, dk, dv, device="cuda"), torch.ones(BH, 1, 1, device="cuda"), L)

    table = [("retention_layer", "main path decoder", rl_dec, True),
             ("retention_layer", "encoder", rl_enc, True),
             ("chunk_retention", "main path batch decoder", cr_calls[max(cr_calls)], True),
             ("chunk_retention", "main path batch encoder", cr_calls[min(cr_calls)], True),
             ("chunk_retention", "", cr_args(LANES * SLOTS * H, BLOCK, BLOCK), True),
             ("chunk_retention", "", cr_args(LANES * H, 1000, 500), False),
             ("chunk_retention", "", cr_args(LANES * H, BLOCK, BLOCK), False)]
    enc_row = None
    for name, label, args, compared in table:
        _, kern, plain = chunk_kernels()[name]
        shape = f"{label} {tuple(args[1].shape)} L={args[-1]}".strip()
        row = time_kernel(name, shape, kern, plain, args, {}, cfg, card, plain_reps=3)
        if label.startswith("main path decoder") or label.startswith("main path batch decoder"):
            rows[name] = row
        if name == "retention_layer" and label == "encoder":
            enc_row = row
        if PARENT and compared:
            old = PARENT[name]
            old_args = args if name == "chunk_retention" else (*args[:2], torch_layout(args[2]),
                                                               *args[3:])
            diff = max((a - b).abs().max().item() for a, b in zip(old(*old_args), kern(*args)))
            log(f"  earlier {name} vs this [{shape}]: max abs diff {diff:.3e}")
            in_turns(f"{name} {shape}", lambda: old(*old_args), lambda: kern(*args), 5, card)
    for name, args in (("retention_layer", rl_dec), ("chunk_retention", cr_calls[max(cr_calls)])):
        kern = chunk_kernels()[name][1]
        versions = [("this", kern, args)]
        if PARENT:
            versions.insert(0, ("earlier", PARENT[name], args if name == "chunk_retention" else
                                (*args[:2], torch_layout(args[2]), *args[3:])))
        for which, fn, a in versions:
            busy = device_ms_by_kernel(lambda: fn(*a), reps=PARTS_REPS)
            log(json.dumps({f"{name}_parts": {
                "kernel": which, "shape": f"{tuple(a[1].shape)} L={a[-1]}",
                "device_busy_ms": sum(busy.values()), "top": top_kernels(busy, 1)},
                "card": card}))

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
        if kernel == "fused" and PARENT:
            # the same blocks on PR 7's retention layer (its weights in torch's
            # layout, made once per packed layer)
            layouts = {}

            def earlier_layer(gammas, x, w, kv0, s0, chunk):
                if w.wqkvg.data_ptr() not in layouts:
                    layouts[w.wqkvg.data_ptr()] = torch_layout(w)
                return PARENT["retention_layer"](gammas, x, layouts[w.wqkvg.data_ptr()], kv0,
                                                 s0, chunk)

            in_turns("blockwise process_block, fused route",
                     via(RL, "retention_layer", earlier_layer, lambda: bsrv.process_block(xb)),
                     lambda: bsrv.process_block(xb), 5, card, rounds=2)
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
    if PARENT:
        # phase 7's ls_test on the "core" route, on PR 7's chunkwise core
        xt = torch.as_tensor(rng.standard_normal((len(BATCH_LENS), BATCH_T, cfg.in_size)),
                             dtype=torch.float32, device="cuda")
        lens = torch.as_tensor(BATCH_LENS, device="cuda")
        core = with_route(model, "core", chunk_size=BATCH_CHUNK)

        def batch():
            ls_eend.ls_test(core, xt, lens)

        in_turns(f"ls_test, core route, {len(BATCH_LENS)} x {BATCH_T} frames",
                 via(CR, "chunk_retention", PARENT["chunk_retention"], batch), batch, 3, card,
                 rounds=2)
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
    # where each direction's time goes: device time by kernel per call
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
            busy = device_ms_by_kernel(lambda: fn(*args, **kw), reps=PARTS_REPS)
            log(json.dumps({f"{name}_parts": {
                "kernel": which, "device_busy_ms": sum(busy.values()),
                "top": top_kernels(busy, 1, n=16)}, "card": card}))
        if PARENT:
            # B3 keeps the parent's core: the same bits in every output
            old = PARENT[name]
            a, b = old(*args, **kw), this(*args, **kw)
            leaves = ([a[0], *a[1]], [b[0], *b[1]]) if name.endswith("bwd") else (a, b)
            for j, (x, y) in enumerate(zip(*leaves)):
                if not torch.equal(x, y):
                    raise AssertionError(f"earlier {name} vs this: output {j} differs by "
                                         f"{(x - y).abs().max().item():.3e}")
            log(f"  earlier {name} vs this: all {len(leaves[0])} outputs bit for bit")
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


def device_ms_by_kernel(fn, warm=True, reps=1):
    """Device time by kernel name per call of fn(), from `reps` calls under
    torch.profiler (after one outside it, if `warm`): each kernel's mean
    time per launch times its launches per call (its count over reps,
    rounded).  The tracer can miss the first launches of its window, so a
    call of a few launches wants a few reps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / e.count * max(1, round(e.count / reps))
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.count}


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
            calls = capture_kernel_inputs(
                lambda: (srv.process_block(xs[2]), srv.step(xs[0][:, 0])),
                [(CA, "cached_attention_perlane")], key=lambda name, a: tuple(a[0].shape[:2]))
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


# ---------------------------------------------------------------------------
# FS-EEND training, training from a Kaldi data directory, raw-audio serving
# ---------------------------------------------------------------------------


def _allclose(label, got, want, atol, rtol=0.0):
    """|got - want| <= atol + rtol |want| elementwise (numpy's rule); returns
    the worst |got - want| / (atol + rtol |want|)."""
    ratio = ((got - want).abs() / (atol + rtol * want.abs())).max().item()
    if not (torch.isfinite(got).all() and ratio <= 1.0):
        raise AssertionError(f"{label}: differs by {ratio:.3f} of atol {atol:g} + rtol {rtol:g}")
    return ratio


def phase_fs_train_golden():
    """F6: the reference's own FS training run (tests/goldens/fs_train_ref.npz:
    the golden's small model, B 2, T 16, dropout 0) on the card through the
    port's state-dict reader: step-0 losses within rtol 1e-4 and every
    gradient within atol 1e-5 + rtol 1e-3 (tests/test_train_parity.py:80-99);
    then its three Adam steps through make_train_step: losses within rtol
    2e-4, the post-step weights within 1e-4 and BatchNorm statistics within
    1e-5."""
    from fseend_tpu_torch.models import fs_eend
    from fseend_tpu_torch.train import optim
    from fseend_tpu_torch.train import trainer as TRN
    from fseend_tpu_torch.utils import torch_convert as TC

    g = np.load(Path(__file__).resolve().parent / "tests" / "goldens" / "fs_train_ref.npz")

    def sub(prefix):
        return {k[len(prefix):]: g[k] for k in g.files if k.startswith(prefix)}

    sd, gr, sdN, steps = sub("sd__"), sub("gr__"), sub("sdN__"), g["steps"]
    gcfg = fs_eend.FSEENDConfig(in_size=23, n_units=32, n_heads=4, enc_n_layers=2,
                                dec_n_layers=2, enc_dim_feedforward=2048,
                                dec_dim_feedforward=64, conv_delay=9, max_nspks=5, dropout=0.0)
    batch = {k: torch.as_tensor(g[k], device="cuda") for k in ("feats", "labels", "lens", "n_spk")}
    task = TRN.TaskConfig(model="fs", label_mode="fixed")
    model = TC.fs_from_state_dict(sd, gcfg, "cuda")
    loss, (_, metrics) = TRN.compute_loss(task, model, batch, None, train=True)
    loss.backward()
    for i, k in enumerate(("pit_loss", "emb_loss", "tot_loss")):
        _allclose(f"fs train golden step 0 {k}", metrics[k].double().cpu(),
                  torch.tensor(float(steps[0][i]), dtype=torch.float64), 0.0, 1e-4)
    full = {k: np.zeros_like(v) for k, v in sd.items()}
    full.update(gr)
    ref = dict(TC.fs_from_state_dict(full, gcfg, "cuda").named_parameters())
    # norm12 is allocated and unused (as in the reference): no gradient, the
    # reference's is zero
    worst = max(_allclose(f"fs train golden: gradient of {name}",
                          p.grad if p.grad is not None else torch.zeros_like(p),
                          ref[name].detach(), 1e-5, 1e-3)
                for name, p in model.named_parameters())
    tx = optim.Optimizer("adam", 1e-3)            # torch.optim.Adam's defaults, the golden's
    model = TC.fs_from_state_dict(sd, gcfg, "cuda")
    state = TRN.TrainState.create(model, tx)
    step = TRN.make_train_step(task, gcfg, tx)
    traj = []
    for i in range(steps.shape[0]):
        state, metrics = step(state, batch, 0)
        traj.append([float(metrics[k]) for k in ("pit_loss", "emb_loss", "tot_loss")])
        _allclose(f"fs train golden step {i} losses", torch.tensor(traj[-1], dtype=torch.float64),
                  torch.as_tensor(steps[i], dtype=torch.float64), 0.0, 2e-4)
    want = TC.fs_from_state_dict(sdN, gcfg, "cuda").state_dict()
    for name, t in model.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            _allclose(f"fs train golden after {steps.shape[0]} steps: {name}", t, want[name],
                      1e-5 if "running_" in name else 1e-4)
    log(f"F6 fs train golden (fs_train_ref.npz, B {tuple(batch['feats'].shape)}): step-0 "
        f"losses within rtol 1e-4, {len(ref)} gradient leaves, worst at {worst:.3f} of "
        f"atol 1e-5 + rtol 1e-3; {steps.shape[0]} Adam steps' losses {traj} (reference "
        f"{steps.tolist()}), weights and BatchNorm statistics after them within 1e-4 / 1e-5")


def phase_fs_train(fcfg, card):
    """F7: one FS train step at production width (configs/fs_simu.yaml's
    model: FSEENDConfig(), dropout 0.1; Noam-Adam, lr 1, warm-up 100000,
    clip 5) on a batch of FS_TRAIN_B x FS_TRAIN_T frames x FS_TRAIN_SPK
    speakers of synthetic features and labels from the seed: FS_TRAIN_STEPS
    steps with finite losses and moving BatchNorm statistics, then the step
    timed (CUDA events), its peak memory, and a torch.profiler window."""
    from fseend_tpu_torch.data.loader import pad_collate
    from fseend_tpu_torch.models import fs_eend
    from fseend_tpu_torch.train import optim
    from fseend_tpu_torch.train import trainer as TRN

    tcfg = dataclasses.replace(fcfg, dropout=0.1)
    task = TRN.TaskConfig(model="fs", label_mode="fixed")
    tx = optim.build_optimizer("noam", 1.0, d_model=fcfg.n_units, warmup_steps=100_000,
                               grad_clip=5.0)
    data = SyntheticSpeech(FS_TRAIN_B, SEED + 2, FS_TRAIN_T, fcfg.in_size, FS_TRAIN_SPK)
    batch = pad_collate([data[i] for i in range(FS_TRAIN_B)], FS_TRAIN_T, FS_TRAIN_SPK,
                        fcfg.in_size)
    batch.pop("recs")
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    model = fs_eend.init_fs_eend(tcfg, torch.Generator().manual_seed(SEED), device="cuda")
    state = TRN.TrainState.create(model, tx)
    step = TRN.make_train_step(task, tcfg, tx)
    bn0 = (model.enc.bn.running_mean.clone(), model.enc.bn.running_var.clone())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = []
    for _ in range(FS_TRAIN_STEPS):
        state, metrics = step(state, batch, SEED)
        losses.append(float(metrics["tot_loss"]))
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if not np.isfinite(losses).all():
        raise AssertionError(f"fs train losses {losses}")
    moved = [float((a - b).abs().max()) for a, b in
             zip((model.enc.bn.running_mean, model.enc.bn.running_var), bn0)]
    if not min(moved) > 0:
        raise AssertionError(f"fs train: the BatchNorm statistics did not move {moved}")
    ms = cuda_ms(lambda: step(state, batch, SEED), reps=3)
    line = {"model": "fs", "B": FS_TRAIN_B, "T": FS_TRAIN_T, "speakers": FS_TRAIN_SPK,
            "slots": FS_TRAIN_SPK + 2, "dropout": tcfg.dropout, "ms": ms,
            "frames_per_s": FS_TRAIN_B * FS_TRAIN_T / (ms / 1e3),
            "first_steps_s": secs, "losses": losses, "bn_moved": moved,
            "max_memory_allocated": peak}
    log(f"F7 fs train: {FS_TRAIN_STEPS} steps of {FS_TRAIN_B} x {FS_TRAIN_T} frames x "
        f"{FS_TRAIN_SPK} speakers in {secs:.2f} s, losses {[round(v, 4) for v in losses]}, "
        f"BatchNorm statistics moved by {moved}")
    log(json.dumps({"train_step": line, "card": card}))
    profile_window(lambda: step(state, batch, SEED), 2, card, "fs train step")


def write_wav(path, x, sr=8000):
    import wave

    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())


def make_kaldi_dir(path, rng, n_recs, dur, sr=8000):
    """A Kaldi data directory (wav.scp, segments, utt2spk, reco2dur) of
    `n_recs` mixtures of 2-3 harmonic "speakers" talking in turns over a
    noise floor, written with the stdlib `wave` (as tools/make_simu_data.py
    does); the second recording's wav.scp entry is a pipe."""
    path.mkdir(parents=True)
    n = int(sr * dur)
    t = np.arange(n) / sr
    files = {k: [] for k in ("wav.scp", "segments", "utt2spk", "reco2dur")}
    for r in range(n_recs):
        rec = f"rec{r}"
        audio = 0.02 * rng.standard_normal(n)
        for s in range(2 + r % 2):
            f0 = 110.0 * 1.5 ** (s + r % 3)
            voice = sum(a * np.sin(2 * np.pi * f0 * h * t) for h, a in ((1, 1.0), (2, 0.5)))
            st, ui = float(rng.uniform(0, 2)), 0
            while st < dur - 1:
                ed = min(dur, st + float(rng.uniform(1, 4)))
                audio[int(st * sr):int(ed * sr)] += 0.2 * voice[int(st * sr):int(ed * sr)]
                files["segments"].append(f"{rec}_s{s}_{ui:03d} {rec} {st:.2f} {ed:.2f}")
                files["utt2spk"].append(f"{rec}_s{s}_{ui:03d} {rec}_s{s}")
                st, ui = ed + float(rng.uniform(0.5, 3)), ui + 1
        wav = path / f"{rec}.wav"
        write_wav(wav, audio / max(1.0, np.abs(audio).max()), sr)
        files["wav.scp"].append(f"{rec} cat {wav} |" if r == 1 else f"{rec} {wav}")
        files["reco2dur"].append(f"{rec} {dur}")
    for name, lines in files.items():
        (path / name).write_text("\n".join(lines) + "\n")
    return path


def phase_kaldi_train(fcfg, rng):
    """A1: run_training(TaskConfig(model="fs")) at FSEENDConfig() width on
    a Kaldi data directory synthesized from the seed: DiarizationDataset
    (logmel23, context 7, subsampling 10, as configs/fs_simu.yaml) for
    training and the same directory for validation, 2 epochs; losses and the
    validation DER finite; the last checkpoint reloaded through
    `load_fs_eend` bit for bit."""
    import tempfile

    from fseend_tpu_torch.data.dataset import DiarizationDataset, FeatureConfig
    from fseend_tpu_torch.train import loop as LOOP
    from fseend_tpu_torch.train import optim
    from fseend_tpu_torch.train import trainer as TRN
    from fseend_tpu_torch.utils import checkpoint as CK

    tcfg = dataclasses.replace(fcfg, dropout=0.1)
    feat = FeatureConfig(input_transform="logmel23")
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        data_dir = make_kaldi_dir(Path(tmp) / "data", rng, KALDI_RECS, KALDI_DUR)
        train = DiarizationDataset(str(data_dir), feat, chunk_size=KALDI_CHUNK)
        val = DiarizationDataset(str(data_dir), feat, chunk_size=KALDI_CHUNK)
        logger = LOOP.MetricsLogger(tmp, "kaldi")
        t0 = time.perf_counter()
        try:
            state, ckpt_dir = LOOP.run_training(
                task=TRN.TaskConfig(model="fs"), model_cfg=tcfg, train_dataset=train,
                val_dataset=val, tx=optim.build_optimizer("noam", 1.0, d_model=fcfg.n_units,
                                                          warmup_steps=100_000, grad_clip=5.0),
                logger=logger, batch_size=KALDI_B, chunk_size=KALDI_CHUNK, max_speakers=3,
                input_dim=feat.input_dim, max_epochs=2, seed=SEED, log_every=1)
        finally:
            logger.close()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        steps = 2 * (len(train) // KALDI_B)
        if state.step != steps:
            raise AssertionError(f"kaldi training took {state.step} steps, not {steps}")
        recs = [json.loads(ln) for ln in (ckpt_dir / "metrics.jsonl").read_text().splitlines()]
        losses = [r["train/tot_loss"] for r in recs if "train/tot_loss" in r]
        der = [r["val/DER"] for r in recs if "val/DER" in r]
        if len(losses) != steps or len(der) != 2 or not np.isfinite(losses + der).all():
            raise AssertionError(f"kaldi training losses {losses}, validation DER {der}")
        fresh = CK.load_fs_eend(ckpt_dir / "ckpt_epoch=1.npz", tcfg, "cuda")
        for (name, a), b in zip(state.model.state_dict().items(), fresh.state_dict().values()):
            if not name.endswith("num_batches_tracked") and not torch.equal(a, b):
                raise AssertionError(f"kaldi training checkpoint reload: {name} differs")
    log(f"A1 kaldi training: {KALDI_RECS} recordings x {KALDI_DUR:g} s, {len(train)} chunks of "
        f"{KALDI_CHUNK} frames ({feat.input_dim} features), batch {KALDI_B}, 2 epochs = "
        f"{steps} steps in {secs:.2f} s; losses {[round(v, 4) for v in losses]}, validation "
        f"DER {[round(v, 4) for v in der]}; the last checkpoint reloaded bit for bit")


def speech_audio(rng, lanes, n, sr=8000):
    """(lanes, n) float32 audio: a harmonic voice per lane in bursts over a
    noise floor, the first quarter second silent (exact zeros: the log10
    floor of the front end)."""
    t = np.arange(n) / sr
    out = np.empty((lanes, n), np.float32)
    for b in range(lanes):
        f0 = 100.0 + 4.0 * b
        gate = np.zeros(n, np.float32)
        for st in rng.integers(0, n, max(2, n // sr // 3)):
            gate[st:st + int(rng.integers(sr // 2, 3 * sr))] = 1.0
        voice = 0.2 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(4 * np.pi * f0 * t)
        out[b] = voice * gate + 0.01 * rng.standard_normal(n)
        out[b, :sr // 4] = 0.0
    return out


def host_features(audio, tf):
    """The host pipeline (ops/features.py) per lane: (lanes, T, 345)."""
    from fseend_tpu_torch.ops import features as F

    return np.stack([F.subsample(F.splice(F.transform(F.stft(a, 200, 80), tf), 7),
                                 subsampling=10) for a in audio])


def phase_raw_audio(cfg, fcfg, fmodel, rng, card):
    """A2: RawAudioPipeline (StreamingLogmel on the card, then the
    blockwise server) over BlockStreamingServer(kind="ls") at 128 lanes, K
    128, the "fused" route (B4), logmel23_cummn (configs/ls_infer.yaml),
    then over BlockStreamingServer(kind="fs") at 64 lanes, K 128, capacity
    2048, the kernel route (B7), logmel23 (configs/fs_infer.yaml): 8 kHz
    audio from the seed in blocks of K x 80 x 10 samples, RAW_BLOCKS blocks
    and a ragged remainder into the flush.  The streamed features within
    2e-4 of the host pipeline; the probabilities within SERVE_ATOL of the
    same server fed the host features; B4 / B7 launched on this path (counts
    set to 0 just before it) and their last call held against plain; the
    front end's ms per audio block alone and the pipeline's, CUDA events.
    Returns each kernel's largest error."""
    from fseend_tpu_torch.kernels import cached_attention as CA
    from fseend_tpu_torch.kernels import retention_layer as RL
    from fseend_tpu_torch.ops.features_tpu import StreamingLogmel
    from fseend_tpu_torch.serving.raw_audio import RawAudioPipeline
    from fseend_tpu_torch.serving.runtime import BlockStreamingServer

    errs = {}
    for kind, lanes, tf in (("ls", LANES, "logmel23_cummn"), ("fs", FS_LANES, "logmel23")):
        if kind == "ls":
            mcfg, model, mod, name = cfg, make_model(cfg, rng), RL, "retention_layer"
            per_block, on_flush = cfg.enc_n_layers + cfg.dec_n_layers, cfg.dec_n_layers
        else:
            mcfg, model, mod, name = fcfg, fmodel, CA, "cached_attention"
            per_block, on_flush = fcfg.enc_n_layers, 0

        def server():
            return BlockStreamingServer(kind=kind, cfg=mcfg, model=model, n_lanes=lanes,
                                        n_slots=mcfg.max_nspks, block=BLOCK, capacity=FS_CAP,
                                        device="cuda")

        S = BLOCK * 80 * 10
        audio = speech_audio(rng, lanes, RAW_BLOCKS * S + RAW_RAGGED)
        audio_dev = torch.as_tensor(audio, device="cuda")
        pipe = RawAudioPipeline(server(), context_size=7, input_transform=tf)
        feats = []
        fe_block, fe_flush = pipe.fe.process_block, pipe.fe.flush
        pipe.fe.process_block = lambda b: feats.append(fe_block(b)) or feats[-1]
        pipe.fe.flush = lambda last=None: feats.append(fe_flush(last)) or feats[-1]
        outs = []

        def run():
            for i in range(RAW_BLOCKS):
                outs.append(pipe.process_audio(audio_dev[:, i * S:(i + 1) * S]))
            outs.append(pipe.flush(audio_dev[:, RAW_BLOCKS * S:]))

        mod.launches = 0
        t0 = time.perf_counter()
        captured = capture_kernel_inputs(run, [(mod, name)])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = mod.launches
        probs = torch.cat(outs, dim=1)
        T = probs.shape[1]
        want_launches = pipe._fed * per_block + on_flush
        log(f"A2 raw audio, {kind}: {lanes} lanes x {audio.shape[1]} samples ({RAW_BLOCKS} "
            f"blocks of {S} + {RAW_RAGGED}) -> {T} frames in {secs:.2f} s; {pipe._fed} model "
            f"blocks + 1 flush; {name} launches {launches}")
        if launches != want_launches or launches == 0:
            raise AssertionError(f"{name} launched {launches} times on the raw-audio path, "
                                 f"not {want_launches}")
        host = host_features(audio, tf)
        got = torch.cat(feats, dim=1).cpu().numpy()
        if got.shape != host.shape or probs.shape != (lanes, T, mcfg.max_nspks - 1) \
                or host.shape[1] != T:
            raise AssertionError(f"raw audio {kind}: features {got.shape} vs host "
                                 f"{host.shape}, probabilities {tuple(probs.shape)}")
        err = float(np.abs(got - host).max())
        log(f"  streamed features vs the host pipeline: max abs diff {err:.3e} (tol 2e-4)")
        if not err <= 2e-4:
            raise AssertionError(f"raw audio {kind}: features differ by {err}")
        srv = server()
        pad = (-T) % BLOCK
        xs = torch.as_tensor(np.concatenate([host, np.zeros((lanes, pad, host.shape[2]),
                                                            np.float32)], axis=1), device="cuda")
        ref = [srv.process_block(xs[:, st:st + BLOCK], h_mask=np.arange(st, st + BLOCK) < T)
               for st in range(0, T + pad, BLOCK)]
        ref.append(srv.process_block(torch.zeros_like(xs[:, :BLOCK]), flush=True))
        fs_check("probabilities vs the server fed the host features", probs.cpu().numpy(),
                 torch.cat(ref[1:], dim=1)[:, :T].cpu().numpy(), SERVE_ATOL)
        args, _ = captured[name]
        if kind == "ls":
            errs[name], _ = compare_chunk_kernel(name, args, "last call of the raw-audio path")
        else:
            got_ca = CA.cached_attention(*args)
            torch.cuda.synchronize()
            errs[name] = compare(f"{name}[last call of the raw-audio path]", [got_ca],
                                 [CA.cached_attention_plain(*args)], ("out",), atol=TC_ATOL)

        # times: the front end alone on one audio block in steady state, and
        # the pipeline's block (front end + server) from its second block on
        fe = StreamingLogmel(lanes, S, context_size=7, input_transform=tf, device="cuda")
        fe.process_block(audio_dev[:, :S])
        fe_ms = cuda_ms(lambda: fe.process_block(audio_dev[:, S:2 * S]), reps=5)
        timed = RawAudioPipeline(server(), context_size=7, input_transform=tf)
        timed.process_audio(audio_dev[:, :S])
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(1, RAW_BLOCKS):
            timed.process_audio(audio_dev[:, i * S:(i + 1) * S])
        end.record()
        torch.cuda.synchronize()
        pipe_ms = start.elapsed_time(end) / (RAW_BLOCKS - 1)
        log(json.dumps({"raw_audio": {
            "server": f"{kind} blockwise, {'fused' if kind == 'ls' else 'kernel'} route",
            "lanes": lanes, "K": BLOCK, "transform": tf, "audio_block_samples": S,
            "frontend_ms": fe_ms, "pipeline_ms": pipe_ms, "frontend_share": fe_ms / pipe_ms,
            "audio_s_per_s": lanes * S / 8000 / (pipe_ms / 1e3),
            "frontend_audio_s_per_s": lanes * S / 8000 / (fe_ms / 1e3),
            "feature_max_abs_err": err, "launches": {name: launches}}, "card": card}))
        del pipe, timed, srv, xs, audio_dev, model
    torch.cuda.empty_cache()
    return errs


# ---------------------------------------------------------------------------
# EEND-EDA: E1 the train step, E2 training from a Kaldi directory and
# FLEX-STB streaming, E3 scoring
# ---------------------------------------------------------------------------


def eda_configs():
    """(EDAConfig, FeatureConfig, eda_offline.yaml, stb.yaml) from the
    repository's configs, read by the port's `utils/config.py`, as the
    JAX package's cli/train.py and cli/stb_eval.py build them."""
    from fseend_tpu_torch.data.dataset import FeatureConfig
    from fseend_tpu_torch.models import eend_eda
    from fseend_tpu_torch.utils.config import load_config

    root = Path(__file__).resolve().parent / "configs"
    off, stb = load_config(root / "eda_offline.yaml"), load_config(root / "stb.yaml")
    data, p = off["data"], off["model"]["params"]
    feat = FeatureConfig(context_size=data["context_recp"], subsampling=data["subsampling"],
                         input_transform=data["feat_type"])
    ecfg = eend_eda.EDAConfig(in_size=feat.input_dim, n_units=p["n_units"],
                              n_heads=p["n_heads"], n_layers=p["enc_n_layers"],
                              dropout=p["dropout"])
    return ecfg, feat, off, stb


def medians_in_turns(a, b, rounds):
    """Two host-bound calls timed a, b, b, a (CUDA events around one call
    each), `rounds` times: (median ms of a, median ms of b).  A call of
    thousands of small launches spreads by 15 % between readings, so a part
    timed apart from its whole is timed beside it."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def once(fn):
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    ta, tb = [], []
    for _ in range(rounds):
        ta.append(once(a))
        tb += [once(b), once(b)]
        ta.append(once(a))
    return float(np.median(ta)), float(np.median(tb))


def eda_optimizer(off, ecfg):
    from fseend_tpu_torch.train import optim

    tr = off["training"]
    return optim.build_optimizer(tr["opt"], tr["lr"], d_model=ecfg.n_units,
                                 warmup_steps=tr["warm_steps"],
                                 schedule_scale=tr["schedule_scale"], grad_clip=tr["grad_clip"])


def phase_eda_train(ecfg, off, card):
    """E1: the EEND-EDA train step at eda_offline.yaml's model and batch
    (32 x 500 frames x 4 speakers, dropout 0.1, Noam-Adam with clip 5) on
    synthetic features and labels from the seed: the loss and every
    gradient at dropout 0 within atol 1e-5 + rtol 1e-3 of the same pass on
    the CPU (the batch's first EDA_CPU_B samples); EDA_TRAIN_STEPS steps
    with finite losses; two seeded steps at dropout 0.1 from the same
    weights the same bits; then the step timed (CUDA events), its peak
    memory, a torch.profiler window, and the attractor LSTMs' forward and
    backward alone (their wall and device share of the step)."""
    from fseend_tpu_torch.data.loader import pad_collate
    from fseend_tpu_torch.models import eend_eda
    from fseend_tpu_torch.train import trainer as TRN

    t_phase = time.perf_counter()
    data = off["data"]
    B, T, S = off["training"]["batch_size"], data["chunk_size"], data["max_speakers"]
    task = TRN.TaskConfig(model="eda", label_mode=off["task"]["label_mode"])
    tx = eda_optimizer(off, ecfg)
    items = SyntheticSpeech(B, SEED + 3, T, ecfg.in_size, S)
    batch_np = pad_collate([items[i] for i in range(B)], T, S, ecfg.in_size)
    batch_np.pop("recs")
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch_np.items()}

    # the gradients at dropout 0 on the card against the CPU
    zcfg = dataclasses.replace(ecfg, dropout=0.0)
    got = {}
    for dev in ("cuda", "cpu"):
        m = eend_eda.init_eend_eda(zcfg, torch.Generator().manual_seed(SEED), device=dev)
        loss, _ = TRN.compute_loss(task, m, {k: torch.as_tensor(v[:EDA_CPU_B], device=dev)
                                             for k, v in batch_np.items()}, train=True)
        loss.backward()
        got[dev] = (loss.detach().double().cpu(),
                    {n: p.grad.cpu() for n, p in m.named_parameters()})
        del m, loss
    _allclose("eda train loss, card vs CPU", got["cuda"][0], got["cpu"][0], 0.0, 1e-5)
    worst = max(_allclose(f"eda train gradient of {n}, card vs CPU", g, got["cpu"][1][n],
                          1e-5, 1e-3) for n, g in got["cuda"][1].items())
    n_grads = len(got["cpu"][1])
    del got

    model = eend_eda.init_eend_eda(ecfg, torch.Generator().manual_seed(SEED), device="cuda")
    state = TRN.TrainState.create(model, tx)
    step = TRN.make_train_step(task, ecfg, tx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = []
    for _ in range(EDA_TRAIN_STEPS):
        state, metrics = step(state, batch, SEED)
        losses.append(float(metrics["tot_loss"]))
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if not np.isfinite(losses).all():
        raise AssertionError(f"eda train losses {losses}")

    # a seeded step at dropout 0.1, twice from the same weights: the same bits
    after = []
    for _ in range(2):
        m = eend_eda.init_eend_eda(ecfg, torch.Generator().manual_seed(SEED + 1), device="cuda")
        st, _ = step(TRN.TrainState.create(m, tx), batch, SEED + 5)
        after.append({k: v.clone() for k, v in m.state_dict().items()})
        del m, st
    for name, a in after[0].items():
        if not torch.equal(a, after[1][name]):
            raise AssertionError(f"eda train: two seeded steps differ in {name}")
    del after

    emb = torch.randn(B, T, ecfg.n_units, device="cuda", requires_grad=True,
                      generator=torch.Generator(device="cuda").manual_seed(SEED))

    def lstms():
        attractors, exist = eend_eda.eda_attractors(model, emb, S + 1)
        (attractors.sum() + exist.sum()).backward()

    ms, lstm_ms = medians_in_turns(lambda: step(state, batch, SEED), lstms, 2)
    prof = profile_window(lambda: step(state, batch, SEED), 2, card, "eda train step")
    lstm_prof = profile_window(lstms, 2, card, "eda attractor lstms, forward + backward")
    line = {"model": "eda", "B": B, "T": T, "speakers": S, "attractors": S + 1,
            "dropout": ecfg.dropout, "ms": ms, "frames_per_s": B * T / (ms / 1e3),
            "first_steps_s": secs, "losses": losses, "max_memory_allocated": peak,
            "device_busy_ms": prof["device_busy_ms_per_call"],
            "device_idle_share": 1 - prof["device_busy_ms_per_call"] / ms,
            "device_idle_share_profiled": prof["device_idle_share"],
            "device_kernels_per_step": prof["device_kernels_per_call"],
            "lstm": {"serial_steps": T + S + 1, "ms": lstm_ms, "share_of_step": lstm_ms / ms,
                     "device_busy_ms": lstm_prof["device_busy_ms_per_call"],
                     "share_of_step_busy": lstm_prof["device_busy_ms_per_call"]
                     / prof["device_busy_ms_per_call"],
                     "device_kernels": lstm_prof["device_kernels_per_call"]},
            "phase_s": time.perf_counter() - t_phase}
    log(f"E1 eda train: loss and {n_grads} gradient leaves on the card within atol 1e-5 + "
        f"rtol 1e-3 of the CPU ({EDA_CPU_B} x {T} frames, dropout 0; worst at {worst:.3f} of "
        f"the bound); {EDA_TRAIN_STEPS} steps of {B} x {T} frames x {S} speakers in "
        f"{secs:.2f} s, losses {[round(v, 4) for v in losses]}; two seeded steps at dropout "
        f"{ecfg.dropout} the same bits")
    log(json.dumps({"train_step": line, "card": card}))
    del state, model, batch, emb
    torch.cuda.empty_cache()


def phase_eda_kaldi(ecfg, feat, off, stb, rng, card):
    """E2: run_training(TaskConfig(model="eda")) at eda_offline.yaml's
    model on a Kaldi directory synthesized from the seed (EDA_KALDI_RECS
    recordings of EDA_KALDI_DUR s, 500-frame chunks, batch EDA_KALDI_B), 2
    epochs, the last checkpoint reloaded through `load_eend_eda` bit for
    bit; then FlexSTB with stb.yaml's buffer, block and weights ("v1") over
    the first recording with the trained model on the card (ms per block,
    the real-time factor), its "fifo" probabilities within 1e-3 of the same
    model on the CPU, the attractor LSTMs' share of a full buffer + block,
    and eda_test on stb.yaml's chunk_size frames.  Returns what E3 scores."""
    import tempfile

    from fseend_tpu_torch.data.dataset import DiarizationDataset
    from fseend_tpu_torch.models import eend_eda
    from fseend_tpu_torch.serving.flex_stb import FlexSTB
    from fseend_tpu_torch.train import loop as LOOP
    from fseend_tpu_torch.train import trainer as TRN
    from fseend_tpu_torch.utils import checkpoint as CK

    t_phase = time.perf_counter()
    data, sd = off["data"], stb["data"]
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        data_dir = make_kaldi_dir(Path(tmp) / "data", rng, EDA_KALDI_RECS, EDA_KALDI_DUR)
        train = DiarizationDataset(str(data_dir), feat, chunk_size=data["chunk_size"])
        logger = LOOP.MetricsLogger(tmp, "eda")
        t0 = time.perf_counter()
        try:
            state, ckpt_dir = LOOP.run_training(
                task=TRN.TaskConfig(model="eda", label_mode=off["task"]["label_mode"]),
                model_cfg=ecfg, train_dataset=train, val_dataset=train,
                tx=eda_optimizer(off, ecfg), logger=logger, batch_size=EDA_KALDI_B,
                chunk_size=data["chunk_size"], max_speakers=data["max_speakers"],
                input_dim=feat.input_dim, max_epochs=2, seed=SEED, log_every=1)
        finally:
            logger.close()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        steps = 2 * (len(train) // EDA_KALDI_B)
        if state.step != steps:
            raise AssertionError(f"eda kaldi training took {state.step} steps, not {steps}")
        recs = [json.loads(ln) for ln in (ckpt_dir / "metrics.jsonl").read_text().splitlines()]
        losses = [r["train/tot_loss"] for r in recs if "train/tot_loss" in r]
        der = [r["val/DER"] for r in recs if "val/DER" in r]
        if len(losses) != steps or len(der) != 2 or not np.isfinite(losses + der).all():
            raise AssertionError(f"eda kaldi training losses {losses}, validation DER {der}")
        ckpt = ckpt_dir / "ckpt_epoch=1.npz"
        model = CK.load_eend_eda(ckpt, ecfg, "cuda")
        for (name, a), b in zip(state.model.state_dict().items(), model.state_dict().values()):
            if not torch.equal(a, b):
                raise AssertionError(f"eda kaldi training checkpoint reload: {name} differs")
        cpu_model = CK.load_eend_eda(ckpt, ecfg, "cpu")
        # whole recordings: one chunk each (stb.yaml's chunk_size is longer)
        whole = DiarizationDataset(str(data_dir), feat, chunk_size=sd["chunk_size"])
        feats, _, rec = whole[0]
        ref100, _ = whole.full_labels(0)
        turns = [(whole.data.utt2spk[seg["utt"]], seg["st"], seg["et"])
                 for seg in whole.data.segments[rec]]
    del state

    S, buf, blk = sd["max_speakers"], sd["buffer_size"], sd["block_size"]

    def stb_run(m, weights, timed=None):
        stb_ = FlexSTB(m, ecfg, S, buf_size=buf, block_size=blk,
                       seed=stb["training"]["seed"], buffer_weights=weights)
        if timed is not None:
            score = stb_.score

            def clocked(inp):
                t = time.perf_counter()
                out = score(inp)
                timed.append((len(inp), time.perf_counter() - t))
                return out

            stb_.score = clocked
        return stb_.run(feats)

    probs = stb_run(model, sd["buffer_weights"])          # warm-up and the result
    blocks = []
    t0 = time.perf_counter()
    again = stb_run(model, sd["buffer_weights"], blocks)
    run_s = time.perf_counter() - t0
    if not (np.isfinite(probs).all() and probs.shape == (len(feats), S)):
        raise AssertionError(f"FLEX-STB probabilities {probs.shape}, finite "
                             f"{np.isfinite(probs).all()}")
    if not np.array_equal(probs, again):
        raise AssertionError("FLEX-STB: two runs of the same recording differ")
    fifo = stb_run(model, "fifo")
    fifo_cpu = stb_run(cpu_model, "fifo")
    fifo_err = _allclose("FLEX-STB fifo probabilities, card vs CPU", torch.as_tensor(fifo),
                         torch.as_tensor(fifo_cpu), SERVE_ATOL)
    frame_s = feat.frame_shift * feat.subsampling / feat.rate
    full = [s for n, s in blocks if n == buf + blk]
    block_ms = 1e3 * run_s / len(blocks)
    full_ms = 1e3 * float(np.median(full))
    x = torch.as_tensor(feats[None, :buf + blk], device="cuda")
    emb = eend_eda.eda_test(model, x, n_attractors=S)["emb"]
    with torch.no_grad():
        test_ms, lstm_ms = medians_in_turns(
            lambda: eend_eda.eda_test(model, x, n_attractors=S),
            lambda: eend_eda.eda_attractors(model, emb, S), 3)
    prof = profile_window(lambda: eend_eda.eda_test(model, x, n_attractors=S), 2, card,
                          "FLEX-STB scorer, buffer + block")
    xl = torch.randn(1, sd["chunk_size"], ecfg.in_size, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(SEED))
    long_ms = cuda_ms(lambda: eend_eda.eda_test(model, xl, n_attractors=S), reps=1)
    out = eend_eda.eda_test(model, xl, n_attractors=S)
    if not (torch.isfinite(out["logits"]).all() and out["logits"].shape == (1, len(xl[0]), S)):
        raise AssertionError("eda_test on a long recording: non-finite or misshapen logits")
    log(f"E2 eda kaldi training: {EDA_KALDI_RECS} recordings x {EDA_KALDI_DUR:g} s, "
        f"{len(train)} chunks of {data['chunk_size']} frames, batch {EDA_KALDI_B}, 2 epochs = "
        f"{steps} steps in {train_s:.2f} s; losses {[round(v, 4) for v in losses]}, validation "
        f"DER {[round(v, 4) for v in der]}; the last checkpoint reloaded bit for bit; FLEX-STB "
        f"({sd['buffer_weights']}, buffer {buf}, block {blk}) over {rec} ({len(feats)} frames, "
        f"{len(blocks)} blocks) twice the same bits; fifo within {fifo_err:.3f} of 1e-3 of "
        f"the CPU")
    log(json.dumps({"flex_stb": {
        "buffer": buf, "block": blk, "weights": sd["buffer_weights"], "speakers": S,
        "frames": len(feats), "blocks": len(blocks), "ms_per_block": block_ms,
        "ms_per_full_block": full_ms, "full_blocks": len(full),
        "real_time_factor": block_ms / (1e3 * blk * frame_s),
        "real_time_factor_full": full_ms / (1e3 * blk * frame_s),
        "eda_test_ms_at_buffer_plus_block": test_ms, "lstm_ms_at_buffer_plus_block": lstm_ms,
        "lstm_share": lstm_ms / test_ms, "lstm_serial_steps": buf + blk + S,
        "device_busy_ms_at_buffer_plus_block": prof["device_busy_ms_per_call"],
        "device_kernels_at_buffer_plus_block": prof["device_kernels_per_call"],
        "eda_test_frames": sd["chunk_size"], "eda_test_ms": long_ms,
        "fifo_max_abs_err_vs_cpu": float(np.abs(fifo - fifo_cpu).max()),
        "phase_s": time.perf_counter() - t_phase}, "card": card}))
    del model, x, xl, emb, out
    torch.cuda.empty_cache()
    return rec, probs, ref100, turns, feat


def phase_eda_score(rec, probs, ref100, turns, feat):
    """E3: E2's FLEX-STB probabilities through the port's scoring:
    make_rttm to a file, read_rttm back to the turns it wrote (2-decimal
    seconds), der_components against the directory's reference turns
    (segments + utt2spk) with the reference's collar, the reference
    against itself (DER 0), score_frames on the 100 Hz labels, and
    oracle-SAD rescoring.  (The h5 export needs h5py, which the card's
    machine lacks; the CPU tests hold it.)"""
    import tempfile

    from fseend_tpu_torch.utils import metrics as MET
    from fseend_tpu_torch.utils import postprocess as PP
    from fseend_tpu_torch.utils import rttm as RTTM

    scale = feat.frame_shift * feat.subsampling / feat.rate
    build = Path(__file__).resolve().parent / "build"
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        path = Path(tmp) / "hyp.rttm"
        text = RTTM.make_rttm(rec, probs, feat.frame_shift, feat.subsampling, feat.rate,
                              out_rttm_file=path)
        hyp = RTTM.read_rttm(path).get(rec, [])
    want = [(f"{rec}_{spk}", st * scale, ed * scale)
            for spk, segs in RTTM.pred_to_segments(probs).items() for st, ed in segs]
    if len(hyp) != len(want) or len(text.splitlines()) != len(want) or any(
            h[0] != w[0] or abs(h[1] - w[1]) > 0.005 + 1e-9 or abs(h[2] - w[2]) > 0.01 + 1e-9
            for h, w in zip(hyp, want)):
        raise AssertionError(f"RTTM read back: {len(hyp)} turns, wrote {len(want)}")
    der = MET.der_components(turns, hyp, collar=EDA_COLLAR_S)
    self_der = MET.der_components(turns, turns, collar=EDA_COLLAR_S)
    if not (self_der.total > 0 and self_der.der == 0.0):
        raise AssertionError(f"the reference against itself: DER {self_der.der}")
    if not (np.isfinite(der.der) and np.isclose(der.total, self_der.total, rtol=1e-9)):
        raise AssertionError(f"DER {der}")
    frames = MET.score_frames(ref100, probs, collar_frames=EDA_COLLAR_S * 100)
    speech = ref100[::feat.subsampling][:len(probs)].any(axis=1)
    sad = MET.score_frames(ref100, PP.oracle_sad_rescore(probs, speech),
                           collar_frames=EDA_COLLAR_S * 100)
    log(f"E3 scoring {rec}: {len(hyp)} RTTM turns read back as written, the reference "
        f"({len(turns)} turns) against itself DER 0")
    log(json.dumps({"eda_scoring": {
        "rec": rec, "frames": len(probs), "rttm_turns": len(hyp), "reference_turns": len(turns),
        "collar_s": EDA_COLLAR_S, "der": der.der, "miss": der.miss, "falarm": der.falarm,
        "confusion": der.confusion, "total": der.total, "score_frames_der": frames.der,
        "oracle_sad_der": sad.der}}))


def one_pass_sources():
    """A copy of the kernel sources under build/one_pass/ whose 3xTF32
    product (tc::mma3) keeps only its a_big b_big pass, with the builder
    pointed at it: products to about 1e-3 of sum |a b|, as one TF32 pass
    gives, which the 1e-4 guards must catch."""
    from fseend_tpu_torch.kernels import _build

    out = _build.BUILD_DIR / "one_pass"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC, out / "csrc")
    head = out / "csrc" / "tc_f32.cuh"
    cut = "  mma_tf32(d, a.big, b.small);\n  mma_tf32(d, a.small, b.big);\n"
    text = head.read_text()
    if cut not in text:
        raise SystemExit("--one-pass: tc_f32.cuh has no three-pass mma3 to cut")
    head.write_text(text.replace(cut, ""))
    _build.CSRC, _build.BUILD_DIR = out / "csrc", out


def one_pass_control(card):
    """--one-pass: phase 5 (both chunkwise kernels at every shape) and T1
    (the fusion layer's forward and backward) on the one-pass build, each
    kernel-vs-plain check that fails logged and counted instead of raised.
    Prints {"one_pass_control": {check: "fails" or "passes"}} and exits 0;
    the guards discriminate where a kernel's checks fail here."""
    from fseend_tpu_torch.models import ls_eend

    one_pass_sources()
    phase_build()
    results = {}

    def counting(check):
        def wrapped(label, *a, **kw):
            try:
                out = check(label, *a, **kw)
            except AssertionError as e:
                results[label] = "fails"
                log(f"  one pass: {e}")
                return 0.0
            results.setdefault(label, "passes")
            return out
        return wrapped

    g = globals()
    for name in ("compare_exact", "compare", "compare_grads"):
        g[name] = counting(g[name])
    cfg = ls_eend.LSEENDConfig()
    rng = np.random.default_rng(SEED)
    model = make_model(cfg, rng)
    phase_chunk_kernels_vs_plain(cfg, model, rng)
    phase_dec_train_vs_plain(cfg, model, rng)
    log(json.dumps({"one_pass_control": results, "card": card}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from fseend_tpu_torch.models import fs_eend, ls_eend

    t0 = time.perf_counter()
    card = phase_device()
    if "--one-pass" in sys.argv[1:]:
        return one_pass_control(card)
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
    phase_fs_train_golden()
    phase_fs_train(fcfg, card)
    phase_kaldi_train(fcfg, rng)
    for name, err in phase_raw_audio(cfg, fcfg, fmodel, rng, card).items():
        errs[name] = max(errs[name], err)
    del fmodel
    torch.cuda.empty_cache()
    ecfg, feat, off, stb = eda_configs()
    log(f"config: {ecfg}")
    phase_eda_train(ecfg, off, card)
    phase_eda_score(*phase_eda_kaldi(ecfg, feat, off, stb, rng, card))
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
