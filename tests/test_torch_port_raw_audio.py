"""PyTorch port, raw-audio serving: `RawAudioPipeline` (the streaming
front end on the device, then `BlockStreamingServer`) over both model
families on the CPU, against the JAX package's `RawAudioPipeline` over its
own server on the same weights and audio, and against the same port server
fed the host pipeline's offline features; `stream_audio_file` against the
first lane.

Small models (32 units, 2 + 1 layers), 2 lanes, K 8, context 1 (69
features), a stream of five audio blocks and a ragged remainder; the
servers on the port's default routes (LS "fused", FS the cached-attention
kernels), whose wrappers run their plain versions on the CPU.
Tolerance: 1e-3 on probabilities, the guard the servers are held to."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fseend_tpu.models import fs_eend as JFS
from fseend_tpu.models import ls_eend as JLS
from fseend_tpu.serving import raw_audio as JRA
from fseend_tpu.serving import runtime as JRT
from fseend_tpu_torch.models import fs_eend as TFS
from fseend_tpu_torch.models import ls_eend as TLS
from fseend_tpu_torch.ops import features as TF
from fseend_tpu_torch.serving import raw_audio as RA
from fseend_tpu_torch.serving import runtime as RT
from fseend_tpu_torch.utils import convert as CV

torch.set_num_threads(1)
LANES, K, CTX = 2, 8, 1
IN = (2 * CTX + 1) * 23
FEAT = dict(context_size=CTX, input_transform="logmel23_cummn")
ATOL = 1e-3
CFGS = {
    "ls": (JLS.LSEENDConfig(in_size=IN, n_units=32, n_heads=4, enc_n_layers=2, dec_n_layers=1,
                            chunk_size=K, conv_kernel_size=4, dec_dim_feedforward=48,
                            conv_delay=2, max_nspks=4, dropout=0.0), TLS.LSEENDConfig),
    "fs": (JFS.FSEENDConfig(in_size=IN, n_units=32, n_heads=4, enc_n_layers=2, dec_n_layers=1,
                            enc_dim_feedforward=48, dec_dim_feedforward=48, conv_delay=3,
                            max_nspks=4, dropout=0.0), TFS.FSEENDConfig),
}


def _audio(seed: int, n: int) -> np.ndarray:
    """(LANES, n) speech-like audio: tones in bursts over a noise floor, a
    silent start."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 8000.0
    out = np.zeros((LANES, n), np.float32)
    for b in range(LANES):
        gate = np.zeros(n)
        for st in rng.integers(0, n, 5):
            gate[st:st + int(rng.integers(800, 4000))] = 1.0
        out[b] = (0.3 * np.sin(2 * np.pi * (180 + 90 * b) * t) * gate
                  + 0.01 * rng.standard_normal(n))
        out[b, :500] = 0.0
    return out


@pytest.fixture(scope="module", params=["ls", "fs"])
def family(request):
    """(kind, the port's model and config, the JAX server's params and
    model state) holding the same random weights."""
    kind = request.param
    jcfg, tcls = CFGS[kind]
    tcfg = tcls(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(tcls)
                   if hasattr(jcfg, f.name)})
    gen = torch.Generator().manual_seed(4)
    if kind == "ls":
        model = TLS.init_ls_eend(tcfg, gen, device="cpu")
        params, mstate = CV.ls_params_to_jax(model)
        shapes, _ = jax.eval_shape(lambda k: JLS.init_ls_eend(k, jcfg), jax.random.PRNGKey(0))
    else:
        model = TFS.init_fs_eend(tcfg, gen, device="cpu")
        params, mstate = CV.fs_params_to_jax(model)
        shapes, _ = jax.eval_shape(lambda k: JFS.init_fs_eend(k, jcfg), jax.random.PRNGKey(0))

    def leaf(path, _):
        node = params
        for p in path:
            node = node[p.key if hasattr(p, "key") else p.idx]
        return jnp.asarray(node)

    jparams = jax.tree_util.tree_map_with_path(leaf, shapes)
    return kind, model, tcfg, jcfg, jparams, jax.tree.map(jnp.asarray, mstate)


def _server(kind, model, cfg, capacity=256):
    return RT.BlockStreamingServer(kind=kind, cfg=cfg, model=model, n_lanes=LANES,
                                   n_slots=cfg.max_nspks, block=K, device="cpu",
                                   capacity=capacity)


def _run_pipeline(pipe, audio):
    S = pipe.audio_block_samples
    n_full = audio.shape[1] // S
    outs = [pipe.process_audio(audio[:, i * S:(i + 1) * S]) for i in range(n_full)]
    outs.append(pipe.flush(audio[:, n_full * S:] if audio.shape[1] % S else None))
    return outs


def test_pipeline_matches_jax_and_the_offline_features(family):
    kind, model, tcfg, jcfg, jparams, jmstate = family
    S = K * 80 * 10
    audio = _audio(1, 5 * S + 333)
    pipe = RA.RawAudioPipeline(_server(kind, model, tcfg), **FEAT)
    outs = _run_pipeline(pipe, torch.as_tensor(audio))
    got = torch.cat(outs, dim=1).numpy()

    # the JAX package's pipeline over its own server, block by block
    jsrv = JRT.BlockStreamingServer(kind=kind, cfg=jcfg, params=jparams, model_state=jmstate,
                                    n_lanes=LANES, n_slots=jcfg.max_nspks, block=K,
                                    capacity=256)
    with jax.default_matmul_precision("highest"):
        want = _run_pipeline(JRA.RawAudioPipeline(jsrv, **FEAT), audio)
    assert [o.shape[1] for o in outs] == [w.shape[1] for w in want]
    np.testing.assert_allclose(got, np.concatenate(want, axis=1), atol=ATOL)

    # the same server fed the host pipeline's features of the whole stream
    feats = np.stack([TF.subsample(TF.splice(TF.transform(TF.stft(a, 200, 80), FEAT[
        "input_transform"]), CTX), subsampling=10) for a in audio])
    T = feats.shape[1]
    assert got.shape == (LANES, T, tcfg.max_nspks - 1)
    srv = _server(kind, model, tcfg)
    pad = (-T) % K
    xs = np.concatenate([feats, np.zeros((LANES, pad, IN), np.float32)], axis=1)
    offline = []
    for st in range(0, T + pad, K):
        offline.append(srv.process_block(xs[:, st:st + K], h_mask=np.arange(st, st + K) < T))
    offline.append(srv.process_block(np.zeros((LANES, K, IN), np.float32), flush=True))
    offline = torch.cat(offline[1:], dim=1)[:, :T].numpy()
    np.testing.assert_allclose(got, offline, atol=ATOL)

    # one recording through stream_audio_file: lane 0 of the same stream
    one = RA.stream_audio_file(_server(kind, model, tcfg), audio[0], **FEAT)
    np.testing.assert_allclose(one, got[0], atol=ATOL)
    with pytest.raises(RuntimeError, match="flushed"):
        pipe.process_audio(torch.as_tensor(audio[:, :S]))
