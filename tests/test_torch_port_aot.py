"""PyTorch port, ahead-of-time serving artifacts (`serving/aot.py`) and the
two custom ops they carry (`torch.ops.fseend_tpu_torch.retention_layer`,
B4, and `torch.ops.fseend_tpu_torch.cached_attention`, B7).

`save_server` / `AotBlockServer` against the live `BlockStreamingServer`
bit for bit on the CPU (three blocks, the flush, a reset and a padded
block; the artifacts frozen after their servers processed two blocks, so
the exported `init` must be pristine), the FS capacity guard, the loader in a child process that never
imports the model, config or checkpoint modules, and `cli.export`; against
the JAX package's `AotBlockServer` on the same weights within 1e-5
(float32, another summation order; its XLA route).  `torch.library.opcheck`
holds both ops' CPU and fake implementations.  The models are the
reference's tiny LS-EEND and FS-EEND of `tests/goldens/{ls,fs}_model_ref.npz`.
"""

import dataclasses
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import yaml

from fseend_tpu.models import fs_eend as JFS
from fseend_tpu.models import ls_eend as JLS
from fseend_tpu.utils import torch_convert as JTC
from fseend_tpu_torch.kernels import cached_attention as CA
from fseend_tpu_torch.kernels import retention_layer as RL
from fseend_tpu_torch.models import fs_eend, ls_eend
from fseend_tpu_torch.serving.aot import AotBlockServer, save_server
from fseend_tpu_torch.serving.runtime import BlockStreamingServer
from fseend_tpu_torch.utils import torch_convert as TTC

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
LS_CFG = ls_eend.LSEENDConfig(in_size=23, n_units=32, n_heads=4, enc_n_layers=2,
                              dec_n_layers=2, chunk_size=8, ff_expansion=2,
                              conv_kernel_size=5, dec_dim_feedforward=64, conv_delay=3,
                              max_nspks=4, kernel="fused")
FS_CFG = fs_eend.FSEENDConfig(in_size=23, n_units=32, n_heads=4, enc_n_layers=2,
                              dec_n_layers=2, enc_dim_feedforward=2048,
                              dec_dim_feedforward=64, conv_delay=9, max_nspks=4,
                              use_flash_attn=True)
LANES, SLOTS, BLOCK, CAP = 2, 4, 12, 48


def _sd(name):
    g = np.load(REPO / "tests" / "goldens" / name)
    return {k[len("sd__"):]: g[k] for k in g.files if k.startswith("sd__")}


@pytest.fixture(scope="module")
def models():
    return {"ls": TTC.ls_from_state_dict(_sd("ls_model_ref.npz"), LS_CFG, "cpu"),
            "fs": TTC.fs_from_state_dict(_sd("fs_model_ref.npz"), FS_CFG, "cpu")}


def _server(models, kind, block=BLOCK, capacity=CAP):
    cfg = LS_CFG if kind == "ls" else FS_CFG
    return BlockStreamingServer(kind=kind, cfg=cfg, model=models[kind], n_lanes=LANES,
                                n_slots=SLOTS, block=block, capacity=capacity, device="cpu")


def _frames(seed, n_blocks=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((LANES, n_blocks * BLOCK, 23)).astype(np.float32)


def _run(srv, feats, mask=None):
    """Three blocks (the last one padded past `mask`) and the flush."""
    out = []
    for st in range(0, feats.shape[1], BLOCK):
        last = st + BLOCK == feats.shape[1]
        out.append(srv.process_block(feats[:, st:st + BLOCK],
                                     h_mask=mask if last else None))
    out.append(srv.process_block(np.zeros((LANES, BLOCK, 23), np.float32), flush=True))
    return [o.numpy() for o in out]


@pytest.fixture(scope="module")
def artifacts(models, tmp_path_factory):
    """Each server frozen after it has processed two blocks: the exported
    `init` must still be pristine."""
    d = tmp_path_factory.mktemp("aot")
    out = {}
    feats = _frames(2)
    for kind in ("ls", "fs"):
        live = _server(models, kind)
        live.process_block(feats[:, :BLOCK])
        live.process_block(feats[:, BLOCK:2 * BLOCK])
        out[kind] = d / f"{kind}.npz"
        save_server(live, str(out[kind]))
    return out


@pytest.mark.parametrize("kind", ["ls", "fs"])
def test_aot_reproduces_a_fresh_live_server_bit_for_bit(models, artifacts, kind):
    """The artifact of a server frozen mid-stream against a fresh server:
    three blocks and the flush, then a reset and one block."""
    aot = AotBlockServer(str(artifacts[kind]))
    assert (aot.kind, aot.n_lanes, aot.block, aot.device) == (kind, LANES, BLOCK,
                                                              torch.device("cpu"))
    assert aot.capacity == (CAP if kind == "fs" else None)
    live = _server(models, kind)
    feats = _frames(1)
    mask = np.arange(BLOCK) < 7
    for got, want in zip(_run(aot, feats, mask), _run(live, feats, mask)):
        np.testing.assert_array_equal(got, want)
    aot.reset_all()
    live.reset_all()
    for got, want in zip(_run(aot, feats[:, :BLOCK]), _run(live, feats[:, :BLOCK])):
        np.testing.assert_array_equal(got, want)


def test_the_fs_artifact_keeps_the_capacity_guard(artifacts):
    """The FS artifact refuses a block past its capacity until reset; a
    flush block writes no cache and passes."""
    feats = _frames(2)
    faot = AotBlockServer(str(artifacts["fs"]))
    for _ in range(CAP // BLOCK):
        faot.process_block(feats[:, :BLOCK])
    with pytest.raises(ValueError, match="capacity"):
        faot.process_block(feats[:, :BLOCK])
    faot.process_block(feats[:, :BLOCK], flush=True)
    faot.reset_all()
    faot.process_block(feats[:, :BLOCK])


@pytest.mark.parametrize("kind", ["ls", "fs"])
def test_aot_matches_the_jax_artifact(models, artifacts, kind, tmp_path):
    """The JAX package's artifact of the same weights (its XLA route)."""
    from fseend_tpu.serving.aot import AotBlockServer as JAot
    from fseend_tpu.serving.aot import save_server as jsave
    from fseend_tpu.serving.runtime import BlockStreamingServer as JServer

    if kind == "ls":
        fields = {f.name for f in dataclasses.fields(JLS.LSEENDConfig)}
        jcfg = JLS.LSEENDConfig(**{k: v for k, v in dataclasses.asdict(LS_CFG).items()
                                   if k in fields})
        params, mstate = JTC.ls_from_state_dict(_sd("ls_model_ref.npz"), jcfg)
    else:
        jcfg = JFS.FSEENDConfig(**dict(dataclasses.asdict(FS_CFG), use_flash_attn=False))
        params, mstate = JTC.fs_from_state_dict(_sd("fs_model_ref.npz"), jcfg)
    jsave(JServer(cfg=jcfg, params=params, model_state=mstate, n_lanes=LANES, n_slots=SLOTS,
                  block=BLOCK, kind=kind, capacity=CAP),
          str(tmp_path / "jax.npz"))
    feats = _frames(3)
    mask = np.arange(BLOCK) < 5
    want = [np.asarray(p) for p in _run_jax(JAot(str(tmp_path / "jax.npz")), feats, mask)]
    got = _run(AotBlockServer(str(artifacts[kind])), feats, mask)
    for g, w in zip(got[1:], want[1:]):          # the first emission is warm-up garbage
        np.testing.assert_allclose(g, w, atol=1e-5)


def _run_jax(srv, feats, mask):
    out = []
    for st in range(0, feats.shape[1], BLOCK):
        last = st + BLOCK == feats.shape[1]
        out.append(srv.process_block(feats[:, st:st + BLOCK], h_mask=mask if last else None))
    out.append(srv.process_block(np.zeros((LANES, BLOCK, 23), np.float32), flush=True))
    return out


def test_the_loader_imports_no_model_config_or_checkpoint_module(models, artifacts,
                                                                 tmp_path):
    """A child process loads the LS artifact with JAX and the model,
    config and checkpoint modules unimportable, and serves the same bits."""
    feats = _frames(4)
    np.save(tmp_path / "feats.npy", feats)
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "fseend_tpu", "fseend_tpu_torch.models",
                     "fseend_tpu_torch.utils.config", "fseend_tpu_torch.utils.checkpoint"):
            sys.modules[name] = None
        import numpy as np
        import torch
        torch.set_num_threads(1)
        from fseend_tpu_torch.serving.aot import AotBlockServer
        srv = AotBlockServer({str(artifacts["ls"])!r})
        feats = np.load({str(tmp_path / "feats.npy")!r})
        out = [srv.process_block(feats[:, s:s + {BLOCK}]).numpy()
               for s in range(0, feats.shape[1], {BLOCK})]
        out.append(srv.process_block(np.zeros_like(feats[:, :{BLOCK}]), flush=True).numpy())
        np.save({str(tmp_path / "out.npy")!r}, np.stack(out))
        loaded = sorted(m for m in sys.modules if m.startswith("fseend_tpu_torch.")
                        and sys.modules[m] is not None)
        print(" ".join(loaded))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    loaded = res.stdout.split()
    assert "fseend_tpu_torch.serving.aot" in loaded
    assert not [m for m in loaded if m.startswith(("fseend_tpu_torch.models",
                                                   "fseend_tpu_torch.utils"))], loaded
    want = _run(_server(models, "ls"), feats)
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), np.stack(want))


@pytest.mark.parametrize("dtype", ["f32", "bf16", None])
def test_export_cli_writes_what_the_live_server_serves(models, tmp_path, dtype):
    """`cli.export` from a yaml config and a reference .ckpt, in float32 and
    in bf16 (None: no `--dtype`, whose default is bf16, as the JAX CLI's):
    the artifact records its dtype, and a bf16 artifact serves what a live
    bf16 server serves, bit for bit."""
    from fseend_tpu_torch.cli import export as TEXP

    torch.save({k: torch.from_numpy(v.copy()) for k, v in _sd("ls_model_ref.npz").items()},
               tmp_path / "ls.ckpt")
    configs = {"model": {"arch": "ls_eend_conformer_retention", "params": {
        "n_units": 32, "n_heads": 4, "enc_n_layers": 2, "dec_n_layers": 2,
        "feed_forward_expansion_factor": 2, "dec_dim_feedforward": 64, "conv_kernel_size": 5,
        "recurrent_chunk_size": 8, "conv_delay": 3, "use_fused_ret": True}},
        "data": {"max_speakers": 2, "context_recp": 0,
                 "feat": {"sample_rate": 8000, "win_length": 200, "hop_length": 80,
                          "n_mels": 23}},
        "task": {"label_mode": "fixed"}}
    (tmp_path / "ls.yaml").write_text(yaml.safe_dump(configs))
    srv = TEXP.main(["--configs", str(tmp_path / "ls.yaml"), "--ckpt", str(tmp_path / "ls.ckpt"),
                     "--out", str(tmp_path / "srv.npz"), "--lanes", str(LANES), "--block",
                     str(BLOCK), "--device", "cpu"] + (["--dtype", dtype] if dtype else []))
    assert srv.cfg == dataclasses.replace(LS_CFG, dropout=0.1)
    aot = AotBlockServer(str(tmp_path / "srv.npz"))
    want_dt = torch.float32 if dtype == "f32" else torch.bfloat16
    assert aot.dtype == srv.dtype == want_dt and aot.meta["dtype"] == str(want_dt)[6:]
    live = BlockStreamingServer(kind="ls", cfg=LS_CFG, model=models["ls"], n_lanes=LANES,
                                n_slots=SLOTS, block=BLOCK, dtype=want_dt, device="cpu")
    feats = _frames(5)
    for got, want in zip(_run(aot, feats), _run(live, feats)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_both_ops_pass_opcheck():
    g = torch.Generator().manual_seed(0)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    for B, T, chunk in ((2, 16, 8), (3, 8, 8)):
        D, H = 16, 2
        args = (torch.tensor([1.0, 0.9]), r(B, T, D), r(D, 4 * D, scale=0.2), r(4 * D),
                r(D, D, scale=0.2), r(D), r(B, H, D // H, D // H), r(B, H, 1, 1).abs() + 1,
                chunk)
        torch.library.opcheck(RL.retention_layer_op, args)
        # the bf16 form: the fake implementation gives bf16 outputs
        torch.library.opcheck(RL.retention_layer_op, (args[0],) + tuple(
            a.to(torch.bfloat16) for a in args[1:8]) + (chunk,))
    for start in (0, 5):
        torch.library.opcheck(CA.cached_attention_op,
                              (r(6, 4, 8), r(6, 12, 8), r(6, 12, 8),
                               torch.tensor([start], dtype=torch.int32)))


def test_the_wrappers_route_through_the_ops():
    """Without a gradient the wrappers call the ops (the launch counts stay
    where the CUDA kernels are); with one, B4 keeps its autograd.Function."""
    g = torch.Generator().manual_seed(1)
    B, T, D, H = 2, 16, 16, 2
    x = torch.randn(B, T, D, generator=g)
    w = RL.RetLayerWeights(torch.randn(D, 4 * D, generator=g) * 0.2, torch.randn(4 * D),
                           torch.randn(D, D, generator=g) * 0.2, torch.randn(D))
    kv0, s0 = torch.zeros(B, H, D // H, D // H), torch.ones(B, H, 1, 1)
    gam = torch.ones(H)
    with torch.no_grad():
        got = RL.retention_layer(gam, x, w, kv0, s0, 8)
    for a, b in zip(got, RL.retention_layer_plain(gam, x, w, kv0, s0, 8)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    xg = x.clone().requires_grad_()
    y, _, _ = RL.retention_layer(gam, xg, w, kv0, s0, 8)
    assert type(y.grad_fn).__name__ == "_RetentionLayerFnBackward"
    y.sum().backward()
    assert torch.isfinite(xg.grad).all()
    q, k, v = (torch.randn(4, 3, 8, generator=g) for _ in range(3))
    start = torch.tensor([0], dtype=torch.int32)
    torch.testing.assert_close(CA.cached_attention(q, k, v, 0),
                               CA.cached_attention_plain(q, k, v, start), rtol=0, atol=0)
