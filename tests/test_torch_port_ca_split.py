"""PyTorch port, one query per row against its cache as the CUDA kernel
computes it (`fseend_tpu_torch/kernels/csrc/cached_attention.cu`,
`perlane_split_kernel` and `combine_kernel`: the K = 1 calls of the FS
per-frame `step()`): a plain PyTorch mirror of the split over the cache and
the fixed-order combine, kept in this file, against
`cached_attention_perlane_plain` and against the JAX package's Pallas kernel
`flash_cached_attention_perlane` in interpret mode.

The mirror: row r's query sits at qpos = start[r // rows_per_lane] and reads
the positions p with (min_pos <= p <= qpos) or p == qpos, p < cap.  The
positions up to the row's last readable one, min(qpos, cap - 1), are cut
into splits of `per` tiles of T positions.  Each split runs the online
softmax over its tiles (a masked score is -1e30 and its probability 0) and
leaves (max, sum, accumulator): -1e30, 0, 0 when it holds no position of
the row, and also when every position it holds is masked.  The row's splits
merge in their order, each weighted by exp(its max - the row's max), so such
a split weighs 0.  `split_plan` is the kernel's `split_count`: the rows alone
when they fill the card, else about fill / R splits of whole tiles.

Cases: a split with no position of the row (short rows beside long ones),
splits whose positions are all masked (min_pos past a whole split),
pre-warm-up lanes (qpos < min_pos: the own position only), starts at and
past the capacity (the clamped write: every position from min_pos on is
readable), a capacity that is not a multiple of the split length, and one
split (the decoder's rows).

Tolerance: 1e-6 against the plain version, both in float64, so that the
comparison sees the algorithm; 3e-5 against the Pallas kernel in float32
(`test_torch_port_fs_ops.py`'s ATOL_FLASH).

The bf16 form keeps these tiles and splits (`kernel_tiling` takes the
dtype and gives one plan for both): its mirror rounds each probability to
bf16 before p v and the output to bf16, and is held within 2 bf16 ulps of
a row's largest output against the bf16 plain version over the same tiles
and splits, and against the Pallas kernel in bf16 (interpret mode, one
tiny shape) over its 16-position blocks; over a kernel-like plan, within
the JAX package's drift rule from float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fseend_tpu.kernels import cached_attention_pallas as JCA
from fseend_tpu_torch.kernels import cached_attention as CA

torch.set_num_threads(1)
NEG = -1e30
ATOL_PLAIN, ATOL_JAX = 1e-6, 3e-5
HD, RPL = 8, 2                                 # head dim, rows per lane


def split_plan(R: int, cap: int, tile: int, fill: int) -> tuple[int, int]:
    """(splits, tiles per split) of `cached_attention.cu:split_count`."""
    tiles = -(-cap // tile)
    n = 1 if R >= fill else -(-fill // R)
    n = min(n, tiles)
    per = -(-tiles // n)
    return -(-tiles // per), per


def split_attention(q, k, v, start, rows_per_lane, min_pos, tile, nsplit, per, bf16=False):
    """The kernel's algorithm: q (R, 1, hd); k, v (R, cap, hd); start per
    lane.  Returns (out (R, 1, hd), the splits' maxima (nsplit, R)).  With
    `bf16` the bf16 form's arithmetic on bf16 q, k, v: float32 throughout,
    each probability rounded to bf16 before it multiplies v (the sum adds it
    unrounded), the output rounded to bf16."""
    if bf16:
        out, ms = _split_attention(q.float(), k.float(), v.float(), start, rows_per_lane,
                                   min_pos, tile, nsplit, per, True)
        return out.to(torch.bfloat16), ms
    return _split_attention(q, k, v, start, rows_per_lane, min_pos, tile, nsplit, per, False)


def _split_attention(q, k, v, start, rows_per_lane, min_pos, tile, nsplit, per, rnd):
    R, _, hd = q.shape
    cap = k.shape[1]
    qpos = start.to(torch.int64).repeat_interleave(rows_per_lane)       # (R,)
    last = qpos.clamp(max=cap - 1)
    scale = 1.0 / hd ** 0.5
    parts = []
    for z in range(nsplit):
        m = q.new_full((R,), NEG)
        l = q.new_zeros(R)
        acc = q.new_zeros(R, hd)
        j_end = torch.clamp(last + 1, max=(z + 1) * per * tile)      # (R,): the split's end
        for j0 in range(z * per * tile, (z + 1) * per * tile, tile):
            p = j0 + torch.arange(tile)
            pc = p.clamp(max=cap - 1)
            ok = (p[None] < j_end[:, None]) & ((p[None] >= min_pos) | (p[None] == qpos[:, None]))
            s = torch.einsum("rd,rtd->rt", q[:, 0], k[:, pc]) * scale
            s = torch.where(ok, s, torch.full_like(s, NEG))
            m_new = torch.maximum(m, s.max(dim=1).values)
            corr = torch.exp(m - m_new)
            pr = torch.where(ok, torch.exp(s - m_new[:, None]), torch.zeros_like(s))
            l = l * corr + pr.sum(dim=1)
            pv = pr.to(torch.bfloat16).to(pr.dtype) if rnd else pr
            acc = acc * corr[:, None] + torch.einsum("rt,rtd->rd", pv, v[:, pc])
            m = m_new
        parts.append((m, l, acc))
    ms = torch.stack([m for m, _, _ in parts])                           # (nsplit, R)
    w = torch.exp(ms - ms.max(dim=0).values)
    num = sum(w[z][:, None] * parts[z][2] for z in range(nsplit))
    den = sum(w[z] * parts[z][1] for z in range(nsplit))
    return (num / den[:, None])[:, None], ms


def _qkv(rng, R, cap, dtype):
    return tuple(torch.as_tensor(rng.standard_normal(s), dtype=dtype)
                 for s in ((R, 1, HD), (R, cap, HD), (R, cap, HD)))


# (starts per lane, min_pos, cap, tile, fill): cap 37 is no multiple of a
# split's 16 positions (tile 8, two tiles a split)
CASES = {
    "empty splits": ([0, 5, 20, 36], 0, 37, 8, 24),
    "all-masked splits": ([25, 33, 36, 30], 20, 37, 8, 24),
    "pre-warm-up lanes": ([0, 1, 2, 9], 3, 37, 8, 24),
    "at and past the capacity": ([36, 37, 50, 3], 3, 37, 8, 24),
    "one tile per split": ([0, 13, 29, 40], 9, 37, 8, 100),
    "one split": ([0, 13, 29, 40], 9, 37, 8, 8),
}


@pytest.mark.parametrize("case", list(CASES))
def test_split_mirror_matches_plain(case):
    starts, min_pos, cap, tile, fill = CASES[case]
    R = RPL * len(starts)
    nsplit, per = split_plan(R, cap, tile, fill)
    rng = np.random.default_rng(len(case))
    q, k, v = _qkv(rng, R, cap, torch.float64)
    start = torch.tensor(starts, dtype=torch.int32)
    got, ms = split_attention(q, k, v, start, RPL, min_pos, tile, nsplit, per)
    want = CA.cached_attention_perlane_plain(q, k, v, start, RPL, min_pos)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=ATOL_PLAIN, rtol=0)
    if case in ("empty splits", "all-masked splits"):
        # some split of some row weighed nothing, and the result is still right
        assert nsplit > 1 and bool((ms == NEG).any())
    if case == "one split":
        assert nsplit == 1


def test_split_plan_is_the_kernels():
    """The kernel's constants: tiles of 128 positions, 132 x 8 blocks fill
    the card.  The FS encoder's 256 rows split a 2048-position cache in 4;
    the decoder's 1536 rows fill the card alone."""
    assert split_plan(256, 2048, 128, 132 * 8) == (4, 4)
    assert split_plan(1536, 2048, 128, 132 * 8) == (1, 16)
    assert split_plan(28, 260, 128, 132 * 8) == (3, 1)


@pytest.fixture(scope="module")
def jax_case():
    """One tiny shape through the Pallas kernel in interpret mode, once:
    4 lanes x 2 rows, cap 64 (a multiple of its 16-position kv block)."""
    rng = np.random.default_rng(77)
    q, k, v = (a.numpy() for a in _qkv(rng, 8, 64, torch.float32))
    starts = np.array([0, 2, 30, 70], np.int32)
    with jax.default_matmul_precision("highest"):
        want = JCA.flash_cached_attention_perlane(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(starts),
            rows_per_lane=RPL, min_pos=3, interpret=True, block_kv=16)
    return q, k, v, starts, np.asarray(want, np.float32)


def test_split_mirror_matches_pallas(jax_case):
    q, k, v, starts, want = jax_case
    nsplit, per = split_plan(8, 64, 8, 24)
    assert nsplit > 1
    got, _ = split_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                             torch.as_tensor(starts), RPL, 3, 8, nsplit, per)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_JAX)


# ---------------------------------------------------------------------------
# the bf16 form: the same tiles and splits (kernel_tiling takes the dtype),
# each probability rounded to bf16 before p v
# ---------------------------------------------------------------------------

ULPS = 2   # bf16 ulps of a row's largest output: float32 summation orders differ


def _ulps_ok(got, want, n=ULPS):
    """Every output within n bf16 ulps of its row's largest magnitude."""
    got, want = got.float(), want.float()
    mag = want.abs().amax(-1, keepdim=True).clamp(min=1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert bool(((got - want).abs() <= n * ulp).all()), float(((got - want).abs() / ulp).max())


def _drift_ok(got, f32, yard):
    """The JAX package's bf16 drift rule: max |got - f32| <= 3 max |yard -
    f32| + 1e-3."""
    err = float((got.float() - f32.float()).abs().max())
    assert err <= 3 * float((yard.float() - f32.float()).abs().max()) + 1e-3, err


def test_bf16_plan_is_the_kernels():
    """kernel_tiling's plan for each dtype: 64-position tiles at K > 1 (and
    for the shared-head form at any K), and the per-lane form's K = 1 split
    plan above at the kernel's constants, one plan for float32 and bf16
    (the bf16 form keeps the float32 form's tiles and splits; its ring of
    copies is deeper)."""
    for dt in (torch.float32, torch.bfloat16):
        for R, cap in ((256, 2048), (1536, 2048), (28, 260)):
            _, per = split_plan(R, cap, 128, 132 * 8)
            assert CA.kernel_tiling(R, 1, cap, dt) == {"tile": 128, "split": per * 128}
            assert CA.kernel_tiling(R, 125, cap, dt) == {"tile": 64}
            assert CA.kernel_tiling(R, 1, cap, dt, perlane=False) == {"tile": 64}
    with pytest.raises(ValueError):
        CA.kernel_tiling(8, 1, 64, torch.float16)


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_split_mirror_matches_plain(case):
    """The bf16 mirror against the bf16 plain version over the same tiles
    and splits: the same rounding points, so within float32 summation
    order (a bf16 ulp where a value sits on a rounding boundary)."""
    starts, min_pos, cap, tile, fill = CASES[case]
    R = RPL * len(starts)
    nsplit, per = split_plan(R, cap, tile, fill)
    rng = np.random.default_rng(len(case) + 1)
    q, k, v = (t.to(torch.bfloat16) for t in _qkv(rng, R, cap, torch.float32))
    start = torch.tensor(starts, dtype=torch.int32)
    got, _ = split_attention(q, k, v, start, RPL, min_pos, tile, nsplit, per, bf16=True)
    want = CA.cached_attention_perlane_plain(q, k, v, start, RPL, min_pos, tile=tile,
                                             split=per * tile)
    assert got.dtype == want.dtype == torch.bfloat16
    _ulps_ok(got, want)


def test_bf16_kernel_plan_mirror_matches_plain():
    """At the kernel's own constants (kernel_tiling): 28 rows split a
    260-position cache into three one-tile splits, a lane at position 0
    leaves two of them empty."""
    starts, min_pos, cap = [0, 5, 130, 200, 259, 300, 140], 9, 260
    R = 4 * len(starts)
    plan = CA.kernel_tiling(R, 1, cap, torch.bfloat16)
    nsplit, per = split_plan(R, cap, plan["tile"], 132 * 8)
    assert nsplit == 3 and plan["split"] == per * plan["tile"]
    rng = np.random.default_rng(5)
    q, k, v = (torch.as_tensor(rng.standard_normal(s), dtype=torch.bfloat16)
               for s in ((R, 1, 16), (R, cap, 16), (R, cap, 16)))
    start = torch.tensor(starts, dtype=torch.int32)
    got, ms = split_attention(q, k, v, start, 4, min_pos, plan["tile"], nsplit, per, bf16=True)
    assert bool((ms == NEG).any())
    _ulps_ok(got, CA.cached_attention_perlane_plain(q, k, v, start, 4, min_pos, **plan))


@pytest.fixture(scope="module")
def jax_case16():
    """The tiny shape of `jax_case` in bf16 through the Pallas kernel in
    interpret mode with 16-position kv blocks, and in float32 on the same
    values, once."""
    rng = np.random.default_rng(78)
    q, k, v = (jnp.asarray(a.numpy(), jnp.bfloat16) for a in _qkv(rng, 8, 64, torch.float32))
    starts = jnp.asarray([0, 2, 30, 70], jnp.int32)
    outs = [np.asarray(JCA.flash_cached_attention_perlane(
        *(a.astype(dt) for a in (q, k, v)), starts, rows_per_lane=RPL, min_pos=3,
        interpret=True, block_kv=16).astype(jnp.float32)) for dt in (jnp.bfloat16, jnp.float32)]
    return (*(torch.as_tensor(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
              for a in (q, k, v)), torch.as_tensor(np.array(starts)),
            *(torch.as_tensor(np.array(o)) for o in outs))


def test_bf16_split_mirror_matches_pallas(jax_case16):
    """Over one split of 16-position tiles the bf16 mirror takes its running
    max where the Pallas kernel's 16-position blocks do: within 2 bf16 ulps
    of its bf16 result; over tiles of 8 in splits (a kernel-like plan) within
    the drift rule from its float32 result."""
    q, k, v, starts, want16, want32 = jax_case16
    got, _ = split_attention(q, k, v, starts, RPL, 3, 16, 1, 4, bf16=True)
    _ulps_ok(got, want16)
    nsplit, per = split_plan(8, 64, 8, 24)
    assert nsplit > 1
    got, _ = split_attention(q, k, v, starts, RPL, 3, 8, nsplit, per, bf16=True)
    _drift_ok(got, want32, want16)
