"""The wide band-attention kernels (csrc/band_attention_wide.cu) on the CPU:
their launch plan, the three-way route, and a model of their arithmetic.

band_attention_wide_plan mirrors the source's thread mapping and shared
memory; these tests walk the mapping to show every (column, dim) of the
output has one owner, hold the shared memory to a block's at every (dtype,
D, halo) of the envelope, and check the refusals. The model repeats the
kernels' summation order in f32 (products rounded once, as an fma rounds
them): each part's dims in step order, the parts' partial scores added by
the lanes' xor tree and then warp by warp, the masked softmax, the weighted
sum of v in band order; it is held against the JAX package's
band_attention_diag and its Pallas kernel in interpret mode within 1e-5,
and in bf16 against the plain bf16 version within 2 bf16 eps of max(1,
|plain|). The kernels themselves are held against the plain version on the
card in tests/test_torch_kernels.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from decafnet_tpu.ops import local_attention as jla
from decafnet_tpu_torch.ops import local_attention as tla

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)

SMS = 132                      # an H100 SXM
SERVED_T = [2304 // 2 ** lvl for lvl in range(7)]
TOL_BF16 = 2 * 2.0 ** -7


def _owners(T, D, plan):
    """How many lanes write each (column, dim) of one (b, h), by the
    kernel's mapping: block n owns columns n * tile ..; lane l of warp w
    owns columns tq, tq + 1 (tq = 2 * (l % (32 // lanes))) as part
    w * lanes + l // (32 // lanes), whose dims at step c are c * dims +
    part * 8 + j."""
    pairs = 32 // plan.lanes
    dims = tla.BAND_WIDE_DIMS * plan.warps * plan.lanes
    owned = np.zeros((T, D), np.int64)
    for t0 in range(0, T, plan.tile):
        for w in range(plan.warps):
            for lane in range(32):
                tq = 2 * (lane % pairs)
                part = w * plan.lanes + lane // pairs
                for c in range(D // dims):
                    for j in range(tla.BAND_WIDE_DIMS):
                        d = c * dims + part * tla.BAND_WIDE_DIMS + j
                        for t in (t0 + tq, t0 + tq + 1):
                            if t < T:
                                owned[t, d] += 1
    return owned


@pytest.mark.parametrize("D", [8, 16, 40, 64, 128, 256])
@pytest.mark.parametrize("T,rows", [(2304, 64), (301, 4), (36, 64), (7, 2)])
def test_wide_plan_owns_every_column(D, T, rows):
    plan = tla.band_attention_wide_plan(torch.float32, rows, 4, T, D, 2, SMS)
    assert plan.tile * plan.lanes == tla.BAND_WIDE_PAIR_COLS
    assert plan.grid == rows * 4 * -(-T // plan.tile)
    assert (plan.grid // (rows * 4) - 1) * plan.tile < T   # no tile left empty
    assert (_owners(T, D, plan) == 1).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_plan_fits_shared_memory_everywhere(dtype):
    """Every (D, halo) of the envelope at every served length gets a plan
    within a block's shared memory; so does every forced split the kernel
    takes, at the widest halo."""
    for D in range(8, 257, 8):
        for halo in range(17):
            for T in (2304, 36):
                plan = tla.band_attention_wide_plan(dtype, 64, 4, T, D, halo, SMS)
                assert plan.smem == tla.band_wide_smem(dtype, plan.warps, plan.lanes,
                                                       halo)
                assert plan.smem <= tla.SMEM_LIMIT
                assert 32 * plan.warps <= 256
        for warps in range(1, tla.BAND_WIDE_MAX_WARPS + 1):
            for lanes in tla.BAND_WIDE_LANES:
                if (D // 8) % (warps * lanes) == 0:
                    plan = tla.band_attention_wide_plan(
                        dtype, 64, 4, 36, D, 16, SMS, warps=warps, lanes=lanes)
                    assert plan.smem <= tla.SMEM_LIMIT


def test_wide_plan_smem_counts_each_region():
    """f32, 8 warps, 1 lane, halo 2: two stages of q [64][64] and k [64][72]
    (halo rounded to 4 columns), 8 x 5 x 64 partial scores, 72 mask bytes
    rounded to 80."""
    assert tla.band_wide_smem(torch.float32, 8, 1, 2) == (
        2 * 64 * (64 + 72) * 4 + 8 * 5 * 64 * 4 + 80)
    # bf16 rounds the halo to 8 columns; one warp keeps no partial scores
    assert tla.band_wide_smem(torch.bfloat16, 1, 1, 2) == (
        2 * 8 * (64 + 80) * 2 + 80)
    # halos between the kernel's classes take the larger class's block
    classes = [tla.band_wide_halo_class(h) for h in range(17)]
    assert classes == list(range(6)) + [8] * 3 + [16] * 8
    for h in range(17):
        assert tla.band_wide_smem(torch.float32, 4, 1, h) == tla.band_wide_smem(
            torch.float32, 4, 1, classes[h])


@pytest.mark.parametrize("D", [16, 40, 64, 128, 256])
def test_wide_plan_splits_lanes_only_short_of_threads(D):
    """Blocks of the most warps up to BAND_WIDE_PLAN_WARPS whose parts divide
    D; lanes 1 where the launch has 1024 threads per multiprocessor, else
    the fewest more that reach them, or the most the dims allow."""
    n = D // 8
    for T in SERVED_T:
        plan = tla.band_attention_wide_plan(torch.float32, 64, 4, T, D, 2, SMS)
        assert plan.warps == max(w for w in range(1, tla.BAND_WIDE_PLAN_WARPS + 1)
                                 if n % w == 0)
        fits = [l for l in tla.BAND_WIDE_LANES if n % (plan.warps * l) == 0]
        threads = {l: 32 * plan.warps * tla.band_attention_wide_plan(
            torch.float32, 64, 4, T, D, 2, SMS, lanes=l).grid for l in fits}
        enough = [l for l in fits if threads[l] >= 1024 * SMS]
        assert plan.lanes == (enough[0] if enough else fits[-1])
    assert tla.band_attention_wide_plan(torch.float32, 64, 4, 2304, D, 2,
                                        SMS).lanes == 1
    assert tla.band_attention_wide_plan(torch.float32, 64, 4, 36, 256, 2,
                                        SMS).lanes == 4


@pytest.mark.parametrize("D,halo,warps,lanes", [
    (12, 2, None, None), (264, 2, None, None), (0, 2, None, None),
    (64, 17, None, None), (64, 2, 3, 1), (64, 2, 8, 2), (64, 2, 9, 1),
    (64, 2, 1, 3), (256, 2, 16, 1)])
def test_wide_plan_refuses_outside_its_envelope(D, halo, warps, lanes):
    with pytest.raises(ValueError):
        tla.band_attention_wide_plan(torch.float32, 2, 4, 100, D, halo, SMS,
                                     warps=warps, lanes=lanes)


@pytest.mark.parametrize("D,window,route", [
    (8, 5, "wide"), (256, 5, "wide"), (264, 5, "general"), (32, 3, "tuned"),
    (32, 9, "tuned"), (32, 11, "wide"), (32, 1, "wide"), (16, 33, "wide"),
    (16, 35, "general"), (12, 5, "general"), (40, 1, "wide"), (4, 5, "general")])
def test_band_route_three_way(D, window, route):
    assert tla.band_attention_route(D, window) == route


# -------------------------------------------------------- the kernels' order

def _fma(acc, a, b):
    """fmaf(a, b, acc) in f32: the exact product and sum rounded once (in
    f64 the f32 product is exact; its sum with acc rounds twice at most at
    ties, below this test's resolution)."""
    return (acc.double() + a.double() * b.double()).float()


def _xor_tree(parts):
    """The lanes' __shfl_xor_sync sum: offsets 32 // lanes, then twice
    that, so parts (0 + 1) + (2 + 3)."""
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
    return parts[0]


def _wide_model(q, k, v, mask, window, plan):
    """csrc/band_attention_wide.cu's arithmetic on (B, H, T, D) q, k, v (f32
    or bf16, widened exactly): part p sums its dims c * dims + 8 p + j in
    step order c, then j; a warp's lanes' parts meet in the xor tree, the
    warps in warp order; the masked max-subtracted softmax (sum in band
    order, clamped at FLT_MIN); the weighted sum of v in band order; zeros
    for an invalid query; the result in q's dtype."""
    halo = window // 2
    B, H, T, D = q.shape
    f = [x.float() for x in (q, k, v)]
    ks = torch.stack([tla._shift_time(f[1], r) for r in range(-halo, halo + 1)], -2)
    vs = torch.stack([tla._shift_time(f[2], r) for r in range(-halo, halo + 1)], -2)
    mf = mask.float()[:, None, :, None]
    ok = torch.cat([tla._shift_time(mf, r) for r in range(-halo, halo + 1)], -1) > 0
    ok = ok.expand(B, H, T, window)                       # (B, H, T, w)
    qb = f[0][..., None, :]                               # (B, H, T, 1, D)
    dims = tla.BAND_WIDE_DIMS * plan.warps * plan.lanes
    parts = []
    for p in range(plan.warps * plan.lanes):
        s = torch.zeros(B, H, T, window)
        for c in range(D // dims):
            for j in range(tla.BAND_WIDE_DIMS):
                d = c * dims + p * tla.BAND_WIDE_DIMS + j
                s = _fma(s, qb[..., d], ks[..., d])
        parts.append(s)
    warps = [_xor_tree(parts[w * plan.lanes:(w + 1) * plan.lanes])
             for w in range(plan.warps)]
    s = warps[0]
    for x in warps[1:]:
        s = s + x
    m = torch.where(ok, s, -torch.inf).amax(-1, keepdim=True)
    e = torch.where(ok, torch.exp(s - torch.where(ok, m, 0.0)), 0.0)
    den = torch.zeros(B, H, T, 1)
    for r in range(window):
        den = den + e[..., r:r + 1]
    p = e / den.clamp_min(torch.finfo(torch.float32).tiny)
    out = torch.zeros(B, H, T, D)
    for r in range(window):
        out = torch.where(ok[..., r:r + 1], _fma(out, p[..., r:r + 1], vs[..., r, :]), out)
    return torch.where(mask[:, None, :, None], out, 0.0).to(q.dtype)


def _inputs(D, T, seed, B=2, H=2):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, T, D).astype(np.float32) * D ** -0.25
               for _ in range(3))
    mask = np.ones((B, T), bool)
    mask[1, T * 3 // 5:] = False                # a masked tail
    mask[1, 3:7] = False                        # a hole
    return q, k, v, mask


@pytest.mark.parametrize("window", [1, 5, 11, 33])
@pytest.mark.parametrize("D", [16, 64, 128, 256])
def test_wide_model_matches_jax(D, window):
    """The model at the wrapper's plan for these shapes (lanes 2 or 4 where
    the dims allow: the launch is short of threads) and at lanes 1, against
    band_attention_diag."""
    T = 70
    q, k, v, mask = _inputs(D, T, D + window)
    want = np.asarray(jax.jit(jla.band_attention_diag, static_argnums=4)(
        *map(jnp.asarray, (q, k, v, mask)), window))
    args = [torch.from_numpy(x) for x in (q, k, v, mask)]
    plan = tla.band_attention_wide_plan(torch.float32, 2, 2, T, D, window // 2, SMS)
    plans = {plan, tla.band_attention_wide_plan(torch.float32, 2, 2, T, D, window // 2,
                                                SMS, lanes=1)}
    assert len(plans) == (2 if D >= 64 else 1)
    for plan in plans:
        got = _wide_model(*args, window, plan).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_wide_model_matches_pallas_interpret():
    """D 64, window 11 through the JAX Pallas kernel in interpret mode."""
    q, k, v, mask = _inputs(64, 40, 3)
    want = np.asarray(jla.band_attention_pallas(
        *map(jnp.asarray, (q, k, v, mask)), 11, chunk=16, interpret=True))
    plan = tla.band_attention_wide_plan(torch.float32, 2, 2, 40, 64, 5, SMS)
    got = _wide_model(*map(torch.from_numpy, (q, k, v, mask)), 11, plan).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("D,window,warps,lanes", [
    (256, 5, 8, 4), (256, 5, 2, 4), (64, 11, 8, 1), (40, 33, 5, 1), (16, 1, 1, 2)])
def test_wide_model_bf16_matches_plain(D, window, warps, lanes):
    """bf16 inputs: the model (f32 sums, one rounding) against the plain
    bf16 version within 2 bf16 eps of max(1, |plain|)."""
    q, k, v, mask = _inputs(D, 70, D + window + 1)
    args = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    m = torch.from_numpy(mask)
    plan = tla.band_attention_wide_plan(torch.bfloat16, 2, 2, 70, D, window // 2,
                                        SMS, warps=warps, lanes=lanes)
    got = _wide_model(*args, m, window, plan)
    want = tla.band_attention_torch(*args, m, window)
    assert got.dtype == want.dtype == torch.bfloat16
    rel = ((got.float() - want.float()).abs() / want.float().abs().clamp_min(1.0)).max()
    assert float(rel) <= TOL_BF16
