"""Launch plans and summation orders of the band-attention and q/k/v-trio
kernels, on the CPU.

csrc/band_attention.cu and csrc/qkv_depthwise_ln.cu take a launch plan
(time columns per block; band attention also lanes per query) that the
wrappers choose from the shapes. These tests hold every plan the wrappers choose at the served FPN
lengths and at edge lengths to the kernels' constraints, and walk the
kernels' thread-to-(column, dim) mapping to show each output element has
exactly one owner. They also emulate, in f32 torch, the order in which the
kernels sum (band attention's D split over lanes and its xor-shuffle tree;
the trio's channel split over 4 lanes and its two-pass LN with y
recomputed) and hold
that against the JAX package's reference forms at 1e-5. The kernels
themselves are held against their plain versions on the card in
tests/test_torch_kernels.py."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from decafnet_tpu.ops import fused_conv as jfc
from decafnet_tpu.ops import local_attention as jla
from decafnet_tpu_torch.ops import cuda
from decafnet_tpu_torch.ops import fused_conv as tfc
from decafnet_tpu_torch.ops import local_attention as tla

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)

# the served lengths (T=2304 and its 6 halvings) and edge lengths
SERVED_T = [2304 // 2 ** lvl for lvl in range(7)]
EDGE_T = [1000, 301, 17, 9, 4, 3, 1]
MAX_THREADS = 512  # both kernels' __launch_bounds__
# multiprocessors of an H100 SXM and of an H100 PCIe
SMS = [132, 114]


def _owners(T, tile, split, width):
    """How many threads write each (column, dim) element, by the kernels'
    mapping: thread tid of block n owns column n * tile + tq with
    tq = (tid // 32) * (32 // split) + lane % (32 // split), and, as part
    lane // (32 // split), the dims part, part + split, ... < width."""
    qw = 32 // split
    tid = np.arange(tile * split)
    lane = tid % 32
    tq = (tid // 32) * qw + lane % qw
    part = lane // qw
    owned = np.zeros((T, width), np.int64)
    for t0 in range(0, T, tile):
        t = t0 + tq
        for d0 in range(0, width, split):
            d = d0 + part
            keep = (t < T) & (d < width)
            np.add.at(owned, (t[keep], d[keep]), 1)
    return owned


def _check_plan(T, tile, split, max_tile, width):
    assert split in (1, 2, 4)
    assert tile % 4 == 0 and tile % (32 // split) == 0 and tile <= max_tile
    assert tile * split <= MAX_THREADS and tile * split % 32 == 0
    n_tiles = -(-T // tile)
    assert (n_tiles - 1) * tile < T <= n_tiles * tile  # no tile left empty
    assert (_owners(T, tile, split, width) == 1).all()


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("rows", [64, 4])
@pytest.mark.parametrize("T", SERVED_T + EDGE_T)
def test_band_attention_plan_owns_every_column(T, rows, sms):
    tile, split = tla.band_attention_plan(rows, 4, T, sms)
    _check_plan(T, tile, split, tla.BAND_MAX_TILE, 32)


@pytest.mark.parametrize("sms", SMS)
def test_band_attention_plan_splits_only_short_levels(sms):
    plans = [tla.band_attention_plan(64, 4, T, sms) for T in SERVED_T]
    splits = [s for _, s in plans]
    assert splits == sorted(splits) and splits[0] == 1 and splits[-1] == 4
    assert all(64 * 4 * T * s >= 1024 * sms
               for T, (_, s) in zip(SERVED_T, plans) if s < 4)
    assert all(64 * 4 * T * (s // 2) < 1024 * sms  # the fewest lanes
               for T, (_, s) in zip(SERVED_T, plans) if s > 1)


@pytest.mark.parametrize("T", SERVED_T + EDGE_T)
def test_qkv_depthwise_ln_plan_owns_every_column(T):
    tile = tfc.qkv_depthwise_ln_plan(T)
    _check_plan(T, tile, tfc.QKV_LANES, tfc.QKV_MAX_TILE, 128)


@pytest.mark.parametrize("T", [2304, 301, 36, 9, 3])
@pytest.mark.parametrize("quantum", [8, 16, 32])
def test_time_tile_is_balanced(T, quantum):
    tile = cuda.time_tile(T, quantum, 128)
    n_tiles = -(-T // tile)
    assert n_tiles == -(-T // 128)  # the fewest tiles of at most 128
    assert tile % quantum == 0 and tile - quantum < -(-T // n_tiles) <= tile


# ------------------------------------------------- summation-order emulations

def _xor_tree(parts):
    """The kernels' __shfl_xor_sync sum of per-part partials: offsets
    32 // split, then twice that, so parts (0+1) + (2+3)."""
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
    return parts[0]


def _band_emulation(q, k, v, mask, window, split):
    """csrc/band_attention.cu's arithmetic in f32: each lane part sums its
    dims d = part, part + split, ... in order, the parts meet in the xor
    tree, then the masked max-subtracted softmax and the weighted v sum over
    the band in order r = -halo..halo."""
    halo = window // 2
    B, H, T, D = q.shape
    kp = F.pad(k, (0, 0, halo, halo))
    vp = F.pad(v, (0, 0, halo, halo))
    mp = F.pad(mask, (halo, halo))
    s, ok = [], []
    for r in range(window):
        kr = kp[:, :, r:r + T]
        parts = []
        for part in range(split):
            acc = torch.zeros(B, H, T)
            for d in range(part, D, split):
                acc = acc + q[..., d] * kr[..., d]
            parts.append(acc)
        s.append(_xor_tree(parts))
        ok.append(mp[:, None, r:r + T].expand(B, H, T))
    s, ok = torch.stack(s, -1), torch.stack(ok, -1)
    m = torch.where(ok, s, -torch.inf).amax(-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    den = torch.zeros(B, H, T, 1)
    for r in range(window):
        den = den + p[..., r:r + 1]
    p = p / den.clamp_min(torch.finfo(torch.float32).tiny)
    out = torch.zeros(B, H, T, D)
    for r in range(window):
        p_r = torch.where(ok[..., r:r + 1], p[..., r:r + 1], 0.0)
        out = out + p_r * vp[:, :, r:r + T]
    return torch.where(mask[:, None, :, None], out, 0.0)


def _band_inputs(T, seed=0, B=3, H=2, D=32):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, T, D).astype(np.float32) * D ** -0.25
               for _ in range(3))
    mask = rng.rand(B, T) < 0.8
    mask[0, :] = True
    mask[1, :] = False                      # an all-masked row
    mask[2, T // 2:] = False                # a masked tail
    return q, k, v, mask


@pytest.mark.parametrize("T", [64, 37])
@pytest.mark.parametrize("split", [1, 2, 4])
def test_band_split_order_matches_reference(split, T):
    q, k, v, mask = _band_inputs(T)
    got = _band_emulation(*map(torch.from_numpy, (q, k, v, mask)), 5, split)
    want = jla.band_attention_reference(*map(jnp.asarray, (q, k, v, mask)), 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def _trio_emulation(x, mask, ws, ln_ws, ln_bs, eps=1e-5):
    """csrc/qkv_depthwise_ln.cu's arithmetic in f32: y = w0*x[t-1] + w1*x[t]
    + w2*x[t+1] of x * mask, recomputed for each pass; each of the
    QKV_LANES lane parts sums its channels c = part, part + QKV_LANES, ...
    in order and the parts meet in the xor tree, first for the mean, then
    for the centred squares."""
    lanes = tfc.QKV_LANES
    xm = x * mask[:, None, :].float()
    xl = F.pad(xm, (1, 0))[..., :-1]
    xr = F.pad(xm, (0, 1))[..., 1:]
    C = x.shape[1]

    def conv(w):
        w = w[:, 0, :, None]
        return w[:, 2] * xr + (w[:, 1] * xm + w[:, 0] * xl)

    def channel_sum(f):
        parts = []
        for part in range(lanes):
            acc = torch.zeros(x.shape[0], x.shape[2])
            for c in range(part, C, lanes):
                acc = acc + f(c)
            parts.append(acc)
        return _xor_tree(parts)

    outs = []
    for w, lw, lb in zip(ws, ln_ws, ln_bs):
        mean = channel_sum(lambda c: conv(w)[:, c]) / C
        var = channel_sum(lambda c: (conv(w)[:, c] - mean) ** 2) / C
        rstd = torch.rsqrt(var + eps)
        y = conv(w)
        outs.append((y - mean[:, None]) * rstd[:, None] * lw.reshape(-1, 1)
                    + lb.reshape(-1, 1))
    return outs


@pytest.mark.parametrize("C,T", [(128, 50), (128, 37), (160, 8)])
def test_trio_channel_split_order_matches_xla(C, T):
    rng = np.random.RandomState(T)
    x = rng.randn(3, C, T).astype(np.float32)
    mask = np.zeros((3, T), bool)
    mask[0, :] = True
    mask[1, :T // 2] = True                 # a masked tail; row 2 all masked
    ws = [rng.randn(C, 1, 3).astype(np.float32) / np.sqrt(3) for _ in range(3)]
    lws = [(1 + 0.1 * rng.randn(C, 1)).astype(np.float32) for _ in range(3)]
    lbs = [(0.1 * rng.randn(C, 1)).astype(np.float32) for _ in range(3)]
    got = _trio_emulation(torch.from_numpy(x), torch.from_numpy(mask),
                          *[[torch.from_numpy(a) for a in p] for p in (ws, lws, lbs)])
    want = jfc.qkv_depthwise_ln_xla(jnp.asarray(x), jnp.asarray(mask),
                                    *[[jnp.asarray(a) for a in p]
                                      for p in (ws, lws, lbs)])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
