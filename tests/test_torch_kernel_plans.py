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


@pytest.mark.parametrize("T", SERVED_T + EDGE_T)
def test_qkv_depthwise_ln_bf16_plan_owns_every_column(T):
    """The bf16 trio: thread tid of a block owns columns tc and tc + 1 with
    tc = 2 * ((tid // 32) * 8 + lane % 8), channels part, part + 4, ... for
    part = lane // 8; 2 * tile threads."""
    tile = tfc.qkv_depthwise_ln_plan(T, torch.bfloat16)
    assert tile % 16 == 0 and 2 * tile <= MAX_THREADS
    assert tile <= tfc.QKV_MAX_TILE
    n_tiles = -(-T // tile)
    assert (n_tiles - 1) * tile < T <= n_tiles * tile
    C = 128
    tid = np.arange(2 * tile)
    lane = tid % 32
    tc = 2 * ((tid // 32) * 8 + lane % 8)
    part = lane // 8
    owned = np.zeros((T, C), np.int64)
    for t0 in range(0, T, tile):
        for dt in (0, 1):
            t = t0 + tc + dt
            for c0 in range(0, C, tfc.QKV_LANES):
                c = c0 + part
                keep = t < T
                np.add.at(owned, (t[keep], c[keep]), 1)
    assert (owned == 1).all()


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


# ------------------------------------------------------------ dispatch rule
# Each wrapper picks a kernel from the shape and dtype before it launches
# (band_attention_route, conv3_route, qkv_route). These tests run the public
# ops as they run on a CUDA tensor, with the library replaced by a stand-in
# that records which entry point each launch reaches and refuses, as the C
# entry points do, the arguments that entry point does not take. So every
# shape of the envelope below reaches a kernel that takes it, and the served
# and MAD shapes reach the tuned kernels.

INT_MAX = 2 ** 31 - 1


def _entry_refuses(name, a):
    """Why the C entry point ``name`` would return cudaErrorInvalidValue for
    the arguments ``a`` of a ctypes call (None: it takes them); mirrors the
    checks at the top of each entry point in csrc/."""
    if name.startswith("decafnet_band_attention"):
        B, H, T, D, halo = a[5], a[6], a[7], a[8], a[13]
        if "wide" in name:
            warps, lanes = a[14], a[15]
            dtype = torch.bfloat16 if name.endswith("bf16") else torch.float32
            ok = (D % 8 == 0 and 8 <= D <= 256 and 0 <= halo <= 16
                  and 1 <= warps <= 8 and lanes in (1, 2, 4)
                  and D % (8 * warps * lanes) == 0
                  and tla.band_wide_smem(dtype, warps, lanes, halo) <= tla.SMEM_LIMIT
                  and B * H * -(-T // (64 // lanes)) <= INT_MAX)
            return None if ok else f"wide band arguments D {D}, halo {halo}, plan {a[14:16]}"
        if "general" in name:
            return None if D >= 1 and halo >= 0 and B * H * -(-T // 128) <= INT_MAX \
                else "general band arguments"
        if D != 32 or not 1 <= halo <= 4:
            return f"tuned band kernel at D {D}, halo {halo}"
        if name.endswith("f32"):
            tile, split = a[14], a[15]
            ok = (split in (1, 2, 4) and tile > 0 and tile % 4 == 0
                  and tile % (32 // split) == 0 and tile * split <= MAX_THREADS)
            return None if ok else f"f32 band plan {(tile, split)}"
        return None if a[14] in (1, 4) and a[15] >= 1 else f"bf16 band plan {a[14:16]}"
    if name.startswith("decafnet_conv3_ln_act"):
        n_levels, C_out = a[1], a[9]
        if not 1 <= n_levels <= tfc.CONV3_MAX_LEVELS:
            return f"{n_levels} levels"
        if "general" in name:
            tile = a[10]
            return None if tile == _StubLibrary.GENERAL_TILE \
                else f"general conv3 tile {tile} at C_out {C_out}"
        if "passes" in name:
            if not 1 <= C_out <= tfc.CONV3_PASSES_MAX_C:
                return f"pass conv3 at C_out {C_out}"
            dtype = torch.bfloat16 if name.endswith("bf16") else torch.float32
            plan = tfc.conv3_passes_plan(dtype, C_out)
            return None if (a[10], a[11]) == (plan.slice, plan.passes) \
                else f"pass conv3 plan {a[10:12]} at C_out {C_out}"
        if "wide" in name:
            if not 1 <= C_out <= 1024:
                return f"wide conv3 at C_out {C_out}"
            dtype = torch.bfloat16 if name.endswith("bf16") else torch.float32
            plan = tfc.conv3_wide_plan(dtype, C_out)
            return None if (a[10], a[11]) == (plan.slice, plan.cluster) \
                else f"wide conv3 plan {a[10:12]} at C_out {C_out}"
        return None if C_out <= 256 else f"tuned conv3 at C_out {C_out}"
    if name.startswith("decafnet_qkv_depthwise_ln"):
        C = a[15]
        if "general" in name:
            return None if C >= 1 else "general trio arguments"
        if "wide" in name:
            dtype = torch.bfloat16 if name.endswith("bf16") else torch.float32
            plan = tfc.qkv_wide_plan(C, a[16], dtype)
            return None if C <= tfc.QKV_WIDE_MAX_C and tuple(a[18:21]) == plan[:3] \
                else f"wide trio plan {a[18:21]} at C {C}"
        tile = a[18]
        if C > 256:
            return f"tuned trio at C {C}"
        ok = (tile % 16 == 0 and 2 * tile <= MAX_THREADS if name.endswith("bf16")
              else tile % 8 == 0 and tile * 4 <= MAX_THREADS)
        return None if ok else f"trio tile {tile}"
    raise AssertionError(name)


class _StubLibrary:
    """The kernel library as the wrappers see it: each entry point records
    its name and returns 0 (cudaSuccess), or fails the test where the real
    one would refuse the arguments. The general conv3 kernel's tile query
    (which reads the card's shared memory) answers GENERAL_TILE, or
    ``tile`` where a test sets it."""

    GENERAL_TILE = 32

    def __init__(self, tile=GENERAL_TILE):
        self.calls = []
        self.tile = tile

    def __getattr__(self, name):
        if name == "decafnet_conv3_ln_act_general_tile":
            return lambda C_out: self.tile
        def entry(*args):
            a = [x.value if hasattr(x, "value") else x for x in args]
            why = _entry_refuses(name, a)
            assert why is None, f"{name} refuses: {why}"
            self.calls.append(name)
            return 0
        return entry


@pytest.fixture
def dry_card(monkeypatch):
    """CPU tensors routed as CUDA tensors are, into _StubLibrary."""
    lib = _StubLibrary()
    require = cuda.require

    def require_but_device(cond, name, what):
        if "CUDA tensors" not in what:
            require(cond, name, what)

    monkeypatch.setattr(cuda, "use_kernel", lambda x: True)
    monkeypatch.setattr(cuda, "require", require_but_device)
    monkeypatch.setattr(cuda, "library", lambda: lib)
    monkeypatch.setattr(cuda, "stream", lambda: None)
    monkeypatch.setattr(cuda, "sm_count", lambda device: SMS[0])
    return lib


def _band_args(B, H, T, D, window, dtype):
    # torch.empty: the stand-in reads no element, and the MAD shapes' inputs
    # then take no memory
    qkv = [torch.empty(B, H * D, T, dtype=dtype).reshape(B, H, D, T).transpose(2, 3)
           for _ in range(3)]
    return (*qkv, torch.ones(B, T, dtype=torch.bool), window)


def _band_entry(route, dtype):
    return ("decafnet_band_attention" + ("" if route == "tuned" else "_" + route)
            + ("_bf16" if dtype == torch.bfloat16 else "_f32"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [1, 4, 8, 12, 16, 32, 40, 64, 128, 256, 264])
def test_band_dispatch_takes_every_head_width_and_window(dry_card, D, dtype):
    from decafnet_tpu_torch import ops

    for window in (1, 3, 5, 9, 11, 33, 35):
        for T in (7, 301, 2304):
            ops.band_attention(*_band_args(2, 2, T, D, window, dtype))
            route = tla.band_attention_route(D, window)
            assert route == ("tuned" if D == 32 and 3 <= window <= 9
                             else "wide" if D % 8 == 0 and 8 <= D <= 256 and window <= 33
                             else "general")
            assert dry_card.calls[-1] == _band_entry(route, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C_out", [24, 160, 256, 257, 288, 544, 1024, 1025, 1056,
                                   3000, 4096, 4097, 8000])
def test_conv3_dispatch_takes_every_width_and_level_count(dry_card, C_out, dtype):
    from decafnet_tpu_torch import ops

    route = ("tuned" if C_out <= 256 else "wide" if C_out <= 1024
             else "passes" if C_out <= 4096 else "general")
    assert tfc.conv3_route(C_out) == route
    entry = ("decafnet_conv3_ln_act" + ("" if route == "tuned" else "_" + route)
             + ("_bf16" if dtype == torch.bfloat16 else "_f32"))
    w = torch.zeros(C_out, 16, 3)
    lw, lb = torch.ones(C_out, 1), torch.zeros(C_out, 1)
    for n_levels in (1, 7, 8, 9, 17):
        xs = [torch.zeros(2, 16, max(1, 64 >> lvl), dtype=dtype)
              for lvl in range(n_levels)]
        masks = [torch.ones(2, x.shape[2], dtype=torch.bool) for x in xs]
        before = len(dry_card.calls)
        ys = ops.conv3_ln_act_levels(xs, masks, w, None, lw, lb)
        assert [y.shape for y in ys] == [(2, C_out, x.shape[2]) for x in xs]
        assert dry_card.calls[before:] == [entry] * -(-n_levels // 8)


def test_conv3_general_tile_comes_from_the_kernel_source(dry_card):
    """The general conv3 wrapper takes its work-item width from the C query
    of csrc/conv3_ln_act_general.cu and raises where no tile fits a block."""
    from decafnet_tpu_torch import ops

    assert tfc.conv3_general_tile(544) == _StubLibrary.GENERAL_TILE
    dry_card.tile = 0
    with pytest.raises(ValueError, match="C_out 9000 exceeds the shared memory"):
        ops.conv3_ln_act(torch.zeros(2, 16, 40), torch.ones(2, 40, dtype=torch.bool),
                         torch.zeros(9000, 16, 3))
    assert not dry_card.calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [16, 128, 256, 257, 320, 512, 2048, 4096, 4100])
def test_trio_dispatch_takes_every_width(dry_card, C, dtype):
    from decafnet_tpu_torch import ops

    route = "tuned" if C <= 256 else "wide" if C <= 4096 else "general"
    assert tfc.qkv_route(C) == route
    for T in (7, 301, 2304):
        ops.qkv_depthwise_ln(torch.zeros(2, C, T, dtype=dtype),
                             torch.ones(2, T, dtype=torch.bool),
                             [torch.zeros(C, 1, 3)] * 3, [torch.ones(C)] * 3,
                             [torch.zeros(C)] * 3)
        assert dry_card.calls[-1] == (
            "decafnet_qkv_depthwise_ln" + ("" if route == "tuned" else "_" + route)
            + ("_bf16" if dtype == torch.bfloat16 else "_f32"))


# the served decode call (64 rows, T = 2304) and the MAD one (32 rows,
# T = 32768), all 7 levels, at embd 128 (4 heads of 32, window 5; conv3 at
# C_out 128 and 160, the trio at 128)
DECODE_SHAPES = [(64, 2304), (32, 32768)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,t0", DECODE_SHAPES)
def test_served_and_mad_shapes_keep_the_tuned_kernels(dry_card, rows, t0, dtype):
    from decafnet_tpu_torch import ops

    suffix = "_bf16" if dtype == torch.bfloat16 else "_f32"
    Ts = [t0 >> lvl for lvl in range(7)]
    for T in Ts:
        ops.band_attention(*_band_args(rows, 4, T, 32, 5, dtype))
    assert dry_card.calls == ["decafnet_band_attention" + suffix] * 7
    ops.qkv_depthwise_ln(torch.empty(rows, 128, t0, dtype=dtype),
                         torch.ones(rows, t0, dtype=torch.bool),
                         [torch.zeros(128, 1, 3)] * 3, [torch.ones(128)] * 3,
                         [torch.zeros(128)] * 3)
    assert dry_card.calls[-1] == "decafnet_qkv_depthwise_ln" + suffix
    for C in (128, 160):
        xs = [torch.empty(rows, C, T, dtype=dtype) for T in Ts]
        masks = [torch.ones(rows, T, dtype=torch.bool) for T in Ts]
        ops.conv3_ln_act_levels(xs, masks, torch.zeros(C, C, 3), torch.zeros(C),
                                torch.ones(C, 1), torch.zeros(C, 1))
        assert dry_card.calls[-1] == "decafnet_conv3_ln_act" + suffix
    assert not any("general" in c or "wide" in c for c in dry_card.calls)
