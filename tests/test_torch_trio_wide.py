"""The wide trio kernels (csrc/qkv_depthwise_ln_wide.cu: the depthwise q/k/v
trio at C 257 to 4096, a thread-block cluster whose blocks split the
channels, f32 and bf16).

On the CPU: the launch plan (qkv_wide_plan: every width planned, shared
memory within a block's, the cluster within 8, the tile a multiple of a
warp's columns), the three-way route, the refusals, and a model of the
kernels' statistics (each lane's Welford pass over its channels in order,
the lanes merged by Chan's formula in pairs, then the chunks, then the
cluster's blocks in rank order) held against an f64 run of the function and
against the plain version. On the card (marked ``cuda``, skipped without
one; no JAX here):

    python -m pytest --noconftest -q tests/test_torch_trio_wide.py

the kernels against qkv_depthwise_ln_torch at C 257, 320, 512, 1024 and 4096,
short and long T, a base off 16 bytes, partly and wholly masked rows, a
time-sharded rank's level-0 block, forced plans, and at C 4096 against f64."""

import math

import numpy as np
import pytest
import torch

from chip_smoke import moved
from decafnet_tpu_torch import ops
from decafnet_tpu_torch.ops import cuda, fused_conv as tfc

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)

DTYPES = [torch.float32, torch.bfloat16]
# max |diff| kernel vs plain (as tests/test_torch_kernels.py): the trio sums
# C terms per statistic in another order; bf16 within 2 bf16 eps of
# max(1, |plain|); f32 kernel vs f64 as conv3's (TOL_F64 there)
TOL = 1e-5
TOL_BF16 = 2 * 2.0 ** -7
TOL_F64 = 1e-5
# a time-sharded rank's level-0 block at the served T = 2304: half the
# columns and one halo column each side
SEQ2_T = 2304 // 2 + 2


# ------------------------------------------------------------------ plan

@pytest.mark.parametrize("dtype", DTYPES)
def test_wide_plan_takes_every_width(dtype):
    """Every C of the wide route at short and long T: a cluster of 1 to 8
    blocks whose shares hold C (every block some of it), a chunk within a
    block's share, a tile that is a multiple of a warp's columns with at
    most 256 threads, and a block's shared memory within the card's."""
    cols = 2 if dtype == torch.bfloat16 else 1
    for C in range(tfc.QKV_MAX_C + 1, tfc.QKV_WIDE_MAX_C + 1):
        assert tfc.qkv_route(C) == "wide"
        for T in (7, 36, 301, 2304):
            p = tfc.qkv_wide_plan(C, T, dtype)
            share = -(-C // p.cluster)
            assert 1 <= p.cluster <= tfc.QKV_WIDE_MAX_CLUSTER <= 8
            assert (p.cluster - 1) * share < C <= p.cluster * share
            assert 1 <= p.chunk <= share
            assert p.chunk <= tfc.QKV_WIDE_CHANNELS
            assert p.tile % (32 // tfc.QKV_LANES * cols) == 0
            assert tfc.QKV_LANES * p.tile // cols <= tfc.QKV_WIDE_MAX_THREADS
            assert p.tile == tfc.qkv_depthwise_ln_plan(T, dtype)
            assert (-(-T // p.tile) - 1) * p.tile < T      # no tile left empty
            assert p.smem == tfc.qkv_wide_smem(dtype, p.tile, p.chunk) <= tfc.SMEM_LIMIT


@pytest.mark.parametrize("dtype,C,plan", [
    (torch.float32, 512, (4, 64, 128)), (torch.bfloat16, 512, (4, 64, 128)),
    (torch.float32, 1024, (8, 64, 128)), (torch.bfloat16, 1024, (8, 64, 128)),
    (torch.float32, 257, (3, 64, 86)), (torch.float32, 4096, (8, 64, 128))])
def test_wide_plan_at_model_widths(dtype, C, plan):
    """The embd-512 and embd-1024 legs' widths at the served T, the
    narrowest C and the widest (four chunks a block)."""
    assert tuple(tfc.qkv_wide_plan(C, 2304, dtype))[:3] == plan


def test_wide_smem_counts_each_region():
    """f32, 64 columns: rows of 72 floats (64 + 2 x 4 of halo room, 72 words
    = 8 mod 32); bf16: rows of 80 elements (40 words); per channel a float4
    of taps and a float2 of LN per branch; the mask's 66 floats; the
    exchange's (mean, M2) per branch and column."""
    assert tfc.qkv_wide_row(torch.float32, 64) == 72
    assert tfc.qkv_wide_row(torch.bfloat16, 64) == 80
    assert tfc.qkv_wide_smem(torch.float32, 64, 256) == (
        256 * 72 * 4 + 256 * 3 * (16 + 8) + 66 * 4 + 3 * 8 * 64)
    assert tfc.qkv_wide_smem(torch.bfloat16, 64, 256) == (
        256 * 80 * 2 + 256 * 3 * (16 + 8) + 66 * 4 + 3 * 8 * 64)
    for dtype in DTYPES:
        esz = 2 if dtype == torch.bfloat16 else 4
        for tile in (8, 16, 32, 64, 128):
            row = tfc.qkv_wide_row(dtype, tile)
            # 16-byte rows; the 4 lanes of a column 32 / 4 words apart
            assert row * esz % 16 == 0 and row >= tile + 2 * 16 // esz
            assert row * esz // 4 % 32 == 32 // tfc.QKV_LANES


@pytest.mark.parametrize("kw", [
    {"C": 4097}, {"C": 0}, {"C": 512, "chunk": 257}, {"C": 512, "cluster": 9},
    {"C": 9, "cluster": 4},                    # 3 x 3 >= 9: an empty block
    {"C": 512, "tile": 12}, {"C": 512, "tile": 128},
    {"C": 4096, "cluster": 1, "chunk": 4096}])   # shared memory
def test_wide_plan_refuses_outside_its_envelope(kw):
    C = kw.pop("C")
    with pytest.raises(ValueError, match="qkv_depthwise_ln_wide"):
        tfc.qkv_wide_plan(C, 2304, torch.float32, **kw)


def test_trio_route_three_way():
    assert [tfc.qkv_route(C) for C in (16, 256, 257, 1024, 4096, 4097, 8192)] == [
        "tuned", "tuned", "wide", "wide", "wide", "general", "general"]


# ----------------------------------------------------------------- model

def _f32(a):
    return np.asarray(a, np.float64).astype(np.float32)


def _fma(a, b, c):
    """f32 fmaf: the product exact in f64, one rounding of the sum (the f64
    sum itself can round first, which moves the model by 1 ulp at most)."""
    return _f32(a.astype(np.float64) * b + c)


def _merge(n, nb, mean, m2, mb, qb):
    nn = np.float32(n + nb)
    d = _f32(mb - mean)
    return (_fma(d, _f32(np.float32(nb) / nn), mean),
            _f32(m2 + _fma(_f32(d * d), _f32(np.float32(n) * np.float32(nb) / nn), qb)))


def _welford_lanes(v):
    """One pass: each of the 4 lanes of a column runs Welford's update over
    its channels (l, l + 4, ...: d = y - mean, mean = fmaf(d, 1 / k, mean),
    M2 = fmaf(d, y - mean, M2)); the lanes merge by Chan's formula, (0, 1)
    and (2, 3), then the pairs, the lower part first. Returns (mean, M2)."""
    lanes = []
    for l in range(4):
        n, mean, m2 = 0, np.zeros(v.shape[1:], np.float32), np.zeros(v.shape[1:], np.float32)
        for y in v[l::4]:
            n += 1
            d = _f32(y - mean)
            mean = _fma(d, _f32(1.0 / np.float32(n)), mean)
            m2 = _fma(d, _f32(y - mean), m2)
        lanes.append((n, mean, m2))

    def pair(a, b):
        if a[0] == 0:
            return b
        if b[0] == 0:
            return a
        return (a[0] + b[0], *_merge(a[0], b[0], a[1], a[2], b[1], b[2]))

    return pair(pair(lanes[0], lanes[1]), pair(lanes[2], lanes[3]))[1:]


def model_trio_wide(x, mask, ws, lws, lbs, cluster, chunk, eps=1e-5):
    """The f32 wide kernel's arithmetic in numpy: y = fmaf(w2, r, fmaf(w1,
    m, w0 a)) of the masked x; per block and chunk its mean and M2
    (:func:`_welford_lanes`), chunks merged in order, blocks in rank order;
    rstd = rsqrt(M2 / C + eps); out = fmaf((y - mean) rstd, ln_w, ln_b).
    Returns (q, k, v) f32."""
    B, C, T = x.shape
    xm = _f32(x * mask[:, None, :])
    xp = np.pad(xm, ((0, 0), (0, 0), (1, 1)))
    a, m, r = xp[..., :-2], xp[..., 1:-1], xp[..., 2:]
    share = -(-C // cluster)
    outs = []
    for w, lw, lb in zip(ws, lws, lbs):
        w = w.reshape(C, 3)[:, :, None, None].transpose(1, 2, 0, 3)  # (3, 1, C, 1)
        y = _fma(w[2], r, _fma(w[1], m, _f32(w[0] * a)))             # (B, C, T)
        y = y.transpose(1, 0, 2)                                      # channels first
        stats = []
        for rank in range(cluster):
            lo, hi = rank * share, min(C, rank * share + share)
            n = 0
            for c0 in range(lo, hi, chunk):
                yc = y[c0:min(hi, c0 + chunk)]
                nc = len(yc)
                mk, qk = _welford_lanes(yc)
                if n == 0:
                    mean, m2 = mk, qk
                else:
                    mean, m2 = _merge(n, nc, mean, m2, mk, qk)
                n += nc
            stats.append((n, mean, m2))
        n, mean, m2 = stats[0]
        for nb, mb, qb in stats[1:]:
            mean, m2 = _merge(n, nb, mean, m2, mb, qb)
            n += nb
        rstd = _f32(1.0 / np.sqrt(_f32(_f32(m2 / np.float32(C)) + np.float32(eps))))
        out = _fma(_f32(_f32(y - mean) * rstd), lw.reshape(C, 1, 1), lb.reshape(C, 1, 1))
        outs.append(out.transpose(1, 0, 2))
    return tuple(outs)


def _inputs(B, C, T, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, C, T).astype(np.float32)
    lens = [T, max(1, T * 3 // 5), T // 2, 0][:B]
    mask = (np.arange(T)[None, :] < np.array(lens)[:, None]).astype(np.float32)
    ws = [(rng.randn(C, 1, 3) / np.sqrt(3)).astype(np.float32) for _ in range(3)]
    lws = [(1 + 0.1 * rng.randn(C)).astype(np.float32) for _ in range(3)]
    lbs = [(0.1 * rng.randn(C)).astype(np.float32) for _ in range(3)]
    return x, mask, ws, lws, lbs


def _f64_trio(x, mask, ws, lws, lbs, eps=1e-5):
    """The trio in f64 end to end (torch, CPU)."""
    d = torch.float64
    xm = torch.as_tensor(x, dtype=d) * torch.as_tensor(mask, dtype=d)[:, None, :]
    C = xm.shape[1]
    outs = []
    for w, lw, lb in zip(ws, lws, lbs):
        y = torch.nn.functional.conv1d(xm, torch.as_tensor(w, dtype=d), padding=1, groups=C)
        y = y - y.mean(dim=1, keepdim=True)
        y = y * torch.rsqrt(y.square().mean(dim=1, keepdim=True) + eps)
        outs.append(y * torch.as_tensor(lw, dtype=d).reshape(-1, 1)
                    + torch.as_tensor(lb, dtype=d).reshape(-1, 1))
    return outs


@pytest.mark.parametrize("C,T,cluster,chunk", [
    (4096, 24, 8, 128),      # the widest: 8 blocks of four chunks
    (4096, 24, 1, 512),      # one block re-reading 8 chunks
    (1024, 40, 8, 128),      # the embd-1024 leg's plan
    (512, 40, 4, 128),       # the embd-512 leg's plan
    (777, 17, 3, 100),       # ragged shares and chunks
    (261, 9, 2, 130)])       # a last chunk of one channel: lanes with none
def test_wide_model_matches_f64_and_plain(C, T, cluster, chunk):
    """The kernels' order of additions, in f32, within TOL_F64 of the f64
    function and within TOL of the plain version, on partly and wholly
    masked rows."""
    x, mask, ws, lws, lbs = _inputs(4, C, T, C + T + cluster)
    got = model_trio_wide(x, mask, ws, lws, lbs, cluster, chunk)
    f64 = _f64_trio(x, mask, ws, lws, lbs)
    plain = tfc.qkv_depthwise_ln_torch(
        torch.from_numpy(x), torch.from_numpy(mask > 0), [torch.from_numpy(w) for w in ws],
        [torch.from_numpy(v) for v in lws], [torch.from_numpy(v) for v in lbs])
    for g, r, p in zip(got, f64, plain, strict=True):
        assert np.isfinite(g).all()
        assert float(np.abs(g - r.numpy()).max()) <= TOL_F64
        assert float(np.abs(g - p.numpy()).max()) <= TOL


# ------------------------------------------------------------------ card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _case(card, B, C, T, dtype, seed, how="as_is", lens=None):
    g = torch.Generator(device=card).manual_seed(seed)
    lens = lens or ([T, max(1, T * 3 // 5), T // 2, 0] * B)[:B]
    mask = torch.arange(T, device=card)[None, :] < torch.tensor(lens, device=card)[:, None]

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=card)

    return (moved(rn(B, C, T).to(dtype), how), mask,
            [rn(C, 1, 3) / math.sqrt(3) for _ in range(3)],
            [1 + 0.1 * rn(C, 1) for _ in range(3)], [0.1 * rn(C, 1) for _ in range(3)])


def _close(got, want, dtype):
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype == dtype
        assert torch.isfinite(g).all()
        g, w = g.float(), w.float()
        if dtype == torch.bfloat16:
            assert float(((g - w).abs() / w.abs().clamp_min(1.0)).max()) <= TOL_BF16
        else:
            assert float((g - w).abs().max()) <= TOL


def _counts():
    op = ops.qkv_depthwise_ln
    return {a: getattr(op, a) for a in ops.COUNTERS}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T", [7, 36, 301, 2304])
@pytest.mark.parametrize("C", [257, 320, 512, 1024])
def test_wide_trio_matches_plain(card, C, T, dtype):
    """Through the route: one wide launch and no other, rows valid, partly
    valid and all masked."""
    args = _case(card, 4, C, T, dtype, C + T)
    before = _counts()
    got = ops.qkv_depthwise_ln(*args)
    attr = "launches_wide" + ("_bf16" if dtype == torch.bfloat16 else "")
    assert _counts() == {a: v + (a == attr) for a, v in before.items()}
    with cuda.plain_versions():
        want = ops.qkv_depthwise_ln(*args)
    torch.cuda.synchronize()
    _close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,T,how", [
    (4096, 301, "as_is"), (4096, 36, "offset"),   # the widest, few rows
    (320, 301, "offset"), (1024, 2304, "offset"), (257, 36, "offset"),
    (512, SEQ2_T, "as_is"), (1024, SEQ2_T, "offset"),
    (512, 300, "as_is"), (512, 302, "as_is")])  # rows on 16 / 8 / 4 bytes
def test_wide_trio_layouts(card, C, T, how, dtype):
    """The base 4 (bf16: 2) bytes off 16, rows whose length allows only 8-
    or 4-byte copies (and, in bf16, single loads at odd T), a seq2 rank's
    level-0 block widened by its halo; 2 rows at C 4096."""
    args = _case(card, 2 if C == 4096 else 4, C, T, dtype, C + T, how)
    got = ops.qkv_depthwise_ln(*args)
    with cuda.plain_versions():
        want = ops.qkv_depthwise_ln(*args)
    torch.cuda.synchronize()
    _close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,plan", [
    (1024, (1, 64, 256)), (1024, (1, 32, 512)), (1024, (1, 16, 512)),
    (1024, (2, 64, 128)), (1024, (8, 64, 128)), (512, (4, 32, 128)),
    (777, (3, 32, 100)), (300, (1, 64, 300)), (261, (2, 32, 130))])
def test_wide_trio_forced_plans(card, C, plan, dtype):
    """The plans the design study times: one block re-reading its chunks,
    narrower tiles, larger clusters, ragged shares, a last chunk of one
    channel."""
    T = 301
    args = _case(card, 4, C, T, dtype, C + sum(plan))
    p = tfc.qkv_wide_plan(C, T, dtype, *plan)
    got = tfc.launch_qkv_depthwise_ln_wide(*args, 1e-5, p)
    with cuda.plain_versions():
        want = ops.qkv_depthwise_ln(*args)
    torch.cuda.synchronize()
    _close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [None, (1, 64, 512)])
@pytest.mark.parametrize("T", [36, 301])
def test_wide_trio_f32_matches_f64_at_4096(card, T, plan):
    """The merged statistics (each lane's Welford pass, then Chan's formula
    over lanes, chunks and blocks) keep f32 accuracy at the widest C: the
    plan's 8 blocks of 4 chunks, and one block of 8 chunks."""
    args = _case(card, 2, 4096, T, torch.float32, T)
    got = tfc.launch_qkv_depthwise_ln_wide(
        *args, 1e-5, tfc.qkv_wide_plan(4096, T, torch.float32, *(plan or ())))
    x, mask, ws, lws, lbs = args
    want = _f64_trio(x.cpu().numpy(), mask.cpu().numpy().astype(np.float32),
                     [w.cpu().numpy() for w in ws], [v.cpu().numpy() for v in lws],
                     [v.cpu().numpy() for v in lbs])
    for g, w in zip(got, want, strict=True):
        assert float((g.double().cpu() - w).abs().max()) <= TOL_F64


@pytest.mark.cuda
def test_wide_trio_all_masked_writes_ln_b(card):
    """Tiles with no valid column (halo included) write ln_b and read no x:
    NaN in x there stays out of the outputs."""
    x, _, ws, lws, lbs = _case(card, 2, 1024, 200, torch.float32, 5)
    x[1] = float("nan")
    mask = torch.zeros(2, 200, dtype=torch.bool, device=card)
    mask[0] = True
    got = ops.qkv_depthwise_ln(x, mask, ws, lws, lbs)
    for g, lb in zip(got, lbs, strict=True):
        assert torch.isfinite(g[0]).all()
        assert torch.equal(g[1], lb.reshape(1024, 1).expand(1024, 200))


@pytest.mark.cuda
def test_wide_trio_refuses_a_plan_outside_the_kernel(card):
    """The C entry point checks the plan itself: a chunk over a block's
    share comes back as cudaErrorInvalidValue, raised."""
    args = _case(card, 2, 512, 64, torch.float32, 0)
    bad = tfc.QkvWidePlan(cluster=2, tile=64, chunk=300, smem=0)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        tfc.launch_qkv_depthwise_ln_wide(*args, 1e-5, bad)
