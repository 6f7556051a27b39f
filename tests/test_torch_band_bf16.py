"""The bf16 band-attention kernel of csrc/band_attention.cu
(``band_attention_bf16_kernel``): its launch plan and summation order on the
CPU, the kernel against its plain version on the card.

On the CPU: ``band_attention_bf16_plan`` and the kernel's mapping of work
items, consumer warps and lanes to (column, head dim) give every output
element exactly one owner, at the served FPN lengths and edge lengths, for
4 and 64 rows on 132- and 114-SM cards; a model of the kernel's arithmetic
(two queries per lane, each lane part summing its head dims in order, the
parts meeting in the xor-shuffle tree, the masked softmax scaled by the
reciprocal of its clamped sum, fma sums of the weighted values, one
rounding to bf16) matches the JAX ``band_attention_diag`` in bf16 within 2
bf16 eps of max(1, |ref|), the tolerance of tests/test_torch_bf16.py;
``band_bf16_pipelined`` tells the views the kernel's pipeline reads, and
under time sharding band_attention hands the kernel time-minor views.

The card cases are marked ``cuda`` and skip without a card; they import no
JAX, so on the card:

    python -m pytest --noconftest -q tests/test_torch_band_bf16.py

(the JAX comparison then skips)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import moved
from decafnet_tpu_torch import ops
from decafnet_tpu_torch.ops import cuda
from decafnet_tpu_torch.ops import local_attention as tla

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)

# the served lengths (T=2304 and its 6 halvings) and edge lengths
SERVED_T = [2304 // 2 ** lvl for lvl in range(7)]
EDGE_T = [1000, 301, 36, 17, 9, 4, 3, 1]
# multiprocessors of an H100 SXM and of an H100 PCIe
SMS = [132, 114]
# the kernel's TMA pipeline (split 1): 8 consumer warps in groups of 2 per
# work item of 128 columns (64 a warp), 4 groups, 2 stages each
# (csrc/band_attention.cu: BF_GROUP, BF_GROUPS, BF_STAGES); its direct path
# (split 4): a warp per item of 16 columns, 12 warps a block
GROUP, GROUPS, STAGES = 2, 4, 8
D = 32
# bf16 kernel vs its plain version, and the model vs JAX: 2 bf16 eps of
# max(1, |ref|) (tests/test_torch_bf16.py, chip_smoke.TOL_BF16)
TOL_BF16 = 2 * 2.0 ** -7


# ------------------------------------------------------------------- plans

def _owners(T, split, grid, rows):
    """How many lanes write each (row, column, dim) element, walking the
    kernel's loops, and how often each work item is visited. Split 1:
    block x takes items x, x + grid, ...; its n-th item goes to consumer
    group n % 4 (stage n % 8); warp w of the group takes columns 64 w ..
    of the item's 128, lane l the query pair at 2 l and every dim. Split
    4: warp w of block x takes items 12 x + w, 12 (x + grid) + w, ...;
    lane l the query pair at 2 (l % 8) of the item's 16 columns and dims
    part, part + 4, ... with part = l // 8."""
    lane = np.arange(32)
    if split == 1:
        cols, part, pair = tla.BAND_BF16_TILE, np.zeros(32, int), lane
    else:
        cols, part, pair = tla.BAND_BF16_WARP_COLS, lane // 8, lane % 8
    n_tiles = -(-T // cols)
    n_items = rows * n_tiles
    owned = np.zeros((rows, T, D), np.int64)
    seen = np.zeros(n_items, np.int64)

    def own(item, first):
        bh, t0 = item // n_tiles, item % n_tiles * cols
        col = t0 + first + 2 * pair
        for dt in (0, 1):
            for i in range(D // split):
                d = i * split + part
                keep = col + dt < T
                np.add.at(owned, (bh, col[keep] + dt, d[keep]), 1)

    for x in range(grid):
        if split == 1:
            for n, item in enumerate(range(x, n_items, grid)):
                seen[item] += 1
                assert (n % STAGES) % GROUPS == n % GROUPS  # a stage has one group
                for w in range(GROUP):
                    own(item, w * (cols // GROUP))
        else:
            for w in range(tla.BAND_BF16_WARPS):
                for item in range(x * tla.BAND_BF16_WARPS + w, n_items,
                                  grid * tla.BAND_BF16_WARPS):
                    seen[item] += 1
                    own(item, 0)
    return owned, seen


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("rows", [64, 4])
@pytest.mark.parametrize("T", SERVED_T + EDGE_T)
def test_bf16_plan_owns_every_column(T, rows, sms):
    split, grid = tla.band_attention_bf16_plan(rows, 4, T, sms)
    assert split in (1, 4) and grid >= 1
    if split == 1:
        assert grid <= min(sms, rows * 4 * -(-T // tla.BAND_BF16_TILE))
    else:  # a warp per item
        items = rows * 4 * -(-T // tla.BAND_BF16_WARP_COLS)
        assert grid == -(-items // tla.BAND_BF16_WARPS)
    # one (b, h) is enough for the mapping; every row walks the same items
    owned, seen = _owners(T, split, grid if split == 4 else min(grid, 18), 1)
    assert (seen == 1).all()
    assert (owned == 1).all()


@pytest.mark.parametrize("grid", [1, 3, 132, 264])
@pytest.mark.parametrize("split", [1, 4])
@pytest.mark.parametrize("T", [301, 36, 3])
def test_bf16_every_plan_owns_every_column(T, split, grid):
    """Every (split, grid) the kernel takes, as the study script and the
    card tests launch them, over 3 rows."""
    owned, seen = _owners(T, split, grid, 3)
    assert (seen == 1).all() and (owned == 1).all()


@pytest.mark.parametrize("sms", SMS)
def test_bf16_plan_splits_only_short_levels(sms):
    plans = [tla.band_attention_bf16_plan(64, 4, T, sms) for T in SERVED_T]
    splits = [s for s, _ in plans]
    assert splits == sorted(splits) and splits[0] == 1 and splits[-1] == 4
    # the pipeline where the queries number at least its consumer lanes
    lanes = 8 * 32 * sms
    for T, (s, g) in zip(SERVED_T, plans):
        assert (s == 1) == (64 * 4 * T >= lanes)
        if s == 1:  # every long level fills the card, a block per SM
            assert g == sms


def test_bf16_plan_values_and_views_it_pipelines():
    assert tla.band_attention_bf16_plan(4, 4, 2304, 132) == (1, 132)
    assert tla.band_attention_bf16_plan(4, 4, 2304, 132, False) == (4, 192)
    assert tla.band_attention_bf16_plan(64, 4, 2304, 132, False) == (4, 3072)
    assert tla.band_attention_bf16_plan(1, 1, 36000, 132) == (1, 132)
    assert tla.band_attention_bf16_plan(64, 4, 72, 132) == (4, 107)
    assert tla.band_attention_bf16_plan(64, 4, 36, 114) == (4, 64)


@pytest.mark.parametrize("T,how,pipelined", [
    (2304, "as_is", True),          # served: TMA
    (1156, "as_is", True),          # a seq2 rank's widened block: 8-byte copies
    (301, "padded", True),          # rows padded to 8 bytes
    (2304, "contiguous", False),    # (B, H, T, D): head dim fastest
    (2304, "offset", False),        # a base 2 bytes off
    (301, "as_is", False),          # odd T
    (22, "as_is", False),           # rows on 4 bytes
])
def test_bf16_pipelined_views(T, how, pipelined):
    q, k, v, _, _ = _views(torch.device("cpu"), 2, T, how=how)
    assert tla.band_bf16_pipelined(q, k, v) is pipelined
    # views with strides of their own are made contiguous: (B, H, T, D)
    assert not tla.band_bf16_pipelined(q, k.contiguous(), v)


# ------------------------------------------------------- summation order

def _xor_tree(parts):
    """The kernel's __shfl_xor_sync sum of per-part partials: offsets
    32 // split, then twice that, so parts (0+1) + (2+3)."""
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
    return parts[0]


def _fma(a, b, c):
    """fmaf(a, b, c) of f32 tensors: the product and sum in f64 (a bf16
    times an f32 is exact there), rounded once to f32."""
    return (a.double() * b.double() + c.double()).float()


def _band_bf16_model(q, k, v, mask, window, split):
    """The bf16 kernel's arithmetic on bf16 q, k, v: per query, lane part p
    sums q[d] * k[d] over d = p, p + split, ... in order (the products are
    exact in f32, so fmaf and a rounded add agree), the parts meet in the
    xor tree; softmax over the valid band keys with the max subtracted (e^x
    as 2^(x log2 e)), p scaled by 1 / max(sum, FLT_MIN); the value sum by
    fmaf in band order; invalid queries 0; one rounding to bf16. (The query pair per lane shares
    its reads only: each query's sums are its own.)"""
    halo = window // 2
    B, H, T, _ = q.shape
    q, k, v = q.float(), k.float(), v.float()
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
    p = torch.where(ok, torch.exp2((s - m) * 1.4426950408889634), 0.0)
    den = torch.zeros(B, H, T, 1)
    for r in range(window):
        den = den + p[..., r:r + 1]
    p = p * (1.0 / den.clamp_min(torch.finfo(torch.float32).tiny))
    out = torch.zeros(B, H, T, D)
    for r in range(window):
        out = _fma(p[..., r:r + 1], vp[:, :, r:r + T], out)
    return torch.where(mask[:, None, :, None], out, 0.0).to(torch.bfloat16)


def _bf16_inputs(T, seed, B=3, H=2):
    rng = np.random.RandomState(seed)
    qkv = [torch.from_numpy((rng.randn(B, H, T, D) * D ** -0.25)
                            .astype(np.float32)).to(torch.bfloat16)
           for _ in range(3)]
    mask = rng.rand(B, T) < 0.8
    mask[0, :] = True
    mask[1, :] = False                      # an all-masked row
    mask[2, T // 2:] = False                # a masked tail
    return qkv, torch.from_numpy(mask)


@pytest.mark.parametrize("T,window", [(64, 5), (37, 5), (40, 3), (40, 9), (40, 7)])
@pytest.mark.parametrize("split", [1, 4])
def test_bf16_model_matches_jax_diag(split, T, window):
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    from decafnet_tpu.ops import local_attention as jla

    (q, k, v), mask = _bf16_inputs(T, seed=T + window)
    got = _band_bf16_model(q, k, v, mask, window, split)
    as_jax = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
              for t in (q, k, v)]
    want = jax.jit(lambda a, b, c, m: jla.band_attention_diag(
        a, b, c, m, window_size=window))(*as_jax, mask.numpy())
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= TOL_BF16, err.max()


@pytest.mark.parametrize("split", [1, 4])
def test_bf16_model_matches_plain_version(split):
    """The model against the port's plain bf16 version, which the card
    holds the kernel to: the same one rounding, sums in another order."""
    (q, k, v), mask = _bf16_inputs(50, seed=split)
    got = _band_bf16_model(q, k, v, mask, 7, split).float()
    want = tla.band_attention_torch(q, k, v, mask, 7).float()
    assert float(((got - want).abs() / want.abs().clamp_min(1.0)).max()) <= TOL_BF16


# ---------------------------------------------------------- time sharding

class _OneRank:
    """The halo exchange of a time-sharded group of one rank: the new
    columns lie past the video's ends (zeros; False in a mask), as
    ``TimeShard.halo`` widens them there."""

    def halo(self, *xs, left, right, axis=-1, fill=0.0):
        def widen(x):
            pad = [0, 0] * (x.dim() - 1 - axis % x.dim()) + [left, right]
            return F.pad(x, pad, value=False if x.dtype == torch.bool else fill)
        return tuple(widen(x) for x in xs)


def _sharded(args, monkeypatch):
    """band_attention under one rank's time sharding, and the views its
    sharded branch hands to the kernel's wrapper."""
    from decafnet_tpu_torch.parallel import seq

    seen, forward = [], tla._band_attention

    def spy(q, k, v, *rest):
        seen.append((q, k, v))
        return forward(q, k, v, *rest)

    monkeypatch.setattr(tla, "_band_attention", spy)
    with seq.sharding(_OneRank()):
        out = ops.band_attention(*args)
    return out, seen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_time_sharded_views_are_time_minor(dtype, monkeypatch):
    """Under time sharding the widened q, k and v reach the kernel's
    wrapper as time-minor (B, H, D, T + 2 halo) buffers, which the bf16
    pipeline reads; the result is the unsharded one."""
    (q, k, v), mask = _bf16_inputs(40, seed=3)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    out, seen = _sharded((q, k, v, mask, 5), monkeypatch)
    [(qh, kh, vh)] = seen
    assert qh.shape == (3, 2, 44, D) and qh.stride() == kh.stride() == vh.stride()
    assert qh.stride()[2:] == (1, 44) and qh.transpose(2, 3).is_contiguous()
    assert tla.band_bf16_pipelined(qh, kh, vh)
    want = tla.band_attention_torch(q, k, v, mask, 5)
    assert out.dtype == dtype and torch.equal(out, want)


# ------------------------------------------------------------------ card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def _views(dev, B, T, seed=0, how="as_is", window=5, lens=None):
    """bf16 (B, 4, T, 32) head views of (B, 128, T) projections laid out as
    ``how`` says (chip_smoke.moved; "contiguous": (B, H, T, D) tensors),
    with rows of lengths T, T - 3, T // 2 and 0 (an all-masked row)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lens = lens or ([T, max(T - 3, 1), T // 2, 0] * B)[:B]
    mask = torch.arange(T, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
    qkv = [moved((torch.randn(B, 4 * D, T, generator=g, device=dev) * D ** -0.25)
                 .to(torch.bfloat16), "as_is" if how == "contiguous" else how)
           .reshape(B, 4, D, T).transpose(2, 3) for _ in range(3)]
    if how == "contiguous":
        qkv = [t.contiguous() for t in qkv]
    return (*qkv, mask, window)


def _check(args, plan=None):
    """The kernel (the wrapper's plan, or ``plan``) against the plain version
    in bf16; one bf16 launch, no f32 one."""
    op = ops.band_attention
    before = (op.launches, op.launches_bf16)
    got = (op(*args) if plan is None
           else tla.launch_band_attention(*args, plan))
    assert (op.launches, op.launches_bf16) == (before[0], before[1] + 1)
    with cuda.plain_versions():
        want = op(*args)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype == torch.bfloat16
    assert torch.isfinite(got).all()
    g, w = got.float(), want.float()
    assert float(((g - w).abs() / w.abs().clamp_min(1.0)).max()) <= TOL_BF16


@pytest.mark.cuda
@pytest.mark.parametrize("level", range(7))
def test_bf16_kernel_served_levels(card, level):
    """The served decode call's 64 rows at each FPN level: 8 videos of
    chip_smoke.VIDEO_LENS clips, 8 queries each."""
    import chip_smoke as cs

    T = cs.T0 // 2 ** level
    _check(_views(card, cs.ROWS, T, lens=cs.row_lens(level)))


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["as_is", "contiguous", "offset", "padded"])
@pytest.mark.parametrize("T", [1000, 301, 36, 17, 9, 4, 3])
def test_bf16_kernel_edge_shapes(card, T, how):
    _check(_views(card, 4, T, how=how))


@pytest.mark.cuda
@pytest.mark.parametrize("window", [3, 5, 7, 9])
@pytest.mark.parametrize("T,how", [(576, "as_is"), (301, "offset"), (36, "as_is"),
                                   (144, "contiguous")])
def test_bf16_kernel_windows(card, window, T, how):
    _check(_views(card, 8, T, how=how, window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [1, 7, 132, 264])
@pytest.mark.parametrize("split,T,how", [
    (s, T, how) for s in (1, 4)
    for T, how in [(2304, "as_is"), (301, "padded"), (72, "as_is"), (36, "as_is"),
                   (1156, "as_is"), (40, "contiguous"), (301, "offset")]
    if s == 4 or how not in ("contiguous", "offset")])
def test_bf16_kernel_every_plan(card, split, grid, T, how):
    _check(_views(card, 6, T, how=how), plan=(split, grid))


@pytest.mark.cuda
@pytest.mark.parametrize("T,how", [(40, "contiguous"), (301, "offset"), (301, "as_is")])
def test_bf16_pipeline_refuses_views_it_cannot_read(card, T, how):
    """Split 1 on views that are not time-contiguous on 8 bytes: the C
    entry refuses the launch, nothing is counted."""
    args = _views(card, 6, T, how=how)
    assert not tla.band_bf16_pipelined(*args[:3])
    before = ops.band_attention.launches_bf16
    with pytest.raises(RuntimeError, match="cudaError 1"):
        tla.launch_band_attention(*args, (1, 7))
    assert ops.band_attention.launches_bf16 == before


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(4, 300), (32, 1152)])
def test_bf16_kernel_time_sharded_layout(card, B, T, monkeypatch):
    """band_attention under one rank's time sharding: the widened q, k, v
    (time-minor, T + 4 columns) through the kernel against the plain
    version, and the seq2 rank's level 0 on the pipeline (split 1)."""
    args = _views(card, B, T)
    before = ops.band_attention.launches_bf16
    got, [qkv] = _sharded(args, monkeypatch)
    assert ops.band_attention.launches_bf16 == before + 1
    assert tla.band_bf16_pipelined(*qkv)
    if B == 32:
        assert tla.band_attention_bf16_plan(B, 4, T + 4, cuda.sm_count(card))[0] == 1
    with cuda.plain_versions():
        want = ops.band_attention(*args)
    g, w = got.float(), want.float()
    assert float(((g - w).abs() / w.abs().clamp_min(1.0)).max()) <= TOL_BF16


@pytest.mark.cuda
def test_bf16_kernel_more_than_65535_heads(card):
    _check(_views(card, 16400, 3))


@pytest.mark.cuda
def test_bf16_kernel_all_masked(card):
    """Every row masked: every item skips its loads and writes zeros."""
    q, k, v, mask, window = _views(card, 4, 2304)
    mask = torch.zeros_like(mask)
    out = ops.band_attention(q, k, v, mask, window)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and (out == 0).all()
