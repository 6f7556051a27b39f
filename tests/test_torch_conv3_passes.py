"""The pass conv3 kernels' wrapper on the CPU (csrc/conv3_ln_act_passes.cu:
C_out 1025 to 4096, one block per 128-column item computing the output
channels in passes of 128 or 160, the pre-LN sums kept in the output until
the LN statistics are known; f32 in 3xTF32 and bf16 on wgmma).

The kernels run only on the card (tests/test_torch_kernels.py holds them
against the plain version there). Here: the Python mirror of their launch
plan (passes that cover every channel once, a block's shared memory), the
pass weight images read back through the swizzles the kernels' descriptors
name, the four-way route, the plain version at C_out 1056 against the JAX
package's composition and its Pallas kernel in interpret mode, and a model
of the kernels' LayerNorm (the passes' sums for the mean, the stored
pre-LN values read back for the centred variance) against both."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from decafnet_tpu.ops import fused_conv as jfc
from decafnet_tpu_torch.ops import fused_conv as tfc

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)

DTYPES = [torch.float32, torch.bfloat16]
LIMIT = tfc.CONV3_PASSES_MAX_C
# C_out: the route's first, the embd-1024 heads' (cls_head2, reg_head),
# one that 128 divides, the JAX kernel's widest (~3,300) and the limit;
# (channels a pass, passes)
PLANS = {1025: (160, 7), 1056: (160, 7), 2048: (128, 16), 3300: (128, 26),
         LIMIT: (128, 32)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C_out", list(PLANS))
def test_passes_plan_covers_every_channel_once(dtype, C_out):
    """Every output channel lies in exactly one pass, each pass holds some
    of C_out, the padding is less than a pass, and a block fits the card's
    shared memory with a ring of at least 2 stages."""
    p = tfc.conv3_passes_plan(dtype, C_out)
    assert (p.slice, p.passes) == PLANS[C_out]
    owner = np.repeat(np.arange(p.passes), p.slice)[:C_out]
    assert np.bincount(owner, minlength=p.passes).min() >= 1
    assert len(owner) == C_out and p.passes * p.slice >= C_out
    assert 2 <= p.stages <= tfc.CONV3_PASSES_MAX_STAGES and p.smem <= tfc.SMEM_LIMIT
    assert p.tile == tfc.CONV3_PASSES_TILE == 128


@pytest.mark.parametrize("dtype", DTYPES)
def test_passes_plan_over_the_whole_route(dtype):
    """At every C_out of the pass route the slice is the one of
    CONV3_PASSES_SLICES that pads C_out least (the wider one on a tie),
    and the passes cover it once."""
    for C_out in range(tfc.CONV3_WIDE_MAX_C + 1, LIMIT + 1):
        assert tfc.conv3_route(C_out) == "passes"
        p = tfc.conv3_passes_plan(dtype, C_out)
        assert p.slice in tfc.CONV3_PASSES_SLICES
        assert (p.passes - 1) * p.slice < C_out <= p.passes * p.slice
        pads = {n: n * -(-C_out // n) - C_out for n in tfc.CONV3_PASSES_SLICES}
        assert pads[p.slice] == min(pads.values())
        assert p.slice == max(n for n in pads if pads[n] == pads[p.slice])


@pytest.mark.parametrize("dtype", DTYPES)
def test_passes_plan_refuses_what_the_kernels_do_not_take(dtype):
    for C_out in (0, -3, LIMIT + 1, 8000):
        with pytest.raises(ValueError, match="C_out"):
            tfc.conv3_passes_plan(dtype, C_out)
    # narrower layers take one pass or a few (the card checks force them)
    assert tfc.conv3_passes_plan(dtype, 24).passes == 1


def test_passes_plan_stages_fill_the_block():
    """f32: 6 boxes of x (6 KB) beside 192 bytes of weights a channel; bf16:
    4 boxes (16 KB); the ring as deep as the block's 227 KB allow, at most
    6 stages."""
    f, b = torch.float32, torch.bfloat16
    assert [tfc.conv3_passes_plan(f, c).stages for c in (2048, 1056)] == [6, 6]
    assert [tfc.conv3_passes_plan(b, c).stages for c in (2048, 1056)] == [5, 4]
    assert tfc.conv3_passes_plan(f, 1056).smem == 6 * (6144 + 192 * 160) + 6 * 16 + 1024


@pytest.mark.parametrize("edge", [(256, 257), (1024, 1025), (LIMIT, LIMIT + 1)])
def test_route_is_four_way_at_its_edges(edge):
    order = ["tuned", "wide", "passes", "general"]
    below, above = (tfc.conv3_route(c) for c in edge)
    assert order.index(above) == order.index(below) + 1
    assert tfc.conv3_route(1) == "tuned" and tfc.conv3_route(10 ** 5) == "general"


def _unswizzle(img, k, piece, shift):
    """(nc, 3, N, k) image back to (N, k nc, 3): row n's 16-byte pieces p
    (of ``piece`` elements) sit at p ^ ((n >> shift) % (k // piece))."""
    f = img.float().numpy()
    nc, _, N, _ = f.shape
    n_p = k // piece
    w = np.full((N, k * nc, 3), np.nan, np.float32)
    for n in range(N):
        for p in range(n_p):
            pp = p ^ ((n >> shift) % n_p)
            for c in range(nc):
                w[n, k * c + piece * p:k * c + piece * (p + 1)] = \
                    f[c, :, n, piece * pp:piece * (pp + 1)].T
    return w


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c_in,c_out", [(16, 1025), (9, 1056), (40, 2048)])
def test_passes_images_unswizzle_to_w(dtype, c_in, c_out):
    """Each pass's image is the tuned kernel's image of its channels at N =
    slice: read back through the swizzle (bf16 64 bytes, f32 32 bytes), the
    passes one after the other are w (its bf16 rounding; in f32 the TF32 hi
    and lo halves), zero where padded in channels and inputs."""
    w = torch.from_numpy(np.random.RandomState(c_in + c_out)
                         .randn(c_out, c_in, 3).astype(np.float32))
    p = tfc.conv3_passes_plan(dtype, c_out)
    img = tfc.conv3_passes_operands(w, dtype)
    k = 32 if dtype == torch.bfloat16 else 8
    nc = -(-c_in // k)
    want = np.zeros((p.passes * p.slice, k * nc, 3), np.float32)
    if dtype == torch.bfloat16:
        assert img.shape == (p.passes, nc, 3, p.slice, 32) and img.dtype == dtype
        got = np.concatenate([_unswizzle(s, 32, 8, 1) for s in img])
        want[:c_out, :c_in] = w.to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(got, want)
    else:
        assert img.shape == (p.passes, nc, 2, 3, p.slice, 8) and img.dtype == dtype
        hi = np.concatenate([_unswizzle(s[:, 0], 8, 4, 2) for s in img])
        lo = np.concatenate([_unswizzle(s[:, 1], 8, 4, 2) for s in img])
        want[:c_out, :c_in] = w.numpy()
        hi_want, lo_want = (t.numpy() for t in tfc.tf32_split(torch.from_numpy(want)))
        np.testing.assert_array_equal(hi, hi_want)
        np.testing.assert_array_equal(lo, lo_want)
    assert img.is_contiguous()


@pytest.mark.parametrize("dtype", DTYPES)
def test_passes_operands_follow_the_weights_version(dtype):
    w = torch.nn.Parameter(torch.randn(1056, 8, 3))
    first = tfc.conv3_passes_operands(w, dtype)
    assert tfc.conv3_passes_operands(w, dtype) is first
    with torch.no_grad():
        w.mul_(2.0)
    second = tfc.conv3_passes_operands(w, dtype)
    assert second is not first
    assert torch.equal(second.float(), 2 * first.float())


def _passes_model(x, mask, w, bias, ln_w, ln_b, dtype=torch.float32, eps=1e-5):
    """conv3_ln_act as the pass kernels compute it (relu): the weight padded
    to passes x slice channels, each pass's conv and bias (in bf16 the conv
    rounded, plus the rounded bias, rounded) stored in the output's dtype,
    the mean from the passes' sums added in pass order, the centred
    variance and the result from the stored values."""
    C_out = w.shape[0]
    p = tfc.conv3_passes_plan(dtype, C_out)
    wp = torch.zeros(p.passes * p.slice, *w.shape[1:])
    wp[:C_out] = w.to(dtype).float()
    xm = (x.to(dtype) * mask[:, None, :].to(dtype)).float()
    stored, s = [], 0.0
    for r, ws in enumerate(wp.split(p.slice)):
        n = min(p.slice, C_out - r * p.slice)
        y = F.conv1d(xm, ws, padding=1)[:, :n]
        b = bias[r * p.slice:r * p.slice + n, None]
        if dtype == torch.bfloat16:
            y = (y.to(dtype) + b.to(dtype)).float()
        else:
            y = y + b
        stored.append(y)
        s = s + y.sum(1)
    mean = s / C_out
    v = 0.0
    for y in stored:
        v = v + (y - mean[:, None]).square().sum(1)
    rstd = torch.rsqrt(v / C_out + eps)
    y = torch.cat(stored, 1)
    y = (y - mean[:, None]) * rstd[:, None] * ln_w.reshape(-1, 1) + ln_b.reshape(-1, 1)
    return torch.relu(y).to(dtype)


def _inputs(B, c_in, c_out, T, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, c_in, T).astype(np.float32)
    lens = [T] + list(rng.randint(0, T + 1, B - 1))
    mask = np.arange(T)[None, :] < np.asarray(lens)[:, None]
    w = (rng.randn(c_out, c_in, 3) / np.sqrt(3 * c_in)).astype(np.float32)
    b = rng.randn(c_out).astype(np.float32)
    lw = (1 + 0.1 * rng.randn(c_out)).astype(np.float32)
    lb = (0.1 * rng.randn(c_out)).astype(np.float32)
    return x, mask, w, b, lw, lb


@pytest.mark.parametrize("c_in,c_out,T", [(64, 1056, 37), (32, 1025, 9),
                                          (16, 2048, 5)])
def test_plain_and_passes_model_match_jax(c_in, c_out, T):
    """The plain version and the pass model against the JAX composition
    within 1e-5 (absolute)."""
    args = _inputs(3, c_in, c_out, T, c_out + T)
    want = np.asarray(jax.jit(jfc.conv3_ln_act_xla)(*map(jnp.asarray, args)))
    targs = tuple(map(torch.from_numpy, args))
    plain = tfc.conv3_ln_act_torch(*targs).numpy()
    np.testing.assert_allclose(plain, want, rtol=0, atol=1e-5)
    got = _passes_model(*targs).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_plain_and_passes_model_match_pallas_interpret():
    """C_out 1056 through the JAX Pallas kernel in interpret mode at T 24."""
    args = _inputs(2, 32, 1056, 24, 7)
    want = np.asarray(jfc.conv3_ln_act_pallas(*map(jnp.asarray, args),
                                              interpret=True))
    targs = tuple(map(torch.from_numpy, args))
    np.testing.assert_allclose(tfc.conv3_ln_act_torch(*targs).numpy(), want,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(_passes_model(*targs).numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("bias", [False, True])
def test_bf16_passes_model_matches_plain(bias):
    """The bf16 pass model (pre-LN values rounded where the composition
    rounds them, stored in bf16) against the plain bf16 version on the
    CPU, within 2 bf16 eps of max(1, |plain|)."""
    x, mask, w, b, lw, lb = map(torch.from_numpy, _inputs(3, 48, 1056, 29, 11))
    b = b if bias else torch.zeros_like(b)
    got = _passes_model(x, mask, w, b, lw, lb, torch.bfloat16).float()
    want = tfc.conv3_ln_act_torch(x.to(torch.bfloat16), mask, w, b if bias else None,
                                  lw, lb).float()
    assert float(((got - want).abs() / want.abs().clamp_min(1.0)).max()) <= 2 * 2.0 ** -7
