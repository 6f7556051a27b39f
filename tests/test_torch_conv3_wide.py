"""The wide conv3 kernels' wrapper on the CPU (csrc/conv3_ln_act_wide.cu:
C_out 257 to 1024, a thread-block cluster whose blocks split the output
channels, f32 in 3xTF32 and bf16 on wgmma).

The kernels run only on the card (tests/test_torch_kernels.py holds them
against the plain version there). Here: the Python mirror of their launch
plan (slices that cover every channel once, a block's shared memory, the
cluster size), the sliced weight images read back through the swizzles
the kernels' descriptors name, the route, and a model of the
kernels' LayerNorm over the cluster (each block's partial sums over its
slice, added in block order) against the JAX package's composition and its
Pallas kernel in interpret mode."""

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
# the widths of the models the kernels serve: embd 256 (cls_head2 and
# reg_head at 288), embd 512 (512 and 544), and the widest; (slice,
# cluster, tile)
MODEL_PLANS = {
    (torch.float32, 288): (144, 2, 64), (torch.bfloat16, 288): (144, 2, 128),
    (torch.float32, 512): (256, 2, 64), (torch.bfloat16, 512): (128, 4, 128),
    (torch.float32, 544): (192, 3, 64), (torch.bfloat16, 544): (144, 4, 128),
    (torch.float32, 1024): (256, 4, 64), (torch.bfloat16, 1024): (128, 8, 128),
}


@pytest.mark.parametrize("dtype", DTYPES)
def test_wide_plan_covers_every_channel_once(dtype):
    """At every C_out of the wide route: the cluster's slices hold C_out
    (every slice some of it), the slice is one of the source's set, a block
    fits the card's shared memory with a ring of at least 2 stages, and a
    cluster is at most 4 blocks in f32 and 8 in bf16 (the portable most;
    the LN exchange feeds blocks q and q + 4 from lane q of a quad)."""
    for C_out in range(257, tfc.CONV3_WIDE_MAX_C + 1):
        assert tfc.conv3_route(C_out) == "wide"
        p = tfc.conv3_wide_plan(dtype, C_out)
        assert p.slice in tfc.CONV3_WIDE_SLICES[dtype]
        assert 2 <= p.cluster <= tfc.CONV3_WIDE_MAX_CLUSTER[dtype] <= 8
        assert (p.cluster - 1) * p.slice < C_out <= p.cluster * p.slice
        owner = np.repeat(np.arange(p.cluster), p.slice)[:C_out]
        assert np.bincount(owner).min() >= 1
        assert 2 <= p.stages <= 4 and p.smem <= tfc.SMEM_LIMIT
        assert p.tile == (128 if dtype == torch.bfloat16 else 64)


@pytest.mark.parametrize("dtype,C_out", list(MODEL_PLANS))
def test_wide_plan_at_the_model_widths(dtype, C_out):
    p = tfc.conv3_wide_plan(dtype, C_out)
    assert (p.slice, p.cluster, p.tile) == MODEL_PLANS[dtype, C_out]
    # the padding a cluster computes and drops
    assert p.cluster * p.slice - C_out < p.slice


@pytest.mark.parametrize("dtype", DTYPES)
def test_wide_plan_refuses_what_the_kernels_do_not_take(dtype):
    for C_out in (0, tfc.CONV3_WIDE_MAX_C + 1):
        with pytest.raises(ValueError, match="C_out"):
            tfc.conv3_wide_plan(dtype, C_out)
    # narrower layers run one block a cluster (the card checks force them)
    assert tfc.conv3_wide_plan(dtype, 24).cluster == 1


def test_route_is_three_way():
    routes = [tfc.conv3_route(c) for c in (1, 160, 256, 257, 544, 1024, 1025,
                                            8000)]
    assert routes == ["tuned"] * 3 + ["wide"] * 3 + ["passes", "general"]


def _unswizzle_f32(img):
    """(ceil(C_in/8), 3, N, 8) TF32 image back to (N, 8 ceil(C_in/8), 3):
    row n's 16-byte pieces k sit at k ^ ((n // 4) % 2) (the 32-byte
    swizzle)."""
    f = img.numpy()
    nc, _, N, _ = f.shape
    w = np.full((N, 8 * nc, 3), np.nan, np.float32)
    for n in range(N):
        for k in range(2):
            kp = k ^ ((n // 4) % 2)
            for c in range(nc):
                w[n, 8 * c + 4 * k:8 * c + 4 * k + 4] = f[c, :, n, 4 * kp:4 * kp + 4].T
    return w


def _unswizzle_bf16(img):
    """(ceil(C_in/32), 3, N, 32) bf16 image back to (N, 32 ceil(C_in/32), 3):
    row n's 16-byte pieces k sit at k ^ ((n // 2) % 4) (the 64-byte
    swizzle)."""
    f = img.float().numpy()
    nc, _, N, _ = f.shape
    w = np.full((N, 32 * nc, 3), np.nan, np.float32)
    for n in range(N):
        for k in range(4):
            kp = k ^ ((n // 2) % 4)
            for c in range(nc):
                w[n, 32 * c + 8 * k:32 * c + 8 * k + 8] = f[c, :, n, 8 * kp:8 * kp + 8].T
    return w


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c_in,c_out", [(16, 264), (13, 288), (40, 300),
                                        (33, 544), (8, 1024), (50, 777)])
def test_wide_images_unswizzle_to_w(dtype, c_in, c_out):
    """Each slice of the operand is the tuned kernel's image of its
    channels at N = slice: read back through the swizzle, the slices one
    after the other are w (its bf16 rounding; in f32 the TF32 hi + lo,
    which is w to 2^-22), zero where padded in channels and inputs."""
    w = torch.from_numpy(np.random.RandomState(c_in + c_out)
                         .randn(c_out, c_in, 3).astype(np.float32))
    p = tfc.conv3_wide_plan(dtype, c_out)
    img = tfc.conv3_wide_operands(w, dtype)
    k = 32 if dtype == torch.bfloat16 else 8
    nc = -(-c_in // k)
    want = np.zeros((p.cluster * p.slice, k * nc, 3), np.float32)
    if dtype == torch.bfloat16:
        assert img.shape == (p.cluster, nc, 3, p.slice, 32) and img.dtype == dtype
        got = np.concatenate([_unswizzle_bf16(s) for s in img])
        want[:c_out, :c_in] = w.to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(got, want)
    else:
        assert img.shape == (p.cluster, nc, 2, 3, p.slice, 8) and img.dtype == dtype
        hi = np.concatenate([_unswizzle_f32(s[:, 0]) for s in img])
        lo = np.concatenate([_unswizzle_f32(s[:, 1]) for s in img])
        want[:c_out, :c_in] = w.numpy()
        hi_want, lo_want = (t.numpy() for t in tfc.tf32_split(torch.from_numpy(want)))
        np.testing.assert_array_equal(hi, hi_want)
        np.testing.assert_array_equal(lo, lo_want)
        np.testing.assert_allclose(hi + lo, want, rtol=2.0 ** -21, atol=0)
    assert img.is_contiguous()


@pytest.mark.parametrize("dtype", DTYPES)
def test_wide_operands_follow_the_weights_version(dtype):
    w = torch.nn.Parameter(torch.randn(288, 16, 3))
    first = tfc.conv3_wide_operands(w, dtype)
    assert tfc.conv3_wide_operands(w, dtype) is first
    with torch.no_grad():
        w.mul_(2.0)
    second = tfc.conv3_wide_operands(w, dtype)
    assert second is not first
    assert torch.equal(second.float(), 2 * first.float())


def _wide_model(x, mask, w, bias, ln_w, ln_b, dtype=torch.float32, eps=1e-5):
    """conv3_ln_act as the wide kernels compute it in f32 (relu): the
    weight padded to cluster x slice channels, each block's conv of its
    slice, each block's partial sums over its real channels added in block
    order for the mean and then for the centred variance (the exchange over
    the cluster), and the affine of each slice."""
    C_out = w.shape[0]
    p = tfc.conv3_wide_plan(dtype, C_out)
    wp = torch.zeros(p.cluster * p.slice, *w.shape[1:])
    wp[:C_out] = w
    xm = x * mask[:, None, :].float()
    ys = []
    for r, ws in enumerate(wp.split(p.slice)):
        n = min(p.slice, C_out - r * p.slice)
        ys.append(F.conv1d(xm, ws, padding=1)[:, :n]
                  + bias[r * p.slice:r * p.slice + n, None])
    s = ys[0].sum(1)
    for y in ys[1:]:
        s = s + y.sum(1)
    mean = s / C_out
    v = (ys[0] - mean[:, None]).square().sum(1)
    for y in ys[1:]:
        v = v + (y - mean[:, None]).square().sum(1)
    rstd = torch.rsqrt(v / C_out + eps)
    y = torch.cat(ys, 1)
    y = (y - mean[:, None]) * rstd[:, None] * ln_w.reshape(-1, 1) + ln_b.reshape(-1, 1)
    return torch.relu(y)


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


@pytest.mark.parametrize("c_in,c_out,T", [(64, 288, 37), (32, 544, 20),
                                          (16, 300, 9), (24, 1024, 5)])
def test_cluster_layer_norm_matches_jax(c_in, c_out, T):
    """The LN over a cluster's slices (partial sums added in block order)
    against the JAX composition, as the plain version is held (1e-5
    absolute, 1e-4 relative)."""
    args = _inputs(3, c_in, c_out, T, c_out + T)
    want = np.asarray(jax.jit(jfc.conv3_ln_act_xla)(*map(jnp.asarray, args)))
    got = _wide_model(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_cluster_layer_norm_matches_pallas_interpret():
    """C_out 288 through the JAX Pallas kernel in interpret mode."""
    args = _inputs(2, 32, 288, 40, 5)
    want = np.asarray(jfc.conv3_ln_act_pallas(*map(jnp.asarray, args),
                                              interpret=True))
    got = _wide_model(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
