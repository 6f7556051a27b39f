"""The port's plain versions of the three kernel ops against the JAX
package's XLA compositions (and, at one small shape each, its Pallas kernels
in interpret mode) at the shapes outside the tuned CUDA kernels' envelope,
which the general kernels (csrc/*_general.cu) take on the card, and for
conv3 at C_out 257 to 1024 and band attention at D a multiple of 8 up to
256 the wide ones (csrc/conv3_ln_act_wide.cu, csrc/band_attention_wide.cu):
band attention at head widths 12 to 256 and windows 1 to 35, conv3 at C_out 288 and
544 and over 9 FPN levels, the trio at C 320. Same numpy inputs on both
sides; tolerance 1e-5 absolute, the conv ops with rtol 1e-4 as
tests/test_torch_ops.py holds them (3 * C_in-term f32 sums before the LN).
The kernels themselves are held against these plain versions on the card
in tests/test_torch_kernels.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from decafnet_tpu.ops import fused_conv as jfc
from decafnet_tpu.ops import local_attention as jla
from decafnet_tpu_torch.ops import fused_conv as tfc
from decafnet_tpu_torch.ops import local_attention as tla

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)

ATOL, CONV_RTOL = 1e-5, 1e-4


def _jit(fn, *static):
    """``fn`` jitted (one compile per shape: eager JAX compiles every
    primitive on its own), ``static`` its static argument positions."""
    return jax.jit(fn, static_argnums=static)


def _mask(B, T, seed):
    rng = np.random.RandomState(seed)
    lens = [T] + list(rng.randint(1, T + 1, B - 1))
    return np.arange(T)[None, :] < np.asarray(lens)[:, None]


def _band_inputs(B, H, T, D, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, T, D).astype(np.float32) * D ** -0.25
               for _ in range(3))
    return q, k, v, _mask(B, T, seed)


# (D, T, window, the route a CUDA launch takes): the wide kernels at D a
# multiple of 8 up to 256 and windows up to 33 (D 128 and 256 at the
# widths legs' window 5), the general one off that envelope
@pytest.mark.parametrize("D,T,window,route", [
    (16, 96, 5, "wide"), (16, 7, 9, "wide"), (64, 40, 11, "wide"), (48, 9, 1, "wide"),
    (128, 37, 5, "wide"), (256, 20, 5, "wide"), (12, 30, 5, "general"),
    (16, 40, 35, "general")])
def test_band_attention_plain_matches_jax(D, T, window, route):
    q, k, v, mask = _band_inputs(2, 4, T, D, D + T + window)
    want = np.asarray(_jit(jla.band_attention_diag, 4)(
        *map(jnp.asarray, (q, k, v, mask)), window))
    got = tla.band_attention_torch(*map(torch.from_numpy, (q, k, v, mask)),
                                   window).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert tla.band_attention_route(D, window) == route


def test_band_attention_plain_matches_pallas_interpret():
    """D 16, window 11 through the JAX Pallas kernel in interpret mode."""
    q, k, v, mask = _band_inputs(2, 4, 40, 16, 3)
    want = np.asarray(jla.band_attention_pallas(
        *map(jnp.asarray, (q, k, v, mask)), 11, chunk=16, interpret=True))
    got = tla.band_attention_torch(*map(torch.from_numpy, (q, k, v, mask)),
                                   11).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _conv3_inputs(B, c_in, c_out, T, seed, bias=True):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, c_in, T).astype(np.float32)
    w = (rng.randn(c_out, c_in, 3) / np.sqrt(3 * c_in)).astype(np.float32)
    b = rng.randn(c_out).astype(np.float32) if bias else None
    lw = (1 + 0.1 * rng.randn(c_out)).astype(np.float32)
    lb = (0.1 * rng.randn(c_out)).astype(np.float32)
    return x, _mask(B, T, seed), w, b, lw, lb


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("c_in,c_out,T,bias", [
    (256, 288, 37, False), (160, 544, 20, True)])
def test_conv3_plain_matches_jax_wide(c_in, c_out, T, bias):
    args = _conv3_inputs(2, c_in, c_out, T, c_out + T, bias)
    want = np.asarray(_jit(jfc.conv3_ln_act_xla)(*map(_j, args)))
    got = tfc.conv3_ln_act_torch(*map(_t, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=CONV_RTOL, atol=ATOL)
    assert tfc.conv3_route(c_out) == "wide"


def test_conv3_plain_matches_pallas_interpret_wide():
    """C_out 288 through the JAX Pallas kernel in interpret mode."""
    args = _conv3_inputs(2, 32, 288, 40, 5)
    want = np.asarray(jfc.conv3_ln_act_pallas(*map(_j, args), interpret=True))
    got = tfc.conv3_ln_act_torch(*map(_t, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=CONV_RTOL, atol=ATOL)


def test_conv3_nine_levels_match_jax():
    """One head layer over 9 FPN levels (an arch[2] of 9): the levels' list
    API against the JAX composition level by level; on the card the list
    takes two launches (CONV3_MAX_LEVELS per launch)."""
    C = 288
    rng = np.random.RandomState(C)
    Ts = [256 // 2 ** lvl for lvl in range(9)]
    xs = [rng.randn(2, C, T).astype(np.float32) for T in Ts]
    masks = [_mask(2, T, i) for i, T in enumerate(Ts)]
    w = (rng.randn(C, C, 3) / np.sqrt(3 * C)).astype(np.float32)
    lw = (1 + 0.1 * rng.randn(C)).astype(np.float32)
    lb = (0.1 * rng.randn(C)).astype(np.float32)
    got = tfc.conv3_ln_act_levels(list(map(_t, xs)), list(map(_t, masks)),
                                  _t(w), None, _t(lw), _t(lb))
    assert len(got) == 9
    for x, m, y in zip(xs, masks, got, strict=True):
        want = np.asarray(_jit(jfc.conv3_ln_act_xla)(_j(x), _j(m), _j(w), None,
                                                     _j(lw), _j(lb)))
        np.testing.assert_allclose(y.numpy(), want, rtol=CONV_RTOL, atol=ATOL)
    assert tfc.conv3_launch_groups(9) == [(0, 8), (8, 9)]


def _trio_inputs(B, C, T, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, C, T).astype(np.float32)
    ws = [(rng.randn(C, 1, 3) / np.sqrt(3)).astype(np.float32) for _ in range(3)]
    lws = [(1 + 0.1 * rng.randn(C)).astype(np.float32) for _ in range(3)]
    lbs = [(0.1 * rng.randn(C)).astype(np.float32) for _ in range(3)]
    return x, _mask(B, T, seed), ws, lws, lbs


@pytest.mark.parametrize("C,T", [(320, 60), (512, 17), (1024, 23)])
def test_trio_plain_matches_jax_wide(C, T):
    x, mask, ws, lws, lbs = _trio_inputs(2, C, T, C + T)
    want = _jit(jfc.qkv_depthwise_ln_xla)(
        _j(x), _j(mask), list(map(_j, ws)), list(map(_j, lws)),
        list(map(_j, lbs)))
    got = tfc.qkv_depthwise_ln_torch(_t(x), _t(mask), list(map(_t, ws)),
                                     list(map(_t, lws)), list(map(_t, lbs)))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=CONV_RTOL,
                                   atol=ATOL)
    assert tfc.qkv_route(C) == "wide"


def test_trio_plain_matches_pallas_interpret_wide():
    """C 320 through the JAX Pallas kernel in interpret mode."""
    x, mask, ws, lws, lbs = _trio_inputs(2, 320, 40, 7)
    want = jfc.qkv_depthwise_ln_pallas(
        _j(x), _j(mask), list(map(_j, ws)), list(map(_j, lws)),
        list(map(_j, lbs)), interpret=True)
    got = tfc.qkv_depthwise_ln_torch(_t(x), _t(mask), list(map(_t, ws)),
                                     list(map(_t, lws)), list(map(_t, lbs)))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=CONV_RTOL,
                                   atol=ATOL)
