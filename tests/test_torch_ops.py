"""Port ops (decafnet_tpu_torch.ops) against their JAX functions on the same
numpy inputs, on the CPU: masked primitives, delegation, the plain versions
of the three kernel ops (held against the XLA compositions and against the
Pallas kernels in interpret mode), and the device NMS. Tolerance 1e-5
absolute, as the JAX package's own op tests; the conv ops add rtol 1e-4 as
tests/test_fused_conv.py does (480-term f32 sums before the LN). The CUDA kernels
themselves are held against these plain versions on the card in
tests/test_torch_kernels.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from decafnet_tpu.ops import delegation as jdel
from decafnet_tpu.ops import fused_conv as jfc
from decafnet_tpu.ops import local_attention as jla
from decafnet_tpu.ops import masked as jm
from decafnet_tpu.ops import nms as jnms
from decafnet_tpu_torch.ops import delegation as tdel
from decafnet_tpu_torch.ops import fused_conv as tfc
from decafnet_tpu_torch.ops import local_attention as tla
from decafnet_tpu_torch.ops import masked as tm
from decafnet_tpu_torch.ops import nms as tnms

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)

ATOL = 1e-5


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _prefix_mask(b, t, lens):
    mask = np.zeros((b, t), bool)
    for i, n in enumerate(lens):
        mask[i, :n] = True
    return mask


# ---------------------------------------------------------------- masked ops

@pytest.mark.parametrize("t,lens", [(20, (20, 7)), (21, (13, 0)), (5, (1, 5))])
def test_masked_pools(t, lens):
    rng = np.random.RandomState(t)
    x = rng.randn(2, 5, t).astype(np.float32)
    mask = _prefix_mask(2, t, lens)[:, None, :]
    _close(tm.masked_avg_pool1d(_t(x), _t(mask)),
           jm.masked_avg_pool1d(_j(x), _j(mask)))
    got_x, got_m = tm.masked_max_pool1d(_t(x), _t(mask))
    want_x, want_m = jm.masked_max_pool1d(_j(x), _j(mask))
    _close(got_x, want_x)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


@pytest.mark.parametrize("in_size,size", [(16, 8), (8, 32), (12, 20),
                                          (10, 10), (9, 4)])
def test_interpolate_nearest(in_size, size):
    x = np.random.RandomState(size).randn(2, 3, in_size).astype(np.float32)
    _close(tm.interpolate_nearest_1d(_t(x), size),
           jm.interpolate_nearest_1d(_j(x), size), atol=0)


@pytest.mark.parametrize("in_size,size,align", [(16, 37, True), (24, 49, True),
                                                (7, 1, True), (10, 23, False)])
def test_interpolate_linear(in_size, size, align):
    x = np.random.RandomState(size).randn(3, in_size).astype(np.float32)
    _close(tm.interpolate_linear_1d(_t(x), size, align),
           jm.interpolate_linear_1d(_j(x), size, align))


@pytest.mark.parametrize("seq_len,n_freqs", [(24, 8), (2304, 64)])
def test_sinusoid_encoding(seq_len, n_freqs):
    np.testing.assert_array_equal(tm.sinusoid_encoding(seq_len, n_freqs),
                                  jm.sinusoid_encoding(seq_len, n_freqs))


@pytest.mark.parametrize("affine", [None, "col", "vec"])
def test_channel_layer_norm(affine):
    rng = np.random.RandomState(2)
    x = (3.0 * rng.randn(2, 12, 30) + 1.0).astype(np.float32)
    w = b = None
    if affine:
        shape = (12, 1) if affine == "col" else (12,)
        w = (1 + 0.1 * rng.randn(*shape)).astype(np.float32)
        b = (0.1 * rng.randn(*shape)).astype(np.float32)
    _close(tm.channel_layer_norm(_t(x), _t(w), _t(b)),
           jm.channel_layer_norm(_j(x), _j(w), _j(b)))


# ---------------------------------------------------------------- delegation

@pytest.mark.parametrize("case,sn,ratio", [
    ("random", 8, 0.3), ("random", 5, 0.29), ("ties", 8, 0.5),
    ("all_masked", 8, 0.3), ("tiny_ratio", 8, 0.01), ("random", 60, 0.3)])
def test_delegation_weights(case, sn, ratio):
    rng = np.random.RandomState(sn)
    T = 130
    correl = rng.randn(4, T).astype(np.float32)
    if case == "ties":
        correl[:] = 1.0
        correl[1, 40:60] = 2.0
    lens = (T, 97, 0 if case == "all_masked" else 33, 9)
    mask = _prefix_mask(4, T, lens)
    got = tdel.delegation_weights(_t(correl), _t(mask), sn, ratio)
    want = jdel.delegation_weights(_j(correl), _j(mask), sn, ratio)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("msf,scat,norm", [(True, False, False),
                                           (False, True, True),
                                           (True, True, True)])
def test_delegate(msf, scat, norm):
    rng = np.random.RandomState(4)
    vid = rng.randn(3, 6, 50).astype(np.float32)
    shallow = rng.randn(3, 5, 50).astype(np.float32)
    tcls = rng.randn(3, 5).astype(np.float32)
    mask = _prefix_mask(3, 50, (50, 31, 12))
    got = tdel.delegate(_t(vid), _t(shallow), _t(mask), _t(tcls), 8, 0.4,
                        normalize=norm, msf=msf, scat=scat)
    want = jdel.delegate(_j(vid), _j(shallow), _j(mask), _j(tcls), 8, 0.4,
                         normalize=norm, msf=msf, scat=scat)
    for g, w in zip(got, want):
        _close(g, w)


# ------------------------------------------------- kernel ops, plain version

def _conv_inputs(t, c_in=16, c_out=24, bias=True, affine=True, seed=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, c_in, t).astype(np.float32)
    mask = _prefix_mask(2, t, (t, t * 2 // 3))
    w = (rng.randn(c_out, c_in, 3) * 0.2).astype(np.float32)
    b = rng.randn(c_out).astype(np.float32) if bias else None
    ln_w = (1.0 + 0.1 * rng.randn(c_out)).astype(np.float32) if affine else None
    ln_b = (0.1 * rng.randn(c_out)).astype(np.float32) if affine else None
    return x, mask, w, b, ln_w, ln_b


@pytest.mark.parametrize("bias,affine,act", [
    (True, True, "relu"), (False, True, "relu"), (True, False, "none"),
    (False, False, "relu")])
def test_conv3_ln_act_vs_xla(bias, affine, act):
    args = _conv_inputs(100, bias=bias, affine=affine)
    got = tfc.conv3_ln_act(*map(_t, args), act=act)
    want = jfc.conv3_ln_act_xla(*map(_j, args), act=act)
    _close(got, want, rtol=1e-4)


@pytest.mark.parametrize("t,bias,affine", [(100, True, True),
                                           (37, False, False)])
def test_conv3_ln_act_vs_pallas_interpret(t, bias, affine):
    args = _conv_inputs(t, bias=bias, affine=affine)
    got = tfc.conv3_ln_act_torch(*map(_t, args))
    want = jfc.conv3_ln_act_pallas(*map(_j, args), chunk=128, interpret=True)
    _close(got, want, rtol=1e-4)


def _trio_inputs(t, c=16, seed=5):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, c, t).astype(np.float32)
    mask = _prefix_mask(2, t, (t, t // 2))
    ws = [(rng.randn(c, 1, 3) * 0.5).astype(np.float32) for _ in range(3)]
    lws = [(1 + 0.1 * rng.randn(c, 1)).astype(np.float32) for _ in range(3)]
    lbs = [(0.1 * rng.randn(c, 1)).astype(np.float32) for _ in range(3)]
    return x, mask, ws, lws, lbs


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
def test_qkv_depthwise_ln(backend):
    x, mask, ws, lws, lbs = _trio_inputs(90)
    got = tfc.qkv_depthwise_ln(_t(x), _t(mask), [_t(w) for w in ws],
                               [_t(w) for w in lws], [_t(b) for b in lbs])
    jargs = (_j(x), _j(mask), [_j(w) for w in ws], [_j(w) for w in lws],
             [_j(b) for b in lbs])
    if backend == "xla":
        want = jfc.qkv_depthwise_ln_xla(*jargs)
    else:
        want = jfc.qkv_depthwise_ln_pallas(*jargs, chunk=128, interpret=True)
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-4)


def _band_inputs(t, lens, d=8, seed=1):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(len(lens), 4, t, d).astype(np.float32)
               for _ in range(3))
    return q, k, v, _prefix_mask(len(lens), t, lens)


@pytest.mark.parametrize("backend", ["diag", "xla", "reference",
                                     "pallas_interpret"])
@pytest.mark.parametrize("t,lens,window", [(96, (96, 64, 0), 5),
                                           (3, (3, 2, 0), 5),
                                           (40, (40, 17, 1), 3)])
def test_band_attention(backend, t, lens, window):
    q, k, v, mask = _band_inputs(t, lens)
    got = tla.band_attention(*map(_t, (q, k, v, mask)), window)
    jargs = tuple(map(_j, (q, k, v, mask))) + (window,)
    if backend == "diag":
        want = jla.band_attention_diag(*jargs)
    elif backend == "xla":
        want = jla.band_attention_xla(*jargs)
    elif backend == "reference":
        want = jla.band_attention_reference(*jargs)
    else:
        want = jla.band_attention_pallas(*jargs, chunk=min(32, -(-t // 8) * 8),
                                         interpret=True)
    _close(got, want)
    assert np.all(got.numpy().transpose(0, 2, 1, 3)[~mask] == 0)


def test_band_attention_reads_head_views():
    """The model hands band attention strided head views of (B, C, T)
    projections; the plain version gives the same result as on copies."""
    rng = np.random.RandomState(9)
    proj = [torch.from_numpy(rng.randn(2, 32, 50).astype(np.float32))
            for _ in range(3)]
    views = [p.reshape(2, 4, 8, 50).transpose(2, 3) for p in proj]
    mask = torch.from_numpy(_prefix_mask(2, 50, (50, 21)))
    a = tla.band_attention(*views, mask, 5)
    b = tla.band_attention(*[v.contiguous() for v in views], mask, 5)
    _close(a, b, atol=0)


# --------------------------------------------------------------------- NMS

@pytest.mark.parametrize("mode,voting", [("soft_nms", 0.75), ("soft_nms", 0.0),
                                         ("nms", 0.95)])
def test_batched_nms_device(mode, voting):
    rng = np.random.RandomState(12)
    Q, N = 3, 60
    x1 = rng.uniform(0, 80, (Q, N)).astype(np.float32)
    x2 = (x1 + rng.uniform(0.5, 20, (Q, N))).astype(np.float32)
    scores = rng.uniform(0, 1, (Q, N)).astype(np.float32)
    valid = rng.uniform(size=(Q, N)) > 0.3
    valid[2] = False                              # a query with no candidate
    scores = np.where(valid, scores, 0).astype(np.float32)
    kw = dict(mode=mode, iou_thresh=0.1, min_score=0.001, sigma=0.9,
              voting_thresh=voting)
    got = tnms.batched_nms_device(*map(_t, (x1, x2, scores, valid)), 5, **kw)
    want = jnms.batched_nms_device(*map(_j, (x1, x2, scores, valid)), 5, **kw)
    for g, w in zip(got, want):
        _close(g, w)
