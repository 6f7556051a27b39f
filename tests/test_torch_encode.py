"""The port's encode stage against the JAX package's, on the same inputs
(numpy, from a seed) and weights: the frame transforms, the delegation
budget and clip selection, delegated encoding, the runner's clip cap, and
encoded features through the port's GroundingService on the CPU.

Tolerances: resizes and the eval transform at rtol 1e-4 / atol 1e-5 (as
tests/test_encode.py holds the JAX form to torch), normalize at 1e-5 /
1e-6, selected clip indices and weights exactly, encoded streams at 2e-5
(the bound of tests/test_encode.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from decafnet_tpu import encode as jenc
from decafnet_tpu_torch.encode import (ClipEncoder, ClipEncoderRunner, center_crop,
                                       delegated_encode, encode_delegate_ground,
                                       encode_video, eval_transform, expert_budget,
                                       gather_clips, horizontal_flip, normalize,
                                       random_resized_crop, resize_bilinear,
                                       resize_short_side, select_salient_clips,
                                       train_transform)
from decafnet_tpu_torch.encode.import_vit import clip_encoder_params_to_state_dict
from decafnet_tpu_torch.encode.transforms import random_resized_crop_box, resized_crop

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)

RESIZE_TOL = dict(rtol=1e-4, atol=1e-5)
STREAM_TOL = dict(rtol=2e-5, atol=2e-5)


def rand(seed, *shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def port(fn, x, *args, **kw):
    return fn(torch.from_numpy(x), *args, **kw).numpy()


@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("in_hw,out_hw", [
    ((32, 48), (16, 16)), ((17, 23), (24, 24)), ((64, 64), (224, 224)),
    ((37, 53), (24, 24)), ((48, 96), (24, 48))])
def test_resize_bilinear_matches_jax(in_hw, out_hw, antialias):
    x = rand(0, 2, 3, *in_hw, 3)                 # (clips, frames, H, W, 3)
    want = np.asarray(jenc.resize_bilinear(jnp.asarray(x), *out_hw, antialias=antialias))
    got = port(resize_bilinear, x, *out_hw, antialias=antialias)
    np.testing.assert_allclose(got, want, **RESIZE_TOL)


@pytest.mark.parametrize("hw", [(30, 60), (90, 45), (40, 40)])
def test_resize_short_side_matches_jax(hw):
    x = rand(1, 1, *hw, 3)
    want = np.asarray(jenc.resize_short_side(jnp.asarray(x), 36, antialias=True))
    got = port(resize_short_side, x, 36, antialias=True)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **RESIZE_TOL)


@pytest.mark.parametrize("hw,size", [((37, 51), 32), ((20, 40), 32), ((10, 12), 16)])
def test_center_crop_matches_jax(hw, size):
    """Exact, including the zero padding of inputs smaller than ``size``."""
    x = rand(2, 2, *hw, 3)
    want = np.asarray(jenc.center_crop(jnp.asarray(x), size))
    np.testing.assert_array_equal(port(center_crop, x, size), want)


def test_normalize_matches_jax():
    x = rand(3, 2, 2, 8, 8, 3)
    want = np.asarray(jenc.normalize(jnp.asarray(x)))
    np.testing.assert_allclose(port(normalize, x), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("antialias", [False, True])
def test_eval_transform_matches_jax(antialias):
    x = rand(4, 2, 2, 70, 90, 3)
    kw = dict(center=64, input_res=48, antialias=antialias)
    want = np.asarray(jenc.eval_transform(jnp.asarray(x), **kw))
    got = port(eval_transform, x, **kw)
    assert got.shape == (2, 2, 48, 48, 3)
    np.testing.assert_allclose(got, want, **RESIZE_TOL)


def test_resized_crop_matches_jax_crop_then_resize():
    x = rand(5, 2, 40, 56, 3)
    top, left, ch, cw = 3, 7, 29, 33
    want = np.asarray(jenc.resize_bilinear(
        jnp.asarray(x[..., top:top + ch, left:left + cw, :]), 24, 24))
    np.testing.assert_allclose(port(resized_crop, x, (top, left, ch, cw), 24),
                               want, **RESIZE_TOL)


def test_random_resized_crop_box_and_determinism():
    x = rand(6, 2, 40, 56, 3)
    g = torch.Generator().manual_seed(11)
    box = random_resized_crop_box(40, 56, torch.Generator().manual_seed(11))
    top, left, ch, cw = box
    assert 0 <= top <= 40 - ch and 0 <= left <= 56 - cw
    assert 0.5 * 40 * 56 * 0.9 <= ch * cw <= 40 * 56 * 1.1       # scale, rounded
    got = port(random_resized_crop, x, g, 24)
    np.testing.assert_array_equal(got, port(resized_crop, x, box, 24))
    again = port(random_resized_crop, x, torch.Generator().manual_seed(11), 24)
    np.testing.assert_array_equal(got, again)
    other = port(random_resized_crop, x, torch.Generator().manual_seed(12), 24)
    assert not np.allclose(got, other)


def test_random_resized_crop_center_fallback_matches_jax():
    """A 4 x 400 frame fits no crop of area 800-1600 and aspect 3/4-4/3, so
    every try fails and both packages take the center crop of the clamped
    aspect, whatever their draws."""
    x = rand(7, 1, 4, 400, 3)
    want = np.asarray(jenc.random_resized_crop(jnp.asarray(x), jax.random.PRNGKey(0), 16))
    got = port(random_resized_crop, x, torch.Generator().manual_seed(0), 16)
    assert random_resized_crop_box(4, 400, torch.Generator()) == (0, 197, 4, 5)
    np.testing.assert_allclose(got, want, **RESIZE_TOL)


def test_train_transform_shapes_flip_and_determinism():
    x = rand(8, 2, 64, 80, 3)
    a = port(train_transform, x, torch.Generator().manual_seed(3), input_res=32)
    b = port(train_transform, x, torch.Generator().manual_seed(3), input_res=32)
    assert a.shape == (2, 32, 32, 3)
    np.testing.assert_array_equal(a, b)
    outs = [port(train_transform, x, torch.Generator().manual_seed(s), input_res=32)
            for s in range(4, 8)]
    assert not any(np.allclose(a, o) for o in outs)
    np.testing.assert_array_equal(port(horizontal_flip, x),
                                  np.asarray(jenc.horizontal_flip(jnp.asarray(x))))


@pytest.mark.parametrize("T,sn,ratio", [
    (21, 4, 0.5), (21, 4, 0.01), (1024, 64, 0.3), (100, 60, 0.3), (7, 8, 0.3),
    (32768, 64, 0.3), (130, 64, 0.3)])
def test_expert_budget_matches_jax(T, sn, ratio):
    assert expert_budget(T, sn, ratio) == jenc.expert_budget(T, sn, ratio)


@pytest.mark.parametrize("T,sn,ratio,normalize", [
    (21, 4, 0.5, False), (21, 4, 0.01, False), (1024, 64, 0.3, False),
    (1000, 60, 0.3, True), (32768, 64, 0.3, False)])
def test_select_salient_clips_matches_jax_exactly(T, sn, ratio, normalize):
    rng = np.random.RandomState(T)
    sk = rng.randn(8, T).astype(np.float32)
    tcls = rng.randn(8).astype(np.float32)
    k = expert_budget(T, sn, ratio)
    j_idx, j_w = jenc.select_salient_clips(jnp.asarray(sk), jnp.asarray(tcls), sn,
                                           ratio, k, normalize=normalize)
    idx, w = select_salient_clips(torch.from_numpy(sk), torch.from_numpy(tcls), sn,
                                  ratio, k, normalize=normalize)
    np.testing.assert_array_equal(w.numpy(), np.asarray(j_w))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    assert len(set(idx.tolist())) == k


def test_gather_clips_matches_index_gather():
    frames = rand(9, 13, 2, 8, 8, 3)
    idx = np.array([7, 0, 12, 3, 3])
    got = gather_clips(torch.from_numpy(frames), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, frames[idx])


ENC = dict(patch_size=16, dim=32, depth=1, heads=2, out_dim=24, frames=2)


@pytest.fixture(scope="module")
def encoders():
    """A flax ClipEncoder and its JAX runner, and the port's on the same
    weights (carried by the bridge)."""
    jax_enc = jenc.make_clip_encoder(ENC)
    frames = rand(10, 21, 2, 32, 32, 3)
    params = jax_enc.init(jax.random.PRNGKey(0), frames[:1])["params"]
    enc = ClipEncoder(**ENC, img_size=32)
    enc.load_state_dict(clip_encoder_params_to_state_dict(jax.tree.map(np.asarray, params)),
                        strict=True)
    return jenc.ClipEncoderRunner(jax_enc, params), ClipEncoderRunner(enc), frames


def test_encode_video_matches_jax(encoders):
    jax_runner, runner, frames = encoders
    want_e, want_s = jenc.encode_video(jax_runner, jax_runner, frames[:5], frames[5:10])
    got_e, got_s = encode_video(runner, runner, frames[:5], frames[5:10])
    assert got_e.shape == (24, 5) and got_e.dtype == np.float32
    np.testing.assert_allclose(got_e, want_e, **STREAM_TOL)
    np.testing.assert_allclose(got_s, want_s, **STREAM_TOL)


def test_runner_clip_cap_changes_no_feature(encoders):
    _, runner, frames = encoders
    capped = ClipEncoderRunner(runner.encoder, max_clips=4)
    np.testing.assert_allclose(capped(frames), runner(frames), **STREAM_TOL)
    assert capped.encode(torch.from_numpy(frames[:9])).shape == (24, 9)


def test_delegated_encode_matches_jax(encoders):
    jax_runner, runner, frames = encoders
    T, sn, ratio = frames.shape[0], 4, 0.5
    text_cls = np.random.RandomState(12).randn(24).astype(np.float32)
    j_expert, j_sk, j_w = jenc.encode_delegate_ground(
        jax_runner, jax_runner, frames, frames, text_cls, sn, ratio)
    expert, sk, w = encode_delegate_ground(
        runner, runner, torch.from_numpy(frames), torch.from_numpy(frames),
        torch.from_numpy(text_cls), sn, ratio)
    assert expert.shape == (24, T) and 0 < float(w.sum()) < T
    np.testing.assert_array_equal(w.numpy(), j_w)
    np.testing.assert_allclose(sk.numpy(), j_sk, **STREAM_TOL)
    np.testing.assert_allclose(expert.numpy(), j_expert, **STREAM_TOL)
    # encoding only the selected clips == encoding all, then gating
    np.testing.assert_allclose(expert.numpy(), runner(frames) * w.numpy()[None],
                               **STREAM_TOL)

    # keep-all: int(ratio * nbins) == 0 selects every bin
    k_all = expert_budget(T, sn, 0.01)
    idx, w_all = select_salient_clips(sk, torch.from_numpy(text_cls), sn, 0.01, k_all)
    j_idx, j_w_all = jenc.select_salient_clips(jnp.asarray(j_sk), jnp.asarray(text_cls),
                                               sn, 0.01, k_all)
    full = delegated_encode(runner, idx, w_all, torch.from_numpy(frames))
    np.testing.assert_allclose(full.numpy(), jenc.delegated_encode(
        jax_runner, j_idx, j_w_all, frames), **STREAM_TOL)
    np.testing.assert_allclose(full.numpy(), runner(frames), **STREAM_TOL)


def test_encoded_features_feed_the_port_grounder(encoders):
    """Encode, delegate, then ground with the port's GroundingService on the
    CPU: finite detections inside the video."""
    from decafnet_tpu_torch.core import get_cfg_defaults, update_opt
    from decafnet_tpu_torch.models import random_params
    from decafnet_tpu_torch.serve import GroundingService

    _, runner, frames = encoders
    T = frames.shape[0]
    text_cls = np.random.RandomState(13).randn(2, 24).astype(np.float32)
    expert, sk, _ = encode_delegate_ground(
        runner, runner, torch.from_numpy(frames), torch.from_numpy(frames),
        torch.from_numpy(text_cls[0]), 4, 0.5)

    cfg = get_cfg_defaults()
    m = cfg.model
    m.name, m.msf, m.sratio, m.sn = "iter", True, 0.5, 4
    m.vid_net.in_dim, m.vid_net.embd_dim, m.vid_net.max_seq_len = 24, 16, 32
    m.vid_net.arch = (1, 0, 2)
    m.text_net.in_dim, m.text_net.embd_dim, m.text_net.n_layers = 16, 16, 1
    m.fusion.n_layers = 1
    update_opt(cfg)
    svc = GroundingService(cfg, params=random_params(cfg, 0), device="cpu")
    texts = [np.random.RandomState(14 + q).randn(16, 5).astype(np.float32)
             for q in range(2)]
    results = svc.ground(vid=expert.numpy(), shallow_vid=sk.numpy(), texts=texts,
                         text_cls=text_cls)
    duration = T * 16 / 30.0
    assert len(results) == 2
    for r in results:
        segs, scores = np.asarray(r["segments"]), np.asarray(r["scores"])
        assert 0 < len(scores) <= cfg.nms.max_num_segs
        assert np.isfinite(segs).all() and np.isfinite(scores).all()
        assert (segs >= 0).all() and (segs <= duration + 1e-4).all()
