"""The port's encode stage in bf16 against the JAX package's on the CPU, on
the same weights and inputs (made from numpy seeds; bf16 inputs hold the
same values on both sides):

- the factorized ``ClipEncoder`` (2 blocks, dim 64) with ``dtype`` bf16 and
  the EgoVLP ``SpaceTimeViT`` (2 blocks, dim 64, 32^2 frames) on bf16
  frames, each held to the bf16 noise floor of tests/test_torch_bf16.py:
  ``mean|port16 - jax16| <= 1.5 * mean|jax16 - jax32|`` and ``max <= 3 *
  max|jax16 - jax32|``, with the output dtype of JAX (f32 for the
  ClipEncoder, bf16 for the ViT);
- ``gather_clips(dtype=)`` exactly;
- ``delegated_encode`` and ``encode_delegate_ground`` with a bf16 sidekick
  and a bf16 expert ViT: the delegation weights and the selected clip
  indices identical, the sidekick and the dense expert stream (f32) by the
  rule;
- the encode CLI with ``"dtype": "bfloat16"`` in ``--sidekick_opt``: the
  written sidekick files by the rule against the JAX encoder in bf16 on the
  JAX-transformed frames; and a ``dtype`` in ``--expert_opt`` of a
  space-time expert is dropped, as the root ``encode.py`` drops it (the
  files equal the run without it, and the JAX CLI's at 1e-4 / 1e-5).
"""

import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from decafnet_tpu import encode as jenc
from decafnet_tpu_torch.encode import (ClipEncoderRunner, SpaceTimeViT,
                                       delegated_encode, encode_delegate_ground,
                                       expert_budget, gather_clips, make_clip_encoder,
                                       select_salient_clips)
from decafnet_tpu_torch.encode.__main__ import main as encode_main
from decafnet_tpu_torch.encode.import_vit import clip_encoder_params_to_state_dict
from decafnet_tpu_torch.models import load_params
from test_torch_encode_cli import save_jax_vit
from test_torch_vit import randomized

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)

CLIP = dict(patch_size=16, dim=64, depth=2, heads=4, out_dim=32, frames=2)
VIT = dict(img_size=32, patch_size=16, dim=64, depth=2, heads=4, frames=2, out_dim=32)
RES = 32


def floor_rule(got, want, want32, what=""):
    """tests/test_torch_bf16.py's noise-floor rule."""
    got, want, want32 = (np.asarray(a, np.float64) for a in (got, want, want32))
    assert got.shape == want.shape == want32.shape, (got.shape, want.shape)
    err, floor = np.abs(got - want), np.abs(want - want32)
    assert floor.max() > 0, what                      # bf16 did compute
    assert err.mean() <= 1.5 * floor.mean(), (what, err.mean(), floor.mean())
    assert err.max() <= 3 * floor.max(), (what, err.max(), floor.max())


def frames_of(seed, b):
    return np.random.RandomState(seed).rand(b, 2, RES, RES, 3).astype(np.float32)


def bf16_pair(a):
    """A numpy f32 array rounded to bf16: a torch bf16 tensor and a numpy
    bf16 array (the JAX side) of the same values."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t, np.asarray(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16))


@functools.lru_cache(maxsize=None)
def clip_weights():
    """The flax ClipEncoder in f32 and bf16, its randomized params, and the
    port's bf16 ClipEncoder on them."""
    j32 = jenc.make_clip_encoder(CLIP)
    j16 = jenc.make_clip_encoder(dict(CLIP, dtype="bfloat16"))
    params = randomized(j32.init(jax.random.PRNGKey(0), frames_of(0, 1))["params"], 7)
    port = make_clip_encoder(dict(CLIP, img_size=RES, dtype="bfloat16"))
    port.load_state_dict(clip_encoder_params_to_state_dict(params), strict=True)
    return j32, j16, params, port.eval()


@functools.lru_cache(maxsize=None)
def vit_weights():
    jm = jenc.SpaceTimeViT(**VIT)
    params = randomized(jm.init(jax.random.PRNGKey(1), frames_of(1, 1))["params"], 8)
    return jm, params, load_params(SpaceTimeViT(**VIT), params).eval()


def test_clip_encoder_bf16_matches_jax_bf16():
    j32, j16, params, port = clip_weights()
    assert port.dtype == torch.bfloat16
    x = frames_of(2, 3)
    want16 = j16.apply({"params": params}, x)
    want32 = j32.apply({"params": params}, x)
    assert want16.dtype == jnp.float32
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, CLIP["out_dim"])
    floor_rule(got.numpy(), want16, want32, "ClipEncoder")
    # bf16 frames give the same bf16 computation: the first Dense casts
    with torch.no_grad():
        assert torch.equal(port(torch.from_numpy(x).to(torch.bfloat16)),
                           port(torch.from_numpy(x).to(torch.bfloat16).float()))


def test_spacetime_vit_bf16_matches_jax_bf16():
    jm, params, port = vit_weights()
    x = frames_of(3, 3)
    x16, jx16 = bf16_pair(x)
    want16 = jm.apply({"params": params}, jnp.asarray(jx16))
    want32 = jm.apply({"params": params}, x)
    assert want16.dtype == jnp.bfloat16
    with torch.no_grad():
        got = port(x16)
    assert got.dtype == torch.bfloat16 and got.shape == (3, VIT["out_dim"])
    floor_rule(got.float().numpy(), np.asarray(want16, np.float32), want32, "SpaceTimeViT")


def test_gather_clips_dtype_matches_jax():
    frames = frames_of(4, 9)
    idx = np.array([7, 0, 3, 3, 8])
    want = jenc.gather_clips(jnp.asarray(frames), jnp.asarray(idx), dtype=jnp.bfloat16)
    got = gather_clips(torch.from_numpy(frames), torch.from_numpy(idx), dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    assert gather_clips(torch.from_numpy(frames), torch.from_numpy(idx)).dtype == torch.float32


@pytest.fixture(scope="module")
def runners():
    """JAX runners (bf16 and f32 of each encoder) and the port's bf16 ones:
    the sidekick a ClipEncoder, the expert the ViT."""
    j32, j16, cparams, port_clip = clip_weights()
    jvit, vparams, port_vit = vit_weights()
    return ({"sk16": jenc.ClipEncoderRunner(j16, cparams),
             "sk32": jenc.ClipEncoderRunner(j32, cparams),
             "ex": jenc.ClipEncoderRunner(jvit, vparams)},
            ClipEncoderRunner(port_clip), ClipEncoderRunner(port_vit))


def test_delegated_encode_bf16_matches_jax(runners):
    jr, sk, ex = runners
    T, sn, ratio = 21, 4, 0.5
    frames = frames_of(5, T)
    f16, jf16 = bf16_pair(frames)
    text_cls = np.random.RandomState(12).randn(CLIP["out_dim"]).astype(np.float32)
    j_expert, j_sk, j_w = jenc.encode_delegate_ground(jr["ex"], jr["sk16"], jf16, jf16,
                                                      text_cls, sn, ratio)
    expert, sidekick, w = encode_delegate_ground(ex, sk, f16, f16,
                                                 torch.from_numpy(text_cls), sn, ratio)
    assert expert.dtype == sidekick.dtype == torch.float32
    assert j_expert.dtype == np.float32 and 0 < float(w.sum()) < T
    np.testing.assert_array_equal(w.numpy(), j_w)
    # the floors: the same clips and weights through the f32 encoders
    sk32 = jr["sk32"](frames)
    floor_rule(sidekick.numpy(), j_sk, sk32, "sidekick")
    k = expert_budget(T, sn, ratio)
    j_idx, _ = jenc.select_salient_clips(jnp.asarray(j_sk), jnp.asarray(text_cls),
                                         sn, ratio, k)
    idx, w2 = select_salient_clips(sidekick, torch.from_numpy(text_cls), sn, ratio, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(w2.numpy(), j_w)
    ex32 = jenc.delegated_encode(jr["ex"], j_idx, j_w, frames)
    selected = j_w > 0
    floor_rule(expert.numpy()[:, selected], j_expert[:, selected],
               ex32[:, selected], "expert")
    assert not expert.numpy()[:, ~selected].any()
    # the port's delegated_encode on the JAX selection gives the same stream
    again = delegated_encode(ex, torch.from_numpy(np.asarray(j_idx, np.int64)),
                             torch.from_numpy(np.array(j_w)), f16)
    assert torch.equal(again, expert)


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("encode_bf16_cli")
    rng = np.random.RandomState(0)
    for vid, n in (("v0", 5), ("v1", 7)):
        np.save(root / f"{vid}.npy",
                rng.randint(0, 256, size=(n, 2, 40, 52, 3), dtype=np.uint8))
    return root


COMMON = ["--frames", "2", "--resize", "36", "--input_res", str(RES)]


def test_encode_cli_bf16_sidekick_matches_jax(frames_dir, tmp_path):
    j32, j16, params, _ = clip_weights()
    torch.save(clip_encoder_params_to_state_dict(params), tmp_path / "sidekick.pth")
    opt = {k: v for k, v in CLIP.items() if k != "frames"}
    out_e, out_s = tmp_path / "expert", tmp_path / "sidekick"
    assert encode_main(["--frames_dir", str(frames_dir), "--out_expert_dir", str(out_e),
                        "--expert_opt", json.dumps(dict(opt, patch_size=8)),
                        "--out_sidekick_dir", str(out_s), "--sidekick", "factorized",
                        "--sidekick_ckpt", str(tmp_path / "sidekick.pth"),
                        "--sidekick_opt", json.dumps(dict(opt, dtype="bfloat16")),
                        "--device", "cpu"] + COMMON) == 0
    r16, r32 = jenc.ClipEncoderRunner(j16, params), jenc.ClipEncoderRunner(j32, params)
    for vid in ("v0", "v1"):
        raw = np.load(frames_dir / f"{vid}.npy").astype(np.float32) / 255.0
        frames = np.asarray(jenc.eval_transform(jnp.asarray(raw), center=36, input_res=RES))
        got = np.load(out_s / f"{vid}.npy")
        assert got.dtype == np.float32 and got.shape == (raw.shape[0], CLIP["out_dim"])
        floor_rule(got, r16(frames).T, r32(frames).T, vid)


def test_encode_cli_spacetime_drops_dtype_as_jax_does(frames_dir, tmp_path):
    import encode as jax_encode_cli

    save_jax_vit(tmp_path / "expert.pth", 0)
    opt = {"patch_size": 16, "dim": 32, "depth": 1, "heads": 2, "out_dim": 32}
    runs = {}
    for name, main, extra, dtype in (
            ("port16", encode_main, ["--device", "cpu"], {"dtype": "bfloat16"}),
            ("port", encode_main, ["--device", "cpu"], {}),
            ("jax16", jax_encode_cli.main, [], {"dtype": "bfloat16"})):
        runs[name] = tmp_path / name
        assert main(["--frames_dir", str(frames_dir), "--out_expert_dir", str(runs[name]),
                     "--expert", "spacetime", "--expert_ckpt", str(tmp_path / "expert.pth"),
                     "--expert_opt", json.dumps(dict(opt, **dtype))] + COMMON + extra) == 0
    for vid in ("v0", "v1"):
        got = np.load(runs["port16"] / f"{vid}.npy")
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, np.load(runs["port"] / f"{vid}.npy"))
        np.testing.assert_allclose(got, np.load(runs["jax16"] / f"{vid}.npy"),
                                   rtol=1e-4, atol=1e-5)
