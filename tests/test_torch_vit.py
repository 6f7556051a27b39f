"""The port's encoders against the JAX package's on the same weights: the
EgoVLP ``SpaceTimeViT`` (flax params carried by ``models.load_params``,
the grounder's bridge; Frozen-in-Time state dicts with EgoVLP
prefixes and without qkv biases, as tests/test_vit_import.py loads them)
and the factorized ``ClipEncoder`` (flax Dense kernels transposed by
``clip_encoder_params_to_state_dict``). Forwards agree at rtol 1e-4 /
atol 1e-5, the tolerance of tests/test_vit_import.py."""

import numpy as np
import pytest
import torch

import jax

from decafnet_tpu.encode import ClipEncoder as JaxClipEncoder
from decafnet_tpu.encode import SpaceTimeViT as JaxSpaceTimeViT
from decafnet_tpu.encode import vit_state_dict_to_params as jax_vit_import
from decafnet_tpu_torch.encode import (ClipEncoder, SpaceTimeViT, load_vit_checkpoint,
                                       make_clip_encoder, normalize_vit_key,
                                       vit_state_dict_to_params)
from decafnet_tpu_torch.encode.import_vit import clip_encoder_params_to_state_dict
from decafnet_tpu_torch.models import load_params
from test_vit_import import TorchSpaceTimeTransformer, _rand_init

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
VIT = dict(img_size=32, patch_size=16, dim=48, depth=2, heads=4, frames=2, out_dim=16)
CLIP = dict(patch_size=16, dim=32, depth=2, heads=2, out_dim=24, frames=2)


EMBEDDINGS = ("patch_embed", "pos_embed", "time_embed", "temporal_embed", "cls_token")


def randomized(tree, seed, quiet=False):
    """Every leaf of a flax params tree redrawn from a seed (N(0, 0.3^2),
    LayerNorm scales around 1), so that no part of the forward is inert and
    the MLPs see inputs where exact and tanh GELU differ. ``quiet`` scales
    the embeddings by 1e-3, so the first LayerNorms see a variance near
    their eps."""
    rng = np.random.RandomState(seed)

    def draw(path, x):
        noise = 0.3 * rng.randn(*np.shape(x)).astype(np.float32)
        if path[-1].key == "scale":
            return 1.0 + noise
        return noise * 1e-3 if quiet and path[0].key in EMBEDDINGS else noise

    return jax.tree_util.tree_map_with_path(draw, jax.tree.map(np.asarray, tree))


def frames_of(seed, b, frames, res):
    return np.random.RandomState(seed).rand(b, frames, res, res, 3).astype(np.float32)


def port_forward(model, frames):
    with torch.no_grad():
        return model.eval()(torch.from_numpy(frames)).numpy()


@pytest.mark.parametrize("quiet", [False, True])
def test_spacetime_vit_matches_jax(quiet):
    jax_model = JaxSpaceTimeViT(**VIT)
    x = frames_of(0, 3, VIT["frames"], VIT["img_size"])
    params = randomized(jax_model.init(jax.random.PRNGKey(0), x)["params"], 1, quiet)
    model = load_params(SpaceTimeViT(**VIT), params)
    want = np.asarray(jax_model.apply({"params": params}, x))
    np.testing.assert_allclose(port_forward(model, x), want, rtol=RTOL, atol=ATOL)


def test_spacetime_vit_without_projection():
    cfg = dict(VIT, out_dim=None, depth=1)
    jax_model = JaxSpaceTimeViT(**cfg)
    x = frames_of(2, 2, cfg["frames"], cfg["img_size"])
    params = randomized(jax_model.init(jax.random.PRNGKey(0), x)["params"], 3)
    model = load_params(SpaceTimeViT(**cfg), params)
    assert model.proj is None
    want = np.asarray(jax_model.apply({"params": params}, x))
    got = port_forward(model, x)
    assert got.shape == (2, cfg["dim"])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def frozen_in_time_oracle(seed):
    return _rand_init(TorchSpaceTimeTransformer(
        img_size=VIT["img_size"], patch=VIT["patch_size"], dim=VIT["dim"],
        depth=VIT["depth"], heads=VIT["heads"], frames=VIT["frames"],
        out_dim=VIT["out_dim"]), seed=seed).eval()


def oracle_forward(oracle, x):
    with torch.no_grad():
        return oracle(torch.from_numpy(x).permute(0, 1, 4, 2, 3)).numpy()


def egovlp_wrapped(sd):
    wrapped = {("module.vid_proj.0." + k.split(".", 1)[1]) if k.startswith("proj.")
               else "module.video_model." + k: v for k, v in sd.items()}
    wrapped["module.text_model.encoder.weight"] = torch.zeros(3, 3)
    wrapped["module.txt_proj.0.weight"] = torch.zeros(3, 3)
    wrapped["module.video_model.head.weight"] = torch.zeros(3, 3)
    return wrapped


def without_qkv_bias(oracle):
    """The oracle with zero qkv biases, and its state dict without them."""
    with torch.no_grad():
        for blk in oracle.blocks:
            blk.attn.qkv.bias.zero_()
            blk.timeattn.qkv.bias.zero_()
    return {k: v for k, v in oracle.state_dict().items() if not k.endswith("qkv.bias")}


@pytest.mark.parametrize("layout", ["plain", "egovlp_prefixes", "no_qkv_bias"])
def test_frozen_in_time_state_dict_loads_like_jax(layout, tmp_path):
    """A Frozen-in-Time state dict loads strictly into the port (through a
    ``.pth`` file nested under ``state_dict``) and into the JAX package;
    both forwards equal the torch oracle's."""
    oracle = frozen_in_time_oracle(seed=4)
    sd = {"plain": lambda: oracle.state_dict(),
          "egovlp_prefixes": lambda: egovlp_wrapped(oracle.state_dict()),
          "no_qkv_bias": lambda: without_qkv_bias(oracle)}[layout]()
    x = frames_of(5, 2, VIT["frames"], VIT["img_size"])
    want = oracle_forward(oracle, x)

    path = str(tmp_path / "egovlp.pth")
    torch.save({"state_dict": sd}, path)
    model = load_vit_checkpoint(SpaceTimeViT(**VIT), path)
    np.testing.assert_allclose(port_forward(model, x), want, rtol=RTOL, atol=ATOL)

    jax_model = JaxSpaceTimeViT(**VIT)
    params = jax_vit_import(sd, template=jax_model.init(jax.random.PRNGKey(0), x)["params"])
    np.testing.assert_allclose(np.asarray(jax_model.apply({"params": params}, x)),
                               want, rtol=RTOL, atol=ATOL)
    for k, v in vit_state_dict_to_params(sd).items():
        assert v.dtype == torch.float32 and v.device.type == "cpu", k


@pytest.mark.parametrize("key,want", [
    ("module.video_model.blocks.0.attn.qkv.weight", "blocks.0.attn.qkv.weight"),
    ("model.video_model.cls_token", "cls_token"),
    ("module.vid_proj.0.bias", "proj.bias"),
    ("module.text_model.embeddings.word.weight", None),
    ("txt_proj.0.weight", None),
    ("video_model.pre_logits.fc.weight", None),
    ("head.bias", None)])
def test_normalize_vit_key_matches_jax(key, want):
    from decafnet_tpu.encode import normalize_vit_key as jax_normalize

    assert normalize_vit_key(key) == jax_normalize(key) == want


def clip_pair(quiet=False):
    jax_model = JaxClipEncoder(**CLIP)
    x = frames_of(6, 3, CLIP["frames"], 32)
    params = randomized(jax_model.init(jax.random.PRNGKey(0), x)["params"], 7, quiet)
    model = ClipEncoder(**CLIP, img_size=32)
    model.load_state_dict(clip_encoder_params_to_state_dict(params), strict=True)
    return jax_model, params, model, x


@pytest.mark.parametrize("quiet", [False, True])
def test_clip_encoder_matches_jax(quiet):
    """Catches the two flax defaults: tanh GELU, and (quiet embeddings)
    LayerNorm eps 1e-6."""
    jax_model, params, model, x = clip_pair(quiet)
    want = np.asarray(jax_model.apply({"params": params}, x))
    got = port_forward(model, x)
    assert got.dtype == np.float32 and got.shape == (3, CLIP["out_dim"])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_clip_encoder_bridge_layout():
    _, params, model, _ = clip_pair()
    sd = model.state_dict()
    np.testing.assert_array_equal(sd["block0.fc1.weight"].numpy(),
                                  params["block0"]["fc1"]["kernel"].T)
    np.testing.assert_array_equal(sd["block1.norm_s.weight"].numpy(),
                                  params["block1"]["norm_s"]["scale"])
    assert model.block0.norm_t.eps == 1e-6 and model.norm.eps == 1e-6


@pytest.mark.parametrize("cls", [SpaceTimeViT, ClipEncoder])
def test_seeded_weights_repeat(cls):
    kw = VIT if cls is SpaceTimeViT else dict(CLIP, img_size=32)
    a = cls(**kw).reset_parameters(torch.Generator().manual_seed(3))
    b = cls(**kw).reset_parameters(torch.Generator().manual_seed(3))
    c = cls(**kw).reset_parameters(torch.Generator().manual_seed(4))
    x = frames_of(8, 2, 2, 32)
    ya, yb, yc = (port_forward(m, x) for m in (a, b, c))
    np.testing.assert_array_equal(ya, yb)
    assert np.isfinite(ya).all() and not np.allclose(ya, yc)


def test_make_clip_encoder_takes_jax_options_and_bf16():
    enc = make_clip_encoder(dict(CLIP, img_size=32, unknown_key=1, dtype=None))
    assert isinstance(enc, ClipEncoder) and enc.depth == CLIP["depth"]
    for name in ("float32", torch.float32, np.float32):
        assert make_clip_encoder(dict(CLIP, dtype=name)).dtype is enc.dtype is None
    for name in ("bfloat16", "bf16", torch.bfloat16):
        enc16 = make_clip_encoder(dict(CLIP, img_size=32, unknown_key=1, dtype=name))
        assert isinstance(enc16, ClipEncoder) and enc16.dtype == torch.bfloat16
    with torch.no_grad():
        assert enc16(torch.zeros(1, CLIP["frames"], 32, 32, 3)).dtype == torch.float32
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        make_clip_encoder(dict(CLIP, dtype="float16"))
