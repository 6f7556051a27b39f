"""The port's encode CLI (``python -m decafnet_tpu_torch.encode``) against
the root ``encode.py`` on the same raw frames and the same weights (a
``.pth`` saved from the JAX SpaceTimeViT params): the feature files agree
at rtol 1e-4 / atol 1e-5, and the port's Evaluator reads them as its
datasets read any feature files. Also: seeded synthetic weights repeat,
and the CLI runs on the CUDA card unless told otherwise."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import encode as jax_encode_cli  # noqa: E402  (the root CLI of the JAX package)
from decafnet_tpu.encode import SpaceTimeViT as JaxSpaceTimeViT  # noqa: E402
from decafnet_tpu_torch.encode.__main__ import main as encode_main  # noqa: E402
from decafnet_tpu_torch.models import state_dict_from_params  # noqa: E402

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)

FEAT_DIM = 32
OPT = {"patch_size": 16, "dim": 32, "depth": 1, "heads": 2, "out_dim": FEAT_DIM}
COMMON = ["--frames", "2", "--resize", "36", "--input_res", "32"]


def save_jax_vit(path, seed):
    model = JaxSpaceTimeViT(img_size=32, frames=2, **OPT)
    sample = np.zeros((1, 2, 32, 32, 3), np.float32)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed), sample)["params"])
    torch.save(state_dict_from_params(params), path)


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    from decafnet_tpu_torch.data import make_synthetic_dataset

    root = tmp_path_factory.mktemp("encode_cli")
    paths = make_synthetic_dataset(str(root / "ds"), num_videos=2, num_queries=2,
                                   clip_range=(9, 14), vid_dim=FEAT_DIM,
                                   shallow_dim=FEAT_DIM, text_dim=24, seed=5)
    anno = json.load(open(paths["anno_file"]))
    frames_dir = root / "frames"
    os.makedirs(frames_dir)
    rng = np.random.RandomState(0)
    for split in anno:
        for vid_id, info in anno[split].items():
            np.save(frames_dir / f"{vid_id}.npy", rng.randint(
                0, 256, size=(info["num_clips"], 2, 40, 52, 3), dtype=np.uint8))
    save_jax_vit(root / "expert.pth", 0)
    save_jax_vit(root / "sidekick.pth", 1)

    outs = {}
    for name, main, extra in (("jax", jax_encode_cli.main, []),
                              ("port", encode_main, ["--device", "cpu"])):
        outs[name] = (str(root / name / "expert"), str(root / name / "sidekick"))
        rc = main([
            "--frames_dir", str(frames_dir),
            "--out_expert_dir", outs[name][0], "--out_sidekick_dir", outs[name][1],
            "--expert", "spacetime", "--expert_ckpt", str(root / "expert.pth"),
            "--expert_opt", json.dumps(OPT),
            "--sidekick", "spacetime", "--sidekick_ckpt", str(root / "sidekick.pth"),
            "--sidekick_opt", json.dumps(OPT)] + COMMON + extra)
        assert rc == 0
    return paths, anno, outs, frames_dir


def test_encode_cli_matches_jax_cli(encoded):
    _, anno, outs, _ = encoded
    for split in anno:
        for vid_id, info in anno[split].items():
            for stream in (0, 1):
                got = np.load(os.path.join(outs["port"][stream], f"{vid_id}.npy"))
                want = np.load(os.path.join(outs["jax"][stream], f"{vid_id}.npy"))
                assert got.shape == (info["num_clips"], FEAT_DIM)
                assert got.dtype == np.float32 and np.isfinite(got).all()
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_encoded_features_drive_the_port_evaluator(encoded):
    from decafnet_tpu_torch.core import get_cfg_defaults, update_eval_data, update_opt
    from decafnet_tpu_torch.data import apply_synthetic_cfg
    from decafnet_tpu_torch.eval import Evaluator
    from decafnet_tpu_torch.models import random_params

    paths, _, outs, _ = encoded
    cfg = get_cfg_defaults()
    m = cfg.model
    m.name, m.sratio, m.sn = "iter", 0.5, 4
    m.vid_net.in_dim, m.vid_net.embd_dim, m.vid_net.max_seq_len = FEAT_DIM, 16, 16
    m.vid_net.arch = (1, 0, 2)
    m.text_net.in_dim, m.text_net.embd_dim, m.text_net.n_layers = 24, 16, 1
    m.fusion.n_layers = 1
    cfg.train.num_workers = 0
    cfg.seed = 1
    apply_synthetic_cfg(cfg, paths)
    for tree in (cfg.data, cfg.eval.data):     # the CLI's features
        tree.vid_feat_dir, tree.shallow_vid_feat_dir = outs["port"]
    update_opt(cfg)
    update_eval_data(cfg)

    ev = Evaluator(cfg, params=random_params(cfg, 0), device="cpu")
    metrics = ev.run()
    assert ev.meter.text_cnt == 4                  # 2 val videos x 2 queries
    assert np.isfinite(metrics).all()


def test_seeded_synthetic_weights_repeat(encoded, tmp_path, capsys):
    _, anno, _, frames_dir = encoded
    opt = json.dumps(dict(OPT, patch_size=8))
    runs = []
    for i in range(2):
        out = tmp_path / f"run{i}"
        assert encode_main(["--frames_dir", str(frames_dir), "--out_expert_dir",
                            str(out), "--expert_opt", opt, "--device", "cpu"]
                           + COMMON) == 0
        runs.append(out)
    assert "seeded synthetic weights (seed 0)" in capsys.readouterr().out
    for vid_id in anno["val"]:
        a = np.load(runs[0] / f"{vid_id}.npy")
        np.testing.assert_array_equal(a, np.load(runs[1] / f"{vid_id}.npy"))
        assert a.shape[1] == FEAT_DIM and np.isfinite(a).all()


def test_encode_cli_needs_cuda_by_default(encoded, tmp_path, monkeypatch):
    _, _, _, frames_dir = encoded
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        encode_main(["--frames_dir", str(frames_dir),
                     "--out_expert_dir", str(tmp_path / "e")])


def test_factorized_checkpoint_matches_jax_encoder(encoded, tmp_path):
    """A factorized encoder's checkpoint (a flax ClipEncoder tree through
    the bridge) gives the features of the JAX encoder on the JAX-transformed
    frames."""
    import jax.numpy as jnp

    from decafnet_tpu import encode as jenc
    from decafnet_tpu_torch.encode.import_vit import clip_encoder_params_to_state_dict

    _, anno, _, frames_dir = encoded
    opt = dict(OPT, frames=2)
    jax_enc = jenc.make_clip_encoder(opt)
    params = jax_enc.init(jax.random.PRNGKey(3), np.zeros((1, 2, 32, 32, 3), np.float32))
    params = jax.tree.map(np.asarray, params["params"])
    torch.save(clip_encoder_params_to_state_dict(params), tmp_path / "factorized.pth")
    out = tmp_path / "out"
    assert encode_main(["--frames_dir", str(frames_dir), "--out_expert_dir", str(out),
                        "--expert", "factorized", "--expert_ckpt",
                        str(tmp_path / "factorized.pth"), "--expert_opt",
                        json.dumps(OPT), "--device", "cpu"] + COMMON) == 0
    runner = jenc.ClipEncoderRunner(jax_enc, params)
    for vid_id in anno["val"]:
        raw = np.load(frames_dir / f"{vid_id}.npy").astype(np.float32) / 255.0
        frames = np.asarray(jenc.eval_transform(jnp.asarray(raw), center=36, input_res=32))
        np.testing.assert_allclose(np.load(out / f"{vid_id}.npy"), runner(frames).T,
                                   rtol=1e-4, atol=1e-5)
