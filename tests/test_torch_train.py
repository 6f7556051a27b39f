"""The port's training math against the JAX package on the CPU, with
dropout off (flax's dropout streams cannot be reproduced, so every rate is
0 here; tests/test_torch_autograd.py covers the dropout helpers):

* ``build_microbatch_loss``: loss terms at rtol 1e-5 and every gradient at
  rtol 2e-4 / atol 2e-5 * scale (the noise-sized skip of
  tests/test_grouped_eval.py:181-187), Q = 2 with one padding row,
  video-major and per row, for the msf/scat/norm settings of
  tests/test_grouped_eval.py, against the JAX trainer's (video-major) loss;
* the train points, ``decay_mask`` key for key and the ``make_schedule``
  traces at every step (cosine, multistep with and without milestones,
  null);
* ``batchify_train`` and the loader with ``transform``, key for key.

tests/test_torch_train_step.py holds the optimizer chain and one train
step; it imports the helpers below."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from decafnet_tpu.core import get_cfg_defaults as jax_defaults
from decafnet_tpu.core import update_eval_data as jax_update_eval_data
from decafnet_tpu.core import update_opt as jax_update_opt
from decafnet_tpu.data import DataLoader as JaxLoader
from decafnet_tpu.data import apply_synthetic_cfg as jax_apply_synthetic_cfg
from decafnet_tpu.data import batchify_train as jax_batchify_train
from decafnet_tpu.data import make_dataset as jax_make_dataset
from decafnet_tpu.data import make_synthetic_dataset
from decafnet_tpu.models import fpn_lengths as jax_fpn_lengths
from decafnet_tpu.models import generate_points as jax_generate_points
from decafnet_tpu.models import make_model as jax_make_model
from decafnet_tpu.models import select_points as jax_select_points
from decafnet_tpu.train import build_microbatch_loss as jax_microbatch_loss
from decafnet_tpu.train import decay_mask as jax_decay_mask
from decafnet_tpu.train import make_schedule as jax_make_schedule
from decafnet_tpu_torch.core import get_cfg_defaults, update_eval_data, update_opt
from decafnet_tpu_torch.data import DataLoader, apply_synthetic_cfg, batchify_train
from decafnet_tpu_torch.data import make_dataset
from decafnet_tpu_torch.models import load_params, make_model
from decafnet_tpu_torch.models import params_from_state_dict
from decafnet_tpu_torch.train import (build_microbatch_loss, decay_mask,
                                      make_schedule)
from decafnet_tpu_torch.train.trainer import train_points

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)

CV, CT = 24, 20
MODEL = {"name": "iter", "sratio": 0.5, "sn": 8, "tcn_dropout": 0.0,
         "vid_net": {"in_dim": CV, "embd_dim": 16, "max_seq_len": 64,
                     "arch": (1, 0, 3), "proj_pdrop": 0.0, "path_pdrop": 0.0},
         "text_net": {"in_dim": CT, "embd_dim": 16, "n_layers": 1},
         "fusion": {"n_layers": 1, "proj_pdrop": 0.0, "path_pdrop": 0.0}}


def _apply(tree, overrides):
    for k, v in overrides.items():
        if isinstance(v, dict):
            _apply(tree[k], v)
        else:
            tree[k] = v


def cfg_pair(paths=None, logdir="", **model):
    """The same small, dropout-free config in both packages' trees."""
    jc, tc = jax_defaults("grounder"), get_cfg_defaults("grounder")
    for cfg, apply in ((jc, jax_apply_synthetic_cfg), (tc, apply_synthetic_cfg)):
        _apply(cfg.model, MODEL)
        _apply(cfg.model, model)
        cfg.train.batch_size = 2
        cfg.train.num_workers = 0
        cfg.train.version = 2
        cfg.seed = 13
        cfg.aux.logdir = logdir
        if paths is not None:
            apply(cfg, paths)
    jax_update_eval_data(jax_update_opt(jc))
    update_eval_data(update_opt(tc))
    return jc, tc


def flat_jax(tree):
    return {tuple(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def flat_port(named):
    """{flax path: array} of a torch {name: tensor} mapping."""
    tree = params_from_state_dict({k: v for k, v in named.items()})

    def walk(node, prefix=()):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from walk(v, prefix + (k,))
            else:
                yield prefix + (k,), v
    return dict(walk(tree))


def port_grads(model):
    return flat_port({n: (p.grad if p.grad is not None else torch.zeros_like(p))
                      for n, p in model.named_parameters()})


def assert_grads_close(got, want, rtol=2e-4, atol_rel=2e-5):
    assert set(got) == set(want)
    for path, b in want.items():
        a = got[path]
        # noise-sized on both sides (e.g. attention key biases, whose exact
        # gradient is 0): tests/test_grouped_eval.py:181-187
        if max(np.abs(a).max(), np.abs(b).max()) <= 1e-8:
            continue
        scale = max(np.abs(b).max(), 1e-12)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol_rel * scale,
                                   err_msg=str(path))


def _inputs(V, Q, T, seed=11, L=12):
    rng = np.random.RandomState(seed)
    vm = np.zeros((V, T), bool)
    for i in range(V):
        vm[i, :T - 7 * i] = True
    tm = np.ones((V * Q, L), bool)
    tm[-2, L // 2:] = False
    return {
        "vid": rng.randn(V, CV, T).astype(np.float32),
        "shallow_vid": rng.randn(V, CV, T).astype(np.float32),
        "vid_masks": vm,
        "text": rng.randn(V * Q, CT, L).astype(np.float32),
        "text_masks": tm,
        "text_cls": rng.randn(V * Q, CV).astype(np.float32),
        "targets": np.sort(rng.uniform(1, 50, (V * Q, 2)), 1).astype(np.float32),
        "row_valid": np.array([True] * (V * Q - 1) + [False]),
    }


def jax_points(cfg, T):
    lens = jax_fpn_lengths(T // cfg.model.vid_stride, cfg.model.num_fpn_levels)
    pts = jax_generate_points(cfg.pt_gen.max_seq_len, cfg.pt_gen.num_fpn_levels,
                              cfg.pt_gen.regression_range, cfg.pt_gen.sigma)
    return np.ascontiguousarray(np.concatenate(jax_select_points(pts, lens)).T)


@functools.lru_cache(maxsize=None)
def _flax_params(msf, scat, norm):
    jc, _ = cfg_pair(msf=msf, scat=scat, norm=norm)
    mb = _inputs(2, 2, 64)
    rep = {k: np.repeat(mb[k], 2, 0) for k in ("vid", "shallow_vid", "vid_masks")}
    model = jax_make_model(jc)
    # one compiled init: eager init compiles every primitive on its own
    init = jax.jit(functools.partial(model.init, deterministic=True))
    params = init(jax.random.PRNGKey(0), rep["vid"], rep["shallow_vid"],
                  rep["vid_masks"], mb["text"], mb["text_cls"],
                  mb["text_masks"])["params"]
    return jax.tree.map(np.asarray, params)


SETTINGS = [(True, False, False), (True, True, False), (False, False, False),
            (False, True, True)]


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(msf, scat, norm):
    """The JAX trainer's microbatch loss (video-major, its default) and
    gradients; tests/test_grouped_eval.py holds its per-row form to it."""
    jc, _ = cfg_pair(msf=msf, scat=scat, norm=norm)
    jc.data.max_num_text = 2
    loss_fn = jax_microbatch_loss(jax_make_model(jc), jc)
    (_, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        _flax_params(msf, scat, norm),
        {k: jnp.asarray(v) for k, v in _inputs(2, 2, 64).items()},
        jax.random.PRNGKey(7), jnp.float32(100.0),
        jnp.asarray(jax_points(jc, 64)))
    return jax.device_get(metrics), flat_jax(grads)


@pytest.mark.parametrize("video_major", [True, False])
@pytest.mark.parametrize("msf,scat,norm", SETTINGS)
def test_microbatch_loss_and_grads_match_jax(msf, scat, norm, video_major):
    _, tc = cfg_pair(msf=msf, scat=scat, norm=norm)
    tc.tpu.video_major_train = video_major
    tc.data.max_num_text = 2
    params = _flax_params(msf, scat, norm)
    mb = _inputs(2, 2, 64)
    points = jax_points(tc, 64)
    want_m, want_g = _jax_loss_and_grads(msf, scat, norm)

    model = load_params(make_model(tc), params).train()
    port_loss = build_microbatch_loss(model, tc)
    total, got_m = port_loss({k: torch.from_numpy(v) for k, v in mb.items()},
                             torch.Generator().manual_seed(7),
                             torch.tensor(100.0), torch.from_numpy(points))
    total.backward()

    assert float(want_m["norm"]) > 0
    for k in ("cls", "reg", "total", "norm"):
        np.testing.assert_allclose(float(got_m[k].detach()), float(want_m[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert_grads_close(port_grads(model), want_g)


def test_train_points_match_the_jax_trainer():
    jc, tc = cfg_pair()
    np.testing.assert_array_equal(train_points(tc, "cpu").numpy(),
                                  jax_points(jc, jc.data.max_vid_len))


# ---------------------------------------------------------------- optimizer

def test_decay_mask_matches_jax():
    params = _flax_params(True, True, False)
    _, tc = cfg_pair(msf=True, scat=True)
    model = load_params(make_model(tc), params)
    got = flat_port({n: torch.tensor(m) for n, m in
                     decay_mask(model.named_parameters()).items()})
    want = flat_jax(jax_decay_mask(params))
    assert set(got) == set(want)
    for path in want:
        assert bool(got[path]) == bool(want[path]), path
    assert 0 < sum(map(bool, want.values())) < len(want)


SCHEDULES = {
    "cosine": {"name": "cosine"},
    "multistep": {"name": "multistep", "steps": (1, 2), "gamma": 0.1},
    "multistep (-1,)": {"name": "multistep", "steps": (-1,), "gamma": 0.1},
    "multistep (0, 3)": {"name": "multistep", "steps": (0, 3), "gamma": 0.5},
    "null": {"name": "null"},
}


@pytest.mark.parametrize("warmup_epochs", [0, 1, 2])
@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_traces_match_jax(name, warmup_epochs):
    sched = dict(SCHEDULES[name], epochs=4, warmup_epochs=warmup_epochs,
                 _base_lr=1e-3)
    itrs = 3
    got = make_schedule(sched, itrs)
    want = jax_make_schedule(sched, itrs)
    ts = np.arange(0, (sched["epochs"] + warmup_epochs) * itrs + 3)
    trace = np.array([got(t) for t in ts])
    ref = np.array([float(want(jnp.int32(t))) for t in ts])
    warm = ts < warmup_epochs * itrs
    np.testing.assert_array_equal(trace[warm], ref[warm])
    if name == "cosine":
        # numpy's f32 cos and XLA's differ in the last bits, which the
        # 1 + cos cancellation near the end of the decay magnifies
        np.testing.assert_allclose(trace, ref, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(trace, ref)
    if warmup_epochs > 1 and name != "null":
        assert trace[0] == 0.0 and trace[1] > 0.0


# ------------------------------------------------------------------ batches

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_train_data")
    return make_synthetic_dataset(str(root), num_videos=4, num_queries=3,
                                  clip_range=(40, 90), vid_dim=CV,
                                  shallow_dim=CV, text_dim=CT, seed=11)


def test_batchify_train_matches_jax(synth):
    jc, tc = cfg_pair(synth)
    ds = make_dataset(tc, num_epochs=2, is_training=True,
                      rng=np.random.RandomState(3))
    samples = [ds[i] for i in range(len(ds))]
    for Q, L in ((2, tc.data.max_text_len), (3, 5)):
        got = batchify_train(samples, tc.data.max_vid_len, L, Q)
        want = jax_batchify_train(samples, jc.data.max_vid_len, L, Q)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="exceeds input_vid_len"):
        batchify_train(samples, 8, 4, 2)


@pytest.mark.parametrize("num_threads", [0, 2])
def test_loader_with_transform_matches_jax(synth, num_threads):
    jc, tc = cfg_pair(synth)
    kw = dict(batch_size=2, shuffle=True, seed=5, num_threads=num_threads)
    loaders = []
    for cfg, make, Loader, batchify in (
            (tc, make_dataset, DataLoader, batchify_train),
            (jc, jax_make_dataset, JaxLoader, jax_batchify_train)):
        ds = make(cfg, num_epochs=2, is_training=True,
                  rng=np.random.RandomState(cfg.seed))
        loaders.append(Loader(ds, transform=lambda s, c=cfg, b=batchify: b(
            s, c.data.max_vid_len, c.data.max_text_len, c.data.max_num_text),
            **kw))
    for epoch in range(2):
        for loader in loaders:
            loader.set_epoch(epoch)
        got, want = (list(loader) for loader in loaders)
        assert len(got) == len(want) == len(loaders[0]) > 0
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
