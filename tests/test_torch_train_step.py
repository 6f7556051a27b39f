"""One train step of the port against the JAX package on the CPU (dropout
off): ten optimizer steps of adamw + clip, adam and sgd + clip on the same
seeded gradients against the optax chain of decafnet_tpu/train/optim.py at
1e-6, and the Trainer's step against ``build_train_step`` with one and two
microbatches (summed metrics, the loss-norm EMA, the weight EMA and AdamW's
first moment). Helpers and the small config come from
tests/test_torch_train.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from decafnet_tpu.core import update_opt as jax_update_opt
from decafnet_tpu.data import batchify_train as jax_batchify_train
from decafnet_tpu.data import make_dataset as jax_make_dataset
from decafnet_tpu.data import make_synthetic_dataset
from decafnet_tpu.models import make_model as jax_make_model
from decafnet_tpu.train import TrainState, build_train_step, make_optimizer
from decafnet_tpu.train import make_schedule as jax_make_schedule
from decafnet_tpu_torch.core import update_opt
from decafnet_tpu_torch.models import (init_random, load_params, make_model,
                                       params_from_state_dict)
from decafnet_tpu_torch.train import Optimizer, Trainer, make_schedule
from test_torch_train import (CT, CV, _flax_params, assert_grads_close,
                              cfg_pair, flat_jax, flat_port, jax_points)

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)


OPTIMIZERS = {
    "adamw + clip": {"name": "adamw", "lr": 1e-3, "weight_decay": 0.05,
                     "clip_grad_norm": 1.0},
    "adam": {"name": "adam", "lr": 1e-3, "clip_grad_norm": None},
    "sgd + clip": {"name": "sgd", "lr": 1e-2, "momentum": 0.9,
                   "clip_grad_norm": 1.0},
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_ten_optimizer_steps_match_optax(name):
    _, tc = cfg_pair()
    model = init_random(make_model(tc), 5)
    params = params_from_state_dict(model.state_dict())
    sched = {"name": "cosine", "epochs": 3, "warmup_epochs": 1,
             "_base_lr": OPTIMIZERS[name]["lr"]}
    opt = Optimizer(model, OPTIMIZERS[name], make_schedule(sched, 4))
    jopt = make_optimizer(params, OPTIMIZERS[name], jax_make_schedule(sched, 4))
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jparams)

    # one compiled optax step: eager, every leaf shape compiles its own ops
    @jax.jit
    def jax_step(jgrads, jstate, jparams):
        updates, jstate = jopt.update(jgrads, jstate, jparams)
        return jax.tree.map(lambda p, u: p + u, jparams, updates), jstate

    rng = np.random.RandomState(3)
    n_clipped = 0
    for step in range(10):
        # alternately below and above the clip norm
        scale = 2e-3 if step % 2 else 5e-2
        grads = {n: np.asarray(scale * rng.randn(*p.shape), np.float32)
                 for n, p in model.named_parameters()}
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n].copy())
        norm = np.sqrt(sum(float(np.square(g).sum()) for g in grads.values()))
        n_clipped += norm >= 1.0
        opt.step()
        jgrads = jax.tree.map(jnp.asarray, params_from_state_dict(
            {n: torch.from_numpy(g) for n, g in grads.items()}))
        jparams, jstate = jax_step(jgrads, jstate, jparams)

        got = flat_port(dict(model.named_parameters()))
        for path, want in flat_jax(jparams).items():
            np.testing.assert_allclose(
                got[path], want, rtol=1e-6,
                atol=1e-6 * max(np.abs(want).max(), 1e-3),
                err_msg=f"step {step} {path}")
    assert opt.count == 10
    if OPTIMIZERS[name]["clip_grad_norm"]:
        assert 0 < n_clipped < 10


# ------------------------------------------------------ one step of training

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_train_data")
    return make_synthetic_dataset(str(root), num_videos=4, num_queries=3,
                                  clip_range=(40, 90), vid_dim=CV,
                                  shallow_dim=CV, text_dim=CT, seed=11)


@pytest.mark.parametrize("micro", [2, 1])
def test_step_matches_build_train_step(synth, tmp_path, micro):
    """One step at lr(0) = 0 (warmup), with the EMA apart from the weights:
    the summed metrics, the loss-norm EMA, the weight EMA and the moments
    of AdamW after one microbatch of 2 videos, or two of 1 (the JAX step's
    scan)."""
    jc, tc = cfg_pair(synth, str(tmp_path / "exp"), msf=True)
    for c in (jc, tc):
        c.train.microbatch_size = micro
        c.train.warmup_epochs = 2
    jax_update_opt(jc)
    update_opt(tc)
    trainer = Trainer(tc, device="cpu")
    ds = jax_make_dataset(jc, num_epochs=jc.train.epochs + jc.train.warmup_epochs,
                          is_training=True, rng=np.random.RandomState(jc.seed))
    batch = jax_batchify_train([ds[0], ds[1]], jc.data.max_vid_len,
                               jc.data.max_text_len, jc.data.max_num_text)

    params = _flax_params(True, False, False)
    rng = np.random.RandomState(4)
    ema = jax.tree.map(lambda p: (p + 0.1 * rng.randn(*p.shape))
                       .astype(np.float32), params)
    load_params(trainer.model, params)
    load_params(trainer.ema, ema)

    model = jax_make_model(jc)
    sched_cfg = dict(jc.scheduler, _base_lr=jc.optimizer.lr)
    optimizer = make_optimizer(params, jc.optimizer,
                               jax_make_schedule(sched_cfg, trainer.itrs_per_epoch))
    state = TrainState(step=jnp.int32(0), params=params, ema_params=ema,
                       opt_state=optimizer.init(params),
                       loss_norm=jnp.float32(jc.train.loss_norm))
    new, want_m = jax.jit(build_train_step(model, optimizer, jc))(
        state, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(1), jnp.asarray(jax_points(jc, jc.data.max_vid_len)))

    got_m = trainer.train_step({k: torch.from_numpy(v) for k, v in batch.items()})
    assert trainer.step == 1 and trainer.optimizer.schedule(0) == 0.0
    for k in ("cls", "reg", "total", "norm"):
        np.testing.assert_allclose(float(got_m[k].detach()), float(want_m[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(trainer.loss_norm), float(new.loss_norm),
                               rtol=1e-6)
    got_p = flat_port(dict(trainer.model.named_parameters()))
    for path, want in flat_jax(new.params).items():
        np.testing.assert_array_equal(got_p[path], want, err_msg=str(path))
    got_e = flat_port(dict(trainer.ema.named_parameters()))
    for path, want in flat_jax(new.ema_params).items():
        np.testing.assert_allclose(got_e[path], want, rtol=1e-6, atol=1e-7,
                                   err_msg=str(path))
    # AdamW's first moment after one step is (1 - b1) * the clipped
    # gradient summed over the microbatches
    mu = flat_jax(new.opt_state[1][0].mu)
    got_mu = flat_port({n: m for (n, _), m in zip(
        trainer.model.named_parameters(), trainer.optimizer.state["mu"])})
    assert_grads_close(got_mu, mu)
