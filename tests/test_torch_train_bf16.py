"""bf16 training of the port (``tpu.compute_dtype: bfloat16``) against the
JAX package's on the CPU, dropout off (flax's dropout streams cannot be
reproduced; tests/test_torch_train.py's small config):

- One Trainer step against the JAX ``build_train_step`` in bf16 at lr 0
  (warmup), the EMA apart from the weights, as
  tests/test_torch_train_step.py holds the f32 step. The bf16 noise floor
  is the JAX bf16 step against the JAX f32 step on the same weights and
  batch; the summed metrics, the loss-norm EMA and AdamW's first moments
  (the gradients, all leaves as one vector) are held to it by
  tests/test_torch_bf16.py's rule,
  ``mean|port16 - jax16| <= 1.5 * mean|jax16 - jax32|`` and ``max <= 3 *
  max|jax16 - jax32|``, each side plus 4 f32 eps of the largest |jax16|,
  so that a quantity bf16 does not touch (the positive-point count, the
  loss norm) is held to f32 rounding; each leaf's moment also lies within
  the train phase's per-leaf relative L2 of 0.25 (below). The weights, their
  EMA, the moments and the loss norm are f32.
- The bf16 copies of the f32 parameters (``ops.params.cast``) and conv3's
  bf16 weight fragments are rebuilt after an optimizer step and after
  ``load_state_dict``: a bf16 forward then equals that of a model built
  afresh from the same weights.
- Activation checkpointing (``tpu.remat`` "nothing" / "dots") in bf16
  gives the unwrapped bf16 step's loss and gradients by the train phase's
  relative-L2 rule (1e-2 over all leaves, 0.25 per leaf; chip_smoke.py).
- The train CLI with ``--set tpu.compute_dtype bfloat16`` trains, writes
  its checkpoints and runs the train-time eval of the EMA in bf16.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from decafnet_tpu.core import update_opt as jax_update_opt
from decafnet_tpu.data import batchify_train as jax_batchify_train
from decafnet_tpu.data import make_dataset as jax_make_dataset
from decafnet_tpu.models import make_model as jax_make_model
from decafnet_tpu.train import TrainState, build_train_step, make_optimizer
from decafnet_tpu.train import make_schedule as jax_make_schedule
from decafnet_tpu_torch.core import update_opt
from decafnet_tpu_torch.models import load_params, make_model
from decafnet_tpu_torch.ops import fused_conv
from decafnet_tpu_torch.ops.params import cast
from decafnet_tpu_torch.train import Trainer
from decafnet_tpu_torch.train.__main__ import main as train_main
from test_torch_remat import Q as REMAT_Q
from test_torch_remat import _cfg as remat_cfg
from test_torch_remat import _inputs as remat_inputs
from test_torch_train import _flax_params, cfg_pair, flat_jax, flat_port, jax_points
from test_torch_train_step import synth  # noqa: F401  (fixture)
from test_torch_trainer import write_cfg

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)

F32_EPS = float(np.finfo(np.float32).eps)
# the train phase's relative-L2 rule (chip_smoke.py GRAD_REL_L2_ALL / _LEAF)
REL_L2_ALL, REL_L2_LEAF = 1e-2, 0.25


def floor_rule(got, want, want32, what):
    """``got`` (port bf16) against ``want`` (JAX bf16) at the noise floor of
    ``want`` against ``want32`` (JAX f32)."""
    got, want, want32 = (np.asarray(a, np.float64).ravel()
                         for a in (got, want, want32))
    slack = 4 * F32_EPS * max(np.abs(want).max(), 1e-30)
    err, floor = np.abs(got - want), np.abs(want - want32)
    assert err.mean() <= 1.5 * floor.mean() + slack, (what, err.mean(), floor.mean())
    assert err.max() <= 3 * floor.max() + slack, (what, err.max(), floor.max())


def _step_cfgs(synth, logdir, dtype, warmup_epochs=2):
    jc, tc = cfg_pair(synth, logdir, msf=True)
    for c in (jc, tc):
        c.train.microbatch_size = 2
        c.train.warmup_epochs = warmup_epochs
        c.tpu.compute_dtype = dtype
    return jax_update_opt(jc), update_opt(tc)


@pytest.fixture(scope="module")
def jax_steps(synth, tmp_path_factory):  # noqa: F811
    """One JAX ``build_train_step`` at lr 0 in f32 and in bf16 from the same
    weights, EMA and batch: (batch, params, ema, {dtype: (state, metrics)})."""
    jc, _ = _step_cfgs(synth, str(tmp_path_factory.mktemp("jax_step")), "float32")
    ds = jax_make_dataset(jc, num_epochs=jc.train.epochs + jc.train.warmup_epochs,
                          is_training=True, rng=np.random.RandomState(jc.seed))
    batch = jax_batchify_train([ds[0], ds[1]], jc.data.max_vid_len,
                               jc.data.max_text_len, jc.data.max_num_text)
    params = _flax_params(True, False, False)
    rng = np.random.RandomState(4)
    ema = jax.tree.map(lambda p: (p + 0.1 * rng.randn(*p.shape))
                       .astype(np.float32), params)
    points = jnp.asarray(jax_points(jc, jc.data.max_vid_len))
    itrs = len(ds) // jc.train.batch_size
    runs = {}
    for dtype in ("float32", "bfloat16"):
        jc.tpu.compute_dtype = dtype
        model = jax_make_model(jc)
        optimizer = make_optimizer(params, jc.optimizer, jax_make_schedule(
            dict(jc.scheduler, _base_lr=jc.optimizer.lr), itrs))
        state = TrainState(step=jnp.int32(0), params=params, ema_params=ema,
                           opt_state=optimizer.init(params),
                           loss_norm=jnp.float32(jc.train.loss_norm))
        runs[dtype] = jax.jit(build_train_step(model, optimizer, jc))(
            state, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(1), points)
    return batch, params, ema, runs


def test_bf16_step_matches_build_train_step(synth, tmp_path, jax_steps):  # noqa: F811
    batch, params, ema, runs = jax_steps
    _, tc = _step_cfgs(synth, str(tmp_path / "exp"), "bfloat16")
    trainer = Trainer(tc, device="cpu")
    assert trainer.model.compute_dtype == torch.bfloat16
    load_params(trainer.model, params)
    load_params(trainer.ema, ema)
    got_m = trainer.train_step({k: torch.from_numpy(v) for k, v in batch.items()})
    assert trainer.step == 1 and trainer.optimizer.schedule(0) == 0.0

    (new16, m16), (new32, m32) = runs["bfloat16"], runs["float32"]
    for k in ("cls", "reg", "total", "norm"):
        floor_rule(float(got_m[k]), float(m16[k]), float(m32[k]), k)
    assert float(got_m["total"]) != float(m32["total"])      # bf16 did compute
    assert trainer.loss_norm.dtype == torch.float32
    floor_rule(float(trainer.loss_norm), float(new16.loss_norm),
               float(new32.loss_norm), "loss_norm")

    named = dict(trainer.model.named_parameters())
    assert all(p.dtype == torch.float32 for p in named.values())
    # lr 0: the weights stay; the EMA moves towards them by f32 arithmetic
    got_p = flat_port(named)
    for path, want in flat_jax(new16.params).items():
        np.testing.assert_array_equal(got_p[path], want, err_msg=str(path))
    got_e = flat_port(dict(trainer.ema.named_parameters()))
    for path, want in flat_jax(new16.ema_params).items():
        np.testing.assert_allclose(got_e[path], want, rtol=1e-6, atol=1e-7,
                                   err_msg=str(path))
    # AdamW's first moment after one step: (1 - b1) * the clipped gradient
    moments = trainer.optimizer.state["mu"]
    assert all(m.dtype == torch.float32 for m in moments)
    assert all(v.dtype == torch.float32 for v in trainer.optimizer.state["nu"])
    got_mu = flat_port({n: m for n, m in zip(named, moments)})
    mu16 = flat_jax(new16.opt_state[1][0].mu)
    mu32 = flat_jax(new32.opt_state[1][0].mu)
    assert set(got_mu) == set(mu16)
    floor_rule(np.concatenate([got_mu[p].ravel() for p in mu16]),
               np.concatenate([mu16[p].ravel() for p in mu16]),
               np.concatenate([mu32[p].ravel() for p in mu16]), "all moments")
    # each leaf by the train phase's per-leaf relative-L2 bound; leaves at
    # f32 noise in the f32 step (the attention key biases, whose exact
    # gradient is 0) are skipped, as tests/test_grouped_eval.py skips them
    for path, want in mu16.items():
        if np.abs(mu32[path]).max() > 1e-8:
            rel = np.linalg.norm(got_mu[path] - want) / np.linalg.norm(want)
            assert rel <= REL_L2_LEAF, (path, rel)


def _bf16_forward(model, inputs):
    with torch.no_grad():
        out = model.eval()(*inputs, queries_per_video=REMAT_Q)
    return [o.float() for group in out[:3] for o in group]


def test_bf16_operand_caches_rebuilt_after_step_and_load(synth, tmp_path):  # noqa: F811
    """A bf16 no-grad forward fills the per-weight caches; after an
    optimizer step (lr > 0) and after ``load_state_dict`` the next forward
    equals a fresh model's on the same weights, every cached cast equals
    the weight's cast, and conv3's bf16 fragments are those of the new
    weight."""
    _, tc = _step_cfgs(synth, str(tmp_path / "exp"), "bfloat16", warmup_epochs=0)
    trainer = Trainer(tc, device="cpu")
    model = trainer.model
    conv_w = model.cls_head.convs[0].conv.weight
    inputs = remat_inputs()          # the same widths (24, 20) and T = 64

    def fresh(state):
        m = make_model(tc)
        m.load_state_dict(state)
        return m

    def check(what):
        got = _bf16_forward(model, inputs)
        want = _bf16_forward(fresh(model.state_dict()), inputs)
        for a, b in zip(got, want, strict=True):
            assert torch.equal(a, b), what
        with torch.no_grad():
            for name, p in model.named_parameters():
                assert torch.equal(cast(p, torch.bfloat16), p.to(torch.bfloat16)), (what, name)
            assert torch.equal(fused_conv.conv3_bf16_operands(conv_w),
                               fused_conv.conv3_bf16_fragments(conv_w)), what
        model.train()

    _bf16_forward(model, inputs)                 # fill the caches
    stale = fused_conv.conv3_bf16_operands(conv_w)
    before = conv_w.detach().clone()
    batch = trainer.loader.transform([trainer.dataset[i] for i in range(2)])
    trainer.train_step({k: torch.from_numpy(v) for k, v in batch.items()})
    assert not torch.equal(conv_w.detach(), before)
    assert not torch.equal(fused_conv.conv3_bf16_operands(conv_w), stale)
    check("after an optimizer step")
    other = make_model(tc)
    other.load_state_dict({k: v + 0.01 for k, v in model.state_dict().items()})
    model.load_state_dict(other.state_dict())
    check("after load_state_dict")


def _remat_step(policy):
    cfg = remat_cfg(policy)
    cfg.tpu.compute_dtype = "bfloat16"
    from decafnet_tpu_torch.models import init_random

    model = init_random(make_model(cfg), 3).train()
    assert model.compute_dtype == torch.bfloat16
    assert model.vid_net.remat == (policy is not None)
    out = model(*remat_inputs(), queries_per_video=REMAT_Q,
                generator=torch.Generator().manual_seed(5))
    w = torch.Generator().manual_seed(1)
    loss = sum((o.float() * torch.randn(o.shape, generator=w)).sum()
               for group in out[:3] for o in group)
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone() for n, p in model.named_parameters()}


@functools.lru_cache(maxsize=None)
def _unwrapped_bf16():
    return _remat_step(None)


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_bf16_remat_matches_unwrapped(policy):
    loss, grads = _remat_step(policy)
    want_loss, want = _unwrapped_bf16()
    assert abs(loss - want_loss) <= 1e-6 * abs(want_loss), (loss, want_loss)
    assert grads.keys() == want.keys()
    assert all(g.dtype == torch.float32 for g in grads.values())
    num = sum(float((grads[n] - g).square().sum()) for n, g in want.items())
    den = sum(float(g.square().sum()) for g in want.values())
    assert den > 0 and (num / den) ** 0.5 <= REL_L2_ALL, (num / den) ** 0.5
    for n, g in want.items():
        if max(float(grads[n].abs().max()), float(g.abs().max())) > 1e-8:
            rel = float((grads[n] - g).norm() / g.norm())
            assert rel <= REL_L2_LEAF, (n, rel)


def test_bf16_train_cli_trains_and_evaluates_in_bf16(synth, tmp_path):  # noqa: F811
    cfg_file = write_cfg(tmp_path / "small.yaml", synth)
    trainer = train_main(["--cfg", cfg_file, "--set", "log.root",
                          str(tmp_path / "log"), "aux.dryrun", "True",
                          "aux.eval_run", "1", "seed", "5",
                          "tpu.compute_dtype", "bfloat16", "--device", "cpu"])
    logdir = trainer.cfg.aux.logdir
    for rel in ("opt.yaml", "finished", "models/last.pth", "states/last.pt"):
        assert os.path.exists(os.path.join(logdir, rel)), rel
    assert trainer.model.compute_dtype == torch.bfloat16
    assert trainer.evaluator.model.compute_dtype == torch.bfloat16
    assert os.path.exists(os.path.join(logdir, "eval_1_1.txt"))
    blob = torch.load(os.path.join(logdir, "models", "last.pth"), weights_only=True)
    for part in ("model", "model_ema"):
        assert all(v.dtype == torch.float32 and torch.isfinite(v).all()
                   for v in blob[part].values()), part
    state = torch.load(os.path.join(logdir, "states", "last.pt"), weights_only=True)
    assert state["loss_norm"].dtype == torch.float32
    assert all(torch.isfinite(m).all() for m in state["optimizer"]["mu"])
