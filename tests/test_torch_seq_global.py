"""Sequence-parallel training of the port with global video self-attention
(``vid_net.mha_win_size -1``, ``tpu.shard_time: true``) over two gloo ranks
on the CPU: every attention of the video net gathers the keys, values and
key mask of both ranks (``nn.blocks.MaskedMHA``) and keeps its own queries.
Held against

* the port's one-process step of the same global-window model on the same
  batch and weights, with every dropout on (the attention dropout too,
  drawn at the global shape from one seed), remat ``nothing`` and two
  microbatches, SGD: the metrics at rtol 1e-5, the summed gradients and
  the update of the weights and the EMA at relative L2 1e-5;
* the JAX ``build_train_step`` of the same global-window model fed by
  ``shard_batch(..., axis="time")`` on a 2-device CPU mesh (XLA's SPMD
  partitioner gathers the keys), dropout off, AdamW in warmup: metrics,
  loss norm, weights, EMA and AdamW's first moment at 1e-4.

The worker, the configs and the one-process step come from
tests/test_torch_seq_train.py."""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from decafnet_tpu.data import batchify_train as jax_batchify_train
from decafnet_tpu.data import make_dataset as jax_make_dataset
from decafnet_tpu.models import make_model as jax_make_model
from decafnet_tpu.parallel import make_mesh
from decafnet_tpu.parallel.mesh import shard_batch
from decafnet_tpu.train import TrainState, build_train_step, make_optimizer
from decafnet_tpu.train import make_schedule as jax_make_schedule
from decafnet_tpu_torch.models import make_model, save_pth
from test_torch_ddp import finish, spawn, synth  # noqa: F401 (a fixture)
from test_torch_seq_train import WORKER, case_cfgs, one_process, rel_l2
from test_torch_train import (_flax_params, assert_grads_close, flat_jax,
                              flat_port, jax_points)

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)

CASES = ("dropout", "jax")


@pytest.fixture(scope="module")
def runs(synth, tmp_path_factory):  # noqa: F811
    """The two ranks' results of both cases on one global batch of 2
    videos x 2 queries, from the same flax weights and EMA."""
    root = tmp_path_factory.mktemp("seq_global")
    jc, cfgs = case_cfgs(synth)
    cfgs = {name: cfgs[name] for name in CASES}
    for c in (jc, *cfgs.values()):
        c.model.vid_net.mha_win_size = -1
    assert cfgs["dropout"].model.vid_net.attn_pdrop > 0
    for name, c in cfgs.items():
        c.dump_to_file(str(root / f"{name}.yaml"))
    ds = jax_make_dataset(jc, num_epochs=jc.train.epochs + jc.train.warmup_epochs,
                          is_training=True, rng=np.random.RandomState(jc.seed))
    batch = jax_batchify_train([ds[i] for i in range(2)], jc.data.max_vid_len,
                               jc.data.max_text_len, jc.data.max_num_text)
    np.savez(root / "batch.npz", **batch)
    params = _flax_params(True, False, False)
    rng = np.random.RandomState(4)
    ema = jax.tree.map(lambda p: (p + 0.1 * rng.randn(*p.shape))
                       .astype(np.float32), params)
    save_pth(str(root / "init.pth"), params, ema)
    (root / "worker.py").write_text(WORKER)
    outs = finish(spawn([sys.executable, str(root / "worker.py"), str(root),
                         ",".join(CASES)]))
    for rc, out in outs:
        assert rc == 0, out[-4000:]
    got = {name: [torch.load(root / f"{name}.r{r}.pt", weights_only=True)
                  for r in (0, 1)] for name in CASES}
    return root, jc, cfgs, batch, params, ema, got


def test_global_attention_step_matches_one_process_with_dropout(runs):
    root, _, cfgs, batch, _, _, got = runs
    want = one_process(root, cfgs["dropout"], batch, "one_dropout")
    for r in got["dropout"]:
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(r["metrics"][k], v, rtol=1e-5, err_msg=k)
        assert rel_l2(r["grads"], want["grads"]) <= 1e-5
        for what, start in (("model", "start"), ("ema", "start_ema")):
            moved = rel_l2(want[what], want[start])
            assert 0 < moved and rel_l2(r[what], want[what], want[start]) <= 1e-5
    # the attention dropout was on: the step differs from one without it
    plain = cfgs["dropout"].clone()
    plain.model.vid_net.attn_pdrop = 0.0
    assert rel_l2(one_process(root, plain, batch, "one_plain")["grads"],
                  want["grads"]) > 1e-3
    # the window-5 model is another function
    banded = cfgs["dropout"].clone()
    banded.model.vid_net.mha_win_size = 5
    assert rel_l2(one_process(root, banded, batch, "one_banded")["grads"],
                  want["grads"]) > 1e-2


def test_global_attention_step_matches_jax_time_sharded_step(runs):
    _, jc, cfgs, batch, params, ema, got = runs
    model = jax_make_model(jc)
    sched_cfg = dict(jc.scheduler, _base_lr=jc.optimizer.lr)
    optimizer = make_optimizer(params, jc.optimizer,
                               jax_make_schedule(sched_cfg, 2))
    state = TrainState(step=jnp.int32(0), params=params, ema_params=ema,
                       opt_state=optimizer.init(params),
                       loss_norm=jnp.float32(jc.train.loss_norm))
    mesh = make_mesh(devices=jax.devices()[:2])
    new, want_m = jax.jit(build_train_step(model, optimizer, jc))(
        state, shard_batch(batch, mesh, axis="time"), jax.random.PRNGKey(1),
        jnp.asarray(jax_points(jc, jc.data.max_vid_len)))
    names = [n for n, _ in make_model(cfgs["jax"]).named_parameters()]
    for r in got["jax"]:
        for k in ("cls", "reg", "total", "norm"):
            np.testing.assert_allclose(r["metrics"][k], float(want_m[k]),
                                       rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(r["loss_norm"], float(new.loss_norm),
                                   rtol=1e-4)
        for name, tree in (("model", new.params), ("ema", new.ema_params)):
            have = flat_port(r[name])
            for path, want in flat_jax(tree).items():
                np.testing.assert_allclose(
                    have[path], want, rtol=1e-4,
                    atol=1e-4 * max(np.abs(want).max(), 1e-3),
                    err_msg=str(path))
        assert_grads_close(flat_port(dict(zip(names, r["mu"]))),
                           flat_jax(new.opt_state[1][0].mu))
