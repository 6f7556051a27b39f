"""Sequence-parallel training of the port (``tpu.shard_time: true``) over
two gloo ranks on the CPU: every rank loads the global batch, keeps its
block of each video's time axis and exchanges halos; held against

* the port's one-process step on the same batch and weights, with dropout
  ON (every dropout, the TCN's and the channel dropout included, drawn from
  one seed at the global shape) and remat ``nothing``, two microbatches,
  SGD: the metrics at rtol 1e-5, the summed gradients and the update of the
  weights and the EMA at relative L2 1e-5 over all leaves;
* the JAX ``build_train_step`` fed by ``shard_batch(..., axis="time")`` on
  a 2-device CPU mesh, dropout off, AdamW in warmup (lr 0), as
  tests/test_torch_ddp_step.py holds the data-parallel step: metrics, loss
  norm, weights, EMA and AdamW's first moment at 1e-4;
* the port's one-process bf16 step (dropout off, SGD): the gradients within
  half the bf16-vs-f32 distance of the same one-process step (the bf16
  noise floor), the metrics within 1e-2 relative.

A non-lead rank writes no checkpoint. Helpers come from
tests/test_torch_ddp.py and tests/test_torch_train.py."""

import json
import sys
import textwrap

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
from decafnet_tpu_torch.models import load_pth, make_model, save_pth
from decafnet_tpu_torch.train import Trainer
from test_torch_ddp import finish, spawn, synth  # noqa: F401 (a fixture)
from test_torch_train import (_flax_params, assert_grads_close, cfg_pair,
                              flat_jax, flat_port, jax_points)

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)

WORKER = textwrap.dedent("""
    import os, sys

    import numpy as np
    import torch

    from decafnet_tpu_torch import parallel
    from decafnet_tpu_torch.core import CfgNode
    from decafnet_tpu_torch.models import load_pth
    from decafnet_tpu_torch.train import Trainer

    torch.set_num_threads(1)
    out_dir = sys.argv[1]
    assert parallel.init_distributed("gloo")
    rank = parallel.rank()
    batch = {k: torch.from_numpy(v)
             for k, v in np.load(os.path.join(out_dir, "batch.npz")).items()}

    for name in sys.argv[2].split(","):
        cfg = CfgNode.load_file(os.path.join(out_dir, name + ".yaml"))
        cfg.aux.logdir = os.path.join(out_dir, name + f"_r{rank}")
        trainer = Trainer(cfg, device="cpu")
        assert trainer.shard is not None and trainer.ddp is None
        load_pth(trainer.model, os.path.join(out_dir, "init.pth"), "model")
        load_pth(trainer.ema, os.path.join(out_dir, "init.pth"), "model_ema")
        trainer.model.train()
        metrics = trainer.accumulate(dict(batch))
        grads = {n: p.grad.clone() for n, p in trainer.model.named_parameters()}
        trainer.update(metrics)
        trainer.checkpoint()
        torch.save({"grads": grads, "model": trainer.model.state_dict(),
                    "ema": trainer.ema.state_dict(),
                    "mu": trainer.optimizer.state.get("mu"),
                    "loss_norm": float(trainer.loss_norm),
                    "metrics": {k: float(v) for k, v in metrics.items()},
                    "wrote": os.path.exists(trainer.cfg.aux.logdir)},
                   os.path.join(out_dir, f"{name}.r{rank}.pt"))
    parallel.barrier()
    parallel.destroy()
""")

DROPOUTS = {"cdrop": 0.1, "attn_pdrop": 0.1, "proj_pdrop": 0.1,
            "path_pdrop": 0.1}
CASES = ("dropout", "jax", "bf16")


def case_cfgs(synth):  # noqa: F811
    """The three configs (JAX's twin of "jax" too), all with
    ``tpu.shard_time``: "dropout" (every dropout on, remat "nothing", two
    microbatches, SGD), "jax" (dropout off, AdamW in warmup) and "bf16"
    (dropout off, SGD, bf16)."""
    jc, tc = cfg_pair(synth, "", msf=True)
    for c in (jc, tc):
        c.train.warmup_epochs = 2
    cfgs = {"jax": tc}
    for name in ("dropout", "bf16"):
        _, c = cfg_pair(synth, "", msf=True)
        c.optimizer.update(name="sgd", lr=1e-2, momentum=0.9)
        # no warmup: a first step that moves the weights
        c.train.warmup_epochs = c.scheduler.warmup_epochs = 0
        cfgs[name] = c
    d = cfgs["dropout"]
    d.model.tcn_dropout = 0.5
    for key in ("vid_net", "fusion", "text_net"):
        d.model[key].update({k: v for k, v in DROPOUTS.items()
                             if k != "cdrop" or key == "vid_net"})
    d.train.microbatch_size = 1
    d.tpu.update(remat=True, remat_policy="nothing")
    cfgs["bf16"].tpu.compute_dtype = "bfloat16"
    for c in cfgs.values():
        c.tpu.shard_time = True
    return jc, cfgs


@pytest.fixture(scope="module")
def runs(synth, tmp_path_factory):  # noqa: F811
    """The two ranks' results of every case on one global batch of 2
    videos x 2 queries, from the same flax weights and EMA."""
    root = tmp_path_factory.mktemp("seq_train")
    jc, cfgs = case_cfgs(synth)
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


def one_process(root, cfg, batch, tag):
    """The same step in this process (no group: unsharded)."""
    cfg = cfg.clone()
    cfg.aux.logdir = str(root / tag)
    trainer = Trainer(cfg, device="cpu")
    assert trainer.shard is None
    load_pth(trainer.model, str(root / "init.pth"), "model")
    load_pth(trainer.ema, str(root / "init.pth"), "model_ema")
    trainer.model.train()
    start = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    start_ema = {k: v.clone() for k, v in trainer.ema.state_dict().items()}
    metrics = trainer.accumulate({k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    grads = {n: p.grad.clone() for n, p in trainer.model.named_parameters()}
    trainer.update(metrics)
    return {"grads": grads, "model": trainer.model.state_dict(),
            "ema": trainer.ema.state_dict(), "start": start,
            "start_ema": start_ema,
            "metrics": {k: float(v) for k, v in metrics.items()}}


def rel_l2(got, want, start=None):
    """Relative L2 distance over all leaves, in f64 (of the updates from
    ``start`` when given)."""
    num = den = 0.0
    for k, b in want.items():
        a, b = got[k].double(), b.double()
        if start is not None:
            a, b = a - start[k].double(), b - start[k].double()
        num += float((a - b).square().sum())
        den += float(b.square().sum())
    return (num / max(den, 1e-300)) ** 0.5


def test_two_rank_step_matches_one_process_with_dropout(runs):
    root, _, cfgs, batch, _, _, got = runs
    want = one_process(root, cfgs["dropout"], batch, "one_dropout")
    for r in got["dropout"]:
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(r["metrics"][k], v, rtol=1e-5, err_msg=k)
        assert rel_l2(r["grads"], want["grads"]) <= 1e-5
        for what, start in (("model", "start"), ("ema", "start_ema")):
            moved = rel_l2(want[what], want[start])
            assert 0 < moved and rel_l2(r[what], want[what], want[start]) <= 1e-5
    # dropout was on: the step differs from a dropout-free one
    plain = cfgs["dropout"].clone()
    plain.model.tcn_dropout = 0.0
    for key in ("vid_net", "fusion", "text_net"):
        plain.model[key].update({k: 0.0 for k in DROPOUTS
                                 if k != "cdrop" or key == "vid_net"})
    assert rel_l2(one_process(root, plain, batch, "one_plain")["grads"],
                  want["grads"]) > 1e-2
    # the lead alone writes
    assert got["dropout"][0]["wrote"] and not got["dropout"][1]["wrote"]


def test_two_rank_step_matches_jax_time_sharded_step(runs):
    _, jc, _, batch, params, ema, got = runs
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
    names = [n for n, _ in make_model(runs[2]["jax"]).named_parameters()]
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
        # AdamW's first moment: (1 - b1) * the clipped summed gradient
        assert_grads_close(flat_port(dict(zip(names, r["mu"]))),
                           flat_jax(new.opt_state[1][0].mu))


def test_two_rank_bf16_step_matches_one_process_bf16(runs):
    root, _, cfgs, batch, _, _, got = runs
    want = one_process(root, cfgs["bf16"], batch, "one_bf16")
    f32 = cfgs["bf16"].clone()
    f32.tpu.compute_dtype = "float32"
    floor = rel_l2(one_process(root, f32, batch, "one_f32")["grads"],
                   want["grads"])
    assert floor > 1e-3        # bf16 did run
    for r in got["bf16"]:
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(r["metrics"][k], v, rtol=1e-2, err_msg=k)
        assert rel_l2(r["grads"], want["grads"]) <= 0.5 * floor
        assert rel_l2(r["model"], want["model"], want["start"]) <= 0.5 * floor
