"""Data x sequence parallelism of the port (``tpu.shard_time: true`` with
``tpu.mesh_shape: (2, 2)``) over four gloo ranks on the CPU: rank r loads
data block r // 2 of the global batch and keeps time block r % 2 of each of
its videos, exchanging halos inside its 2-rank time subgroup. One global
batch of 4 videos x 2 queries, from the same flax weights and EMA, held
against

* the JAX ``build_train_step`` fed by ``shard_batch(..., axis="data+time")``
  on a (2, 2) CPU mesh, dropout off, AdamW in warmup (lr 0), as
  tests/test_torch_seq_train.py holds the 1-D step: metrics, loss norm,
  weights, EMA and AdamW's first moment at 1e-4;
* the port's 2-rank DDP step on the same batch and weights, with every
  dropout on (each data index draws from data rank d's generator at the
  global time shape, as DDP's rank d draws), remat ``nothing``, two
  microbatches, SGD: the metrics at rtol 1e-5, the summed gradients and
  the update of the weights and the EMA at relative L2 1e-5;
* the port's one-process bf16 step (dropout off, SGD) by the bf16
  noise-floor rule of tests/test_torch_seq_train.py: gradients and update
  within half the bf16-vs-f32 distance, metrics within 1e-2 relative.

Ranks are spawned as tests/test_torch_ddp.py spawns them; the 4-rank mesh
run and the 2-rank DDP run start together."""

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
from decafnet_tpu_torch.core import CfgNode, get_cfg_defaults
from decafnet_tpu_torch.models import make_model, save_pth
from decafnet_tpu_torch.parallel import seq
from test_torch_ddp import finish, spawn, synth  # noqa: F401 (a fixture)
from test_torch_seq_train import case_cfgs, one_process, rel_l2
from test_torch_train import (_flax_params, assert_grads_close, flat_jax,
                              flat_port, jax_points)

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
    out_dir, kind = sys.argv[1:3]
    assert parallel.init_distributed("gloo")
    rank = parallel.rank()
    batch = dict(np.load(os.path.join(out_dir, "batch.npz")))

    for name in sys.argv[3].split(","):
        cfg = CfgNode.load_file(os.path.join(out_dir, name + ".yaml"))
        if kind == "ddp":
            cfg.tpu.update(shard_time=False, mesh_shape=None)
        cfg.aux.logdir = os.path.join(out_dir, f"{kind}_{name}_r{rank}")
        trainer = Trainer(cfg, device="cpu")
        d, n = trainer.data_rank, trainer.data_world
        shard = trainer.shard
        # this rank's data block, as the loader gives it
        block = {k: torch.from_numpy(v[d * len(v) // n:(d + 1) * len(v) // n])
                 for k, v in batch.items()}
        load_pth(trainer.model, os.path.join(out_dir, "init.pth"), "model")
        load_pth(trainer.ema, os.path.join(out_dir, "init.pth"), "model_ema")
        trainer.model.train()
        start = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        start_ema = {k: v.clone() for k, v in trainer.ema.state_dict().items()}
        metrics = trainer.accumulate(block)
        grads = {k: p.grad.clone() for k, p in trainer.model.named_parameters()}
        trainer.update(metrics)
        torch.save({"grads": grads, "model": trainer.model.state_dict(),
                    "ema": trainer.ema.state_dict(), "start": start,
                    "start_ema": start_ema,
                    "mu": trainer.optimizer.state.get("mu"),
                    "loss_norm": float(trainer.loss_norm),
                    "metrics": {k: float(v) for k, v in metrics.items()},
                    "place": [d, n] + ([shard.rank, shard.size] if shard
                                       else [])},
                   os.path.join(out_dir, f"{kind}_{name}.r{rank}.pt"))
    parallel.barrier()
    parallel.destroy()
""")

CASES = ("dropout", "jax", "bf16")


@pytest.fixture(scope="module")
def runs(synth, tmp_path_factory):  # noqa: F811
    """Every case over the (2, 2) mesh's four ranks and the dropout case
    over two DDP ranks, on one global batch of 4 videos x 2 queries."""
    root = tmp_path_factory.mktemp("seq_mesh")
    jc, cfgs = case_cfgs(synth)
    jc.train.batch_size = 4
    for c in cfgs.values():
        c.train.batch_size = 4
        c.tpu.mesh_shape = (2, 2)
    # two microbatches of one video per data index
    cfgs["dropout"].train.microbatch_size = 2
    for name, c in cfgs.items():
        c.dump_to_file(str(root / f"{name}.yaml"))
    ds = jax_make_dataset(jc, num_epochs=jc.train.epochs + jc.train.warmup_epochs,
                          is_training=True, rng=np.random.RandomState(jc.seed))
    batch = jax_batchify_train([ds[i] for i in range(4)], jc.data.max_vid_len,
                               jc.data.max_text_len, jc.data.max_num_text)
    np.savez(root / "batch.npz", **batch)
    params = _flax_params(True, False, False)
    rng = np.random.RandomState(4)
    ema = jax.tree.map(lambda p: (p + 0.1 * rng.randn(*p.shape))
                       .astype(np.float32), params)
    save_pth(str(root / "init.pth"), params, ema)
    (root / "worker.py").write_text(WORKER)
    worker = [sys.executable, str(root / "worker.py"), str(root)]
    mesh = spawn(worker + ["mesh", ",".join(CASES)], world=4)
    ddp = spawn(worker + ["ddp", "dropout"], world=2)
    for rc, out in finish(mesh) + finish(ddp):
        assert rc == 0, out[-4000:]
    got = {name: [torch.load(root / f"mesh_{name}.r{r}.pt", weights_only=True)
                  for r in range(4)] for name in CASES}
    got["ddp"] = [torch.load(root / f"ddp_dropout.r{r}.pt", weights_only=True)
                  for r in range(2)]
    return root, jc, cfgs, batch, params, ema, got


def one(root, cfg, batch, tag):
    """The same step in this process, on the whole global batch."""
    cfg = cfg.clone()
    cfg.tpu.mesh_shape = None
    return one_process(root, cfg, batch, tag)


def test_ranks_sit_on_the_mesh_as_jax_places_devices(runs):
    got = runs[-1]
    for name in CASES:
        # rank r at (r // 2, r % 2): data index, then its time subgroup's
        assert [r["place"] for r in got[name]] == [
            [0, 2, 0, 2], [0, 2, 1, 2], [1, 2, 0, 2], [1, 2, 1, 2]]
    assert [r["place"] for r in got["ddp"]] == [[0, 2], [1, 2]]


def test_mesh_step_matches_jax_data_time_step(runs):
    _, jc, cfgs, batch, params, ema, got = runs
    model = jax_make_model(jc)
    sched_cfg = dict(jc.scheduler, _base_lr=jc.optimizer.lr)
    optimizer = make_optimizer(params, jc.optimizer,
                               jax_make_schedule(sched_cfg, 2))
    state = TrainState(step=jnp.int32(0), params=params, ema_params=ema,
                       opt_state=optimizer.init(params),
                       loss_norm=jnp.float32(jc.train.loss_norm))
    mesh = make_mesh((2, 2))
    assert mesh.axis_names == ("data", "time")
    new, want_m = jax.jit(build_train_step(model, optimizer, jc))(
        state, shard_batch(batch, mesh, axis="data+time"),
        jax.random.PRNGKey(1), jnp.asarray(jax_points(jc, jc.data.max_vid_len)))
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
        # AdamW's first moment: (1 - b1) * the clipped summed gradient
        assert_grads_close(flat_port(dict(zip(names, r["mu"]))),
                           flat_jax(new.opt_state[1][0].mu))


def test_mesh_step_matches_two_rank_ddp_step_with_dropout(runs):
    got = runs[-1]
    want = got["ddp"][0]
    for r in got["dropout"]:
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(r["metrics"][k], v, rtol=1e-5, err_msg=k)
        assert rel_l2(r["grads"], want["grads"]) <= 1e-5
        for what, start in (("model", "start"), ("ema", "start_ema")):
            moved = rel_l2(want[what], want[start])
            assert 0 < moved and rel_l2(r[what], want[what], want[start]) <= 1e-5
    # dropout was on: the gradients differ from the dropout-free step's
    assert rel_l2(got["jax"][0]["grads"], want["grads"]) > 1e-2


def test_mesh_bf16_step_matches_one_process_bf16(runs):
    root, _, cfgs, batch, _, _, got = runs
    want = one(root, cfgs["bf16"], batch, "one_bf16")
    f32 = cfgs["bf16"].clone()
    f32.tpu.compute_dtype = "float32"
    floor = rel_l2(one(root, f32, batch, "one_f32")["grads"], want["grads"])
    assert floor > 1e-3        # bf16 did run
    for r in got["bf16"]:
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(r["metrics"][k], v, rtol=1e-2, err_msg=k)
        assert rel_l2(r["grads"], want["grads"]) <= 0.5 * floor
        assert rel_l2(r["model"], want["model"], want["start"]) <= 0.5 * floor


def test_cli_mesh_shape_parses_to_the_mesh(tmp_path):
    """``--set tpu.mesh_shape "[2, 2]"`` (and the opt.yaml it is written
    to) gives the Trainer's (n_data, n_time); a shape of another count, or
    of three axes, raises."""
    cfg = get_cfg_defaults("grounder")
    cfg.merge_from_list(["tpu.shard_time", "True", "tpu.mesh_shape", "[2, 2]"])
    cfg.dump_to_file(str(tmp_path / "opt.yaml"))
    for c in (cfg, CfgNode.load_file(str(tmp_path / "opt.yaml"))):
        assert seq.mesh_dims(c.tpu.mesh_shape, 4) == (2, 2)
    assert seq.mesh_dims(None, 4) == seq.mesh_dims([4], 4) == (1, 4)
    with pytest.raises(ValueError, match="names another count"):
        seq.mesh_dims(cfg.tpu.mesh_shape, 2)
    with pytest.raises(ValueError, match="at most two axes"):
        seq.mesh_dims((1, 2, 2), 4)
