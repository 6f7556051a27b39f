"""Data-parallel training of the port in two gloo worker ranks on the CPU,
dropout off, on one global batch of 4 videos (one microbatch of 2 per
rank) from the same flax weights:

* the gradients DDP leaves in ``.grad`` are the sums over the ranks: equal
  to the one-process ``.grad`` of the global batch (a mean would halve
  them), the metrics too;
* one step equals the JAX ``build_train_step`` on the global batch
  (metrics, loss norm, weights and EMA at 1e-4; AdamW's first moment as
  tests/test_torch_train_step.py holds it);
* a non-lead ``checkpoint()`` writes nothing;
* conv3's weight operand cache, built on rank 1 for its own weights, is
  rebuilt after DDP's broadcast of rank 0's at construction.

Helpers come from tests/test_torch_ddp.py."""

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
    import json, os, sys

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    from decafnet_tpu_torch import parallel
    from decafnet_tpu_torch.core import CfgNode
    from decafnet_tpu_torch.models import load_pth, make_model, init_random
    from decafnet_tpu_torch.ops.fused_conv import (conv3_weight_fragments,
                                                   conv3_weight_operands,
                                                   tf32_split)
    from decafnet_tpu_torch.train import Trainer

    torch.set_num_threads(1)
    out_dir = sys.argv[1]
    assert parallel.init_distributed("gloo")
    rank, world = parallel.rank(), parallel.world_size()
    assert (rank, world, parallel.backend()) == (int(os.environ["RANK"]), 2,
                                                 "gloo")

    def load(name):
        cfg = CfgNode.load_file(os.path.join(out_dir, name + ".yaml"))
        cfg.aux.logdir = os.path.join(out_dir, name + f"_r{rank}")
        return cfg

    batch = dict(np.load(os.path.join(out_dir, "batch.npz")))
    lo, hi = parallel.host_batch_slice(len(batch["vid"]), rank, world)
    block = {k: torch.from_numpy(v[lo * len(v) // len(batch["vid"]):
                                   hi * len(v) // len(batch["vid"])])
             for k, v in batch.items()}

    # summed gradients of the global batch (one microbatch of 2 videos
    # per rank), from the flax weights the test saved
    trainer = Trainer(load("train"), device="cpu")
    load_pth(trainer.model, os.path.join(out_dir, "init.pth"), "model")
    metrics = trainer.accumulate(block)
    if rank == 0:
        torch.save({"grads": {n: p.grad for n, p in
                              trainer.model.named_parameters()},
                    "metrics": {k: float(v) for k, v in metrics.items()}},
                   os.path.join(out_dir, "grads.pt"))

    # one step from the flax weights and EMA (lr 0 in warmup)
    trainer = Trainer(load("train"), device="cpu")
    load_pth(trainer.model, os.path.join(out_dir, "init.pth"), "model")
    load_pth(trainer.ema, os.path.join(out_dir, "init.pth"), "model_ema")
    metrics = trainer.train_step(block)
    if rank == 0:
        torch.save({"model": trainer.model.state_dict(),
                    "ema": trainer.ema.state_dict(),
                    "mu": trainer.optimizer.state["mu"],
                    "loss_norm": float(trainer.loss_norm),
                    "metrics": {k: float(v) for k, v in metrics.items()}},
                   os.path.join(out_dir, "step.pt"))

    # only the lead writes a checkpoint (each rank its own log dir here)
    trainer.checkpoint()
    written = sorted(os.listdir(os.path.join(trainer.cfg.aux.logdir,
                                             "models"))) if rank == 0 else \\
        os.path.exists(trainer.cfg.aux.logdir)

    # conv3's operand cache on rank 1 was built for other weights; DDP's
    # broadcast at construction overwrites them with rank 0's in place
    model = init_random(make_model(load("train")), 3 + rank)
    w = model.vid_net.embd_convs[0].conv.weight
    stale = conv3_weight_operands(w)
    DistributedDataParallel(model)
    fresh = conv3_weight_operands(w)
    want = tf32_split(conv3_weight_fragments(w.detach()))
    rebuilt = all(torch.equal(a, b) for a, b in zip(fresh, want))
    moved = not all(torch.equal(a, b) for a, b in zip(stale, fresh))
    ref = init_random(make_model(load("train")), 3)
    print("WORKER::" + json.dumps({
        "rank": rank, "written": written, "rebuilt": rebuilt, "moved": moved,
        "broadcast": torch.equal(w, ref.vid_net.embd_convs[0].conv.weight)}),
        flush=True)
    parallel.barrier()
    parallel.destroy()
""")


@pytest.fixture(scope="module")
def worker_runs(synth, tmp_path_factory):
    """The worker ranks' results on one global batch of 4 videos and the
    same batch through one process and through the JAX step."""
    root = tmp_path_factory.mktemp("ddp_worker")
    jc, tc = cfg_pair(synth, "", msf=True)
    for c in (jc, tc):
        c.train.batch_size = 4
        c.train.warmup_epochs = 2
    tc.dump_to_file(str(root / "train.yaml"))

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

    outs = finish(spawn([sys.executable, str(root / "worker.py"), str(root)]))
    for rc, out in outs:
        assert rc == 0, out[-4000:]
    results = [json.loads(next(l for l in out.splitlines()
                               if l.startswith("WORKER::"))[8:])
               for _, out in outs]
    return root, jc, tc, batch, params, ema, results


def test_gradients_are_sums_over_ranks(worker_runs):
    root, _, tc, batch, _, _, _ = worker_runs
    tc.aux.logdir = str(root / "one")
    one = Trainer(tc, device="cpu")
    load_pth(one.model, str(root / "init.pth"), "model")
    want_m = one.accumulate({k: torch.from_numpy(v) for k, v in batch.items()})
    got = torch.load(root / "grads.pt", weights_only=True)
    for k, v in want_m.items():
        np.testing.assert_allclose(got["metrics"][k], float(v), rtol=1e-6,
                                   err_msg=k)
    scale = max(float(p.grad.abs().max()) for p in one.model.parameters())
    for n, p in one.model.named_parameters():
        np.testing.assert_allclose(got["grads"][n].numpy(), p.grad.numpy(),
                                   rtol=1e-5, atol=1e-6 * scale, err_msg=n)


def test_two_rank_step_matches_build_train_step(worker_runs):
    """The world-2 step against the JAX step on the same global batch."""
    root, jc, _, batch, params, ema, _ = worker_runs
    model = jax_make_model(jc)
    sched_cfg = dict(jc.scheduler, _base_lr=jc.optimizer.lr)
    optimizer = make_optimizer(params, jc.optimizer,
                               jax_make_schedule(sched_cfg, 2))
    state = TrainState(step=jnp.int32(0), params=params, ema_params=ema,
                       opt_state=optimizer.init(params),
                       loss_norm=jnp.float32(jc.train.loss_norm))
    new, want_m = jax.jit(build_train_step(model, optimizer, jc))(
        state, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(1), jnp.asarray(jax_points(jc, jc.data.max_vid_len)))

    got = torch.load(root / "step.pt", weights_only=True)
    for k in ("cls", "reg", "total", "norm"):
        np.testing.assert_allclose(got["metrics"][k], float(want_m[k]),
                                   rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["loss_norm"], float(new.loss_norm), rtol=1e-4)
    for name, tree in (("model", new.params), ("ema", new.ema_params)):
        have = flat_port(got[name])
        for path, want in flat_jax(tree).items():
            np.testing.assert_allclose(
                have[path], want, rtol=1e-4,
                atol=1e-4 * max(np.abs(want).max(), 1e-3), err_msg=str(path))
    # AdamW's first moment: (1 - b1) * the clipped summed gradient
    names = [n for n, _ in make_model(worker_runs[2]).named_parameters()]
    assert_grads_close(flat_port(dict(zip(names, got["mu"]))),
                       flat_jax(new.opt_state[1][0].mu))


def test_lead_writes_the_checkpoint_and_broadcast_reaches_the_cache(worker_runs):
    results = worker_runs[-1]
    assert [r["rank"] for r in results] == [0, 1]
    assert results[0]["written"] == ["0-0.pth", "last.pth"]
    assert results[1]["written"] is False       # rank 1 made no directory
    for r in results:
        assert r["broadcast"] and r["rebuilt"]
    assert results[1]["moved"] and not results[0]["moved"]


