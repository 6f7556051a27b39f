"""Activation checkpointing of the port's video encoders (``tpu.remat``,
policies "nothing" and "dots") on the CPU: in training, with dropout and
stochastic depth drawing from an explicit ``torch.Generator``, the loss and
every gradient equal the unwrapped model's (rtol 1e-6) and the generator
ends in the unwrapped run's state. The same check fails when the recompute
is not fed a replay of the generator (it then draws fresh masks), so the
check sees the hazard. Eval mode and no-grad forwards are not wrapped. The
Trainer takes ``tpu.remat`` for one step, writes its checkpoint, and logs
the losses of the unwrapped Trainer."""

import contextlib
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from decafnet_tpu_torch.core import get_cfg_defaults, update_opt
from decafnet_tpu_torch.models import init_random, make_model
from decafnet_tpu_torch.models import video_net
from decafnet_tpu_torch.train import Trainer
from test_torch_trainer import metrics_records, small_cfgs, synth  # noqa: F401

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)

POLICIES = ("nothing", "dots")
V, Q, T = 2, 2, 64


def _cfg(policy=None):
    """A small config with every dropout of the encoders on; ``policy``
    None leaves remat off. arch (2, 1, 3): one stem and three branch
    encoders are wrapped."""
    cfg = get_cfg_defaults("grounder")
    m = cfg.model
    m.name = "iter"
    m.msf, m.sratio, m.sn = True, 0.5, 8
    m.vid_net.update(in_dim=24, embd_dim=16, max_seq_len=T, arch=(2, 1, 3),
                     attn_pdrop=0.1, proj_pdrop=0.2, path_pdrop=0.2)
    m.text_net.update(in_dim=20, embd_dim=16, n_layers=1)
    m.fusion.n_layers = 1
    cfg.tpu.remat = policy is not None
    cfg.tpu.remat_policy = policy or "nothing"
    return update_opt(cfg)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    vm = np.zeros((V, T), bool)
    vm[0, :], vm[1, :41] = True, True
    tm = np.ones((V * Q, 8), bool)
    tm[-1, 5:] = False
    arrays = (rng.randn(V, 24, T), rng.randn(V, 24, T), vm,
              rng.randn(V * Q, 20, 8), rng.randn(V * Q, 24), tm)
    return [torch.from_numpy(a.astype(np.float32) if a.dtype != bool else a)
            for a in arrays]


class _CountOps(TorchDispatchMode):
    """Counts the aten ops that reach it by overload packet."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        key = func.overloadpacket
        self.counts[key] = self.counts.get(key, 0) + 1
        return func(*args, **(kwargs or {}))


def _step(policy, gen_seed=5, backward_ops=None):
    """One training forward and backward: (loss, {name: grad}, the
    generator's state after it). ``backward_ops``: a :class:`_CountOps`
    to watch the backward with."""
    model = init_random(make_model(_cfg(policy)), 3).train()
    assert model.vid_net.remat == (policy is not None)
    generator = torch.Generator().manual_seed(gen_seed)
    out = model(*_inputs(), queries_per_video=Q, generator=generator)
    w = torch.Generator().manual_seed(1)
    loss = sum((o * torch.randn(o.shape, generator=w)).sum()
               for group in out[:3] for o in group)
    with backward_ops or contextlib.nullcontext():
        loss.backward()
    return (float(loss.detach()),
            {n: p.grad.clone() for n, p in model.named_parameters()},
            generator.get_state())


@pytest.fixture(scope="module")
def unwrapped():
    return _step(None)


def check_equal(policy, unwrapped):
    loss, grads, state = _step(policy)
    want_loss, want_grads, want_state = unwrapped
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    assert grads.keys() == want_grads.keys()
    for name, g in grads.items():
        torch.testing.assert_close(g, want_grads[name], rtol=1e-6, atol=0,
                                   msg=name)
    assert torch.equal(state, want_state)


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_gradients_equal_the_unwrapped_model(policy, unwrapped):
    check_equal(policy, unwrapped)


@pytest.mark.parametrize("policy", POLICIES)
def test_the_check_sees_a_recompute_without_the_replay(policy, unwrapped,
                                                       monkeypatch):
    """Feed the recompute the main generator itself, as
    ``preserve_rng_state`` alone would leave it: the recompute draws other
    masks and advances the generator, and the check above fails."""
    monkeypatch.setattr(video_net, "replay_generator", lambda g, state: g)
    with pytest.raises(AssertionError):
        check_equal(policy, unwrapped)


def test_policies_recompute_what_they_say():
    """Against the backward of an unwrapped step (whose forward
    convolutions are the kernel ops' recomputes through their plain
    versions), "nothing" recomputes the encoders' convolutions too, and
    draws their dropout masks again; "dots" reads the saved convolution
    outputs and recomputes the rest, the masks among them."""
    conv, rand = torch.ops.aten.convolution, torch.ops.aten.rand
    seen = {}
    for policy in (None,) + POLICIES:
        mode = _CountOps()
        _step(policy, backward_ops=mode)
        seen[policy] = (mode.counts.get(conv, 0), mode.counts.get(rand, 0))
    assert seen[None][1] == 0, seen
    assert seen["nothing"][0] > seen[None][0] and seen["nothing"][1] > 0, seen
    assert seen["dots"][0] == seen[None][0] and seen["dots"][1] > 0, seen


def test_dropout_draws_are_live(unwrapped):
    """Another generator seed gives another loss: the encoders' dropouts
    draw from the generator in this setting."""
    assert _step(None, gen_seed=6)[0] != unwrapped[0]


@pytest.mark.parametrize("policy", POLICIES)
def test_eval_and_no_grad_forwards_are_not_wrapped(policy, monkeypatch):
    calls = []
    monkeypatch.setattr(video_net, "checkpointed",
                        lambda *a, **k: calls.append(a))
    model = init_random(make_model(_cfg(policy)), 3)
    plain = init_random(make_model(_cfg(None)), 3)
    with torch.no_grad():
        a = model.eval()(*_inputs(), queries_per_video=Q)
        b = plain.eval()(*_inputs(), queries_per_video=Q)
        model.train()(*_inputs(), queries_per_video=Q,
                      generator=torch.Generator().manual_seed(0))
    assert not calls
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert torch.equal(x, y)


def test_unknown_policy_raises():
    cfg = _cfg("nothing")
    cfg.tpu.remat_policy = "everything"
    with pytest.raises(ValueError, match="remat_policy"):
        make_model(cfg)


def test_trainer_steps_with_remat(synth, tmp_path):  # noqa: F811
    """One dryrun step with ``tpu.remat`` (policy "dots") writes the
    checkpoint, and logs the losses and saves the weights of the same step
    without remat, dropout on."""
    runs = {}
    for name, remat in (("remat", True), ("plain", False)):
        _, tc = small_cfgs(synth, str(tmp_path / name))
        tc.tpu.remat, tc.tpu.remat_policy = remat, "dots"
        tc.model.vid_net.proj_pdrop = tc.model.vid_net.path_pdrop = 0.1
        trainer = Trainer(tc, device="cpu")
        assert trainer.model.vid_net.remat == remat
        trainer.run()
        assert trainer.step == 1
        for rel in ("models/last.pth", "states/last.pt"):
            assert os.path.exists(os.path.join(tc.aux.logdir, rel)), rel
        runs[name] = (metrics_records(tc.aux.logdir),
                      torch.load(os.path.join(tc.aux.logdir, "models",
                                              "last.pth"), weights_only=True))
    (got, got_ckpt), (want, want_ckpt) = runs["remat"], runs["plain"]
    for k in ("train/cls", "train/reg", "train/total"):
        assert np.isfinite(got[0][k])
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-6, err_msg=k)
    for k, v in want_ckpt["model"].items():
        torch.testing.assert_close(got_ckpt["model"][k], v, rtol=1e-6,
                                   atol=1e-9, msg=k)
