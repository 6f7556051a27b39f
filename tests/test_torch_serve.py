"""The port's GroundingService (device='cpu') against
decafnet_tpu.serve.GroundingService on the same weights and requests: one
request per shape bucket, one longer than the base length (the 2x bucket and
the PE interpolation plans), and a ground_many batch that stacks same-bucket
videos. Detections must match: segments to 1e-3 s, scores to 1e-4. Also: the
default device is the CUDA card, and the port imports nothing of JAX."""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from decafnet_tpu.core import get_cfg_defaults as jax_defaults
from decafnet_tpu.core import update_eval_data
from decafnet_tpu.core import update_opt as jax_update_opt
from decafnet_tpu.models import make_model as jax_make_model
from decafnet_tpu.serve import GroundingService as JaxService
from decafnet_tpu_torch.core import get_cfg_defaults, update_opt
from decafnet_tpu_torch.models import make_model, params_from_state_dict
from decafnet_tpu_torch.models import load_params
from decafnet_tpu_torch.serve import GroundingService

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CV, CS, CT = 32, 32, 24


def _small(model):
    model.name = "iter"
    model.vid_net.in_dim = CV
    model.vid_net.embd_dim = 16
    model.vid_net.max_seq_len = 64
    model.vid_net.arch = (1, 0, 3)
    model.text_net.in_dim = CT
    model.text_net.embd_dim = 16
    model.text_net.n_layers = 1
    model.fusion.n_layers = 1
    model.sratio = 0.5
    model.sn = 8
    model.msf = True


@pytest.fixture(scope="module")
def services():
    jcfg = jax_defaults("grounder")
    _small(jcfg.model)
    update_eval_data(jax_update_opt(jcfg))
    tcfg = get_cfg_defaults()
    _small(tcfg.model)
    update_opt(tcfg)

    V, T, L = 2, 64, 8
    rng = np.random.RandomState(0)
    # one compiled init: eager init compiles every primitive on its own
    init = jax.jit(functools.partial(jax_make_model(jcfg).init, deterministic=True))
    params = init(
        jax.random.PRNGKey(0), rng.randn(V, CV, T).astype(np.float32),
        rng.randn(V, CS, T).astype(np.float32), np.ones((V, T), bool),
        rng.randn(V, CT, L).astype(np.float32),
        rng.randn(V, CS).astype(np.float32), np.ones((V, L), bool))["params"]
    params = jax.tree.map(np.asarray, params)
    return (JaxService(jcfg, params=params),
            GroundingService(tcfg, params=params, device="cpu"), tcfg, params)


def _request(t, q, seed):
    rng = np.random.RandomState(seed)
    return dict(vid=rng.randn(CV, t).astype(np.float32),
                shallow_vid=rng.randn(CS, t).astype(np.float32),
                texts=[rng.randn(CT, int(n)).astype(np.float32)
                       for n in rng.randint(3, 9, q)],
                text_cls=rng.randn(q, CS).astype(np.float32),
                fps=30.0, clip_size=32, clip_stride=16)


REQUESTS = [(40, 3, 1), (64, 2, 2), (100, 3, 3), (57, 3, 4)]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g["scores"]) == len(w["scores"])
        np.testing.assert_allclose(
            np.asarray(g["segments"], np.float32).reshape(-1, 2),
            np.asarray(w["segments"], np.float32).reshape(-1, 2), atol=1e-3)
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-4)


@pytest.mark.parametrize("t,q,seed", REQUESTS)
def test_ground_matches_jax_service(services, t, q, seed):
    jax_svc, svc, _, _ = services
    req = _request(t, q, seed)
    got = svc.ground(**req)
    _assert_same(got, jax_svc.ground(**req))
    assert any(len(r["scores"]) for r in got)


def test_ground_many_matches_jax_and_ground(services):
    jax_svc, svc, _, _ = services
    reqs = [_request(*r) for r in REQUESTS]
    calls = svc.decoder.decode_calls
    got = svc.ground_many(reqs)
    # the 40- and 57-clip videos share a bucket and decode as one stack
    assert svc.decoder.decode_calls - calls == 3
    for g, w in zip(got, jax_svc.ground_many(reqs)):
        _assert_same(g, w)
    for g, r in zip(got, reqs):
        _assert_same(g, svc.ground(**r))


def test_checkpoint_pth_loads_like_params(services, tmp_path):
    _, svc, cfg, params = services
    model = load_params(make_model(cfg), params)
    path = str(tmp_path / "ckpt.pth")
    torch.save({"model": {}, "model_ema": model.state_dict()}, path)
    from_pth = GroundingService(cfg, checkpoint=path, device="cpu")
    back = params_from_state_dict(from_pth.model.state_dict())
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    req = _request(*REQUESTS[0])
    _assert_same(from_pth.ground(**req), svc.ground(**req))
    assert set(from_pth.stats()) >= {"prepare", "forward", "post_process"}


def test_warmup_decodes_one_bucket(services):
    _, svc, _, _ = services
    calls = svc.decoder.decode_calls
    svc.warmup(40, num_queries=2)
    assert svc.decoder.decode_calls - calls == 1


def test_default_device_needs_cuda(services, monkeypatch):
    _, _, cfg, params = services
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GroundingService(cfg, params=params)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import decafnet_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'decafnet_tpu')]\n"
        "assert not bad, bad\n"
        "walked = [m for m in ('data.dataset', 'data.loader', 'eval.__main__', "
        "'train.losses', 'train.optim', 'train.trainer', 'train.__main__', "
        "'utils.analysis', 'utils.tracking', 'serve', 'encode.pipeline', "
        "'encode.__main__', 'parallel', 'parallel.dist', 'parallel.seq') "
        "if 'decafnet_tpu_torch.' + m not in sys.modules]\n"
        "assert not walked, walked\n"
        "print('ok', len([k for k in sys.modules "
        "if k.startswith('decafnet_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    # importing the CLIs' modules runs neither CLI
    assert out.stdout.startswith("ok"), out.stdout
    assert int(out.stdout.split()[1]) >= 30


@pytest.mark.parametrize("first", ["utils", "utils.analysis", "eval.metrics",
                                   "train", "encode", "parallel.seq"])
def test_port_module_imports_first_in_a_fresh_process(first):
    # no import cycle depends on which module of the port comes first
    out = subprocess.run([sys.executable, "-c",
                          f"import decafnet_tpu_torch.{first}"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
