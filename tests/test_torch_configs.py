"""The port against the JAX package under three shipped configurations that
the other port tests do not load: configs/charades.yaml (task ``charades``:
the ``mad`` defaults plus ``group_method: None``, a 5-level pyramid),
configs/tacos.yaml (6 levels, ``sn 30``, ``sratio 0.5``) and
configs/ego4d_goalstep.yaml (7 levels, ``train.microbatch_size 4``).

Each config is loaded by both packages from its file and its task, then cut
to test widths (embd 16, feature dims 32 / 24, one text and one fusion
layer) and a shorter ``max_seq_len``; the pyramid depth, the window, the
delegation keys ``sn`` and ``sratio``, ``msf`` and the task's own keys stay
as shipped. The same seeded random weights, a flax-layout tree of numpy arrays
(``models.random_params``), go into the JAX GroundingService and, carried
across by ``models.load_params``, into the port's (on the CPU).
Both ground the same seeded requests, of lengths below ``max_seq_len`` so
that padding and partial masks occur; the decoded detections (segments in
seconds, scores) agree at rtol 2e-4 / atol 2e-5, the full-model tolerance of
tests/test_grouped_eval.py."""

import os

import numpy as np
import pytest
import torch

from decafnet_tpu.core import get_cfg_defaults as jax_defaults
from decafnet_tpu.core import update_eval_data as jax_update_eval_data
from decafnet_tpu.core import update_opt as jax_update_opt
from decafnet_tpu.serve import GroundingService as JaxService
from decafnet_tpu_torch.core import (file_task, load_config, update_eval_data,
                                     update_opt)
from decafnet_tpu_torch.models import random_params
from decafnet_tpu_torch.serve import GroundingService

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CV, CT = 32, 24
RTOL, ATOL = 2e-4, 2e-5
# each config's shipped pyramid depth and delegation keys, and the test's
# max_seq_len: the shortest whose deepest level still has 4 columns
CONFIGS = {
    "charades": {"levels": 5, "sn": 10, "sratio": 0.5, "T": 64},
    "tacos": {"levels": 6, "sn": 30, "sratio": 0.5, "T": 128},
    "ego4d_goalstep": {"levels": 7, "sn": 60, "sratio": 0.3, "T": 256},
}


def _cut(cfg, T):
    m = cfg.model
    m.vid_net.in_dim = CV
    m.vid_net.embd_dim = 16
    m.vid_net.max_seq_len = T
    m.text_net.in_dim = CT
    m.text_net.embd_dim = 16
    m.text_net.n_layers = 1
    m.fusion.n_layers = 1
    return cfg


def configs(name):
    """(JAX cfg, port cfg) of configs/<name>.yaml at test widths."""
    path = os.path.join(REPO, "configs", name + ".yaml")
    T = CONFIGS[name]["T"]
    jcfg = jax_defaults(file_task(path))
    jcfg.merge_from_file(path)
    jax_update_eval_data(jax_update_opt(_cut(jcfg, T)))
    tcfg = load_config(path)
    update_eval_data(update_opt(_cut(tcfg, T)))
    return jcfg, tcfg


@pytest.fixture(scope="module", params=list(CONFIGS))
def services(request):
    name = request.param
    jcfg, tcfg = configs(name)
    # a JAX init would compile the whole model once more
    params = random_params(tcfg, len(name))
    return (name, jcfg, tcfg, JaxService(jcfg, params=params),
            GroundingService(tcfg, params=params, device="cpu"))


def test_config_keeps_its_shipped_keys(services):
    name, jcfg, tcfg, _, _ = services
    want = CONFIGS[name]
    for cfg in (jcfg, tcfg):
        m = cfg.model
        assert m.vid_net.arch[-1] == m.num_fpn_levels == want["levels"]
        assert (m.sn, m.sratio) == (want["sn"], want["sratio"])
        assert m.vid_net.mha_win_size == 5 and m.msf
        assert m.vid_net.max_seq_len % 2 ** (want["levels"] - 1) == 0
    assert tcfg.task == jcfg.task == file_task(
        os.path.join(REPO, "configs", name + ".yaml"))
    if name == "charades":
        assert tcfg.data.group_method is None and jcfg.data.group_method is None
        assert tcfg.eval.data.group_method is None
    if name == "ego4d_goalstep":
        assert tcfg.train.microbatch_size == jcfg.train.microbatch_size == 4


def _requests(cfg, seed):
    """Two videos of one bucket (lengths below max_seq_len) with 3 and 2
    queries, on the config's clip grid."""
    rng = np.random.RandomState(seed)
    T = cfg.model.vid_net.max_seq_len
    out = []
    for t, q in ((T - 5, 3), (T // 2 + 3, 2)):
        out.append(dict(
            vid=rng.randn(CV, t).astype(np.float32),
            shallow_vid=rng.randn(CV, t).astype(np.float32),
            texts=[rng.randn(CT, int(n)).astype(np.float32)
                   for n in rng.randint(3, 9, q)],
            text_cls=rng.randn(q, CV).astype(np.float32), fps=30.0,
            clip_size=cfg.data.clip_size, clip_stride=cfg.data.clip_stride))
    return out


def test_detections_match_jax(services):
    name, _, tcfg, jax_svc, svc = services
    reqs = _requests(tcfg, len(name))
    got, want = svc.ground_many(reqs), jax_svc.ground_many(reqs)
    assert len(got) == len(want) == len(reqs)
    n = 0
    for g_req, w_req in zip(got, want, strict=True):
        for g, w in zip(g_req, w_req, strict=True):
            assert len(g["scores"]) == len(w["scores"])
            np.testing.assert_allclose(
                np.asarray(g["segments"], np.float64).reshape(-1, 2),
                np.asarray(w["segments"], np.float64).reshape(-1, 2),
                rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(g["scores"], w["scores"], rtol=RTOL,
                                       atol=ATOL)
            n += len(g["scores"])
    assert n > 0


def test_one_request_matches_its_stacked_decode(services):
    """ground() of one video equals its row of the stacked ground_many()."""
    name, _, tcfg, _, svc = services
    reqs = _requests(tcfg, len(name))
    stacked = svc.ground_many(reqs)
    for req, row in zip(reqs, stacked, strict=True):
        for g, w in zip(svc.ground(**req), row, strict=True):
            np.testing.assert_allclose(g["scores"], w["scores"], rtol=RTOL,
                                       atol=ATOL)
