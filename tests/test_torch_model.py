"""The port's DeCafNetIterative against the flax model on the same weights:
the flax params carry across by the key rule of
decafnet_tpu_torch/models/import_torch.py with a strict load, and cls_head
logits, cls_head2 logits, offsets and masks match per row (Q = 1) and
video-major (Q > 1) for the msf/scat/norm combinations of
tests/test_grouped_eval.py. Tolerance rtol 2e-4, atol 2e-5, as
tests/test_grouped_eval.py:81. CPU, f32."""

import functools

import numpy as np
import pytest
import torch

import jax

from decafnet_tpu.core import get_cfg_defaults as jax_defaults
from decafnet_tpu.core import update_opt as jax_update_opt
from decafnet_tpu.models import make_model as jax_make_model
from decafnet_tpu_torch.core import get_cfg_defaults, update_opt
from decafnet_tpu_torch.models import (load_params, make_model,
                                       params_from_state_dict, random_params,
                                       state_dict_from_params)

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)

SMALL = {
    "name": "iter", "sratio": 0.5, "sn": 8,
    "vid_net": {"in_dim": 24, "embd_dim": 16, "max_seq_len": 64,
                "arch": (1, 0, 3)},
    "text_net": {"in_dim": 20, "embd_dim": 16, "n_layers": 1},
    "fusion": {"n_layers": 1},
}


def _apply(cfg, overrides):
    for k, v in overrides.items():
        if isinstance(v, dict):
            _apply(cfg[k], v)
        else:
            cfg[k] = v


def cfg_pair(**model):
    """The same small config in both packages' own config trees."""
    jc, tc = jax_defaults("grounder"), get_cfg_defaults()
    for c in (jc.model, tc.model):
        _apply(c, SMALL)
        _apply(c, model)
    return jax_update_opt(jc), update_opt(tc)


def _inputs(V, Q, T, cv, ct, L=12, seed=11):
    rng = np.random.RandomState(seed)
    vid = rng.randn(V, cv, T).astype(np.float32)
    shallow = rng.randn(V, cv, T).astype(np.float32)
    vm = np.zeros((V, T), bool)
    for i in range(V):
        vm[i, :T - 7 * i] = True
    text = rng.randn(V * Q, ct, L).astype(np.float32)
    tcls = rng.randn(V * Q, cv).astype(np.float32)
    tm = np.ones((V * Q, L), bool)
    tm[-1, L // 2:] = False
    return vid, shallow, vm, text, tcls, tm


def flax_params(jcfg, V=2, T=64, Q=1):
    cv, ct = jcfg.model.vid_net.in_dim, jcfg.model.text_net.in_dim
    vid, shallow, vm, text, tcls, tm = _inputs(V, Q, T, cv, ct)
    model = jax_make_model(jcfg)
    # one compiled init: eager init compiles every primitive on its own
    init = jax.jit(functools.partial(model.init, deterministic=True))
    params = init(jax.random.PRNGKey(0), vid, shallow, vm, text, tcls, tm)["params"]
    return model, jax.tree.map(np.asarray, params)


def test_strict_load_round_trips_every_key():
    jcfg, tcfg = cfg_pair(msf=True, scat=True)
    _, params = flax_params(jcfg)
    model = load_params(make_model(tcfg), params)
    flat = dict(jax.tree_util.tree_leaves_with_path(params))
    sd = model.state_dict()
    assert len(sd) == len(flat) == len(state_dict_from_params(params))
    back = params_from_state_dict(sd)
    for path, value in flat.items():
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, value)
        assert node.shape == value.shape


def test_random_params_load_strictly():
    _, tcfg = cfg_pair()
    a, b = random_params(tcfg, 3), random_params(tcfg, 3)
    model = load_params(make_model(tcfg), a)
    assert all(torch.isfinite(p).all() for p in model.parameters())
    for pa, pb in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(pa, pb)


@functools.lru_cache(maxsize=None)
def _flax_setup(msf, scat, norm):
    """One flax init per msf/scat/norm combination, shared by both Q."""
    jcfg, tcfg = cfg_pair(msf=msf, scat=scat, norm=norm)
    return (jcfg, tcfg) + flax_params(jcfg, Q=1)


@pytest.mark.parametrize("Q", [1, 3])
@pytest.mark.parametrize("msf,scat,norm", [
    (True, False, False), (True, True, False), (False, False, False),
    (False, True, True)])
def test_forward_matches_flax(msf, scat, norm, Q):
    jcfg, tcfg, jmodel, params = _flax_setup(msf, scat, norm)
    tmodel = load_params(make_model(tcfg), params).eval()
    V, T = 3, 64
    args = _inputs(V, Q, T, jcfg.model.vid_net.in_dim,
                   jcfg.model.text_net.in_dim, seed=Q)
    want = jax.jit(functools.partial(jmodel.apply, deterministic=True,
                                     queries_per_video=Q))({"params": params}, *args)
    with torch.inference_mode():
        got = tmodel(*map(torch.from_numpy, args), queries_per_video=Q)
    assert len(got) == len(want) == 4
    for g_group, w_group in zip(got, want):
        assert len(g_group) == len(w_group) == 3
        for g, w in zip(g_group, w_group):
            g, w = g.numpy(), np.asarray(w)
            assert g.shape == w.shape
            if w.dtype == bool:
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5)


def test_port_defaults_match_jax_defaults():
    """Every key the port's config tree keeps has the JAX package's default."""
    jc, tc = jax_defaults("grounder"), get_cfg_defaults()

    def walk(t, j, prefix=""):
        for k, v in t.items():
            assert k in j, prefix + k
            if isinstance(v, dict):
                walk(v, j[k], prefix + k + ".")
            else:
                assert v == j[k], prefix + k

    walk(tc, jc)
