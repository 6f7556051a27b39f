"""The port's model variants against their flax modules on the same
weights, here ``iter2`` (DeCafNetIterative with the second fusion) and
``early`` / ``early2`` (DeCafNetEarlyFusion without / with it);
tests/test_torch_variants_late.py holds ``default`` and the identity text
net with ``pool_only`` on the helpers of this file. The configs are the
ones tests/test_torch_parity.py runs against the reference. The flax params
load strictly into the port (every key, no new rule) and round-trip; every
output list matches per row (Q = 1) and video-major (Q = 3) at rtol 2e-4 /
atol 2e-5 (tests/test_grouped_eval.py:81). Also ``iter2`` through the
port's Evaluator (its Decoder) against the JAX Evaluator, and the
construction-time refusal of the forward-only variants by the Evaluator,
GroundingService and Trainer. CPU, f32."""

import functools

import numpy as np
import pytest
import torch

import jax

from decafnet_tpu.core import get_cfg_defaults as jax_defaults
from decafnet_tpu.core import update_eval_data as jax_update_eval_data
from decafnet_tpu.core import update_opt as jax_update_opt
from decafnet_tpu.data import apply_synthetic_cfg as jax_apply_synthetic_cfg
from decafnet_tpu.data import make_synthetic_dataset as jax_make_synthetic
from decafnet_tpu.eval import Evaluator as JaxEvaluator
from decafnet_tpu.models import make_model as jax_make_model
from decafnet_tpu.utils.analysis import EvalResults as JaxEvalResults
from decafnet_tpu_torch.core import get_cfg_defaults, update_eval_data, update_opt
from decafnet_tpu_torch.data import apply_synthetic_cfg
from decafnet_tpu_torch.eval import Evaluator
from decafnet_tpu_torch.models import (DeCafNetEarlyFusion, DeCafNetIterative,
                                       DeCafNetLateFusion, load_params,
                                       make_model, params_from_state_dict,
                                       state_dict_from_params)
from decafnet_tpu_torch.serve import GroundingService
from decafnet_tpu_torch.train import Trainer
from decafnet_tpu_torch.utils import EvalResults

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)

# tests/test_torch_parity.py small_cfg(msf=True)
PARITY = {
    "sratio": 0.3, "sn": 8, "msf": True, "scat": False,
    "vid_net": {"in_dim": 32, "embd_dim": 32, "max_seq_len": 64,
                "arch": (2, 0, 3), "proj_pdrop": 0.0, "path_pdrop": 0.0},
    "text_net": {"in_dim": 24, "embd_dim": 32, "n_layers": 2},
    "fusion": {"n_layers": 2, "proj_pdrop": 0.0, "path_pdrop": 0.0},
}
# tests/test_torch_parity.py:122-130: identity text net, pool_only, norm
IDENTITY = {"text_net": {"name": "identity"}, "vid_net": {"pool_only": True},
            "norm": True}
VARIANTS = {
    "iter2": {"name": "iter2"},
    "early": {"name": "early"},
    "early2": {"name": "early2"},
    "default": {"name": "default"},
    "identity_pool_only_norm": {"name": "iter", **IDENTITY},
}
CLASSES = {"iter2": DeCafNetIterative, "early": DeCafNetEarlyFusion,
           "early2": DeCafNetEarlyFusion, "default": DeCafNetLateFusion,
           "identity_pool_only_norm": DeCafNetIterative}
SEG_TOL_S, SCORE_TOL = 1e-3, 1e-4


def _apply(cfg, overrides):
    for k, v in overrides.items():
        if isinstance(v, dict):
            _apply(cfg[k], v)
        else:
            cfg[k] = v


def _set_model(model, overrides):
    """The parity config with ``overrides`` in a ``model`` tree (the
    identity net has no layer stack: its ``n_layers`` is deleted, as
    tests/test_torch_parity.py:128 does)."""
    _apply(model, PARITY)
    _apply(model, overrides)
    if model.text_net.name == "identity":
        del model.text_net["n_layers"]


def _model_cfgs(overrides):
    """The same model config in both packages' own config trees."""
    jc, tc = jax_defaults("grounder"), get_cfg_defaults()
    _set_model(jc.model, overrides)
    _set_model(tc.model, overrides)
    return jc, tc


def _inputs(V, Q, T=64, cv=32, ct=24, L=8, seed=0):
    """V videos (valid lengths 64, 40, 17, ...) and V*Q query rows, the
    last with a masked token tail."""
    rng = np.random.RandomState(seed)
    vid = rng.randn(V, cv, T).astype(np.float32)
    shallow = rng.randn(V, cv, T).astype(np.float32)
    vm = np.zeros((V, T), bool)
    for i, n in enumerate((64, 40, 17)[:V]):
        vm[i, :n] = True
    text = rng.randn(V * Q, ct, L).astype(np.float32)
    tcls = rng.randn(V * Q, cv).astype(np.float32)
    tm = np.ones((V * Q, L), bool)
    tm[-1, 6:] = False
    return vid, shallow, vm, text, tcls, tm


def _flax_init(jcfg):
    model = jax_make_model(jcfg)
    # one compiled init: eager init compiles every primitive on its own
    init = jax.jit(functools.partial(model.init, deterministic=True))
    params = init(jax.random.PRNGKey(0), *_inputs(2, 1))["params"]
    return model, jax.tree.map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _setup(variant):
    """Both configs, the flax model and its params; ``early2`` shares the
    params of ``early`` (the second fusion reuses the fusion's weights)."""
    jcfg, tcfg = _model_cfgs(VARIANTS[variant])
    jcfg, tcfg = jax_update_opt(jcfg), update_opt(tcfg)
    if variant == "early2":
        return jcfg, tcfg, jax_make_model(jcfg), _setup("early")[3]
    return (jcfg, tcfg) + _flax_init(jcfg)


def _compare(got, want):
    assert len(got) == len(want)
    for g_group, w_group in zip(got, want, strict=True):
        assert len(g_group) == len(w_group) == 3
        for g, w in zip(g_group, w_group, strict=True):
            g, w = g.numpy(), np.asarray(w)
            assert g.shape == w.shape
            if w.dtype == bool:
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5)


def _forward_pair(jmodel, tmodel, params, Q):
    args = _inputs(3, Q, seed=Q)
    want = jax.jit(functools.partial(jmodel.apply, deterministic=True,
                                     queries_per_video=Q))({"params": params}, *args)
    with torch.inference_mode():
        got = tmodel(*map(torch.from_numpy, args), queries_per_video=Q)
    return got, want


def check_forward(variant, Q):
    _, tcfg, jmodel, params = _setup(variant)
    tmodel = load_params(make_model(tcfg), params).eval()
    assert type(tmodel) is CLASSES[variant]
    got, want = _forward_pair(jmodel, tmodel, params, Q)
    assert len(got) == (4 if variant in ("iter2", "identity_pool_only_norm")
                        else 3)
    _compare(got, want)


def check_strict_load(variant):
    _, tcfg, _, params = _setup(variant)
    model = load_params(make_model(tcfg), params)   # strict
    flat = dict(jax.tree_util.tree_leaves_with_path(params))
    sd = model.state_dict()
    assert len(sd) == len(flat) == len(state_dict_from_params(params))
    back = params_from_state_dict(sd)
    for path, value in flat.items():
        node = back
        for p in path:
            node = node[p.key]
        assert node.shape == value.shape
        np.testing.assert_array_equal(node, value)


@pytest.mark.parametrize("Q", [1, 3])
@pytest.mark.parametrize("variant", ["iter2", "early", "early2"])
def test_forward_matches_flax(variant, Q):
    check_forward(variant, Q)


@pytest.mark.parametrize("variant", ["iter2", "early", "early2"])
def test_strict_load_round_trips_every_key(variant):
    check_strict_load(variant)


def test_iter2_evaluator_matches_jax(tmp_path):
    """``iter2`` returns the four lists of ``iter``: the port's Evaluator
    (its Decoder, device SoftNMS) on one synthetic video of 3 queries gives
    the JAX Evaluator's detections within 1e-3 s / 1e-4 and the same R@k."""
    paths = jax_make_synthetic(str(tmp_path / "data"), num_videos=1,
                               num_queries=3, clip_range=(40, 90), vid_dim=32,
                               shallow_dim=32, text_dim=24, seed=5)
    cfgs = []
    for pkg, (defaults, apply, derive) in {
            "jax": (jax_defaults, jax_apply_synthetic_cfg,
                    (jax_update_opt, jax_update_eval_data)),
            "port": (get_cfg_defaults, apply_synthetic_cfg,
                     (update_opt, update_eval_data))}.items():
        cfg = defaults("grounder")
        _set_model(cfg.model, VARIANTS["iter2"])
        cfg.train.num_workers = 0
        cfg.eval.iou_threshs = (0.1, 0.3)
        cfg.eval.save_results = True
        cfg.aux.logdir = str(tmp_path / pkg)
        apply(cfg, paths)
        for fn in derive:
            fn(cfg)
        cfgs.append(cfg)
    jcfg, tcfg = cfgs
    params = _setup("iter2")[3]        # the same model config
    (tmp_path / "jax").mkdir()
    want = JaxEvaluator(jcfg, train_time=True).run(ema_params=params)
    ev = Evaluator(tcfg, params=params, device="cpu")
    assert isinstance(ev.model, DeCafNetIterative) and ev.model.second_fusion
    got = ev.run()
    np.testing.assert_array_equal(got, want)
    jr = JaxEvalResults.load(str(tmp_path / "jax" / "results_eval.pk"))
    tr = EvalResults.load(str(tmp_path / "port" / "results_eval.pk"))
    n = 0
    for tv, jv in zip(tr.videos, jr.videos, strict=True):
        for g, w in zip(tv["detections"], jv["detections"], strict=True):
            assert len(g["scores"]) == len(w["scores"]) > 0
            np.testing.assert_allclose(g["segments"], w["segments"],
                                       atol=SEG_TOL_S, rtol=0)
            np.testing.assert_allclose(g["scores"], w["scores"],
                                       atol=SCORE_TOL, rtol=0)
            n += 1
    assert n == 3 and ev.decoder.decode_calls == 1


@pytest.mark.parametrize("who", ["Evaluator", "GroundingService", "Trainer"])
@pytest.mark.parametrize("name", ["early", "early2", "default"])
def test_forward_only_variants_are_refused(name, who):
    """The decode and the losses read two classification heads; the three
    one-head variants stop at construction, naming why."""
    _, tcfg = _model_cfgs({"name": name})
    tcfg = update_opt(tcfg)
    tcfg.seed = 0
    build = {"Evaluator": lambda: Evaluator(tcfg, params={}, device="cpu"),
             "GroundingService": lambda: GroundingService(tcfg, params={},
                                                          device="cpu"),
             "Trainer": lambda: Trainer(tcfg, device="cpu")}[who]
    with pytest.raises(ValueError, match="forward-only") as e:
        build()
    assert who in str(e.value) and "two" in str(e.value)
    # the model itself builds and runs forward
    model = make_model(tcfg).eval()
    with torch.inference_mode():
        out = model(*map(torch.from_numpy, _inputs(1, 1)))
    assert len(out) == 3 and all(len(o) == 3 for o in out)


def test_variant_names_and_unknown_name():
    for name in ("iter", "iter2", "early", "early2", "default"):
        _, tcfg = _model_cfgs({"name": name})
        make_model(update_opt(tcfg))
    _, tcfg = _model_cfgs({"name": "other"})
    with pytest.raises(ValueError, match="unknown model"):
        make_model(update_opt(tcfg))
    _, tcfg = _model_cfgs({"text_net": {"name": "other"}})
    with pytest.raises(ValueError, match="unknown text net"):
        make_model(update_opt(tcfg))
