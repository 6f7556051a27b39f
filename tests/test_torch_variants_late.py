"""The port's late-fusion variant (``default``, DeCafNetLateFusion) and
``iter`` with the identity text net (AttNPool1D), ``pool_only`` video
branches and the L2-normalized saliency (``norm``), against their flax
modules on the same weights, on the helpers of tests/test_torch_variants.py
(the configs of tests/test_torch_parity.py; every output list at rtol 2e-4
/ atol 2e-5, Q = 1 and 3; strict load and round trip). Also TextIdentity
without a projection and AttNPool1D on masked rows. CPU, f32."""

import numpy as np
import pytest
import torch

import jax

from decafnet_tpu.core import update_opt as jax_update_opt
from decafnet_tpu.nn.blocks import AttNPool1D as JaxAttNPool1D
from decafnet_tpu_torch.core import update_opt
from decafnet_tpu_torch.models import (load_params, make_model,
                                       state_dict_from_params)
from decafnet_tpu_torch.models.text_net import TextIdentity
from decafnet_tpu_torch.nn import AttNPool1D
from test_torch_variants import (_compare, _flax_init, _forward_pair,
                                 _model_cfgs, _setup, check_forward,
                                 check_strict_load)

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)


@pytest.mark.parametrize("Q", [1, 3])
@pytest.mark.parametrize("variant", ["default", "identity_pool_only_norm"])
def test_forward_matches_flax(variant, Q):
    check_forward(variant, Q)


@pytest.mark.parametrize("variant", ["default", "identity_pool_only_norm"])
def test_strict_load_round_trips_every_key(variant):
    check_strict_load(variant)


def test_pool_only_tree_has_no_branch_encoders():
    """The pool_only branches are depthwise convs (C, 1, 3) without bias,
    and the identity text net holds only its projection and pooling."""
    _, _, _, params = _setup("identity_pool_only_norm")
    assert set(params["vid_net"]["branch_0"]) == {"conv"}
    assert set(params["vid_net"]["branch_1"]["conv"]) == {"weight"}
    assert params["vid_net"]["branch_1"]["conv"]["weight"].shape == (32, 1, 3)
    assert set(params["text_net"]) == {"embd_fc", "attn_pool"}


def test_text_identity_without_projection():
    """``text_net.embd_dim`` unset: the text keeps its ``in_dim`` channels
    and the fusion reads that width (the JAX tree needs fusion.text_dim set
    by hand; the port takes it from the text net)."""
    jcfg, tcfg = _model_cfgs({"name": "iter", "text_net": {
        "name": "identity", "embd_dim": None}})
    jcfg, tcfg = jax_update_opt(jcfg), update_opt(tcfg)
    jcfg.model.fusion.text_dim = jcfg.model.text_net.in_dim
    jmodel, params = _flax_init(jcfg)
    assert "embd_fc" not in params["text_net"]
    tmodel = load_params(make_model(tcfg), params).eval()
    assert tmodel.text_net.out_dim == 24 and tmodel.text_net.embd_fc is None
    _compare(*_forward_pair(jmodel, tmodel, params, 1))


def test_attn_pool_masked_rows():
    """AttNPool1D against the flax module on a full row, a row with a
    masked tail and an all-masked row (zeros from the NaN-safe softmax and
    the clamped mean, no NaN)."""
    rng = np.random.RandomState(7)
    x = rng.randn(3, 16, 9).astype(np.float32)
    mask = np.ones((3, 1, 9), bool)
    mask[1, :, 5:] = False
    mask[2] = False
    jmod = JaxAttNPool1D(16, n_heads=4)
    params = jax.tree.map(np.asarray, jax.jit(jmod.init)(
        jax.random.PRNGKey(3), x, mask)["params"])
    want_x, want_m = jax.jit(jmod.apply)({"params": params}, x, mask)
    tmod = AttNPool1D(16, n_heads=4)
    tmod.load_state_dict(state_dict_from_params(params), strict=True)
    with torch.inference_mode():
        got_x, got_m = tmod(torch.from_numpy(x), torch.from_numpy(mask))
    assert got_x.shape == (3, 16, 10) and np.isfinite(got_x.numpy()).all()
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(got_x[2, :, 0].numpy(), 0.0)
    # TextIdentity is that pooling behind the optional projection
    ident = TextIdentity(16, None, n_heads=4).eval()
    ident.attn_pool.load_state_dict(tmod.state_dict())
    with torch.inference_mode():
        out, m = ident(torch.from_numpy(x), torch.from_numpy(mask[:, 0]))
    torch.testing.assert_close(out, got_x, rtol=0, atol=0)
    assert torch.equal(m, got_m)


