"""The frozen reference against the port's plain path on the CPU, at a
tiny ``nlq``-shaped configuration; its weights against the port's
parameter tree; the control precisions."""

import numpy as np
import pytest
import torch

from portbench import check, traffic
from portbench.reference import decode as ref_decode
from portbench.reference.model import rounder
from portbench.reference.weights import flax_tree, make_weights, param_spec
from portbench.tests import tiny

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def served():
    from decafnet_tpu_torch.core import CfgNode
    from decafnet_tpu_torch.serve import GroundingService
    conf = tiny.config()
    cfg = conf["cfg"]
    weights = make_weights(cfg["model"], 123)
    service = GroundingService(CfgNode.from_dict(cfg),
                               params=flax_tree(weights), device="cpu")
    pool = traffic.make_pool(tiny.mix(pool=4), cfg["model"], 7)
    answers = service.ground_many(pool, max_group=4)
    return cfg, weights, pool, answers


def pairs_of(cfg, weights, pool, answers, precision="f32"):
    pairs = []
    for req, ans in zip(pool, answers):
        ref = ref_decode.ground(weights, cfg, req, k=10)
        if precision != "f32":
            ans = ref_decode.ground(weights, cfg, req, k=5, precision=precision)
        pairs += [(p, r, req["clip_stride"] / req["fps"])
                  for p, r in zip(ans, ref)]
    return pairs


def test_spec_matches_the_port_parameters():
    from decafnet_tpu_torch.core import CfgNode
    from decafnet_tpu_torch.models import make_model
    for conf in (tiny.config(),):
        sd = make_model(CfgNode.from_dict(conf["cfg"])).state_dict()
        spec = {k: s for k, s, _, _ in param_spec(conf["cfg"]["model"])}
        assert set(spec) == set(sd)
        assert all(tuple(sd[k].shape) == spec[k] for k in spec)


@pytest.mark.parametrize("name", ["nlq", "mad32k"])
def test_spec_matches_the_port_at_the_cells_widths(name):
    from decafnet_tpu_torch.core import CfgNode
    from decafnet_tpu_torch.models import make_model
    from portbench import harness
    conf = harness.load_json(harness.HERE, "configs", f"{name}.json")
    sd = make_model(CfgNode.from_dict(conf["cfg"])).state_dict()
    spec = {k: s for k, s, _, _ in param_spec(conf["cfg"]["model"])}
    assert set(spec) == set(sd)
    assert all(tuple(sd[k].shape) == spec[k] for k in spec)


def test_weights_are_seeded_and_every_leaf_drawn():
    m = tiny.config()["cfg"]["model"]
    a, b, c = make_weights(m, 5), make_weights(m, 5), make_weights(m, 6)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
    scales = [v for k, v in a.items() if k.endswith("drop_path_ffn.scale")]
    assert all(float(v.min()) >= 0.1 for v in scales)
    tree = flax_tree(a)
    assert tree["vid_net"]["branch_0"]["attn"]["q_conv"]["conv"]["weight"].shape \
        == tuple(a["vid_net.branch.0.attn.q_conv.conv.weight"].shape)


def test_reference_matches_the_port_plain_path(served):
    cfg, weights, pool, answers = served
    numbers = check.compare(pairs_of(cfg, weights, pool, answers), 5, 0.0)
    assert numbers["count_gap"] == 0
    assert numbers["top_score_gap"] < 1e-6
    assert numbers["top_segment_gap"] < 1e-4
    assert numbers["segment_gap"] < 1e-4


@pytest.mark.parametrize("precision,least", [("tf32", 1e-5), ("fp8", 1e-3)])
def test_controls_read_far_above_the_port(served, precision, least):
    cfg, weights, pool, answers = served
    numbers = check.compare(pairs_of(cfg, weights, pool, answers, precision),
                            5, 0.0)
    assert numbers["top_score_gap"] > least


def test_rounders():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -12,
                      -3.0e-3])
    t = rounder("tf32")(x)
    assert t[0] == 1.0 and t[1] == 1.0 + 2.0 ** -10
    assert t[2] == 1.0 + 2.0 ** -10
    assert abs(float(t[3]) + 3.0e-3) <= 3.0e-3 * 2.0 ** -11
    f = rounder("fp8")(x)
    assert torch.all((f - x).abs() <= x.abs() * 2.0 ** -3 + 1e-12)
    assert torch.equal(rounder("f32")(x), x)


def test_a_near_tie_at_the_kept_edge_gives_the_swapped_alternate():
    from portbench.reference.model import DELEGATION_TIE, delegation_weights
    means = [5.0, 1.0, 3.0, 3.0 - 0.5 * DELEGATION_TIE * 5.0, -2.0]
    correl = torch.tensor(means).repeat_interleave(2)[None]
    valid = torch.ones(1, 10, dtype=torch.bool)
    w, alts = delegation_weights(correl, valid, 2, 0.4)
    assert alts == {}
    assert w[0].tolist() == [1, 1, 0, 0, 1, 1, 0, 0, 0, 0]
    w, alts = delegation_weights(correl, valid, 2, 0.4, alternates=True)
    assert alts[0].tolist() == [1, 1, 0, 0, 0, 0, 1, 1, 0, 0]
    correl[0, 6:8] = 2.0
    assert delegation_weights(correl, valid, 2, 0.4, alternates=True)[1] == {}
