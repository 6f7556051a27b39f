"""The grouped conv3 + LN + ReLU (``ops.fused_conv.conv3_ln_act_levels``):
one kernel launch per head layer over all FPN levels.

On the CPU: the work table the wrapper hands the kernel covers each
(level, row, column tile) exactly once; the plain list op equals the
per-level ``conv3_ln_act_torch`` exactly; the port's ClsHead and RegHead,
which run each trunk layer over all levels at once, match the JAX heads on
flax parameters carried by the port's key rule (``import_torch``), within
1e-5; the gradients through the list op equal the per-level ones; and on
two gloo ranks the time-sharded list op makes one halo exchange per level
and equals the unsharded op. The card cases are in
tests/test_torch_kernels.py."""

import functools
import json
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from decafnet_tpu.models.heads import ClsHead as JaxClsHead
from decafnet_tpu.models.heads import RegHead as JaxRegHead
from decafnet_tpu_torch.models import load_params
from decafnet_tpu_torch.models.heads import ClsHead, RegHead
from decafnet_tpu_torch.ops import conv3_ln_act_torch
from decafnet_tpu_torch.ops.fused_conv import (CONV3_TILE_T,
                                               conv3_ln_act_levels,
                                               conv3_work_table)
from test_torch_ddp import finish, spawn

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)

# (B, T) per level: the served decode call (64 rows, T = 2304 halved 6
# times), ragged lists, odd T, and levels shorter than one tile
LEVEL_LISTS = {
    "served": [(64, 2304 >> lvl) for lvl in range(7)],
    "ragged": [(3, 1000), (2, 301), (5, 150), (1, 17)],
    "odd": [(2, 97), (1, 95), (4, 193), (3, 1)],
    "short": [(4, 9), (2, 4), (3, 3), (1, 1)],
}


@pytest.mark.parametrize("tile", [96, CONV3_TILE_T, 64])
@pytest.mark.parametrize("which", list(LEVEL_LISTS))
def test_work_table_covers_each_tile_once(which, tile):
    shapes = LEVEL_LISTS[which]
    table = conv3_work_table(shapes, tile)
    assert table.dtype == torch.int32 and table.shape[1] == 3
    items = [tuple(r) for r in table.tolist()]
    want = {(lvl, b, t0) for lvl, (B, T) in enumerate(shapes)
            for b in range(B) for t0 in range(0, T, tile)}
    assert len(items) == len(set(items)) == len(want)
    assert set(items) == want
    # level by level, the longest first as the FPN lists them
    assert [i[0] for i in items] == sorted(i[0] for i in items)
    # every column of every row lies in exactly one tile
    for lvl, (B, T) in enumerate(shapes):
        cover = np.zeros((B, T), int)
        for level, b, t0 in items:
            if level == lvl:
                cover[b, t0:t0 + tile] += 1
        assert (cover == 1).all()


def _levels(shapes, C_in=6, C_out=8, seed=0, dtype=torch.float32):
    """Inputs of a list op: per level x (garbage under the mask) and a
    ragged mask with an all-masked row; shared weights."""
    rng = np.random.RandomState(seed)
    xs, masks = [], []
    for B, T in shapes:
        xs.append(torch.from_numpy(rng.randn(B, C_in, T).astype(np.float32))
                  .to(dtype))
        lens = rng.randint(1, T + 1, B)
        lens[-1] = 0
        masks.append(torch.arange(T)[None, :] < torch.from_numpy(lens)[:, None])
    f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa: E731
    return xs, masks, (f(C_out, C_in, 3) * 0.3, f(C_out), 1 + 0.1 * f(C_out),
                       0.1 * f(C_out))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["relu", "none"])
def test_plain_list_op_equals_per_level(dtype, act):
    xs, masks, params = _levels([(3, 40), (3, 20), (3, 10), (3, 5), (3, 3)],
                                dtype=dtype)
    got = conv3_ln_act_levels(xs, masks, *params, act=act)
    assert isinstance(got, list) and len(got) == len(xs)
    for y, x, m in zip(got, xs, masks):
        assert y.dtype == dtype
        assert torch.equal(y, conv3_ln_act_torch(x, m, *params, act=act))


@pytest.mark.parametrize("bias", [True, False])
def test_list_op_grads_equal_per_level(bias):
    xs, masks, params = _levels([(2, 24), (2, 12), (2, 6)], seed=3)
    params = params if bias else (params[0], None, *params[2:])
    g = torch.Generator().manual_seed(1)
    grads_out = [torch.randn(x.shape[0], 8, x.shape[2], generator=g) for x in xs]
    runs = []
    for grouped in (True, False):
        lx = [x.clone().requires_grad_() for x in xs]
        lp = [None if p is None else p.clone().requires_grad_() for p in params]
        if grouped:
            ys = conv3_ln_act_levels(lx, masks, *lp)
            assert type(ys[0].grad_fn).__name__ == "_Conv3LnActBackward"
        else:
            ys = [conv3_ln_act_torch(x, m, *lp) for x, m in zip(lx, masks)]
        torch.autograd.backward(ys, grads_out)
        runs.append([t.grad for t in lx + [p for p in lp if p is not None]])
    for a, b in zip(*runs, strict=True):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


# the heads at a small width: embd 16, 3 levels, ragged masks
EMBD, LEVELS = 16, 3


def _fpn(B=3, T=32, seed=5):
    rng = np.random.RandomState(seed)
    fpn, masks = [], []
    for lvl in range(LEVELS):
        t = T >> lvl
        fpn.append(rng.randn(B, EMBD, t).astype(np.float32))
        lens = np.array([t, t - 3 - lvl, 1])[:B]
        masks.append((np.arange(t)[None, :] < lens[:, None])[:, None, :])
    return fpn, masks


@functools.lru_cache(maxsize=None)
def _jax_head(kind):
    fpn, masks = _fpn()
    model = (JaxClsHead(EMBD, n_layers=2, prior_prob=0.01) if kind == "cls"
             else JaxRegHead(EMBD, LEVELS, n_layers=2))
    params = jax.jit(model.init)(jax.random.PRNGKey(7), tuple(fpn),
                                 tuple(masks))["params"]
    # random LN affines and scales, so the carry of every leaf shows
    rng = np.random.RandomState(9)
    params = jax.tree.map(
        lambda p: (np.asarray(p) + 0.1 * rng.randn(*np.shape(p))).astype(
            np.float32), params)
    out = jax.jit(model.apply)({"params": params}, tuple(map(jnp.asarray, fpn)),
                               tuple(map(jnp.asarray, masks)))
    return params, [np.asarray(o) for o in out[0]]


@pytest.mark.parametrize("kind", ["cls", "reg"])
def test_heads_match_jax_on_carried_params(kind):
    params, want = _jax_head(kind)
    head = (ClsHead(EMBD, n_layers=2, prior_prob=0.01) if kind == "cls"
            else RegHead(EMBD, LEVELS, n_layers=2))
    load_params(head, params)
    fpn, masks = _fpn()
    with torch.no_grad():
        got, out_masks = head([torch.from_numpy(x) for x in fpn],
                              [torch.from_numpy(m) for m in masks])
    assert len(got) == len(want) == LEVELS
    for g, w, m, mo in zip(got, want, masks, out_masks, strict=True):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5)
        assert torch.equal(mo, torch.from_numpy(m[:, 0, :]))


WORKER = textwrap.dedent("""
    import json

    import numpy as np
    import torch

    from decafnet_tpu_torch import parallel
    from decafnet_tpu_torch.ops.fused_conv import conv3_ln_act_levels
    from decafnet_tpu_torch.parallel import seq

    torch.set_num_threads(1)
    assert parallel.init_distributed("gloo")
    shard = seq.TimeShard()
    S = shard.size
    halos = []
    widen = shard.halo
    shard.halo = lambda *a, **k: halos.append(1) or widen(*a, **k)

    rng = np.random.RandomState(0)
    B, C, Ts = 2, 8, (32, 16, 8, 4)
    xs = [torch.from_numpy(rng.randn(B, C, T).astype(np.float32)) for T in Ts]
    # valid prefixes ending inside a block: masked tails cross block edges
    masks = [torch.arange(T)[None, :] < torch.tensor([T - 3, T // 2 - 1])[:, None]
             for T in Ts]
    params = [torch.from_numpy(rng.randn(*s).astype(np.float32))
              for s in ((C, C, 3), (C,), (C,), (C,))]
    params[0] *= 0.3
    g = torch.Generator().manual_seed(1)
    grads_out = [torch.randn(B, C, T, generator=g) for T in Ts]
    res = {}
    for local in (False, True):
        lx = [(shard.shard(x) if local else x).clone().requires_grad_()
              for x in xs]
        lm = [shard.shard(m) if local else m for m in masks]
        lp = [p.clone().requires_grad_() for p in params]
        n = len(halos)
        with seq.sharding(shard if local else None):
            ys = conv3_ln_act_levels(lx, lm, *lp)
        exchanges = len(halos) - n
        gos = [shard.shard(g) if local else g for g in grads_out]
        torch.autograd.backward(ys, gos)
        gp = [p.grad for p in lp]
        if local:
            for t in gp:
                shard.all_reduce(t)
        res[local] = ([y.detach() for y in ys], [x.grad for x in lx], gp,
                      exchanges)
    (ref_y, ref_gx, ref_gp, _), (y, gx, gp, exchanges) = res[False], res[True]
    rel = lambda a, b: float((a - b).norm() / b.norm().clamp_min(1e-30))
    print("WORKER::" + json.dumps({
        "S": S, "exchanges": exchanges, "levels": len(Ts),
        "forward": max(float((a - shard.shard(b)).abs().max())
                       for a, b in zip(y, ref_y)),
        "grad_input": max(rel(a, shard.shard(b)) for a, b in zip(gx, ref_gx)),
        "grad_params": max(rel(a, b) for a, b in zip(gp, ref_gp))}), flush=True)
    parallel.barrier()
    parallel.destroy()
""")


def test_time_sharded_list_op_one_halo_per_level(tmp_path):
    path = tmp_path / "conv3_levels_worker.py"
    path.write_text(WORKER)
    outs = finish(spawn([sys.executable, str(path)], world=2))
    got = []
    for rc, out in outs:
        assert rc == 0, out[-4000:]
        got.append(json.loads(next(line for line in out.splitlines()
                                   if line.startswith("WORKER::"))[8:]))
    assert len(got) == 2
    for r in got:
        assert r["S"] == 2 and r["exchanges"] == r["levels"] == 4, r
        assert r["forward"] <= 1e-5, r
        assert r["grad_input"] <= 1e-5 and r["grad_params"] <= 1e-5, r
