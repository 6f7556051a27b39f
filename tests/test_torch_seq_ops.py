"""Each op that sequence parallelism widens by a halo
(``decafnet_tpu_torch/parallel/seq.py``), run time-sharded over gloo ranks
on the CPU, against the same op unsharded on the whole video: the forward
(every rank's block of it) and the gradients of the input and of the
parameters (summed over the ranks), in f32 and bf16.

The ops: conv3 + LN + ReLU (S = 2 and S = 4), the q/k/v trio, band
attention, a stride-2 depthwise ``MaskedConv1D`` and the k5 stride-2
embedding conv, the masked max-pool skip, a TCN layer at dilation 4 with its
dropout on (drawn globally), the global video self-attention
(``ConvAttNLayer`` with window -1 at stride 1, after the q/k/v trio, and at
stride 2; its attention and projection dropouts on), whose keys are
gathered, and the backwards of ``TimeShard.halo`` and
``TimeShard.gather`` themselves. Every
row's valid prefix ends inside a block, so a masked tail crosses a block
edge. Tolerances: f32 forward |diff| <= 1e-5 * max(1, |ref|), gradients at
relative L2 1e-5; bf16 forward within 2 bf16 eps (2^-7) of max(1, |ref|),
gradients at relative L2 1e-2.

Ranks are spawned as tests/test_torch_ddp.py spawns them."""

import json
import sys
import textwrap

import pytest
import torch

from test_torch_ddp import finish, spawn

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)

WORKER = textwrap.dedent("""
    import json, sys

    import numpy as np
    import torch
    import torch.distributed as dist

    from decafnet_tpu_torch import parallel
    from decafnet_tpu_torch.models.tcn import DilatedResidualLayer
    from decafnet_tpu_torch.nn.blocks import (ConvAttNLayer, MaskedConv1D,
                                              reset_parameters)
    from decafnet_tpu_torch.ops import (band_attention, conv3_ln_act,
                                        masked_max_pool1d, qkv_depthwise_ln)
    from decafnet_tpu_torch.parallel import seq

    torch.set_num_threads(1)
    which = sys.argv[1].split(",")
    assert parallel.init_distributed("gloo")
    shard = seq.TimeShard()
    S, r = shard.size, shard.rank
    B, C, T, H, D = 2, 8, 32, 2, 4
    # valid prefixes ending inside a block: masked tails cross block edges
    LENS = (T - 5, T // 2 - 3)
    rng = np.random.RandomState(0)

    def arr(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    mask = torch.arange(T)[None, :] < torch.tensor(LENS)[:, None]

    def run(fn, inputs, params, dtype, time_axes):
        # fn(*inputs, *params) -> tuple of outputs with time at the given
        # axes; returns the global reference and the sharded result
        def leaves(ts, local):
            out = []
            for t, ax in zip(ts, time_axes if local else [None] * len(ts)):
                if local and ax is not None:
                    t = shard.shard(t, ax)
                t = t.to(dtype) if t.is_floating_point() else t
                out.append(t.detach().requires_grad_(t.is_floating_point()))
            return out
        grads_out = None
        res = {}
        for local in (False, True):
            xs = leaves(inputs, local)
            ps = [p.detach().to(dtype).requires_grad_() for p in params]
            with seq.sharding(shard if local else None):
                outs = fn(*xs, *ps)
            outs = outs if isinstance(outs, tuple) else (outs,)
            if grads_out is None:
                g = torch.Generator().manual_seed(1)
                grads_out = [torch.randn(o.shape, generator=g).to(o.dtype)
                             for o in outs]
            gos = ([shard.shard(g, ax)
                    for g, ax in zip(grads_out, out_axes(outs))]
                   if local else grads_out)
            wrt = [x for x in xs if x.requires_grad] + ps
            fl = [o for o in outs if o.is_floating_point()]
            gs = torch.autograd.grad(
                fl, wrt, [go for go, o in zip(gos, outs)
                          if o.is_floating_point()], allow_unused=True)
            gs = [torch.zeros_like(w) if g is None else g
                  for g, w in zip(gs, wrt)]
            n_x = len(wrt) - len(ps)
            if local:
                for g in gs[n_x:]:
                    shard.all_reduce(g)
            res[local] = (outs, gs[:n_x], gs[n_x:])
        return res

    def out_axes(outs):
        return [-2 if o.ndim == 4 else -1 for o in outs]

    def rel_l2(a, b):
        a, b = a.double(), b.double()
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    def compare(name, res, dtype, x_axes):
        ref_o, ref_gx, ref_gp = res[False]
        got_o, got_gx, got_gp = res[True]
        fwd = 0.0
        for a, b, ax in zip(got_o, ref_o, out_axes(ref_o)):
            a, b = a.detach(), shard.shard(b.detach(), ax)
            if a.dtype == torch.bool:
                fwd = max(fwd, float((a != b).sum()))
                continue
            fwd = max(fwd, float(((a.float() - b.float()).abs()
                                  / b.float().abs().clamp_min(1.0)).max()))
        gx = max([rel_l2(a, shard.shard(b, ax))
                  for a, b, ax in zip(got_gx, ref_gx, x_axes)] or [0.0])
        gp = max([rel_l2(a, b) for a, b in zip(got_gp, ref_gp)] or [0.0])
        return {"op": name, "dtype": str(dtype), "S": S, "forward": fwd,
                "grad_input": gx, "grad_params": gp}

    def shard_or_pad(x):
        # the halo's own backward: every rank's window of the zero-padded
        # video, side by side, is what the ranks' widened blocks hold, and
        # a column's gradient is the sum over the windows that hold it
        sh = seq.active()
        if sh is not None:
            return sh.halo(x, left=2, right=3)[0]
        t = x.shape[-1] // S
        xp = torch.nn.functional.pad(x, (2, 3))
        return torch.cat([xp[..., q * t:q * t + t + 5] for q in range(S)],
                         dim=-1)

    def gathered_roll(x):
        # gather's backward: each rank keeps the block of the rank before
        # it from the gathered video, so every gradient crosses ranks
        sh = seq.active()
        t = x.shape[-1] // S if sh is None else x.shape[-1]
        if sh is None:
            return x.roll(t, -1)
        return sh.shard(sh.gather(x)[0].roll(t, -1))

    results = []
    for dtype in (torch.float32, torch.bfloat16):
        x = arr(B, C, T)
        if "conv3" in which:
            w, b, lw, lb = arr(C, C, 3) * 0.3, arr(C), arr(C), arr(C)
            res = run(lambda x, m, *p: conv3_ln_act(x, m, *p), [x, mask],
                      [w, b, lw, lb], dtype, [-1, -1])
            results.append(compare("conv3", res, dtype, [-1]))
        if "trio" in which:
            ps = [arr(C, 1, 3) for _ in range(3)] + [arr(C) for _ in range(6)]
            res = run(lambda x, m, *p: qkv_depthwise_ln(
                x, m, p[0:3], p[3:6], p[6:9]), [x, mask], ps, dtype, [-1, -1])
            results.append(compare("trio", res, dtype, [-1]))
        if "band" in which:
            q, k, v = arr(B, H, T, D), arr(B, H, T, D), arr(B, H, T, D)
            res = run(lambda q, k, v, m: band_attention(q, k, v, m, 5),
                      [q, k, v, mask], [], dtype, [-2, -2, -2, -1])
            results.append(compare("band", res, dtype, [-2, -2, -2]))
        if "stride2" in which:
            for k, pad in ((3, 1), (5, 2)):
                conv = MaskedConv1D(C, C, k, 2, pad, groups=C if k == 3 else 1,
                                    bias=k == 5)
                conv.conv.reset_parameters(torch.Generator().manual_seed(2))
                names = [n for n, _ in conv.named_parameters()]

                def f(x, m, *p, conv=conv, names=names):
                    out = torch.func.functional_call(
                        conv, dict(zip(names, p)), (x, m[:, None, :]))
                    return out[0], out[1][:, 0, :]
                res = run(f, [x, mask], [p for p in conv.parameters()],
                          dtype, [-1, -1])
                results.append(compare(f"stride2_k{k}", res, dtype, [-1]))
        if "maxpool" in which:
            res = run(lambda x, m: masked_max_pool1d(x, m[:, None, :], 3, 2),
                      [x, mask], [], dtype, [-1, -1])
            results.append(compare("maxpool", res, dtype, [-1]))
        if "tcn" in which:
            layer = DilatedResidualLayer(4, C, pdrop=0.5).train()
            layer.conv_dilated.reset_parameters(torch.Generator().manual_seed(3))
            layer.conv_1x1.reset_parameters(torch.Generator().manual_seed(4))
            names = [n for n, _ in layer.named_parameters()]

            def f(x, m, *p):
                gen = torch.Generator().manual_seed(5)
                return torch.func.functional_call(
                    layer, dict(zip(names, p)), (x, m[:, None, :]),
                    {"generator": gen})
            res = run(f, [x, mask], [p for p in layer.parameters()], dtype,
                      [-1, -1])
            results.append(compare("tcn_d4_dropout", res, dtype, [-1]))
        if "mha_global" in which:
            for stride in (1, 2):
                layer = ConvAttNLayer(C, stride=stride, n_heads=H,
                                      window_size=-1, attn_pdrop=0.2,
                                      proj_pdrop=0.1).train()
                reset_parameters(layer, torch.Generator().manual_seed(6))
                # the key biases stay fixed: their exact gradient is 0
                # (the softmax ignores a bias shared by every key), so both
                # sides of it are rounding noise
                named = [(n, p) for n, p in layer.named_parameters()
                         if n not in ("attn.key.bias", "k_norm.bias")]
                names = [n for n, _ in named]

                def f(x, m, *p, layer=layer, names=names):
                    gen = torch.Generator().manual_seed(7)
                    out, om = torch.func.functional_call(
                        layer, dict(zip(names, p)), (x, m[:, None, :]),
                        {"generator": gen})
                    return out, om[:, 0, :]
                res = run(f, [x, mask], [p for _, p in named], dtype,
                          [-1, -1])
                results.append(compare(
                    "mha_global" + ("_stride2" if stride == 2 else ""), res,
                    dtype, [-1]))
        if "halo" in which:
            res = run(shard_or_pad, [x], [], dtype, [-1])
            results.append(compare("halo", res, dtype, [-1]))
            res = run(gathered_roll, [x], [], dtype, [-1])
            results.append(compare("gather", res, dtype, [-1]))

    print("WORKER::" + json.dumps(results), flush=True)
    parallel.barrier()
    parallel.destroy()
""")

def _worker(tmp_path):
    path = tmp_path / "seq_ops_worker.py"
    path.write_text(WORKER)
    return str(path)


def _runs(tmp_path, world, which):
    outs = finish(spawn([sys.executable, _worker(tmp_path), ",".join(which)],
                        world=world))
    for rc, out in outs:
        assert rc == 0, out[-4000:]
    return [r for _, out in outs for r in json.loads(
        next(l for l in out.splitlines() if l.startswith("WORKER::"))[8:])]


def _check(results):
    assert results
    for r in results:
        if r["dtype"] == "torch.float32":
            lim = {"forward": 1e-5, "grad_input": 1e-5, "grad_params": 1e-5}
        else:
            lim = {"forward": 2 ** -7, "grad_input": 1e-2, "grad_params": 1e-2}
        for k, v in lim.items():
            assert r[k] <= v, (r, k)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return _runs(tmp_path_factory.mktemp("seq_ops2"), 2,
                 ["conv3", "trio", "band", "stride2", "maxpool", "tcn",
                  "mha_global", "halo"])


@pytest.mark.parametrize("op", ["conv3", "trio", "band", "stride2_k3",
                                "stride2_k5", "maxpool", "tcn_d4_dropout",
                                "mha_global", "mha_global_stride2", "halo",
                                "gather"])
@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
def test_sharded_op_matches_whole_video(two_ranks, op, dtype):
    got = [r for r in two_ranks if r["op"] == op and r["dtype"] == dtype]
    assert len(got) == 2        # one record per rank
    _check(got)


def test_conv3_over_four_ranks(tmp_path):
    got = _runs(tmp_path, 4, ["conv3", "halo"])
    assert sorted({(r["op"], r["S"]) for r in got}) == [
        ("conv3", 4), ("gather", 4), ("halo", 4)]
    _check(got)
