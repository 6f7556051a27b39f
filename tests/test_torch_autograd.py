"""Autograd through the port's three kernel ops, and the dropout helpers of
train mode (CPU).

Under autograd each kernel op runs as a ``torch.autograd.Function`` whose
forward is the op's own (the plain version on the CPU, the kernel on the
card) and whose backward recomputes through the plain version, as the JAX
``custom_vjp`` rules recompute through the XLA forms. Here each Function,
driven with the plain forward in f64, passes ``torch.autograd.gradcheck``
over masked tails, an all-masked row, absent bias / LN affine and the
strided head views the model hands to band attention; its f32 gradients
equal direct autograd of the plain version. The dropout helpers draw from
an explicit ``torch.Generator``: identity in eval mode, reproducible from a
seed, a per-sample stochastic-depth gate, a channel mask constant over
time, the keep rate and the 1 / keep scale; a model in train mode with
every rate 0 is the eval forward bit for bit, and ``sfonly`` applies at
eval only."""

import numpy as np
import pytest
import torch

from decafnet_tpu_torch.core import get_cfg_defaults, update_opt
from decafnet_tpu_torch.models import init_random, make_model
from decafnet_tpu_torch.nn.blocks import LayerScale, dropout, drop_path
from decafnet_tpu_torch.ops import (band_attention, band_attention_torch,
                                    conv3_ln_act, conv3_ln_act_torch,
                                    qkv_depthwise_ln, qkv_depthwise_ln_torch)

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)

F64 = torch.float64


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _mask(lens, T):
    return torch.arange(T)[None, :] < torch.tensor(lens)[:, None]


def _conv3_inputs(dtype, bias, affine, C_in=4, C_out=5, T=7,
                  lens=(7, 4, 0)):
    g = _gen(1)
    B = len(lens)

    def r(*shape, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(*shape, generator=g)).to(dtype)

    x = r(B, C_in, T)
    w = r(C_out, C_in, 3, scale=0.4)
    b = r(C_out, scale=0.3) if bias else None
    lw = r(C_out, 1, scale=0.1, shift=1.0) if affine else None
    lb = r(C_out, 1, scale=0.1) if affine else None
    return x, _mask(lens, T), w, b, lw, lb


CONV3_CASES = {
    "bias, affine, relu": (True, True, "relu"),
    "no bias, affine, relu": (False, True, "relu"),
    "bias, no affine, no act": (True, False, "none"),
    "no bias, no affine, no act": (False, False, "none"),
}


@pytest.mark.parametrize("case", list(CONV3_CASES))
def test_conv3_ln_act_gradcheck(case):
    bias, affine, act = CONV3_CASES[case]
    x, mask, w, b, lw, lb = _conv3_inputs(F64, bias, affine)
    leaves = [t.requires_grad_() for t in (x, w, b, lw, lb) if t is not None]

    def fn(*args):
        it = iter(args)
        xx, ww = next(it), next(it)
        bb = next(it) if bias else None
        lww, lbb = (next(it), next(it)) if affine else (None, None)
        return conv3_ln_act(xx, mask, ww, bb, lww, lbb, act=act)

    out = fn(*leaves)
    assert type(out.grad_fn).__name__ == "_Conv3LnActBackward"
    assert torch.autograd.gradcheck(fn, leaves, eps=1e-6, atol=1e-5)


@pytest.mark.parametrize("case", list(CONV3_CASES))
def test_conv3_ln_act_grads_equal_plain(case):
    bias, affine, act = CONV3_CASES[case]
    args = _conv3_inputs(torch.float32, bias, affine, C_in=6, C_out=8, T=11,
                         lens=(11, 5, 0))
    grads = []
    for op in (conv3_ln_act, conv3_ln_act_torch):
        leaves = [t.detach().clone().requires_grad_() if t is not None
                  and t.dtype != torch.bool else t for t in args]
        out = op(*leaves, act=act)
        out.backward(torch.cos(torch.arange(out.numel(), dtype=out.dtype))
                     .reshape(out.shape))
        grads.append([t.grad for t in leaves if t is not None
                      and t.dtype != torch.bool])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the mask gets no gradient, and absent parameters stay absent
    assert not args[1].requires_grad


def _trio_inputs(dtype, C=4, T=9, lens=(9, 6, 0)):
    g = _gen(2)
    x = torch.randn(len(lens), C, T, generator=g).to(dtype)
    ws = [(0.5 * torch.randn(C, 1, 3, generator=g)).to(dtype) for _ in range(3)]
    lws = [(1 + 0.1 * torch.randn(C, 1, generator=g)).to(dtype) for _ in range(3)]
    lbs = [(0.1 * torch.randn(C, 1, generator=g)).to(dtype) for _ in range(3)]
    return x, _mask(lens, T), ws, lws, lbs


def test_qkv_depthwise_ln_gradcheck():
    x, mask, ws, lws, lbs = _trio_inputs(F64)
    leaves = [t.requires_grad_() for t in [x, *ws, *lws, *lbs]]

    def fn(xx, *p):
        return qkv_depthwise_ln(xx, mask, p[0:3], p[3:6], p[6:9])

    outs = fn(*leaves)
    assert all(type(o.grad_fn).__name__ == "_QkvDepthwiseLnBackward"
               for o in outs)
    assert torch.autograd.gradcheck(fn, leaves, eps=1e-6, atol=1e-5)


def test_qkv_depthwise_ln_grads_equal_plain():
    args = _trio_inputs(torch.float32, C=6, T=13, lens=(13, 7, 0))
    grads = []
    for op in (qkv_depthwise_ln, qkv_depthwise_ln_torch):
        x = args[0].clone().requires_grad_()
        ps = [[t.clone().requires_grad_() for t in group] for group in args[2:]]
        q, k, v = op(x, args[1], *ps)
        (q.sum() + 2 * k.square().sum() + (v * q).sum()).backward()
        grads.append([x.grad] + [t.grad for group in ps for t in group])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _heads(base, H):
    """The (B, H, T, D) head view of a (B, C, T) projection, as
    nn/blocks.py hands q, k and v to band attention."""
    B, C, T = base.shape
    return base.reshape(B, H, C // H, T).transpose(2, 3)


@pytest.mark.parametrize("window", [3, 5])
def test_band_attention_gradcheck_on_head_views(window):
    g = _gen(3)
    lens, H, D, T = (8, 5, 0), 2, 3, 8
    bases = [torch.randn(len(lens), H * D, T, generator=g, dtype=F64)
             .requires_grad_() for _ in range(3)]
    mask = _mask(lens, T)

    def fn(qb, kb, vb):
        return band_attention(_heads(qb, H), _heads(kb, H), _heads(vb, H),
                              mask, window)

    out = fn(*bases)
    assert type(out.grad_fn).__name__ == "_BandAttentionBackward"
    assert torch.autograd.gradcheck(fn, bases, eps=1e-6, atol=1e-5)


def test_band_attention_grads_equal_plain():
    g = _gen(4)
    lens, H, D, T = (12, 9, 0, 1), 4, 8, 12
    base = [torch.randn(len(lens), H * D, T, generator=g) for _ in range(3)]
    mask = _mask(lens, T)
    grads = []
    for op in (band_attention, band_attention_torch):
        leaves = [b.clone().requires_grad_() for b in base]
        out = op(*(_heads(b, H) for b in leaves), mask, 5)
        (out * torch.sin(torch.arange(out.numel(), dtype=out.dtype))
         .reshape(out.shape)).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_kernel_ops_skip_the_function_without_grad():
    """Serve and eval (no grad, or no input that requires grad) take the op
    as before: no autograd Function is recorded."""
    x, mask, w, b, lw, lb = _conv3_inputs(torch.float32, True, True)
    assert conv3_ln_act(x, mask, w, b, lw, lb).grad_fn is None
    w.requires_grad_()
    with torch.no_grad():
        assert conv3_ln_act(x, mask, w, b, lw, lb).grad_fn is None
    with torch.inference_mode():
        assert conv3_ln_act(x, mask, w, b, lw, lb).grad_fn is None
    assert conv3_ln_act(x, mask, w, b, lw, lb).grad_fn is not None


# ------------------------------------------------------------------ dropout

def test_dropout_eval_mode_and_rate_zero_are_identity():
    x = torch.randn(3, 4, 5)
    assert dropout(x, 0.5, _gen(), training=False) is x
    assert dropout(x, 0.0, None, training=True) is x
    assert drop_path(x, 0.5, _gen(), training=False) is x
    assert drop_path(x, 0.0, None, training=True) is x
    with pytest.raises(ValueError, match="torch.Generator"):
        dropout(x, 0.5, None, training=True)


def test_dropout_same_seed_same_masks():
    x = torch.randn(4, 8, 16)
    a = dropout(x, 0.3, _gen(5), True)
    b = dropout(x, 0.3, _gen(5), True)
    c = dropout(x, 0.3, _gen(6), True)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(drop_path(x, 0.3, _gen(5), True),
                       drop_path(x, 0.3, _gen(5), True))


def test_dropout_keep_rate_and_scale():
    x = torch.full((64, 64, 64), 2.0)
    p = 0.1
    y = dropout(x, p, _gen(7), True)
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - p)) < 5e-3
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 2.0 / (1 - p)))


def test_channel_dropout_mask_is_constant_over_time():
    x = torch.randn(4, 32, 50).abs() + 0.1
    y = dropout(x, 0.5, _gen(8), True, shape=x.shape[:2] + (1,))
    dropped = y == 0
    assert dropped.any() and (~dropped).any()
    assert torch.equal(dropped, dropped[..., :1].expand_as(dropped))


def test_layer_scale_gate_is_per_sample():
    ls = LayerScale(6, pdrop=0.5).train()
    x = torch.randn(64, 6, 10)
    y = ls(x, _gen(9))
    keep = 0.5
    want = ls.scale * x / keep
    gates = []
    for i in range(x.shape[0]):
        if torch.equal(y[i], torch.zeros_like(y[i])):
            gates.append(0)
        else:
            torch.testing.assert_close(y[i], want[i], rtol=0, atol=0)
            gates.append(1)
    assert 0 < sum(gates) < len(gates)
    assert torch.equal(ls.eval()(x, _gen(9)), ls.scale * x)


# ------------------------------------------------------------ model modes

def _small_cfg(**model):
    cfg = get_cfg_defaults("grounder")
    m = cfg.model
    m.name = "iter"
    m.vid_net.in_dim, m.vid_net.embd_dim = 24, 16
    m.vid_net.max_seq_len, m.vid_net.arch = 64, (1, 0, 3)
    m.text_net.in_dim, m.text_net.embd_dim, m.text_net.n_layers = 20, 16, 1
    m.fusion.n_layers = 1
    m.sratio, m.sn, m.msf = 0.5, 8, True
    for k, v in model.items():
        m[k] = v
    return update_opt(cfg)


def _no_dropout(cfg):
    for tree in (cfg.model.vid_net, cfg.model.fusion):
        tree.proj_pdrop = tree.path_pdrop = 0.0
    cfg.model.tcn_dropout = 0.0
    return cfg


def _model_inputs(V=2, Q=2, T=64, seed=0):
    rng = np.random.RandomState(seed)
    vid = rng.randn(V, 24, T).astype(np.float32)
    shallow = rng.randn(V, 24, T).astype(np.float32)
    vm = np.zeros((V, T), bool)
    vm[0], vm[1, :T - 9] = True, True
    text = rng.randn(V * Q, 20, 12).astype(np.float32)
    tcls = rng.randn(V * Q, 24).astype(np.float32)
    tm = np.ones((V * Q, 12), bool)
    tm[-1, 6:] = False
    return [torch.from_numpy(a) for a in (vid, shallow, vm, text, tcls, tm)]


def _outputs_equal(a, b):
    return all(torch.equal(x, y) for ga, gb in zip(a, b) for x, y in zip(ga, gb))


@pytest.mark.parametrize("Q", [1, 2])
def test_train_mode_without_dropout_is_the_eval_forward(Q):
    cfg = _no_dropout(_small_cfg())
    model = init_random(make_model(cfg), 1)
    args = _model_inputs(Q=Q)
    with torch.no_grad():
        want = model.eval()(*args, queries_per_video=Q)
        got = model.train()(*args, queries_per_video=Q)
        got_gen = model(*args, queries_per_video=Q, generator=_gen(3))
    assert _outputs_equal(got, want) and _outputs_equal(got_gen, want)


def test_train_mode_dropout_draws_from_the_generator():
    cfg = _small_cfg()
    cfg.model.vid_net.cdrop = 0.3
    model = init_random(make_model(cfg), 1).train()
    args = _model_inputs()
    with torch.no_grad():
        a = model(*args, queries_per_video=2, generator=_gen(4))
        b = model(*args, queries_per_video=2, generator=_gen(4))
        c = model(*args, queries_per_video=2, generator=_gen(5))
        with pytest.raises(ValueError, match="torch.Generator"):
            model(*args, queries_per_video=2)
        want = model.eval()(*args, queries_per_video=2)
    assert _outputs_equal(a, b)
    assert not _outputs_equal(a, c) and not _outputs_equal(a, want)


def test_sfonly_applies_at_eval_only(monkeypatch):
    """A train-mode forward with ``sfonly`` set takes the full delegated
    stream (JAX decafnet.py:233): it equals the forward without sfonly, and
    only the eval forward asks delegation for the sidekick stream alone."""
    from decafnet_tpu_torch.models import decafnet

    model = init_random(make_model(_no_dropout(_small_cfg(sfonly=True))), 2)
    plain = init_random(make_model(_no_dropout(_small_cfg(sfonly=False))), 2)
    args = _model_inputs(Q=2)
    with torch.no_grad():
        train_sf = model.train()(*args, queries_per_video=2)
        full = plain.eval()(*args, queries_per_video=2)
    # train (rows, since sfonly is set) against eval (video-major)
    for a, b in zip(train_sf, full):
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=2e-5, atol=2e-6)

    asked = []
    real = decafnet.delegate
    monkeypatch.setattr(decafnet, "delegate", lambda *a, **kw: (
        asked.append(kw["sfonly"]), real(*a, **kw))[1])
    with torch.no_grad():
        model.train()(*args, queries_per_video=2)
        # the sidekick stream alone has C channels; vid_map (msf) takes 2C
        with pytest.raises(RuntimeError):
            model.eval()(*args, queries_per_video=2)
    assert asked == [False, True]


def test_train_mode_refuses_inputs_past_the_pe_table():
    cfg = _no_dropout(_small_cfg())
    model = init_random(make_model(cfg), 1)
    args = _model_inputs(Q=1, T=128)
    with torch.no_grad():
        model.eval()(*args)                      # eval interpolates the PE
        with pytest.raises(ValueError, match="PE table"):
            model.train()(*args)
    cfg.model.text_net.use_abs_pe = True
    cfg.model.text_net.max_seq_len = 8
    model = init_random(make_model(cfg), 1)
    with torch.no_grad():
        model.eval()(*_model_inputs(Q=1))
        with pytest.raises(ValueError, match="PE table"):
            model.train()(*_model_inputs(Q=1))
