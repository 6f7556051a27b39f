"""The port's CUDA kernels against their plain PyTorch versions.

The kernel cases are marked ``cuda`` and need the card; without one they
skip. They import neither JAX nor the JAX package, so they run where only
PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

(``--noconftest``: tests/conftest.py configures JAX.) The CPU cases check
the routing rule every kernel wrapper follows."""

import math
import os

import pytest
import torch

from chip_smoke import moved
from decafnet_tpu_torch import ops
from decafnet_tpu_torch.ops import cuda, fused_conv, local_attention

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)

KERNELS = ("conv3_ln_act", "qkv_depthwise_ln", "band_attention")
# max |diff| kernel vs plain: conv3 sums 3*C_in f32 products in another order
# than cuDNN before a LayerNorm; the trio and band attention sum few terms
TOL = {"conv3_ln_act": 1e-4, "qkv_depthwise_ln": 1e-5, "band_attention": 1e-5}
# conv3 kernel vs an f64 run of the same function: its 3xTF32 products must
# keep f32 accuracy (one TF32 pass is off by ~1e-3 at these widths)
TOL_F64 = 1e-5
# bf16 kernels vs their bf16 plain versions: |diff| <= 2 bf16 eps (2 * 2**-7)
# times max(1, |plain|). Both round at the same places (the conv outputs,
# the result); their f32 sums run in another order, which can move a
# rounding by one bf16 step
TOL_BF16 = 2 * 2.0 ** -7


def _mask(lens, T, dev):
    return torch.arange(T, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]


def _case(name, T, dev, seed=0, C=160, contiguous_heads=False, how="as_is",
          B=4, dtype=torch.float32):
    """Arguments of one op at width C (band attention: 4 heads of C//4), the
    (B, C, T) input(s) in ``dtype`` and laid out as ``how`` says (see
    chip_smoke.moved); the parameters in f32."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lens = ([T, max(T - 3, 1), T // 2, 0] * B)[:B]
    mask = _mask(lens, T, dev)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    if name == "conv3_ln_act":
        return (moved(rn(B, C, T).to(dtype), how), mask,
                rn(C, C, 3) / math.sqrt(3 * C), None, 1 + 0.1 * rn(C, 1),
                0.1 * rn(C, 1))
    if name == "qkv_depthwise_ln":
        return (moved(rn(B, C, T).to(dtype), how), mask,
                [rn(C, 1, 3) for _ in range(3)],
                [1 + 0.1 * rn(C, 1) for _ in range(3)],
                [0.1 * rn(C, 1) for _ in range(3)])
    D = C // 4
    qkv = [moved((rn(B, C, T) * D ** -0.25).to(dtype), how).reshape(B, 4, D, T)
           .transpose(2, 3) for _ in range(3)]
    if contiguous_heads:
        qkv = [t.contiguous() for t in qkv]
    return (*qkv, mask, 5)


def _flat(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


# (kernel, layout of its input): the trio and band attention also take base
# pointers off 16 bytes, band attention rows padded past T
LAYOUTS = [("conv3_ln_act", "as_is"), ("qkv_depthwise_ln", "as_is"),
           ("qkv_depthwise_ln", "offset"), ("band_attention", "as_is"),
           ("band_attention", "offset"), ("band_attention", "padded")]


# batch rows: on a 132-SM H100, at the served 64 rows band attention's plan
# splits a query's D over 1 lane at T >= 1000, 2 at T=301 and 4 below; at
# 4 rows always over 4
@pytest.mark.cuda
@pytest.mark.parametrize("rows", [4, 64])
@pytest.mark.parametrize("T", [2304, 1000, 301, 72, 36, 17, 9, 3])
@pytest.mark.parametrize("name,how", LAYOUTS)
def test_kernel_matches_plain_version(card, name, how, T, rows):
    op = getattr(ops, name)
    C = 160 if name == "conv3_ln_act" else 128
    args = _case(name, T, card, C=C, how=how, B=rows)
    before = op.launches
    got = op(*args)
    assert op.launches == before + 1
    with cuda.plain_versions():
        want = op(*args)
    assert op.launches == before + 1
    torch.cuda.synchronize()
    for g, w in zip(_flat(got), _flat(want)):
        assert g.shape == w.shape
        assert torch.isfinite(g).all()
        assert float((g - w).abs().max()) <= TOL[name]


# bf16 layouts: conv3 also takes a base pointer off 16 bytes (its scalar
# staging path)
LAYOUTS_BF16 = LAYOUTS + [("conv3_ln_act", "offset")]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [4, 64])
@pytest.mark.parametrize("T", [2304, 1000, 301, 72, 36, 17, 9, 3])
@pytest.mark.parametrize("name,how", LAYOUTS_BF16)
def test_bf16_kernel_matches_plain_version(card, name, how, T, rows):
    op = getattr(ops, name)
    C = 160 if name == "conv3_ln_act" else 128
    args = _case(name, T, card, C=C, how=how, B=rows, dtype=torch.bfloat16)
    before, before_bf16 = op.launches, op.launches_bf16
    got = op(*args)
    assert (op.launches, op.launches_bf16) == (before, before_bf16 + 1)
    with cuda.plain_versions():
        want = op(*args)
    assert (op.launches, op.launches_bf16) == (before, before_bf16 + 1)
    torch.cuda.synchronize()
    for g, w in zip(_flat(got), _flat(want)):
        assert g.shape == w.shape and g.dtype == w.dtype == torch.bfloat16
        assert torch.isfinite(g).all()
        g, w = g.float(), w.float()
        assert float(((g - w).abs() / w.abs().clamp_min(1.0)).max()) <= TOL_BF16


# the MAD decode's level 0 (configs/mad.yaml): 32 query rows of one movie at
# T = 32768, conv3 at C = 128 (embedding convs, cls_head) and 160
# (cls_head2, reg_head), the trio and band attention at C = 128
MAD_ROWS, MAD_T = 32, 32768


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,C", [("conv3_ln_act", 128), ("conv3_ln_act", 160),
                                    ("qkv_depthwise_ln", 128),
                                    ("band_attention", 128)])
def test_kernel_matches_plain_version_at_mad_level0(card, name, C, dtype):
    op = getattr(ops, name)
    args = _case(name, MAD_T, card, C=C, B=MAD_ROWS, dtype=dtype)
    count = "launches_bf16" if dtype == torch.bfloat16 else "launches"
    before = getattr(op, count)
    got = op(*args)
    with cuda.plain_versions():
        want = op(*args)
    assert getattr(op, count) == before + 1
    torch.cuda.synchronize()
    for g, w in zip(_flat(got), _flat(want)):
        assert g.shape == w.shape and g.dtype == w.dtype == dtype
        assert torch.isfinite(g).all()
        g, w = g.float(), w.float()
        if dtype == torch.bfloat16:
            assert float(((g - w).abs() / w.abs().clamp_min(1.0)).max()) <= TOL_BF16
        else:
            assert float((g - w).abs().max()) <= TOL[name]


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_out,bias,affine,act", [
    (128, 128, False, True, "relu"), (160, 160, True, True, "relu"),
    (16, 24, True, False, "none"), (13, 40, True, True, "relu"),
    # C_out padded inside the 128- and 160-channel builds, and the 256 one
    (128, 96, True, True, "relu"), (160, 144, False, True, "relu"),
    (200, 256, True, True, "relu")])
@pytest.mark.parametrize("T", [2304, 301, 4])
def test_bf16_conv3_ln_act_widths(card, c_in, c_out, bias, affine, act, T):
    g = torch.Generator(device=card).manual_seed(c_in + c_out + T)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=card)

    args = (rn(4, c_in, T).bfloat16(),
            _mask([T, max(T - 3, 1), T // 2, 0], T, card),
            rn(c_out, c_in, 3) / math.sqrt(3 * c_in),
            rn(c_out) if bias else None,
            1 + 0.1 * rn(c_out, 1) if affine else None,
            0.1 * rn(c_out, 1) if affine else None)
    got = ops.conv3_ln_act(*args, act=act)
    with cuda.plain_versions():
        want = ops.conv3_ln_act(*args, act=act)
    assert got.shape == (4, c_out, T) and got.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    assert float(((got - want).abs() / want.abs().clamp_min(1.0)).max()) <= TOL_BF16


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [16, 64, 128])
@pytest.mark.parametrize("T,how", [(2304, "as_is"), (301, "offset"), (36, "as_is")])
def test_bf16_trio_every_tile_matches_plain(card, tile, T, how):
    args = _case("qkv_depthwise_ln", T, card, C=128, how=how, B=4,
                 dtype=torch.bfloat16)
    with cuda.plain_versions():
        want = ops.qkv_depthwise_ln(*args)
    got = fused_conv.launch_qkv_depthwise_ln(*args, 1e-5, tile)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g).all()
        g, w = g.float(), w.float()
        assert float(((g - w).abs() / w.abs().clamp_min(1.0)).max()) <= TOL_BF16


def _conv3_f64(x, mask, w, bias, ln_w, ln_b, act="relu", eps=1e-5):
    """conv3 + channel LN + act in f64 end to end."""
    d = torch.float64
    y = torch.nn.functional.conv1d(x.to(d) * mask[:, None, :].to(d), w.to(d),
                                   None if bias is None else bias.to(d),
                                   padding=1)
    y = y - y.mean(dim=1, keepdim=True)
    y = y * torch.rsqrt(y.square().mean(dim=1, keepdim=True) + eps)
    if ln_w is not None:
        y = y * ln_w.reshape(-1, 1).to(d) + ln_b.reshape(-1, 1).to(d)
    return torch.relu(y) if act == "relu" else y


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_out,bias,affine,act", [
    (128, 128, True, True, "relu"),      # served width, trunk layers
    (160, 160, True, True, "relu"),      # served width, cls_head2 / reg_head
    (16, 24, True, False, "none"),       # C_in != C_out, bias, no affine
    (160, 128, False, True, "relu"),
    (13, 40, True, True, "relu"),        # C_in and C_out off the tiles
    (200, 256, True, True, "relu")])     # the widest C_out
@pytest.mark.parametrize("T", [2304, 301, 4])
def test_conv3_ln_act_widths_and_f64(card, c_in, c_out, bias, affine, act, T):
    g = torch.Generator(device=card).manual_seed(c_in + c_out + T)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=card)

    args = (rn(4, c_in, T), _mask([T, max(T - 3, 1), T // 2, 0], T, card),
            rn(c_out, c_in, 3) / math.sqrt(3 * c_in),
            rn(c_out) if bias else None,
            1 + 0.1 * rn(c_out, 1) if affine else None,
            0.1 * rn(c_out, 1) if affine else None)
    got = ops.conv3_ln_act(*args, act=act)
    with cuda.plain_versions():
        want = ops.conv3_ln_act(*args, act=act)
    ref = _conv3_f64(*args, act=act)
    assert got.shape == (4, c_out, T) and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= TOL["conv3_ln_act"]
    assert float((got.double() - ref).abs().max()) <= TOL_F64


# one launch over FPN levels: the served 7-level list at 8 rows (T = 2304
# halved 6 times), and an edge list (odd T, T = 36 off and on 16 bytes, T
# shorter than a tile); every level has an all-masked row
LEVEL_LISTS = {
    "served": [(T, "as_is") for T in (2304, 1152, 576, 288, 144, 72, 36)],
    "edge": [(301, "offset"), (36, "offset"), (36, "as_is"), (17, "as_is"),
             (3, "offset")],
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [128, 160, 96, 144, 256])
@pytest.mark.parametrize("which", list(LEVEL_LISTS))
def test_conv3_levels_one_launch_matches_plain(card, which, C, dtype):
    g = torch.Generator(device=card).manual_seed(C)
    rows = 8 if which == "served" else 4
    xs, masks = [], []
    for T, how in LEVEL_LISTS[which]:
        xs.append(moved(torch.randn(rows, C, T, generator=g, device=card)
                        .to(dtype), how))
        masks.append(_mask(([T, max(T - 3, 1), T // 2, 0] * rows)[:rows], T, card))
    params = (torch.randn(C, C, 3, generator=g, device=card) / math.sqrt(3 * C),
              torch.randn(C, generator=g, device=card),
              1 + 0.1 * torch.randn(C, 1, generator=g, device=card),
              0.1 * torch.randn(C, 1, generator=g, device=card))
    op = ops.conv3_ln_act
    before = op.launches, op.launches_bf16
    got = ops.conv3_ln_act_levels(xs, masks, *params)
    bf16 = dtype == torch.bfloat16
    assert (op.launches, op.launches_bf16) == (before[0] + (not bf16),
                                               before[1] + bf16)
    for x, m, y in zip(xs, masks, got, strict=True):
        with cuda.plain_versions():
            want = op(x, m, *params)
        assert y.shape == want.shape and y.dtype == dtype
        assert torch.isfinite(y).all()
        if bf16:
            y, want = y.float(), want.float()
            assert float(((y - want).abs() / want.abs().clamp_min(1.0)).max()) \
                <= TOL_BF16
        else:
            assert float((y - want).abs().max()) <= TOL["conv3_ln_act"]
            ref = _conv3_f64(x, m, *params)
            assert float((y.double() - ref).abs().max()) <= TOL_F64


@pytest.mark.cuda
def test_conv3_weight_operands_follow_updates_on_card(card):
    conv = torch.nn.Conv1d(32, 32, 3).to(card)
    x = torch.randn(2, 32, 50, device=card)
    mask = _mask([50, 20], 50, card)
    w, b = conv.weight, conv.bias
    first = ops.conv3_ln_act(x, mask, w, b)
    with torch.no_grad():
        w.mul_(-1.0)
    second = ops.conv3_ln_act(x, mask, w, b)
    with cuda.plain_versions():
        want = ops.conv3_ln_act(x, mask, w, b)
    assert float((second - want).abs().max()) <= TOL["conv3_ln_act"]
    assert float((second - first).abs().max()) > 1e-2


def _grad_leaves(name, args):
    """Detached copies of ``args`` with every float tensor requiring grad;
    band attention's q/k/v stay head views of their own (B, C, T) bases."""
    def leaf(t):
        if not torch.is_tensor(t) or not t.is_floating_point():
            return t
        if t.dim() == 4:     # a (B, H, T, D) head view
            B, H, T, D = t.shape
            base = t.transpose(2, 3).reshape(B, H * D, T).detach().clone()
            return _HeadView(base.requires_grad_(), H)
        return t.detach().clone().requires_grad_()
    out = [[leaf(x) for x in a] if isinstance(a, list) else leaf(a)
           for a in args]
    return out


class _HeadView:
    def __init__(self, base, H):
        self.base, self.H = base, H

    def view(self):
        B, C, T = self.base.shape
        return self.base.reshape(B, self.H, C // self.H, T).transpose(2, 3)


def _call_args(args):
    return [[x.view() if isinstance(x, _HeadView) else x for x in a]
            if isinstance(a, list) else a.view() if isinstance(a, _HeadView)
            else a for a in args]


def _grad_tensors(args):
    flat = []
    for a in args:
        for x in (a if isinstance(a, list) else [a]):
            x = x.base if isinstance(x, _HeadView) else x
            if torch.is_tensor(x) and x.requires_grad:
                flat.append(x)
    return flat


def _grads(args):
    return [x.grad for x in _grad_tensors(args)]


@pytest.mark.cuda
@pytest.mark.parametrize("T", [2304, 301, 9])
@pytest.mark.parametrize("name", KERNELS)
def test_kernel_backward_matches_plain_autograd(card, name, T):
    """Under autograd the forward launches the kernel once and the backward
    launches nothing: it recomputes through the plain version, so its
    gradients are those of plain autograd for the same output gradient."""
    C = 160 if name == "conv3_ln_act" else 128
    args = _case(name, T, card, C=C, B=8)
    op, plain = getattr(ops, name), getattr(ops, name + "_torch")
    runs = []
    for fn in (op, plain):
        leaves = _grad_leaves(name, args)
        before = op.launches
        outs = _flat(fn(*_call_args(leaves)))
        launched = op.launches - before
        g = torch.Generator(device=card).manual_seed(1)
        torch.autograd.backward(outs, [torch.randn(o.shape, generator=g,
                                                   device=card) for o in outs])
        runs.append((launched, op.launches - before, _grads(leaves)))
    (k_fwd, k_all, k_grads), (p_fwd, p_all, p_grads) = runs
    assert (k_fwd, k_all, p_fwd, p_all) == (1, 1, 0, 0)
    assert len(k_grads) == len(p_grads) > 0
    for a, b in zip(k_grads, p_grads):
        assert torch.isfinite(a).all()
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-5 * max(scale, 1.0)


# bf16 ops under autograd vs plain bf16 autograd: the relative L2 distance
# of each gradient leaf. The backward recomputes through the same plain
# version, so only a rounding step of the weight gradients' sums (cuDNN's
# order) can move a leaf: one bf16 step everywhere would be 2**-8
BF16_GRAD_REL_L2 = 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("T", [2304, 301, 9])
@pytest.mark.parametrize("name", KERNELS)
def test_bf16_autograd_matches_plain_autograd(card, name, T):
    """bf16 activations and f32 parameters, as bf16 training runs the ops:
    the forward launches the bf16 kernel once (no f32 one) and the backward
    launches nothing; each gradient has its leaf's dtype (f32 for the
    parameters) and lies within BF16_GRAD_REL_L2 of plain bf16 autograd's
    for the same output gradient."""
    C = 160 if name == "conv3_ln_act" else 128
    args = _case(name, T, card, C=C, B=8, dtype=torch.bfloat16)
    op, plain = getattr(ops, name), getattr(ops, name + "_torch")
    runs = []
    for fn in (op, plain):
        leaves = _grad_leaves(name, args)
        ops.reset_launch_counts()
        outs = _flat(fn(*_call_args(leaves)))
        fwd = (op.launches, op.launches_bf16)
        assert all(o.dtype == torch.bfloat16 for o in outs)
        g = torch.Generator(device=card).manual_seed(1)
        torch.autograd.backward(outs, [torch.randn(o.shape, generator=g, device=card)
                                       .to(torch.bfloat16) for o in outs])
        runs.append((fwd, (op.launches, op.launches_bf16), _grads(leaves),
                     [x.dtype for x in _grad_tensors(leaves)]))
    (k_fwd, k_all, k_grads, k_dtypes), (p_fwd, p_all, p_grads, _) = runs
    assert (k_fwd, k_all, p_fwd, p_all) == ((0, 1), (0, 1), (0, 0), (0, 0))
    assert len(k_grads) == len(p_grads) > 0
    for a, b, dtype in zip(k_grads, p_grads, k_dtypes, strict=True):
        assert a.dtype == b.dtype == dtype and torch.isfinite(a).all()
        rel = float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))
        assert rel <= BF16_GRAD_REL_L2, (name, T, rel)


@pytest.mark.cuda
def test_conv3_weight_operands_refresh_after_optimizer_step(card):
    """The operand cache is keyed on the weight's version: the port's
    optimizer step and a load_state_dict both update the weight in place,
    and the next launch must build fresh operands."""
    from decafnet_tpu_torch.train import Optimizer

    class Layer(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.weight = torch.nn.Parameter(torch.randn(128, 128, 3) / 20)
            self.bias = torch.nn.Parameter(torch.zeros(128))

    layer = Layer().to(card)
    x = torch.randn(4, 128, 300, device=card)
    mask = _mask([300, 200, 100, 0], 300, card)
    opt = Optimizer(layer, {"name": "adamw", "lr": 0.1, "weight_decay": 0.05,
                            "clip_grad_norm": None}, lambda t: 0.1)

    def check():
        got = ops.conv3_ln_act(x, mask, layer.weight, layer.bias)
        with cuda.plain_versions():
            want = ops.conv3_ln_act(x, mask, layer.weight, layer.bias)
        assert float((got - want).abs().max()) <= TOL["conv3_ln_act"]
        return got

    first = check()
    check().sum().backward()
    opt.step()
    assert float((check() - first).abs().max()) > 1e-2
    saved = {k: v.clone() for k, v in layer.state_dict().items()}
    opt.step()
    layer.load_state_dict(saved)
    check()


@pytest.mark.cuda
def test_band_attention_contiguous_heads(card):
    args = _case("band_attention", 300, card, C=128, contiguous_heads=True)
    got = ops.band_attention(*args)
    with cuda.plain_versions():
        want = ops.band_attention(*args)
    assert float((got - want).abs().max()) <= TOL["band_attention"]


@pytest.mark.cuda
def test_band_attention_more_than_65535_heads(card):
    args = _case("band_attention", 3, card, C=128, B=16400)
    got = ops.band_attention(*args)
    with cuda.plain_versions():
        want = ops.band_attention(*args)
    assert got.shape == (16400, 4, 3, 32)
    assert float((got - want).abs().max()) <= TOL["band_attention"]


@pytest.mark.cuda
def test_kernel_rejects_bad_input(card):
    x, mask, w, b, lw, lb = _case("conv3_ln_act", 64, card, C=16)
    with pytest.raises(ValueError):
        ops.conv3_ln_act(x.transpose(1, 2).contiguous().transpose(1, 2),
                         mask, w, b, lw, lb)
    with pytest.raises(ValueError):
        ops.conv3_ln_act(x, mask.float(), w, b, lw, lb)
    with pytest.raises(ValueError):  # an even window: no band is centred
        ops.band_attention(*_case("band_attention", 64, card, C=160)[:4], 4)


# ---------------------------------------------------------------- general
# The general kernels (csrc/*_general.cu) at the shapes the tuned ones are
# not built for, and at the JAX package's own kernel-test shapes
# (tests/test_local_attention.py, tests/test_fused_conv.py), where the
# launch helpers force them.

def _assert_close(got, want, dtype, tol):
    for g, w in zip(_flat(got), _flat(want), strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype == dtype
        assert torch.isfinite(g).all()
        g, w = g.float(), w.float()
        if dtype == torch.bfloat16:
            assert float(((g - w).abs() / w.abs().clamp_min(1.0)).max()) <= TOL_BF16
        else:
            assert float((g - w).abs().max()) <= tol


def _counts(op):
    return tuple(getattr(op, a) for a in ops.COUNTERS)


def _made(op, before, route, bf16, n=1):
    """The op's counters moved by ``n`` launches of its ``route`` kernel in
    bf16 or f32, and by nothing else, since ``before`` (:func:`_counts`)."""
    attr = ("launches" + ("" if route == "tuned" else "_" + route)
            + ("_bf16" if bf16 else ""))
    want = tuple(b + n * (a == attr) for a, b in zip(ops.COUNTERS, before))
    return _counts(op) == want


def _band_general_case(card, B, D, T, window, dtype, seed, how="as_is"):
    g = torch.Generator(device=card).manual_seed(seed)
    lens = ([T, max(1, T * 3 // 5)] * B)[:B]
    qkv = [moved((torch.randn(B, 4 * D, T, generator=g, device=card)
                  * D ** -0.25).to(dtype), how).reshape(B, 4, D, T).transpose(2, 3)
           for _ in range(3)]
    return (*qkv, _mask(lens, T, card), window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,T,window,B", [
    (16, 96, 5, 2), (16, 40, 9, 2), (16, 130, 5, 2), (16, 8, 5, 2),
    (16, 7, 5, 2), (16, 7, 9, 2),            # the JAX kernel tests' shapes
    (16, 2304, 11, 64), (64, 2304, 11, 64), (128, 1152, 11, 64),
    (64, 301, 5, 4), (40, 36, 1, 4), (32, 300, 11, 4), (32, 17, 21, 4)])
def test_general_band_attention_matches_plain(card, dtype, D, T, window, B):
    """The general kernel, forced: since the wide kernels no path's shape
    routes to it (the route takes it only off their envelope: D not a
    multiple of 8 or over 256, windows over 33)."""
    args = _band_general_case(card, B, D, T, window, dtype, D + T + window)
    op = ops.band_attention
    before = _counts(op)
    got = local_attention.launch_band_attention_general(*args)
    bf16 = dtype == torch.bfloat16
    assert _made(op, before, "general", bf16)
    with cuda.plain_versions():
        want = op(*args)
    torch.cuda.synchronize()
    _assert_close(got, want, dtype, TOL["band_attention"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("how", ["offset", "padded", "contiguous"])
def test_general_band_attention_layouts(card, dtype, how):
    args = _band_general_case(card, 4, 16, 301, 5, dtype, 7,
                              "as_is" if how == "contiguous" else how)
    if how == "contiguous":
        args = (*[t.contiguous() for t in args[:3]], *args[3:])
    got = local_attention.launch_band_attention_general(*args)
    with cuda.plain_versions():
        want = ops.band_attention(*args)
    _assert_close(got, want, dtype, TOL["band_attention"])


# ---------------------------------------------------------------- wide band
# The wide band-attention kernels (csrc/band_attention_wide.cu: D a multiple
# of 8 up to 256, windows up to 33, off the tuned shape), through the route
# and at forced plans: f32 within TOL, bf16 within TOL_BF16 of max(1,
# |plain|).

WIDE_BAND_D = [8, 16, 40, 64, 128, 256]
# windows 13 and 19 (halos 6 and 9) run on the kernel's halo classes 8 and
# 16, their extra offsets masked
WIDE_BAND_WINDOWS = [1, 5, 11, 13, 19, 33]
# (T, rows): several 64-column tiles with an odd T; the served level 0 at
# a few rows; the shortest served level at 64 rows (the plan's lane split
# at D >= 128); a T inside one tile
WIDE_BAND_TB = [(301, 4), (2304, 4), (36, 64), (7, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", WIDE_BAND_WINDOWS)
@pytest.mark.parametrize("D", WIDE_BAND_D)
def test_wide_band_attention_matches_plain(card, dtype, D, window):
    op = ops.band_attention
    bf16 = dtype == torch.bfloat16
    assert local_attention.band_attention_route(D, window) == "wide"
    for T, B in WIDE_BAND_TB:
        args = _band_general_case(card, B, D, T, window, dtype, D + T + window)
        before = _counts(op)
        got = op(*args)
        assert _made(op, before, "wide", bf16)
        with cuda.plain_versions():
            want = op(*args)
        torch.cuda.synchronize()
        _assert_close(got, want, dtype, TOL["band_attention"])


def _band_wide_layout(card, dtype, D, T, window, how):
    """q, k, v of 4 rows x 4 heads as ``how`` lays them out: "offset" (a
    base one element off 16 bytes), "padded" (rows padded to 4 columns),
    "contiguous" ((B, H, T, D) tensors), "time_minor" (views of (B, H, D,
    T + 2 halo) buffers, as the time-sharded path widens a block),
    "as_is" (head views of (B, C, T))."""
    B, h = 4, window // 2
    g = torch.Generator(device=card).manual_seed(D + T)
    if how == "time_minor":
        qkv = [(torch.randn(B, 4, D, T + 2 * h, generator=g, device=card)
                * D ** -0.25).to(dtype).transpose(2, 3) for _ in range(3)]
        T = T + 2 * h
    else:
        qkv = [moved((torch.randn(B, 4 * D, T, generator=g, device=card)
                      * D ** -0.25).to(dtype), "as_is" if how == "contiguous" else how)
               .reshape(B, 4, D, T).transpose(2, 3) for _ in range(3)]
        if how == "contiguous":
            qkv = [t.contiguous() for t in qkv]
    return (*qkv, _mask([T, T - 5, T // 3, 1], T, card), window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("how", ["as_is", "offset", "padded", "contiguous", "time_minor"])
@pytest.mark.parametrize("T", [300, 301])
@pytest.mark.parametrize("D", [16, 256])
def test_wide_band_attention_layouts(card, dtype, D, T, how):
    args = _band_wide_layout(card, dtype, D, T, 5, how)
    op = ops.band_attention
    before = _counts(op)
    got = op(*args)
    assert _made(op, before, "wide", dtype == torch.bfloat16)
    with cuda.plain_versions():
        want = op(*args)
    torch.cuda.synchronize()
    _assert_close(got, want, dtype, TOL["band_attention"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,window", [(64, 5), (256, 33)])
def test_wide_band_attention_masked_rows_and_tiles(card, dtype, D, window):
    """Rows all masked, one valid column, the valid columns ending inside
    the first tile (the later tiles have no valid query and write zeros),
    and a mask with holes: every output finite, zero where the query is
    masked."""
    T = 300
    args = _band_general_case(card, 4, D, T, window, dtype, 3)
    mask = _mask([0, 1, 40, T], T, card)
    mask[3, 50:90] = False
    mask[3, 200::3] = False
    args = (*args[:3], mask, window)
    got = ops.band_attention(*args)
    with cuda.plain_versions():
        want = ops.band_attention(*args)
    torch.cuda.synchronize()
    _assert_close(got, want, dtype, TOL["band_attention"])
    assert float(got[0].float().abs().max()) == 0.0
    assert float(got[2, :, 40:].float().abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,warps,lanes", [
    (64, 1, 1), (64, 2, 1), (64, 4, 1), (64, 8, 1), (64, 2, 4), (64, 4, 2),
    (256, 8, 1), (256, 8, 2), (256, 8, 4), (256, 1, 1), (40, 5, 1), (40, 1, 1),
    (16, 1, 2), (128, 4, 4)])
def test_wide_band_attention_every_split(card, dtype, D, warps, lanes):
    """Forced plans: the dims split over 1 to 8 warps and 1, 2 or 4 lanes
    (the plans the design study compares), at a served level and a short
    one."""
    for T, B in ((576, 8), (36, 8)):
        args = _band_general_case(card, B, D, T, 11, dtype, D + warps + lanes)
        plan = local_attention.band_attention_wide_plan(
            dtype, B, 4, T, D, 5, cuda.sm_count(card), warps=warps, lanes=lanes)
        got = local_attention.launch_band_attention_wide(*args, plan=plan)
        with cuda.plain_versions():
            want = ops.band_attention(*args)
        torch.cuda.synchronize()
        _assert_close(got, want, dtype, TOL["band_attention"])


@pytest.mark.cuda
def test_wide_band_entry_refuses_outside_its_envelope(card):
    """The C entry returns cudaErrorInvalidValue (1) for a D off 8, a halo
    over 16, a split that does not divide D, and launches nothing."""
    q, k, v, mask, _ = _band_general_case(card, 2, 64, 40, 5, torch.float32, 0)
    out = torch.empty(2, 4, 64, 40, device=card)
    lib = cuda.library()

    def call(D, halo, warps, lanes):
        return lib.decafnet_band_attention_wide_f32(
            cuda.ptr(q), cuda.ptr(k), cuda.ptr(v), cuda.ptr(cuda.as_bytes(mask)),
            cuda.ptr(out), 2, 4, 40, D, *q.stride(), halo, warps, lanes, cuda.stream())

    assert call(64, 2, 8, 1) == 0
    torch.cuda.synchronize()
    for bad in ((60, 2, 1, 1), (264, 2, 1, 1), (64, 17, 1, 1), (64, 2, 3, 1),
                (64, 2, 8, 2), (64, 2, 9, 1), (64, 2, 1, 3)):
        assert call(*bad) == 1, bad


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [2304, 301, 9])
def test_wide_band_attention_autograd(card, dtype, T):
    """Under autograd the forward launches the wide kernel once and the
    backward nothing: it recomputes through the plain version, so the
    gradients are plain autograd's for the same output gradient (bf16:
    within BF16_GRAD_REL_L2)."""
    args = _band_general_case(card, 8, 64, T, 5, dtype, T)
    op = ops.band_attention
    runs = []
    for fn in (op, ops.band_attention_torch):
        leaves = _grad_leaves("band_attention", args)
        ops.reset_launch_counts()
        out = fn(*_call_args(leaves))
        fwd = ops.launch_counts(dtype, "wide")["band_attention"]
        g = torch.Generator(device=card).manual_seed(1)
        torch.autograd.backward([out], [torch.randn(out.shape, generator=g,
                                                    device=card).to(dtype)])
        runs.append((fwd, ops.launch_counts(dtype, "wide")["band_attention"],
                     _grads(leaves)))
    (k_fwd, k_all, k_grads), (p_fwd, p_all, p_grads) = runs
    assert (k_fwd, k_all, p_fwd, p_all) == (1, 1, 0, 0)
    assert len(k_grads) == len(p_grads) == 3
    for a, b in zip(k_grads, p_grads):
        assert torch.isfinite(a).all()
        if dtype == torch.bfloat16:
            rel = float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))
            assert rel <= BF16_GRAD_REL_L2
        else:
            assert float((a - b).abs().max()) <= 1e-5 * max(float(b.abs().max()), 1.0)


@pytest.mark.cuda
def test_band_routes_count_apart(card):
    """Each band route counts its own launches, by dtype: D 32 at window 5
    tuned, D 16 and 64 wide, D 12 and window 35 general."""
    ops.reset_launch_counts()
    for D, window, dtype in ((32, 5, torch.float32), (16, 5, torch.float32),
                             (64, 11, torch.bfloat16), (12, 5, torch.float32),
                             (64, 35, torch.bfloat16)):
        ops.band_attention(*_band_general_case(card, 2, D, 50, window, dtype, D)[:4],
                           window)
    want = {("tuned", torch.float32): 1, ("wide", torch.float32): 1,
            ("wide", torch.bfloat16): 1, ("general", torch.float32): 1,
            ("general", torch.bfloat16): 1}
    for route in ops.ROUTES:
        for dtype in (torch.float32, torch.bfloat16):
            assert ops.launch_counts(dtype, route)["band_attention"] == \
                want.get((route, dtype), 0), (route, dtype)


def _conv3_general_case(card, B, c_in, c_out, T, lens, dtype, seed, bias=True,
                        affine=True):
    g = torch.Generator(device=card).manual_seed(seed)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=card)

    return (rn(B, c_in, T).to(dtype), _mask(lens, T, card),
            rn(c_out, c_in, 3) / math.sqrt(3 * c_in),
            rn(c_out) if bias else None,
            1 + 0.1 * rn(c_out, 1) if affine else None,
            0.1 * rn(c_out, 1) if affine else None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c_in,c_out,T,bias,affine,act", [
    (16, 24, 100, True, True, "relu"), (16, 24, 256, True, False, "none"),
    (16, 24, 700, False, True, "relu"),      # the JAX kernel tests' shapes
    (288, 288, 301, True, True, "relu"), (256, 288, 2304, True, True, "relu"),
    (544, 544, 1000, True, True, "relu"), (13, 2000, 37, True, True, "relu"),
    (64, 1100, 300, False, True, "relu"),    # the pass kernels' C_out
    (8, 4100, 40, True, True, "relu")])      # above the pass kernels' C_out
def test_general_conv3_matches_plain_and_f64(card, dtype, c_in, c_out, T, bias,
                                             affine, act):
    args = _conv3_general_case(card, 2, c_in, c_out, T, [T, int(0.6 * T)],
                               dtype, c_in + c_out + T, bias, affine)
    op = ops.conv3_ln_act
    before = _counts(op)
    got = fused_conv.launch_conv3_ln_act_general(
        [args[0]], [args[1]], *args[2:], act, 1e-5)[0]
    bf16 = dtype == torch.bfloat16
    assert _made(op, before, "general", bf16)
    if fused_conv.conv3_route(c_out) == "general":
        assert float((op(*args, act=act) - got).float().abs().max()) == 0.0
    with cuda.plain_versions():
        want = op(*args, act=act)
    torch.cuda.synchronize()
    _assert_close(got, want, dtype, TOL["conv3_ln_act"])
    if not bf16:
        ref = _conv3_f64(*args, act=act)
        assert float((got.double() - ref).abs().max()) <= TOL_F64


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [160, 288, 544])
def test_conv3_nine_levels_launch_twice(card, dtype, C):
    """Nine levels (more than CONV3_MAX_LEVELS) take two launches of the
    routed kernel, the first over 8 levels."""
    g = torch.Generator(device=card).manual_seed(C)
    Ts = [2304 // 2 ** lvl for lvl in range(9)]
    xs = [torch.randn(4, C, T, generator=g, device=card).to(dtype) for T in Ts]
    masks = [_mask([T, max(T - 3, 1), T // 2, 0], T, card) for T in Ts]
    params = (torch.randn(C, C, 3, generator=g, device=card) / math.sqrt(3 * C),
              None, 1 + 0.1 * torch.randn(C, 1, generator=g, device=card),
              0.1 * torch.randn(C, 1, generator=g, device=card))
    op = ops.conv3_ln_act
    before = _counts(op)
    got = ops.conv3_ln_act_levels(xs, masks, *params)
    assert _made(op, before, fused_conv.conv3_route(C), dtype == torch.bfloat16, 2)
    for x, m, y in zip(xs, masks, got, strict=True):
        with cuda.plain_versions():
            want = op(x, m, *params)
        _assert_close(y, want, dtype, TOL["conv3_ln_act"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,T,how", [
    (16, 200, "as_is"), (16, 384, "as_is"),  # the JAX kernel tests' shapes
    (320, 301, "offset"), (512, 2304, "as_is"), (512, 7, "as_is")])
def test_general_trio_matches_plain(card, dtype, C, T, how):
    args = _case("qkv_depthwise_ln", T, card, C=C, how=how, B=4, dtype=dtype)
    op = ops.qkv_depthwise_ln
    before = _counts(op)
    got = fused_conv.launch_qkv_depthwise_ln_general(*args, 1e-5)
    bf16 = dtype == torch.bfloat16
    assert _made(op, before, "general", bf16)
    with cuda.plain_versions():
        want = op(*args)
    torch.cuda.synchronize()
    _assert_close(got, want, dtype, TOL["qkv_depthwise_ln"])


# ------------------------------------------------------------------- wide
# The wide conv3 kernels (csrc/conv3_ln_act_wide.cu: C_out 257 to 1024, a
# thread-block cluster of 2 to 4 blocks splitting the channels), through the
# route and, at narrower widths (one block a cluster), forced.

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c_in,c_out,T,bias,affine,act", [
    (256, 264, 301, True, True, "relu"), (256, 288, 2304, False, True, "relu"),
    (288, 288, 37, True, False, "none"), (16, 300, 700, True, True, "relu"),
    (512, 512, 1000, False, True, "relu"), (544, 544, 2304, False, True, "relu"),
    (100, 544, 17, True, True, "none"), (128, 1024, 500, True, True, "relu"),
    (37, 777, 36, False, False, "relu")])
def test_wide_conv3_matches_plain_and_f64(card, dtype, c_in, c_out, T, bias,
                                          affine, act):
    args = _conv3_general_case(card, 4, c_in, c_out, T,
                               [T, max(T - 3, 1), T // 2, 0], dtype,
                               c_in + c_out + T, bias, affine)
    assert fused_conv.conv3_route(c_out) == "wide"
    op = ops.conv3_ln_act
    before = _counts(op)
    got = op(*args, act=act)
    bf16 = dtype == torch.bfloat16
    assert _made(op, before, "wide", bf16)
    with cuda.plain_versions():
        want = op(*args, act=act)
    torch.cuda.synchronize()
    _assert_close(got, want, dtype, TOL["conv3_ln_act"])
    if not bf16:
        ref = _conv3_f64(*args, act=act)
        assert float((got.double() - ref).abs().max()) <= TOL_F64


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c_in,c_out,T", [
    (16, 24, 100), (16, 24, 700),            # the JAX kernel tests' shapes
    (160, 160, 301), (128, 200, 36), (64, 256, 2304)])
def test_wide_conv3_forced_at_narrow_widths(card, dtype, c_in, c_out, T):
    """The tuned kernels' widths through the wide ones: clusters of one
    block (f32 up to 256 channels, bf16 up to 144, the exchange among one)
    and of two (bf16 above 144)."""
    args = _conv3_general_case(card, 2, c_in, c_out, T, [T, int(0.6 * T)],
                               dtype, c_in + c_out + T)
    widest = 144 if dtype == torch.bfloat16 else 256
    assert fused_conv.conv3_wide_plan(dtype, c_out).cluster == -(-c_out // widest)
    got = fused_conv.launch_conv3_ln_act_wide([args[0]], [args[1]], *args[2:],
                                              "relu", 1e-5)[0]
    with cuda.plain_versions():
        want = ops.conv3_ln_act(*args)
    torch.cuda.synchronize()
    _assert_close(got, want, dtype, TOL["conv3_ln_act"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [288, 544, 1024])
@pytest.mark.parametrize("which", list(LEVEL_LISTS))
def test_wide_conv3_levels_one_launch_matches_plain(card, which, C, dtype):
    """One launch over the served 7-level list and over the edge list (odd
    T, x off 16 bytes, T shorter than a tile), against the plain version
    and f64."""
    g = torch.Generator(device=card).manual_seed(C + 1)
    rows = 8 if which == "served" else 4
    xs, masks = [], []
    for T, how in LEVEL_LISTS[which]:
        xs.append(moved(torch.randn(rows, C, T, generator=g, device=card)
                        .to(dtype), how))
        masks.append(_mask(([T, max(T - 3, 1), T // 2, 0] * rows)[:rows], T, card))
    params = (torch.randn(C, C, 3, generator=g, device=card) / math.sqrt(3 * C),
              None, 1 + 0.1 * torch.randn(C, 1, generator=g, device=card),
              0.1 * torch.randn(C, 1, generator=g, device=card))
    op = ops.conv3_ln_act
    before = _counts(op)
    got = ops.conv3_ln_act_levels(xs, masks, *params)
    bf16 = dtype == torch.bfloat16
    assert _made(op, before, "wide", bf16)
    for x, m, y in zip(xs, masks, got, strict=True):
        with cuda.plain_versions():
            want = op(x, m, *params)
        _assert_close(y, want, dtype, TOL["conv3_ln_act"])
        if not bf16:
            ref = _conv3_f64(x, m, *params)
            assert float((y.double() - ref).abs().max()) <= TOL_F64


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_conv3_weight_operands_follow_updates(card, dtype):
    """The sliced weight images are cached against the weight's version: an
    in-place update builds fresh ones."""
    conv = torch.nn.Conv1d(64, 544, 3).to(card)
    x = torch.randn(2, 64, 300, device=card).to(dtype)
    mask = _mask([300, 120], 300, card)
    w, b = conv.weight, conv.bias
    first = ops.conv3_ln_act(x, mask, w, b)
    assert fused_conv.conv3_wide_operands(w, dtype) is \
        fused_conv.conv3_wide_operands(w, dtype)
    with torch.no_grad():
        w.mul_(-1.0)
    second = ops.conv3_ln_act(x, mask, w, b)
    with cuda.plain_versions():
        want = ops.conv3_ln_act(x, mask, w, b)
    _assert_close(second, want, dtype, TOL["conv3_ln_act"])
    assert float((second.float() - first.float()).abs().max()) > 1e-2


@pytest.mark.cuda
def test_wide_plan_matches_the_kernel_source(card):
    """The wrapper's mirror of the wide kernels' plan is the one the source
    computes, at every C_out the kernels take, in both dtypes; the source
    refuses the rest."""
    for dtype in (torch.float32, torch.bfloat16):
        for C_out in range(1, fused_conv.CONV3_WIDE_MAX_C + 1):
            assert fused_conv.conv3_wide_source_plan(dtype, C_out) == \
                fused_conv.conv3_wide_plan(dtype, C_out), (dtype, C_out)
        with pytest.raises(ValueError):
            fused_conv.conv3_wide_source_plan(dtype, fused_conv.CONV3_WIDE_MAX_C + 1)


@pytest.mark.cuda
def test_wide_shapes_route_to_the_general_kernels(card):
    """The wrappers route the trio at C 257 to 4096 to the wide kernel and
    above that to the general one, band attention at D 16 to the wide one
    and at D 12 to the general one, conv3 at C_out 257 to 1024 to the wide
    ones, to 4096 to the pass ones and above that to the general one, on
    their own; nothing raises."""
    ops.reset_launch_counts()
    ops.qkv_depthwise_ln(*_case("qkv_depthwise_ln", 64, card, C=320))
    ops.qkv_depthwise_ln(*_case("qkv_depthwise_ln", 64, card, C=4100))
    ops.conv3_ln_act(*_case("conv3_ln_act", 64, card, C=288))
    ops.band_attention(*_case("band_attention", 64, card, C=64))
    ops.band_attention(*_case("band_attention", 64, card, C=48))
    assert ops.launch_counts(route="general") == {
        "conv3_ln_act": 0, "band_attention": 1, "qkv_depthwise_ln": 1}
    assert ops.launch_counts(route="wide") == {
        "conv3_ln_act": 1, "band_attention": 1, "qkv_depthwise_ln": 1}
    ops.conv3_ln_act(*_case("conv3_ln_act", 64, card, C=1040))
    assert ops.launch_counts(route="passes")["conv3_ln_act"] == 1
    assert ops.launch_counts(route="general")["conv3_ln_act"] == 0
    x, mask, w, b, lw, lb = _conv3_general_case(card, 2, 8, 4100, 40, [40, 17],
                                                torch.float32, 4100)
    ops.conv3_ln_act(x, mask, w, b, lw, lb)
    assert ops.launch_counts(route="general")["conv3_ln_act"] == 1
    assert ops.launch_counts() == {
        "conv3_ln_act": 0, "band_attention": 0, "qkv_depthwise_ln": 0}


# ------------------------------------------------------------------- passes
# The pass conv3 kernels (csrc/conv3_ln_act_passes.cu: C_out 1025 to 4096,
# one block per 128-column item computing the channels in passes of 128 or
# 160), through the route and, at narrower widths (one pass or a few),
# forced.

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("c_in,c_out,T,n_levels", [
    (64, 1025, 301, 1), (1056, 1056, 2304, 1), (128, 1056, 2304, 7),
    (96, 2048, 500, 7), (32, 2048, 100, 9), (16, 4096, 64, 1)])
def test_passes_conv3_matches_plain_and_f64(card, dtype, bias, c_in, c_out, T,
                                            n_levels):
    """One launch over 1 or 7 levels of T, T/2, ... (two over 9), with and
    without a bias, against the plain version and f64."""
    g = torch.Generator(device=card).manual_seed(c_in + c_out + T + n_levels)
    Ts = [max(1, T >> lvl) for lvl in range(n_levels)]
    xs = [torch.randn(2, c_in, t, generator=g, device=card).to(dtype) for t in Ts]
    masks = [_mask([t, max(t - 3, 1)], t, card) for t in Ts]
    params = (torch.randn(c_out, c_in, 3, generator=g, device=card) / math.sqrt(3 * c_in),
              torch.randn(c_out, generator=g, device=card) if bias else None,
              1 + 0.1 * torch.randn(c_out, 1, generator=g, device=card),
              0.1 * torch.randn(c_out, 1, generator=g, device=card))
    assert fused_conv.conv3_route(c_out) == "passes"
    op = ops.conv3_ln_act
    before = _counts(op)
    got = ops.conv3_ln_act_levels(xs, masks, *params)
    bf16 = dtype == torch.bfloat16
    assert _made(op, before, "passes", bf16, -(-n_levels // fused_conv.CONV3_MAX_LEVELS))
    for x, m, y in zip(xs, masks, got, strict=True):
        with cuda.plain_versions():
            want = op(x, m, *params)
        _assert_close(y, want, dtype, TOL["conv3_ln_act"])
        if not bf16:
            ref = _conv3_f64(x, m, *params)
            assert float((y.double() - ref).abs().max()) <= TOL_F64


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [1025, 1056])
@pytest.mark.parametrize("which", list(LEVEL_LISTS))
def test_passes_conv3_levels_one_launch_matches_plain(card, which, C, dtype):
    """One launch over the served 7-level list and over the edge list (odd
    T, x off 16 bytes, T shorter than a tile), against the plain version
    and f64."""
    g = torch.Generator(device=card).manual_seed(C + 2)
    rows = 4 if which == "served" else 3
    xs, masks = [], []
    for T, how in LEVEL_LISTS[which]:
        xs.append(moved(torch.randn(rows, 96, T, generator=g, device=card)
                        .to(dtype), how))
        masks.append(_mask(([T, max(T - 3, 1), T // 2, 0] * rows)[:rows], T, card))
    params = (torch.randn(C, 96, 3, generator=g, device=card) / math.sqrt(3 * 96),
              torch.randn(C, generator=g, device=card),
              1 + 0.1 * torch.randn(C, 1, generator=g, device=card),
              0.1 * torch.randn(C, 1, generator=g, device=card))
    op = ops.conv3_ln_act
    before = _counts(op)
    got = ops.conv3_ln_act_levels(xs, masks, *params)
    bf16 = dtype == torch.bfloat16
    assert _made(op, before, "passes", bf16)
    for x, m, y in zip(xs, masks, got, strict=True):
        with cuda.plain_versions():
            want = op(x, m, *params)
        _assert_close(y, want, dtype, TOL["conv3_ln_act"])
        if not bf16:
            ref = _conv3_f64(x, m, *params)
            assert float((y.double() - ref).abs().max()) <= TOL_F64


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c_in,c_out,T,how", [
    (16, 24, 100, "as_is"), (16, 24, 700, "offset"),   # the JAX kernel tests' shapes
    (160, 160, 301, "offset"), (13, 200, 36, "as_is"), (64, 1024, 2304, "as_is")])
def test_passes_conv3_forced_at_narrow_widths(card, dtype, c_in, c_out, T, how):
    """The other routes' widths through the pass kernels: one pass (up to
    160 channels) or several."""
    args = _conv3_general_case(card, 2, c_in, c_out, T, [T, int(0.6 * T)],
                               dtype, c_in + c_out + T)
    args = (moved(args[0], how), *args[1:])
    got = fused_conv.launch_conv3_ln_act_passes([args[0]], [args[1]], *args[2:],
                                                "relu", 1e-5)[0]
    with cuda.plain_versions():
        want = ops.conv3_ln_act(*args)
    torch.cuda.synchronize()
    _assert_close(got, want, dtype, TOL["conv3_ln_act"])
    if dtype == torch.float32:
        assert float((got.double() - _conv3_f64(*args)).abs().max()) <= TOL_F64


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_passes_conv3_weight_operands_follow_updates(card, dtype):
    """The pass weight images are cached against the weight's version: an
    in-place update builds fresh ones."""
    conv = torch.nn.Conv1d(64, 1056, 3).to(card)
    x = torch.randn(2, 64, 300, device=card).to(dtype)
    mask = _mask([300, 120], 300, card)
    w, b = conv.weight, conv.bias
    first = ops.conv3_ln_act(x, mask, w, b)
    assert fused_conv.conv3_passes_operands(w, dtype) is \
        fused_conv.conv3_passes_operands(w, dtype)
    with torch.no_grad():
        w.mul_(-1.0)
    second = ops.conv3_ln_act(x, mask, w, b)
    with cuda.plain_versions():
        want = ops.conv3_ln_act(x, mask, w, b)
    _assert_close(second, want, dtype, TOL["conv3_ln_act"])
    assert float((second.float() - first.float()).abs().max()) > 1e-2


@pytest.mark.cuda
def test_passes_plan_matches_the_kernel_source(card):
    """The wrapper's mirror of the pass kernels' plan is the one the source
    computes, at every C_out the kernels take, in both dtypes; the source
    refuses the rest."""
    for dtype in (torch.float32, torch.bfloat16):
        for C_out in range(1, fused_conv.CONV3_PASSES_MAX_C + 1):
            assert fused_conv.conv3_passes_source_plan(dtype, C_out) == \
                fused_conv.conv3_passes_plan(dtype, C_out), (dtype, C_out)
        for C_out in (0, fused_conv.CONV3_PASSES_MAX_C + 1):
            with pytest.raises(ValueError):
                fused_conv.conv3_passes_source_plan(dtype, C_out)


def test_launch_helpers_refuse_cpu_tensors():
    """The launch helpers bypass the routing rule, so they check the device
    themselves before any pointer reaches the library."""
    q, k, v, mask, window = _case("band_attention", 40, torch.device("cpu"),
                                  C=128)
    with pytest.raises(ValueError, match="CUDA"):
        local_attention.launch_band_attention(q, k, v, mask, window, (64, 4))
    x, mask, ws, lws, lbs = _case("qkv_depthwise_ln", 40, torch.device("cpu"),
                                  C=16)
    with pytest.raises(ValueError, match="CUDA"):
        fused_conv.launch_qkv_depthwise_ln(x, mask, ws, lws, lbs, 1e-5, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fused_conv.launch_qkv_depthwise_ln_general(x, mask, ws, lws, lbs, 1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        fused_conv.launch_qkv_depthwise_ln_wide(
            x, mask, ws, lws, lbs, 1e-5, fused_conv.qkv_wide_plan(16, 40))
    with pytest.raises(ValueError, match="CUDA"):
        local_attention.launch_band_attention_general(q, k, v, mask[:, :40],
                                                      window)
    with pytest.raises(ValueError, match="CUDA"):
        local_attention.launch_band_attention_wide(q, k, v, mask[:, :40], window)
    x, mask, w, b, lw, lb = _case("conv3_ln_act", 40, torch.device("cpu"), C=16)
    with pytest.raises(ValueError, match="CUDA"):
        fused_conv.launch_conv3_ln_act_general([x], [mask], w, b, lw, lb,
                                               "relu", 1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        fused_conv.launch_conv3_ln_act_wide([x], [mask], w, b, lw, lb,
                                            "relu", 1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        fused_conv.launch_conv3_ln_act_passes([x], [mask], w, b, lw, lb,
                                              "relu", 1e-5)


@pytest.mark.parametrize("name", KERNELS)
def test_cpu_tensors_take_the_plain_version(name):
    op, plain = getattr(ops, name), getattr(ops, name + "_torch")
    args = _case(name, 40, torch.device("cpu"), C=16)
    before = op.launches
    got, want = _flat(op(*args)), _flat(plain(*args))
    assert op.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", KERNELS)
def test_bf16_cpu_tensors_take_the_plain_version(name):
    op, plain = getattr(ops, name), getattr(ops, name + "_torch")
    args = _case(name, 40, torch.device("cpu"), C=16, dtype=torch.bfloat16)
    before = op.launches, op.launches_bf16
    got, want = _flat(op(*args)), _flat(plain(*args))
    assert (op.launches, op.launches_bf16) == before
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and torch.equal(g, w)


def test_plain_versions_hook_restores_routing():
    x = torch.zeros(1)
    assert cuda.use_kernel(x) is False
    with cuda.plain_versions():
        with cuda.plain_versions():
            assert cuda._ROUTE.plain
        assert cuda._ROUTE.plain
    assert not cuda._ROUTE.plain
    with pytest.raises(ValueError):
        cuda.use_kernel(torch.zeros(1, device="meta"))


def test_library_path_is_keyed_by_sources():
    path = cuda.library_path()
    assert path == cuda.library_path()
    assert path.startswith(cuda.BUILD_DIR + os.sep)
    assert path.endswith(cuda.LIB_NAME)
    assert {os.path.basename(s) for s in cuda.sources()} >= {
        "conv3_ln_act.cu", "qkv_depthwise_ln.cu", "band_attention.cu"}
