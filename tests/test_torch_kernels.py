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


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_out,bias,affine,act", [
    (128, 128, False, True, "relu"), (160, 160, True, True, "relu"),
    (16, 24, True, False, "none"), (13, 40, True, True, "relu")])
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
    (13, 40, True, True, "relu")])       # C_in and C_out off the tiles
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
    with pytest.raises(ValueError):  # head width 40: no instantiation
        ops.band_attention(*_case("band_attention", 64, card, C=160))


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
