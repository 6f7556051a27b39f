"""The 3xTF32 operands of the port's conv3 kernel, on the CPU.

csrc/conv3_ln_act.cu runs its products on the tensor cores as three TF32
passes (lo*hi + hi*lo + hi*hi of hi = tf32(a), lo = tf32(a - hi)), on
weight halves that ops/fused_conv.py rounds and lays out once per weight.
These tests hold the rounding to ``cvt.rna.tf32.f32``, the layout to the
A fragment of ``mma.sync.m16n8k8`` as the PTX ISA states it, the three-pass
arithmetic to the JAX package's XLA composition at 1e-5, and the cache to
the weight's in-place updates. The kernel itself is held against its plain
version and f64 on the card in tests/test_torch_kernels.py."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from decafnet_tpu.ops import fused_conv as jfc
from decafnet_tpu_torch.ops import fused_conv as tfc
from decafnet_tpu_torch.ops.masked import channel_layer_norm

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)


def _bits(a):
    return a.contiguous().view(torch.int32)


def _rna_f64(a):
    """tf32 rounding in f64 arithmetic: nearest multiple of the tf32 ulp
    (2^(e - 10)), ties away from zero."""
    a = np.asarray(a, np.float64)
    mag = np.abs(a)
    ulp = np.exp2(np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 10)
    return np.sign(a) * np.floor(mag / ulp + 0.5) * ulp


def _randn(seed, *shape, scale=1.0):
    return torch.from_numpy(
        (scale * np.random.RandomState(seed).randn(*shape)).astype(np.float32))


@pytest.mark.parametrize("scale", [1e-4, 1.0, 3e4])
def test_split_hi_has_zero_low_mantissa_bits(scale):
    hi, lo = tfc.tf32_split(_randn(0, 4096, scale=scale))
    assert int((_bits(hi) & 0x1FFF).abs().max()) == 0
    assert int((_bits(lo) & 0x1FFF).abs().max()) == 0


@pytest.mark.parametrize("scale", [1e-4, 1.0, 3e4])
def test_split_halves_sum_to_input(scale):
    a = _randn(1, 4096, scale=scale)
    hi, lo = tfc.tf32_split(a)
    a64, s64 = a.double(), hi.double() + lo.double()
    assert float(((s64 - a64).abs() / a64.abs()).max()) <= 2.0 ** -22


def test_split_rounds_to_nearest_ties_away():
    one_ulp = 2.0 ** -10                      # tf32 ulp of [1, 2)
    ties = np.array([1 + one_ulp / 2, -(1 + one_ulp / 2),
                     1 + 3 * one_ulp / 2, 2 - 2.0 ** -23, 0.0, -0.0],
                    np.float32)
    a = np.concatenate([ties, np.random.RandomState(2).randn(4096)
                        .astype(np.float32)])
    hi, _ = tfc.tf32_split(torch.from_numpy(a))
    np.testing.assert_array_equal(hi.numpy().astype(np.float64), _rna_f64(a))
    # ties go away from zero, not to even: 1 + ulp/2 -> 1 + ulp
    assert hi[0] == 1 + one_ulp and hi[1] == -(1 + one_ulp)
    assert hi[3] == 2.0


def _unfragment(f):
    """(ceil(C_in/8), 3, M/16, 32, 4) fragments back to (M, C_in8, 3) by
    the PTX ISA's m16n8k8 .tf32 A layout: lane = 4 * groupID + tid_in_group,
    a0 = (row g, col q), a1 = (g + 8, q), a2 = (g, q + 4), a3 = (g + 8, q + 4)."""
    f = np.asarray(f)
    nc8, _, mt = f.shape[:3]
    w = np.full((16 * mt, 8 * nc8, 3), np.nan, f.dtype)
    for lane in range(32):
        g, q = lane // 4, lane % 4
        for i, (dr, dc) in enumerate([(0, 0), (8, 0), (0, 4), (8, 4)]):
            rows = 16 * np.arange(mt) + g + dr
            cols = 8 * np.arange(nc8) + q + dc
            w[rows[:, None, None], cols[None, :, None],
              np.arange(3)[None, None, :]] = f[:, :, :, lane, i].transpose(2, 0, 1)
    return w


@pytest.mark.parametrize("c_in,c_out", [(160, 160), (128, 128), (16, 24),
                                        (13, 40)])
def test_fragments_follow_the_mma_a_layout(c_in, c_out):
    w = _randn(3, c_out, c_in, 3)
    f = tfc.conv3_weight_fragments(w)
    m = 32 * -(-c_out // 32)
    assert f.shape == (-(-c_in // 8), 3, m // 16, 32, 4) and f.is_contiguous()
    got = _unfragment(f)
    want = np.zeros_like(got)
    want[:c_out, :c_in] = w.numpy()
    np.testing.assert_array_equal(got, want)


def _inputs(c, t, seed=4):
    rng = np.random.RandomState(seed)
    x = rng.randn(4, c, t).astype(np.float32)
    mask = np.zeros((4, t), bool)
    for i, n in enumerate((t, t - 3, t // 2 + 1, 0)):
        mask[i, :n] = True
    w = (rng.randn(c, c, 3) / np.sqrt(3 * c)).astype(np.float32)
    b = rng.randn(c).astype(np.float32)
    ln_w = (1 + 0.1 * rng.randn(c, 1)).astype(np.float32)
    ln_b = (0.1 * rng.randn(c, 1)).astype(np.float32)
    return x, mask, w, b, ln_w, ln_b


def _three_pass(x, mask, w, b, ln_w, ln_b):
    """conv3 + LN + ReLU with the kernel's arithmetic in f32: x * mask split
    in hi/lo, the weight halves taken from the kernel's operands, the three
    products lo*hi + hi*lo + hi*hi (each exact in f32), f32 sums."""
    c_out, c_in, _ = w.shape
    xh, xl = tfc.tf32_split(x * mask[:, None, :].float())
    wh, wl = (torch.from_numpy(_unfragment(h)[:c_out, :c_in].copy())
              for h in tfc.conv3_weight_operands(w))
    y = (F.conv1d(xh, wl, padding=1) + F.conv1d(xl, wh, padding=1)
         + F.conv1d(xh, wh, padding=1) + b[:, None])
    return torch.relu(channel_layer_norm(y, ln_w, ln_b))


def test_three_pass_emulation_matches_xla():
    args = _inputs(160, 256)
    got = _three_pass(*map(torch.from_numpy, args))
    want = jfc.conv3_ln_act_xla(*map(jnp.asarray, args), act="relu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_operands_follow_in_place_updates():
    conv = torch.nn.Conv1d(16, 24, 3)
    w = conv.weight
    first = tfc.conv3_weight_operands(w)
    assert tfc.conv3_weight_operands(w) is first        # cached

    def fresh(ops):
        want = tfc.tf32_split(tfc.conv3_weight_fragments(w.detach()))
        return all(torch.equal(a, b) for a, b in zip(ops, want))

    with torch.no_grad():
        w.add_(0.5)
    second = tfc.conv3_weight_operands(w)
    assert second is not first and fresh(second)
    assert not torch.equal(second[0], first[0])

    state = {k: v + 1.0 for k, v in conv.state_dict().items()}
    conv.load_state_dict(state)
    third = tfc.conv3_weight_operands(w)
    assert third is not second and fresh(third)
    assert tfc.conv3_weight_operands(w) is third


def test_inference_tensors_are_not_cached():
    with torch.inference_mode():
        w = _randn(5, 24, 16, 3)
        a, b = tfc.conv3_weight_operands(w), tfc.conv3_weight_operands(w)
    assert a is not b and all(torch.equal(x, y) for x, y in zip(a, b))
