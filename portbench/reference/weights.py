"""The benchmark's own seeded weights for DeCafNet's ``iter`` grounder.

:func:`param_spec` lists every parameter of the model (the released
checkpoint's torch key names and the flax tree's shapes) from the config
alone. :func:`make_weights` fills them from one uniform draw of a
``torch.Generator`` seeded by ``--seed``, on the device the generator lives
on, in float32 (the served parameters' type). :func:`flax_tree` turns the
flat dict into the nested numpy tree that ``GroundingService(params=...)``
loads; the reference reads the flat dict itself.

The draw is not the model's training initialisation: the residual scales
(LayerScale, init 1e-4 in training) and the LayerNorm affines are drawn
wide, so that every block, attention and FFN included, moves the output by
a visible amount and a fault in any of them shows in the detections; and
the regression head's bias is drawn positive, so that its offsets, like a
trained model's, are mostly well above zero and few candidate segments sit
at the decode's minimum length, where a rounding would drop or keep them.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch

# per kind of leaf: (low, high) of the uniform draw; "fan" draws
# U(+-1/sqrt(fan_in)), fan_in = shape[1] * shape[2] of the conv weight
KINDS = {
    "conv": "fan",
    "bias": "fan",
    "ln_w": (0.5, 1.5),
    "ln_b": (-0.2, 0.2),
    "layer_scale": (0.1, 0.6),
    "scale": (0.5, 1.5),
    "token": (-1.0, 1.0),
    "offset_bias": (1.0, 3.0),
}


def _conv(spec, name, c_out, c_in, k, bias=True):
    spec.append((f"{name}.weight", (c_out, c_in, k), "conv", c_in * k))
    if bias:
        spec.append((f"{name}.bias", (c_out,), "bias", c_in * k))


def _ln(spec, name, c, torch_style=False):
    shape = (c,) if torch_style else (c, 1)
    spec.append((f"{name}.weight", shape, "ln_w", 0))
    spec.append((f"{name}.bias", shape, "ln_b", 0))


def _mha(spec, name, embd, q_dim=None, kv_dim=None, out_dim=None):
    q_dim, kv_dim = q_dim or embd, kv_dim or embd
    out_dim = out_dim or q_dim
    _conv(spec, f"{name}.query", embd, q_dim, 1)
    _conv(spec, f"{name}.key", embd, kv_dim, 1)
    _conv(spec, f"{name}.value", embd, kv_dim, 1)
    _conv(spec, f"{name}.proj", out_dim, embd, 1)


def _ffn(spec, name, c, expansion=4):
    _conv(spec, f"{name}.fc", c * expansion, c, 1)
    _conv(spec, f"{name}.proj", c, c * expansion, 1)


def _encoder(spec, name, embd, stride):
    if stride > 0:
        for b in ("q", "k", "v"):
            _conv(spec, f"{name}.attn.{b}_conv.conv", embd, 1, 3, bias=False)
        for b in ("q", "k", "v"):
            _ln(spec, f"{name}.attn.{b}_norm", embd)
    _mha(spec, f"{name}.attn.attn", embd)
    _ln(spec, f"{name}.ln_attn", embd)
    spec.append((f"{name}.drop_path_attn.scale", (1, embd, 1), "layer_scale", 0))
    _ffn(spec, f"{name}.ffn", embd)
    _ln(spec, f"{name}.ln_ffn", embd)
    spec.append((f"{name}.drop_path_ffn.scale", (1, embd, 1), "layer_scale", 0))


def _decoder(spec, name, embd, kv_dim):
    _conv(spec, f"{name}.xattn.q_conv.conv", embd, 1, 3, bias=False)
    _ln(spec, f"{name}.xattn.q_norm", embd)
    _mha(spec, f"{name}.xattn.xattn", embd, kv_dim=kv_dim, out_dim=2 * embd)
    _ln(spec, f"{name}.ln_xattn_q", embd)
    _ln(spec, f"{name}.ln_xattn_kv", kv_dim)
    _ffn(spec, f"{name}.ffn", embd)
    _ln(spec, f"{name}.ln_ffn", embd)
    spec.append((f"{name}.drop_path_ffn.scale", (1, embd, 1), "layer_scale", 0))


def _head(spec, name, c, n_layers, out, logit_name):
    for i in range(n_layers):
        _conv(spec, f"{name}.convs.{i}.conv", c, c, 3, bias=False)
    for i in range(n_layers):
        _ln(spec, f"{name}.norms.{i}", c)
    _conv(spec, f"{name}.{logit_name}.conv", out, c, 3)
    if logit_name == "reg_head":
        key, shape, _, fan = spec.pop()
        spec.append((key, shape, "offset_bias", fan))


def param_spec(m):
    """(torch key, shape, kind, fan_in) of every parameter of the ``iter``
    model of the ``model`` config tree ``m``, in a fixed order."""
    if m["name"] != "iter":
        raise ValueError(f"the reference builds model.name 'iter' only, "
                         f"not {m['name']!r}")
    tn, vn = m["text_net"], m["vid_net"]
    if tn["name"] != "transformer" or vn["name"] != "transformer":
        raise ValueError("the reference builds the transformer text and "
                         "video nets only")
    spec = []
    e_t = tn["embd_dim"]
    _conv(spec, "text_net.embd_fc.conv", e_t, tn["in_dim"], 1)
    if tn.get("use_bkgd_token", True):
        spec.append(("text_net.bkgd_token", (e_t, 1), "token", 0))
    for i in range(tn.get("n_layers", 5)):
        _encoder(spec, f"text_net.transformer.{i}", e_t, 0)

    embd = vn["embd_dim"]
    in_dim = vn["in_dim"] * (2 if m.get("msf") else 1) + (1 if m.get("scat") else 0)
    _conv(spec, "vid_map.conv", embd, in_dim, 1)
    _conv(spec, "vid_net.embd_fc.conv", embd, embd, 1)
    arch = vn["arch"]
    for i in range(arch[0]):
        _conv(spec, f"vid_net.embd_convs.{i}.conv", embd, embd, 3, bias=False)
    for i in range(arch[0]):
        _ln(spec, f"vid_net.embd_norms.{i}", embd)
    for i in range(arch[1]):
        _encoder(spec, f"vid_net.stem.{i}", embd, 1)
    for i in range(arch[2]):
        _encoder(spec, f"vid_net.branch.{i}", embd, 2 if i > 0 else 1)

    for i in range(m["fusion"].get("n_layers", 2)):
        _decoder(spec, f"fusion.layers.{i}", embd, e_t)
    _ln(spec, "fusion.ln_out", embd)

    levels, rdim = arch[2], m.get("rdim") or 32
    n_cls = m["cls_head"].get("n_layers", 2)
    _head(spec, "cls_head", embd, n_cls, 1, "cls_head")
    _conv(spec, "refine.conv_1x1", rdim, levels, 1)
    for i in range(levels):
        _conv(spec, f"refine.layers.{i}.conv_dilated", rdim, rdim, 3)
        _conv(spec, f"refine.layers.{i}.conv_1x1", rdim, rdim, 1)
        _ln(spec, f"refine.layers.{i}.norm", rdim, torch_style=True)
    _conv(spec, "refine.conv_out", rdim, rdim, 1)
    _head(spec, "cls_head2", embd + rdim, n_cls, 1, "cls_head")
    _head(spec, "reg_head", embd + rdim, m["reg_head"].get("n_layers", 2), 2,
          "reg_head")
    for i in range(levels):
        spec.append((f"reg_head.scales.{i}.scale", (), "scale", 0))
    return spec


def make_weights(m, seed, device="cpu"):
    """Every parameter of :func:`param_spec` as a flat dict of float32
    tensors on ``device``: one ``torch.rand`` of all the leaves' elements
    from a generator on ``device`` seeded by ``seed``, then each leaf's slice
    mapped onto its kind's range."""
    spec = param_spec(m)
    sizes = [math.prod(shape) for _, shape, _, _ in spec]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(sum(sizes), generator=gen, device=device,
                   dtype=torch.float32)
    out, pos = {}, 0
    for (key, shape, kind, fan), n in zip(spec, sizes):
        lo, hi = ((-1.0 / math.sqrt(fan), 1.0 / math.sqrt(fan))
                  if KINDS[kind] == "fan" else KINDS[kind])
        out[key] = (u[pos:pos + n] * (hi - lo) + lo).reshape(shape)
        pos += n
    return out


def flax_tree(weights):
    """The flat dict of tensors as the nested flax-layout numpy tree
    ('a.b.0.c' -> tree['a']['b_0']['c'])."""
    tree = {}
    for key, value in weights.items():
        parts = []
        for p in key.split("."):
            if re.fullmatch(r"\d+", p) and parts:
                parts[-1] = f"{parts[-1]}_{p}"
            else:
                parts.append(p)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.ascontiguousarray(
            value.detach().to("cpu", torch.float32).numpy())
    return tree
