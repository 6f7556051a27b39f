"""Weight carry: flax parameter trees and reference-layout ``.pth`` files
into the port's modules (the port's copy of the key rules in
decafnet_tpu/models/import_torch.py:23-44).

The port's modules use the reference's torch module names and the flax
tree's parameter shapes, so a flax tree maps onto a torch state dict by a
key rename alone: a path component ``name_<int>`` (a list entry) becomes
``name.<int>``.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def torch_key_to_path(key):
    """'text_net.transformer.0.attn.attn.query.weight'
    -> ('text_net', 'transformer_0', 'attn', 'attn', 'query', 'weight')"""
    parts = []
    for p in key.split("."):
        if re.fullmatch(r"\d+", p) and parts:
            parts[-1] = f"{parts[-1]}_{p}"
        else:
            parts.append(p)
    return tuple(parts)


def path_to_torch_key(path):
    """Inverse of :func:`torch_key_to_path`."""
    parts = []
    for p in path:
        m = re.fullmatch(r"(.+)_(\d+)", p)
        if m and not re.fullmatch(r"conv_\d+x\d+", p):
            parts.extend([m.group(1), m.group(2)])
        else:
            parts.append(p)
    return ".".join(parts)


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_dict_from_params(tree):
    """Nested dict of arrays (a flax params tree) -> torch state dict of f32
    CPU tensors."""
    return {path_to_torch_key(path): torch.from_numpy(
                np.array(value, dtype=np.float32))
            for path, value in _walk(tree)}


def params_from_state_dict(state_dict):
    """Torch state dict -> nested dict of f32 numpy arrays (flax layout)."""
    tree = {}
    for key, value in state_dict.items():
        path = torch_key_to_path(key)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value.detach().cpu().numpy().astype(np.float32)
    return tree


def load_params(model, tree):
    """Load a flax-layout params tree into ``model`` (strict: every key and
    shape must match)."""
    model.load_state_dict(state_dict_from_params(tree), strict=True)
    return model


def load_pth(model, path, which="model_ema"):
    """Load a released ``{'model': ..., 'model_ema': ...}`` checkpoint (or a
    bare state dict) into ``model``, strictly."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state_dict = ckpt[which] if which in ckpt else ckpt
    model.load_state_dict(state_dict, strict=True)
    return model


def save_pth(path, params, ema_params=None):
    """Write flax-layout params trees as a reference-layout checkpoint
    ``{'model': ..., 'model_ema': ...}`` (``ema_params`` defaults to
    ``params``), the layout :func:`load_pth` reads."""
    ema = params if ema_params is None else ema_params
    torch.save({"model": state_dict_from_params(params),
                "model_ema": state_dict_from_params(ema)}, path)
