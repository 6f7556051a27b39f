"""Per-weight caches of derived tensors: the kernels' weight operands and
the compute dtype's copies of f32 parameters.

A derived tensor is built once per weight and kept on the weight itself,
against its ``_version``, storage, device and shape, so an in-place update
(``add_``, ``load_state_dict``, an optimizer step) or a new ``.data``
builds a fresh one. Inference tensors carry no version counter and are not
cached.
"""

from __future__ import annotations

import torch


def cached(w, key, build):
    """``build(w.detach())``, computed once per version of ``w`` (under no
    grad) and kept on ``w`` under ``key``."""
    stamp = (None if torch.is_inference(w)
             else (w._version, w.data_ptr(), w.device, tuple(w.shape)))
    store = getattr(w, "_derived", None)
    if stamp is not None and store is not None and key in store \
            and store[key][0] == stamp:
        return store[key][1]
    with torch.no_grad():
        value = build(w.detach())
    if stamp is not None:
        if store is None:
            store = w._derived = {}
        store[key] = (stamp, value)
    return value


def cast(p, dtype):
    """``p`` in ``dtype``, as the JAX modules cast their f32 parameters at
    each use (``param.astype(x.dtype)``): ``p`` itself when it already has
    that dtype (the f32 path makes no copy); a differentiable ``p.to(dtype)``
    when autograd records ``p``; else a copy cached against ``p``'s version,
    so a served decode pays for the cast once per weight."""
    if p is None or p.dtype == dtype:
        return p
    if torch.is_grad_enabled() and p.requires_grad:
        return p.to(dtype)
    return cached(p, ("cast", dtype), lambda w: w.to(dtype))
