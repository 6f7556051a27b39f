"""Weights for the encoders (port of decafnet_tpu/encode/import_vit.py, and
the encoders' counterpart of models/import_torch.py).

EgoVLP checkpoints hold the video tower under ``(module.)video_model.*``
(Frozen-in-Time keys: cls_token, pos_embed, temporal_embed,
patch_embed.proj.*, blocks.N.{norm1,attn,norm3,timeattn,norm2,mlp}.*,
norm.*) and the projection under ``vid_proj.0.*``. ``SpaceTimeViT`` keeps
those names and layouts, so loading one is a key rename after the
prefixes are stripped. The JAX package's flax trees load too: a
``SpaceTimeViT`` tree is in the torch layout already (``models.load_params``
flattens its keys), and a ``ClipEncoder`` tree goes through
:func:`clip_encoder_params_to_state_dict`.
"""

from __future__ import annotations

import torch

from ..models.import_torch import state_dict_from_params

_PREFIXES = ("module.", "model.", "video_model.")
_SKIP_PREFIXES = ("text_model.", "txt_proj.", "text_proj.", "txt_model.")
# timm heads with no counterpart in the eval-only module
_SKIP_KEYS = ("head.weight", "head.bias", "pre_logits.fc.weight",
              "pre_logits.fc.bias")


def normalize_vit_key(key):
    """Strip wrapper prefixes; map EgoVLP's ``vid_proj.0.*`` to ``proj.*``.
    Returns None for keys of other towers (the text model) or of train-time
    heads."""
    changed = True
    while changed:
        changed = False
        for p in _PREFIXES:
            if key.startswith(p):
                key = key[len(p):]
                changed = True
    if key.startswith(_SKIP_PREFIXES) or key in _SKIP_KEYS:
        return None
    if key.startswith("vid_proj."):
        key = "proj." + key.split(".", 2)[2]
    return key


def vit_state_dict_to_params(state_dict):
    """Frozen-in-Time / EgoVLP state dict -> the ``SpaceTimeViT`` state dict
    (f32 CPU tensors under the module's keys). Missing qkv / proj biases
    (``qkv_bias=False`` checkpoints) are zero-filled."""
    sd = {}
    for k, v in state_dict.items():
        nk = normalize_vit_key(k)
        if nk is not None:
            sd[nk] = torch.as_tensor(v).detach().to("cpu", torch.float32)
    for k in list(sd):
        if k.endswith(".weight") and ("qkv" in k or "proj" in k):
            bk = k[:-len(".weight")] + ".bias"
            if bk not in sd:
                sd[bk] = torch.zeros(sd[k].shape[0])
    return sd


def load_vit_checkpoint(model, path):
    """Load a torch ``.pth`` / ``.tar`` checkpoint (EgoVLP layout, possibly
    nested under ``state_dict``) into ``model`` strictly; returns it."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    model.load_state_dict(vit_state_dict_to_params(ckpt), strict=True)
    return model


def clip_encoder_params_to_state_dict(tree):
    """A flax ``ClipEncoder`` params tree (numpy) -> the port's
    ``ClipEncoder`` state dict: Dense ``kernel`` (in, out) -> ``weight``
    (out, in), LayerNorm ``scale`` -> ``weight``. (A flax ``SpaceTimeViT``
    tree is in the torch layout already and loads through
    ``models.load_params``.)"""
    sd = {}
    for key, v in state_dict_from_params(tree).items():
        if key.endswith(".kernel"):
            key, v = key[:-len("kernel")] + "weight", v.T.contiguous()
        elif key.endswith(".scale"):
            key = key[:-len("scale")] + "weight"
        sd[key] = v
    return sd
