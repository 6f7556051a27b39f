"""The DeCafNet grounder and its variants (port of
decafnet_tpu/models/decafnet.py: DeCafNetIterative, DeCafNetEarlyFusion,
DeCafNetLateFusion).

The live model (``model.name: iter``, ``iter2`` with a second fusion):
delegation -> vid_map -> text net -> cross-attention fusion -> video FPN ->
cls_head -> TCN refinement -> cls_head2 + reg_head; it returns four lists
over FPN levels. The early-fusion (``early``, ``early2``) and late-fusion
(``default``) variants have one classification head and return three.

A (video, query) pair is a batch row. With ``queries_per_video`` Q > 1 the
video inputs carry V videos and the text inputs V*Q rows (row r belongs to
video r // Q); the live model runs the vid_map projection once per video
(:meth:`DeCafNetIterative._delegate_project_grouped`), the variants expand
the videos to rows first.

``model.train()`` turns on the configured dropouts (the blocks', the TCN's
``model.tcn_dropout`` and the channel dropout ``vid_net.cdrop``), drawn from
the ``generator`` passed to ``forward``; in eval mode the forward is the
serving forward.

``compute_dtype`` (``torch.bfloat16``, or None for f32) is the activations'
dtype after delegation, which stays f32, as in the JAX models: the video
and text inputs are cast at entry, the parameters stay f32 and are cast at
each use (nn/blocks.py), and the outputs come in the compute dtype. In
training the casts are differentiable (``ops.params.cast``), so the
gradients of the f32 parameters come back in f32.

Each forward names its stages as spans (:func:`utils.profiling.stage`:
``model.delegation`` (delegation and vid_map), ``model.text``,
``model.fusion``, ``model.fpn`` (the video net) and ``model.heads``), which
record into the decode's record and do nothing outside one.

Time-sharded (:mod:`parallel.seq`: the Trainer's ``tpu.shard_time``, the
Evaluator's ``eval.shard_time``), the video inputs are this rank's block of
each video's time axis and the outputs the block's points: the text net
runs whole on every rank, delegation ranks its bins over the gathered
correlation, a global video self-attention attends over the gathered keys,
and every op that reads past its own column exchanges halos with the
neighbouring ranks. :func:`check_time_sharding` holds the rules.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.blocks import MaskedConv1D, dropout, reset_parameters
from ..ops.delegation import delegate, delegation_weights
from ..ops.masked import interpolate_nearest_1d, masked_max_pool1d
from ..ops.params import cast
from ..parallel import seq
from ..utils.profiling import stage
from .fusion import XAttNFusion
from .heads import ClsHead, RegHead
from .tcn import TCN
from .text_net import make_text_net
from .video_net import VideoTransformer

# the model names whose forward returns the two classification heads that
# the decode and the training losses read
TWO_HEAD_NAMES = ("iter", "iter2")


def _delegated_in_dim(m):
    in_dim = m["vid_net"]["in_dim"]
    if m.get("msf"):
        in_dim *= 2
    if m.get("scat"):
        in_dim += 1
    return in_dim


def _drops(sub):
    return {k: sub.get(k, 0.0) for k in ("attn_pdrop", "proj_pdrop", "path_pdrop")}


def _check_names(m):
    for key, want in (("vid_net", "transformer"), ("fusion", "xattn"),
                      ("cls_head", "cls"), ("reg_head", "reg")):
        if m[key]["name"] != want:
            raise NotImplementedError(f"model.{key}.name={m[key]['name']!r}")


def _video_net(m, in_dim):
    vn = m["vid_net"]
    return VideoTransformer(
        in_dim, vn["embd_dim"], vn["max_seq_len"], vn["n_heads"],
        vn["mha_win_size"], stride=vn.get("stride", 1), arch=tuple(vn["arch"]),
        use_abs_pe=vn.get("use_abs_pe", False),
        pool_only=vn.get("pool_only", False), remat=vn.get("remat", False),
        remat_policy=vn.get("remat_policy", "nothing"), **_drops(vn))


def _fusion(m, text_dim):
    """The fusion over the text net's output width (``text_dim``: the text
    net's ``embd_dim``, or its ``in_dim`` for an identity net without one)."""
    fu = m["fusion"]
    return XAttNFusion(m["vid_net"]["embd_dim"], text_dim,
                       n_layers=fu.get("n_layers", 2), n_heads=fu.get("n_heads", 4),
                       xattn_mode=fu.get("xattn_mode", "adaln"), **_drops(fu))


def _to_compute(x, dtype):
    """``x`` in the compute dtype (None: unchanged, f32)."""
    return x if dtype is None else x.to(dtype)


def _expand_videos(Q, *videos):
    """Video-major inputs -> one row per query (each video repeated Q
    times)."""
    if Q == 1:
        return videos
    return tuple(torch.repeat_interleave(v, Q, dim=0) for v in videos)


class DeCafNetIterative(nn.Module):
    """Live DeCafNet model. ``cfg`` is the ``model`` config subtree (after
    ``core.update_opt``). With ``second_fusion`` (``iter2``) the fusion runs
    again over every FPN level before the heads. ``compute_dtype``: see the
    module docstring."""

    def __init__(self, cfg, second_fusion=False, compute_dtype=None):
        super().__init__()
        m = cfg
        self.cfg, self.second_fusion = m, second_fusion
        self.compute_dtype = compute_dtype
        _check_names(m)
        vid_embd = m["vid_net"]["embd_dim"]
        num_levels = m["vid_net"]["arch"][-1]
        rdim = m.get("rdim") or 32
        self.cdrop = m["vid_net"].get("cdrop", 0.0)
        self.text_net = make_text_net(m["text_net"])
        self.vid_map = MaskedConv1D(_delegated_in_dim(m), vid_embd, 1)
        self.vid_net = _video_net(m, vid_embd)
        self.fusion = _fusion(m, self.text_net.out_dim)
        ch, rh = m["cls_head"], m["reg_head"]
        self.cls_head = ClsHead(vid_embd, ch.get("n_layers", 2),
                                ch.get("prior_prob", 0.0))
        # 0.5 is the reference TCN's dropout; tcn_dropout is the JAX
        # package's ablation knob (decafnet_tpu/models/decafnet.py:75-77)
        self.refine = TCN(num_levels, rdim, rdim, num_layers=num_levels,
                          pdrop=m.get("tcn_dropout", 0.5))
        self.cls_head2 = ClsHead(vid_embd + rdim, ch.get("n_layers", 2),
                                 ch.get("prior_prob", 0.0))
        self.reg_head = RegHead(vid_embd + rdim, num_levels,
                                rh.get("n_layers", 2))

    def fuse_and_predict(self, fpn, fpn_masks, text, text_masks,
                         generator=None):
        """(Second fusion with the encoded text, then) heads with TCN
        refinement."""
        if self.second_fusion:
            fpn, fpn_masks = self.fusion(fpn, fpn_masks, text, text_masks,
                                         generator=generator)
        fpn_logits, _ = self.cls_head(fpn, fpn_masks)
        # nearest-expand every level to the level-0 grid and stack (bs, L, T)
        ref_len = fpn_logits[0].shape[1]
        mask0 = fpn_masks[0][:, 0].to(fpn_logits[0].dtype)
        expanded = [fpn_logits[0]]
        for logits in fpn_logits[1:]:
            up = interpolate_nearest_1d(logits[:, None, :], ref_len)[:, 0]
            expanded.append(up * mask0)
        refined = self.refine(torch.stack(expanded, dim=1), fpn_masks[0],
                              generator=generator)

        # per-level concat, downsampling the refined map by masked max pool
        new_fpn = []
        for i, f in enumerate(fpn):
            if i != 0:
                refined = masked_max_pool1d(refined, fpn_masks[i - 1])[0]
            new_fpn.append(torch.cat([f, refined.to(f.dtype)], dim=1))
        fpn_logits2, _ = self.cls_head2(new_fpn, fpn_masks)
        fpn_offsets, out_masks = self.reg_head(new_fpn, fpn_masks)
        return fpn_logits, fpn_logits2, fpn_offsets, out_masks

    def _delegate_project_grouped(self, vid, shallow_vid, vid_masks, text_cls,
                                  Q):
        """Video-major delegation + vid_map for V videos x Q query rows.

        The binary delegation weight broadcasts over channels, so it
        commutes with the 1x1 projection: W_e @ (vid * w) + W_s @ shallow + b
        == w * (W_e @ vid) + (W_s @ shallow) + b. The 2C -> embd projection
        runs once per video; rows are expanded at embd channels. The
        saliency correlation and the delegation weights stay f32; the
        projection and the rows are in the compute dtype. Returns per-row
        (vid_rows, mask_rows)."""
        m = self.cfg
        V, _, T = vid.shape
        embd = self.vid_map.conv.weight.shape[0]
        C_exp = m["vid_net"]["in_dim"]
        C_side = shallow_vid.shape[1]

        sv, tc = shallow_vid, text_cls.reshape(V, Q, C_side)
        if m.get("norm", False):
            sv = sv / (torch.linalg.norm(sv, dim=1, keepdim=True) + 1e-4)
            tc = tc / (torch.linalg.norm(tc, dim=2, keepdim=True) + 1e-4)
        correl = torch.einsum("vct,vqc->vqt", sv, tc).reshape(V * Q, T)
        mask_rows = torch.repeat_interleave(vid_masks, Q, dim=0)
        weight = delegation_weights(correl, mask_rows, m.get("sn", 60),
                                    m.get("sratio", 0.0))

        dtype = self.compute_dtype or vid.dtype
        mask_f = vid_masks[:, None, :].to(dtype)
        W = cast(self.vid_map.conv.weight, dtype)
        bias = cast(self.vid_map.conv.bias, dtype)
        a = F.conv1d(vid.to(dtype) * mask_f, W[:, :C_exp])       # (V, embd, T)
        w_rows = weight.reshape(V, Q, 1, T).to(dtype)
        if m.get("msf", False):
            b_ = F.conv1d(shallow_vid.to(dtype) * mask_f,
                          W[:, C_exp:C_exp + C_side])
            rows = a[:, None] * w_rows + b_[:, None]
        else:
            rows = a[:, None] * w_rows
            mask_rows = (weight > 0) & mask_rows
        rows = rows.reshape(V * Q, embd, T)
        if m.get("scat", False):
            # the correlation channel is masked by the per-row mask
            corr_rows = correl.to(dtype) * mask_rows.to(dtype)
            rows = rows + W[:, -1, 0][None, :, None] * corr_rows[:, None, :]
        if bias is not None:
            rows = rows + bias[None, :, None]
        return rows, mask_rows[:, None, :]

    def forward(self, vid, shallow_vid, vid_masks, text, text_cls, text_masks,
                pe_interp=None, queries_per_video=1, generator=None):
        """Returns (cls_head logits, cls_head2 logits, offsets, masks), each
        a list over FPN levels. ``generator`` feeds the dropouts in training
        mode.

        In training with channel dropout (``cdrop`` > 0) a video-major batch
        is expanded to rows first: the dropout acts per query row on the
        delegated input, which does not commute with the per-video
        projection. ``sfonly`` (the sidekick stream alone) applies at eval
        only, as in the JAX model."""
        m = self.cfg
        Q = queries_per_video
        grouped_ok = not self.training or self.cdrop == 0.0
        with stage("model.delegation"):
            if Q > 1 and grouped_ok and not m.get("sfonly", False):
                vid, vm = self._delegate_project_grouped(
                    vid, shallow_vid, vid_masks, text_cls, Q)
            else:
                vid, shallow_vid, vid_masks = _expand_videos(
                    Q, vid, shallow_vid, vid_masks)
                vid, vid_masks, _ = delegate(
                    vid, shallow_vid, vid_masks, text_cls, sn=m.get("sn", 60),
                    ratio=m.get("sratio", 0.0), normalize=m.get("norm", False),
                    msf=m.get("msf", False), scat=m.get("scat", False),
                    sfonly=m.get("sfonly", False) and not self.training)
                vid = dropout(_to_compute(vid, self.compute_dtype), self.cdrop,
                              generator, self.training,
                              shape=vid.shape[:2] + (1,), time_axis=None)
                vid, vm = self.vid_map(vid, vid_masks[:, None, :])

        with stage("model.text"), seq.replicated():
            # every rank encodes the whole text
            text_enc, text_mask_enc = self.text_net(
                _to_compute(text, self.compute_dtype), text_masks,
                generator=generator)
        with stage("model.fusion"):
            vid, vm = self.fusion(vid, vm, text_enc, text_mask_enc,
                                  generator=generator)
        with stage("model.fpn"):
            fpn, fpn_masks = self.vid_net(vid, vm, pe_interp=pe_interp,
                                          generator=generator)
        with stage("model.heads"):
            return self.fuse_and_predict(fpn, fpn_masks, text_enc,
                                         text_mask_enc, generator=generator)


class _OneHeadModel(nn.Module):
    """What the early- and late-fusion variants share: delegation per row
    (video-major batches expanded to rows first), the text net, the fusion
    and the two heads at the video width. The video (after delegation) and
    the text are cast to ``compute_dtype`` at entry."""

    def __init__(self, m, vid_in_dim, compute_dtype=None):
        super().__init__()
        self.cfg, self.compute_dtype = m, compute_dtype
        _check_names(m)
        vid_embd = m["vid_net"]["embd_dim"]
        self.cdrop = m["vid_net"].get("cdrop", 0.0)
        self.text_net = make_text_net(m["text_net"])
        self.vid_net = _video_net(m, vid_in_dim)
        self.fusion = _fusion(m, self.text_net.out_dim)
        ch, rh = m["cls_head"], m["reg_head"]
        self.cls_head = ClsHead(vid_embd, ch.get("n_layers", 2),
                                ch.get("prior_prob", 0.0))
        self.reg_head = RegHead(vid_embd, m["vid_net"]["arch"][-1],
                                rh.get("n_layers", 2))

    def _delegate(self, vid, shallow_vid, vid_masks, text_cls, Q, sfonly,
                  generator):
        m = self.cfg
        vid, shallow_vid, vid_masks = _expand_videos(Q, vid, shallow_vid,
                                                     vid_masks)
        vid, vid_masks, _ = delegate(
            vid, shallow_vid, vid_masks, text_cls, sn=m.get("sn", 60),
            ratio=m.get("sratio", 0.0), normalize=m.get("norm", False),
            msf=m.get("msf", False), scat=m.get("scat", False), sfonly=sfonly)
        vid = dropout(_to_compute(vid, self.compute_dtype), self.cdrop,
                      generator, self.training, shape=vid.shape[:2] + (1,),
                      time_axis=None)
        return vid, vid_masks[:, None, :]

    def _heads(self, fpn, fpn_masks):
        fpn_logits, _ = self.cls_head(fpn, fpn_masks)
        fpn_offsets, out_masks = self.reg_head(fpn, fpn_masks)
        return fpn_logits, fpn_offsets, out_masks


class DeCafNetEarlyFusion(_OneHeadModel):
    """Early-fusion variant with one classification head: delegation ->
    vid_map -> text net -> fusion -> video FPN -> (with ``second_fusion``,
    ``early2``: the fusion again over every level) -> cls_head + reg_head.
    Returns (logits, offsets, masks), each a list over FPN levels."""

    def __init__(self, cfg, second_fusion=True, compute_dtype=None):
        vid_embd = cfg["vid_net"]["embd_dim"]
        super().__init__(cfg, vid_embd, compute_dtype)
        self.second_fusion = second_fusion
        self.vid_map = MaskedConv1D(_delegated_in_dim(cfg), vid_embd, 1)

    def forward(self, vid, shallow_vid, vid_masks, text, text_cls, text_masks,
                pe_interp=None, queries_per_video=1, generator=None):
        sfonly = self.cfg.get("sfonly", False) and not self.training
        with stage("model.delegation"):
            vid, vm = self._delegate(vid, shallow_vid, vid_masks, text_cls,
                                     queries_per_video, sfonly, generator)
            vid, vm = self.vid_map(vid, vm)
        with stage("model.text"), seq.replicated():
            # every rank encodes the whole text
            text_enc, text_mask_enc = self.text_net(
                _to_compute(text, self.compute_dtype), text_masks,
                generator=generator)
        with stage("model.fusion"):
            vid, vm = self.fusion(vid, vm, text_enc, text_mask_enc,
                                  generator=generator)
        with stage("model.fpn"):
            fpn, fpn_masks = self.vid_net(vid, vm, pe_interp=pe_interp,
                                          generator=generator)
        with stage("model.heads"):
            if self.second_fusion:
                fpn, fpn_masks = self.fusion(fpn, fpn_masks, text_enc,
                                             text_mask_enc, generator=generator)
            return self._heads(fpn, fpn_masks)


class DeCafNetLateFusion(_OneHeadModel):
    """Late-fusion variant (``default``): delegation -> video FPN over the
    delegated width (no vid_map) -> text net -> fusion on every level ->
    cls_head + reg_head. Returns (logits, offsets, masks), each a list over
    FPN levels."""

    def __init__(self, cfg, compute_dtype=None):
        super().__init__(cfg, _delegated_in_dim(cfg), compute_dtype)

    def forward(self, vid, shallow_vid, vid_masks, text, text_cls, text_masks,
                pe_interp=None, queries_per_video=1, generator=None):
        # no sfonly here, as in the JAX model
        with stage("model.delegation"):
            vid, vm = self._delegate(vid, shallow_vid, vid_masks, text_cls,
                                     queries_per_video, False, generator)
        with stage("model.fpn"):
            fpn, fpn_masks = self.vid_net(vid, vm, pe_interp=pe_interp,
                                          generator=generator)
        with stage("model.text"), seq.replicated():
            # every rank encodes the whole text
            text_enc, text_mask_enc = self.text_net(
                _to_compute(text, self.compute_dtype), text_masks,
                generator=generator)
        with stage("model.fusion"):
            fpn, fpn_masks = self.fusion(fpn, fpn_masks, text_enc,
                                         text_mask_enc, generator=generator)
        with stage("model.heads"):
            return self._heads(fpn, fpn_masks)


# compute dtype names -> the models' ``compute_dtype`` (None: f32)
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16,
                  "bf16": torch.bfloat16}


def resolve_compute_dtype(cfg):
    """``cfg.tpu.compute_dtype`` as a concrete name (port of
    decafnet_tpu/models/decafnet.py:379-417). An explicit value passes
    through. "auto" is "float32" for training and for
    ``eval.reference_exact``, and the JAX function gives "bfloat16" only for
    eval and serving on a TPU backend: on any other backend, a GPU included,
    it gives "float32", and so does the port, in every mode (so it takes no
    ``eval_mode``): an explicit "bfloat16" trains, evaluates and serves in
    bf16, "auto" runs all three in f32. Making bf16 the card's eval default
    waits for its own numerics study on the card, on checkpoints the bf16
    trainer can now make there (ROADMAP item 12d)."""
    tpu = cfg.get("tpu") or {}
    value = tpu.get("compute_dtype", "float32")
    return "float32" if value == "auto" else value


def make_model(cfg, compute_dtype=None):
    """Model factory of the JAX ``make_model`` names: ``iter`` / ``iter2``
    (:class:`DeCafNetIterative` without / with the second fusion),
    ``early`` / ``early2`` (:class:`DeCafNetEarlyFusion` without / with it)
    and ``default`` (:class:`DeCafNetLateFusion`). The compute dtype is
    ``compute_dtype`` when given, else ``cfg.tpu.compute_dtype`` resolved:
    "float32" ("auto") or "bfloat16" / "bf16" (bf16 activations, f32
    parameters and statistics); any other value raises. ``tpu.remat``
    wraps the video net's encoders in activation checkpointing for
    training, with ``tpu.remat_policy`` "nothing" or "dots"."""
    tpu = cfg.get("tpu", {})
    value = compute_dtype or resolve_compute_dtype(cfg)
    if value not in COMPUTE_DTYPES:
        raise ValueError(f"compute dtype {value!r}: tpu.compute_dtype is "
                         f"'auto' or one of {sorted(COMPUTE_DTYPES)}")
    dtype = COMPUTE_DTYPES[value]
    m = cfg.model
    if tpu.get("remat"):
        m = {**m, "vid_net": {**m["vid_net"], "remat": True,
                              "remat_policy": tpu.get("remat_policy", "nothing")}}
    name = m["name"]
    if name in ("iter", "iter2"):
        return DeCafNetIterative(m, second_fusion=name == "iter2",
                                 compute_dtype=dtype)
    if name in ("early", "early2"):
        return DeCafNetEarlyFusion(m, second_fusion=name == "early2",
                                   compute_dtype=dtype)
    if name == "default":
        return DeCafNetLateFusion(m, compute_dtype=dtype)
    raise ValueError(f"unknown model: {name!r}")


def require_two_heads(cfg, who):
    """Raise unless ``cfg.model.name`` returns the two classification heads
    that ``who`` (the decode, the losses) reads."""
    name = cfg.model["name"]
    if name not in TWO_HEAD_NAMES:
        raise ValueError(
            f"{who}: model.name={name!r} returns (logits, offsets, masks) with "
            f"one classification head, but the decode and the training losses "
            f"read two (cls_head and cls_head2): only {TWO_HEAD_NAMES} run "
            f"here; {name!r} is a forward-only model")


def check_time_sharding(cfg, T, S):
    """Raise unless a video of ``T`` input columns splits over ``S`` ranks
    for the model of ``cfg``, naming the rule: T a multiple of
    S * vid_net.stride * 2^(L-1) (every FPN level's blocks start on even
    columns of the level before, and block edges align across levels), no
    halo longer than a block at any level (band attention's
    ``mha_win_size // 2``, the convs' 1, the TCN's dilation 2^(L-1) at level
    0). A global video attention (``mha_win_size <= 0``) gathers every
    rank's keys (``nn.blocks.MaskedMHA``) and needs no halo."""
    vn = cfg.model["vid_net"]
    L, win = vn["arch"][-1], vn["mha_win_size"]
    unit = S * vn.get("stride", 1) * 2 ** (L - 1)
    if T % unit:
        raise ValueError(f"time sharding: a video of {T} columns must be a "
                         f"multiple of S * vid_net.stride * 2^(L-1) = {unit} "
                         f"(S = {S} ranks, L = {L} FPN levels)")
    for lvl in range(L):
        block = T // (S * vn.get("stride", 1) * 2 ** lvl)
        need = max(1, win // 2, 2 ** (L - 1) if lvl == 0 else 0)
        if need > block:
            raise ValueError(
                f"time sharding: a halo of {need} columns at FPN level {lvl} "
                f"is longer than a rank's block of {block} (T = {T}, S = {S}): "
                f"a halo may reach the neighbouring rank only")


def init_random(model, seed):
    """Fill ``model`` with random weights drawn from ``torch.Generator``
    seeded by ``seed``, with the JAX package's initializers."""
    return reset_parameters(model, torch.Generator().manual_seed(seed))
