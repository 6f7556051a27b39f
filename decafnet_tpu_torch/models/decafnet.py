"""The DeCafNet grounder (port of decafnet_tpu/models/decafnet.py:50-252,
DeCafNetIterative).

delegation -> vid_map -> text transformer -> cross-attention fusion ->
video FPN -> cls_head -> TCN refinement -> cls_head2 + reg_head.

A (video, query) pair is a batch row. With ``queries_per_video`` Q > 1 the
video inputs carry V videos and the text inputs V*Q rows (row r belongs to
video r // Q), and the vid_map projection runs once per video
(:meth:`DeCafNetIterative._delegate_project_grouped`).

``model.train()`` turns on the configured dropouts (the blocks', the TCN's
``model.tcn_dropout`` and the channel dropout ``vid_net.cdrop``), drawn from
the ``generator`` passed to :meth:`DeCafNetIterative.forward`; in eval mode
the forward is the serving forward.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.blocks import MaskedConv1D, dropout, reset_parameters
from ..ops.delegation import delegate, delegation_weights
from ..ops.masked import interpolate_nearest_1d, masked_max_pool1d
from .fusion import XAttNFusion
from .heads import ClsHead, RegHead
from .tcn import TCN
from .text_net import TextTransformer
from .video_net import VideoTransformer


def _delegated_in_dim(m):
    in_dim = m["vid_net"]["in_dim"]
    if m.get("msf"):
        in_dim *= 2
    if m.get("scat"):
        in_dim += 1
    return in_dim


class DeCafNetIterative(nn.Module):
    """Live DeCafNet model, f32. ``cfg`` is the ``model`` config subtree
    (after ``core.update_opt``)."""

    def __init__(self, cfg):
        super().__init__()
        m = cfg
        self.cfg = m
        vn, tn, fu = m["vid_net"], m["text_net"], m["fusion"]
        vid_embd = vn["embd_dim"]
        num_levels = vn["arch"][-1]
        rdim = m.get("rdim") or 32
        for key, want in (("vid_net", "transformer"), ("text_net", "transformer"),
                          ("fusion", "xattn"), ("cls_head", "cls"),
                          ("reg_head", "reg")):
            if m[key]["name"] != want:
                raise NotImplementedError(f"model.{key}.name={m[key]['name']!r}")
        if vn.get("pool_only"):
            raise NotImplementedError("model.vid_net.pool_only")

        def drops(sub):
            return {k: sub.get(k, 0.0)
                    for k in ("attn_pdrop", "proj_pdrop", "path_pdrop")}

        self.cdrop = vn.get("cdrop", 0.0)
        self.text_net = TextTransformer(
            tn["in_dim"], tn["embd_dim"], tn["n_heads"], tn["max_seq_len"],
            n_layers=tn.get("n_layers", 5), use_abs_pe=tn.get("use_abs_pe", True),
            use_bkgd_token=tn.get("use_bkgd_token", True), **drops(tn))
        self.vid_map = MaskedConv1D(_delegated_in_dim(m), vid_embd, 1)
        self.vid_net = VideoTransformer(
            vid_embd, vid_embd, vn["max_seq_len"], vn["n_heads"],
            vn["mha_win_size"], stride=vn.get("stride", 1),
            arch=tuple(vn["arch"]), use_abs_pe=vn.get("use_abs_pe", False),
            **drops(vn))
        self.fusion = XAttNFusion(vid_embd, fu.get("text_dim", tn["embd_dim"]),
                                  n_layers=fu.get("n_layers", 2),
                                  n_heads=fu.get("n_heads", 4),
                                  xattn_mode=fu.get("xattn_mode", "adaln"),
                                  **drops(fu))
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

    def fuse_and_predict(self, fpn, fpn_masks, generator=None):
        """Heads with TCN refinement."""
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
        runs once per video; rows are expanded at embd channels. Returns
        per-row (vid_rows, mask_rows)."""
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

        mask_f = vid_masks[:, None, :].to(vid.dtype)
        W, bias = self.vid_map.conv.weight, self.vid_map.conv.bias
        a = F.conv1d(vid * mask_f, W[:, :C_exp])                 # (V, embd, T)
        w_rows = weight.reshape(V, Q, 1, T).to(vid.dtype)
        if m.get("msf", False):
            b_ = F.conv1d(shallow_vid * mask_f, W[:, C_exp:C_exp + C_side])
            rows = a[:, None] * w_rows + b_[:, None]
        else:
            rows = a[:, None] * w_rows
            mask_rows = (weight > 0) & mask_rows
        rows = rows.reshape(V * Q, embd, T)
        if m.get("scat", False):
            # the correlation channel is masked by the per-row mask
            corr_rows = correl.to(vid.dtype) * mask_rows.to(vid.dtype)
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
        if Q > 1 and grouped_ok and not m.get("sfonly", False):
            vid, vm = self._delegate_project_grouped(
                vid, shallow_vid, vid_masks, text_cls, Q)
        else:
            if Q > 1:
                vid = torch.repeat_interleave(vid, Q, dim=0)
                shallow_vid = torch.repeat_interleave(shallow_vid, Q, dim=0)
                vid_masks = torch.repeat_interleave(vid_masks, Q, dim=0)
            vid, vid_masks, _ = delegate(
                vid, shallow_vid, vid_masks, text_cls, sn=m.get("sn", 60),
                ratio=m.get("sratio", 0.0), normalize=m.get("norm", False),
                msf=m.get("msf", False), scat=m.get("scat", False),
                sfonly=m.get("sfonly", False) and not self.training)
            vid = dropout(vid, self.cdrop, generator, self.training,
                          shape=vid.shape[:2] + (1,))
            vid, vm = self.vid_map(vid, vid_masks[:, None, :])

        text_enc, text_mask_enc = self.text_net(text, text_masks,
                                                generator=generator)
        vid, vm = self.fusion(vid, vm, text_enc, text_mask_enc,
                              generator=generator)
        fpn, fpn_masks = self.vid_net(vid, vm, pe_interp=pe_interp,
                                      generator=generator)
        return self.fuse_and_predict(fpn, fpn_masks, generator=generator)


def make_model(cfg):
    """Model factory; the port builds ``model.name: iter`` only, in f32
    (``tpu.compute_dtype`` "auto" or "float32")."""
    dtype = cfg.get("tpu", {}).get("compute_dtype", "auto")
    if dtype not in ("auto", "float32"):
        raise ValueError(f"tpu.compute_dtype={dtype!r}: the port computes in "
                         f"f32; a bf16 mode is ROADMAP item 12")
    name = cfg.model["name"]
    if name != "iter":
        raise NotImplementedError(f"model.name={name!r}: the port builds 'iter'")
    return DeCafNetIterative(cfg.model)


def init_random(model, seed):
    """Fill ``model`` with random weights drawn from ``torch.Generator``
    seeded by ``seed``, with the JAX package's initializers."""
    return reset_parameters(model, torch.Generator().manual_seed(seed))
