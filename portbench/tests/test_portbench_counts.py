"""The benchmark's arithmetic against hand counts at tiny shapes."""

import numpy as np
import pytest
import torch

from portbench import counts

torch.set_num_threads(1)

BW = 3.35e12

M = {"vid_net": {"in_dim": 3, "embd_dim": 4, "n_heads": 2, "max_seq_len": 8,
                 "stride": 1, "arch": [1, 0, 2], "mha_win_size": 3},
     "text_net": {"in_dim": 5, "embd_dim": 4, "n_layers": 1,
                  "use_bkgd_token": True, "use_abs_pe": False,
                  "max_seq_len": 24},
     "fusion": {"n_layers": 1}, "cls_head": {"n_layers": 1},
     "reg_head": {"n_layers": 1}, "msf": True, "rdim": 2}
CFG = {"model": M, "eval": {"max_num_queries": 32}}


def test_trio_bound_by_hand():
    call = counts.DecodeCall(T=8, L=8, qb=1, lengths=[6], queries=[1])
    # params 9*4*4 + 6*4*4, x 4*6*4, mask 8, outputs 3*4*8*4
    nbytes = 144 + 96 + 96 + 8 + 384
    assert counts.trio_bound(M, call, "float32") == pytest.approx(nbytes / BW)
    bf = 144 + 96 + 48 + 8 + 192
    assert counts.trio_bound(M, call, "bfloat16") == pytest.approx(bf / BW)


def test_band_bound_by_hand():
    call = counts.DecodeCall(T=8, L=8, qb=1, lengths=[5], queries=[1])
    # level 0: q, k, v 3*4*5*4, mask 8, out 4*8*4; level 1: 3*4*3*4, 4, 4*4*4
    lvl0, lvl1 = 240 + 8 + 128, 144 + 4 + 64
    assert counts.band_bound(M, call, "float32") == pytest.approx(
        (lvl0 + lvl1) / BW)


def test_conv3_bound_by_hand():
    call = counts.DecodeCall(T=8, L=8, qb=1, lengths=[8], queries=[1])
    # embedding conv at level 0 (C 4), cls_head layer over 2 levels (C 4),
    # cls_head2 and reg_head layers over 2 levels (C 6)
    w4, w6 = 3 * 16 * 4 + 12 * 4, 3 * 36 * 4 + 18 * 4
    emb = w4 + 4 * 8 * 4 + 8 + 4 * 8 * 4
    cls = w4 + (128 + 8 + 128) + (4 * 4 * 4 + 4 + 4 * 4 * 4)
    wide = w6 + (6 * 8 * 4 + 8 + 6 * 8 * 4) + (6 * 4 * 4 + 4 + 6 * 4 * 4)
    assert counts.conv3_bound(M, call, "float32") == pytest.approx(
        (emb + cls + 2 * wide) / BW)


def test_compute_bound_wins_where_flops_dominate():
    wide = {**M, "vid_net": {**M["vid_net"], "embd_dim": 4096}}
    call = counts.DecodeCall(T=8, L=8, qb=1, lengths=[8], queries=[1])
    # one launch: 6 * C * C * 8 FLOPs at 495 TFLOP/s beats its bytes
    emb_flops = 6 * 4096 * 4096 * 8
    assert counts.conv3_bound(wide, call, "float32") > emb_flops / 495e12


def test_model_flops_by_hand():
    call = counts.DecodeCall(T=8, L=8, qb=2, lengths=[8], queries=[2])
    E, T, Lt, w = 4, 8, 9, 3
    per_video = 2 * (3 + 3) * E * T                       # vid_map, msf
    text = 2 * 5 * 4 * 8 + (24 * 16 * Lt + 4 * Lt * Lt * 4)
    fusion = 22 * 16 * T + 4 * T * Lt * E + 6 * E * T + 4 * E * 4 * Lt
    video = 2 * 16 * T + 6 * 16 * T                        # embd fc, conv
    video += sum(24 * 16 * t + 4 * w * E * t + 18 * E * t for t in (8, 4))
    S, E2, r = 12, 6, 2
    heads = 6 * 16 * S + 6 * E * S                         # cls_head
    heads += 2 * 2 * r * T + 2 * 8 * r * r * T + 2 * r * r * T  # TCN
    heads += 6 * 36 * S + 6 * E2 * S                       # cls_head2
    heads += 6 * 36 * S + 12 * E2 * S                      # reg_head
    per_row = 2 * 3 * T + text + fusion + video + heads
    assert counts.model_flops(M, call) == per_video + 2 * per_row


def test_decode_calls_follow_the_service_buckets():
    def req(t, q, tok):
        return {"vid": np.zeros((3, t)), "texts": [np.zeros((5, tok))] * q}
    calls = counts.decode_calls([req(5, 3, 9), req(8, 3, 4), req(12, 1, 4)],
                                CFG, max_group=8)
    by = {(c.T, c.qb, c.L): c for c in calls}
    assert set(by) == {(8, 4, 16), (8, 4, 8), (16, 1, 8)}
    assert by[(8, 4, 16)].lengths == [5] and by[(8, 4, 16)].queries == [3]
    calls = counts.decode_calls([req(5, 3, 4), req(6, 3, 4), req(7, 3, 4)],
                                CFG, max_group=8)
    assert len(calls) == 1
    assert calls[0].lengths == [5, 6, 7, 5] and calls[0].queries == [3, 3, 3, 0]
    assert len(calls[0].row_lengths()) == 16


def test_mfu_against_the_peaks():
    assert counts.mfu(495e12, 1.0, "float32") == pytest.approx(100.0)
    assert counts.mfu(989e12, 2.0, "bfloat16") == pytest.approx(50.0)
