#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (decafnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  device   the card (torch and nvidia-smi);
  build    compiles the CUDA kernels from decafnet_tpu_torch/csrc with nvcc,
           prints ptxas's registers / shared memory / spills of every
           kernel and checks in the SASS (cuobjdump) that the conv3
           kernels, tuned, wide and pass, run on wgmma (HGMMA, in f32 and
           in bf16) and that the bf16 band-attention kernel loads by TMA
           (UTMALDG) under mbarriers (SYNCS);
  kernels  holds each kernel against its plain PyTorch version on the card at
           the served shapes (V=8 videos x Q=8 queries = 64 rows, T=2304, all
           7 FPN levels) and at edge shapes (ragged and odd T, masked tails,
           an all-masked row, base pointers off 16 bytes, padded rows, B*H
           above 65535), holds conv3_ln_act against an f64
           run of the same function at every served shape, and times kernel,
           plain version and, where one exists, the one PyTorch call
           computing the same function (library_ms, timed here only);
           conv3's one launch over a head layer's 7 levels is held level
           by level against the plain version and f64 (served and edge
           level lists) and timed against one launch per level in turns
           (old, new, new, old; "grouping_rule" in its kernels row,
           reported, not asserted); then the same at the MAD decode shape
           (32 query rows of one 32768-clip movie, all 7 levels: the
           embedding conv at level 0, one grouped head layer over levels
           32768 ... 512 at C = 128 and at C = 160, band attention at every
           level, the trio at level 0), SDPA timed at T <= 4096 only;
  bf16     (after the kernels phase) holds each kernel's bf16 variant against
           its plain version in bf16 at the same served and edge shapes
           (band attention also at windows 3, 7 and 9 on a served level and
           with an all-masked row at level 0), within 2 bf16 eps of
           max(1, |plain|), and times kernel, plain
           version and, for band attention, SDPA in bf16 (bounds at 2 bytes
           per activation element, conv3's products at the dense bf16 rate),
           each served level beside the f32 kernel's time; then the same
           at the MAD decode shape;
  shapes   (after the MAD kernels) the general kernels
           (csrc/*_general.cu: the shapes the tuned kernels are not built
           for), band attention's wide kernels (csrc/band_attention_wide.cu:
           D a multiple of 8 up to 256, windows up to 33, staged tiles and
           D streamed in steps), conv3's wide kernels (csrc/conv3_ln_act_wide.cu: C_out
           257 to 1024, a thread-block cluster splitting the channels) and
           pass kernels (csrc/conv3_ln_act_passes.cu: C_out 1025 to 4096,
           one block computing the channels in passes) and the trio's wide
           kernels (csrc/qkv_depthwise_ln_wide.cu: C 257 to 4096, a
           thread-block cluster splitting the channels) against their plain
           versions in f32 and bf16: at the JAX
           package's own kernel-test shapes (band attention B 2, H 4, D 16,
           T 96 ... 7, windows 5 and 9, the wide kernel routed and the
           general one forced; conv3 C_in 16 -> C_out 24 at T 100,
           256, 700; the trio C 16 at T 200, 384, the general kernel and
           the wide one forced; the launch helpers force
           the general kernels there), band attention at D 16, 64 and 128
           with windows 11 and 5 and at D 256 with window 5 over the served
           7 levels, the wide kernel routed and the general one forced, and
           the wide kernel at other views (odd T, a base off 16 bytes,
           rows padded, (B, H, T, D) tensors, a time-sharded rank's widened
           time-minor buffers), conv3 at C_out 288, 512
           and 544 over 7 levels in one launch, the wide kernel routed and
           the general one forced (f32 also against f64), the wide kernel at
           C_out 300 and 1024 over 16 rows, conv3 at C_out 1056 over 7
           levels, the pass kernel routed and the general one forced (f32
           also against f64), the pass kernel at C_out 1025 and 4096 over 4
           rows, the trio's wide kernel at C 257, 320, 512 and 1024 at T 7,
           36, 301 and 2304 (4 rows: valid, partly valid, half, all
           masked), at C 4096 over 2 rows (f32 also against f64), with a
           base off 16 bytes and at a time-sharded rank's level-0 block
           (T0 / 2 + 2 columns), and at C 512 and 1024 over 64 rows x T =
           2304 in turns with the general kernel (forced), and a head
           layer over 9 levels (two
           launches of the routed kernel) at C_out 160 (tuned), 288 (wide),
           1056 (passes) and 4100 (general); a bf16 seed sweep of conv3
           (tuned at 160, wide at 288, 512, 544, passes at 1056) against
           the plain version and the exactly rounded composition; times
           kernel, plain version, bound (conv3's products at the tensor
           cores' rate) and, for band attention, SDPA; band attention's
           wide and general kernels in turns (general, wide, wide, general)
           at every level of its shapes, conv3's wide and general kernels
           in turns at 288, 512 and 544, the pass and general ones at 1056;
  card_tests (after it) the bf16 autograd card cases of
           tests/test_torch_kernels.py through pytest in a subprocess;
  bf16     (after the http phase) the bf16 compute mode, tpu.compute_dtype
           bfloat16: GroundingService with the serve phase's weights on 8
           videos x 8 queries at T = 2304 (8 / 7 / 1 launches of the bf16
           kernels per decode call and none of the f32 ones; logits2 and
           offsets, kernels vs plain versions in bf16, held to the noise
           floor of plain bf16 vs the f32 kernels; bf16 vs f32 logits; wall,
           busy share, kernel launches and peak memory of the f32 and bf16
           services on the same batch), the eval CLI's entry point over the
           eval phase's 12 videos (launches; R@k count flips and top-1
           agreement with the f32 run, printed only: the weights are random)
           and one /ground over HTTP;
  mad      (after the bf16 phase) the MAD movie-length path
           (configs/mad.yaml at full width and depth, seeded random weights,
           a synthetic val split: a 14001-clip movie with 40 queries, a
           chunk of 32 and one of 8, and one of 24576-32768 clips with 8):
           GroundingService of the experiment directory with --set
           model.vid_net.max_seq_len 32768 (the JAX package's own MAD-length
           setting) grounding a 32768-clip movie with 32 queries (8 / 7 / 1
           launches per decode call, detections against the plain versions,
           wall, busy share, device kernels per decode, peak memory of
           kernels and plain versions); the eval CLI's entry point at
           T = 32768 over both movies with device SoftNMS,
           eval.reference_exact and the plain versions (tables equal, also
           on annotations made from the device detections; wall per movie,
           peak memory); the eval CLI at the shipped max_seq_len 2048 over
           the 14001-clip movie (the 16384 bucket, 8x the base, through the
           PE interpolation plans: the longest bucket for which both
           packages' Decoders buffer points) against the plain versions;
           and the serve and eval paths in bf16 (bf16 launches only; R@k
           count flips and top-1 agreement with f32 printed, not asserted);
  configs  (after the mad phase) configs/charades.yaml, tacos.yaml and
           ego4d_goalstep.yaml at full width and depth with seeded random
           weights: each kernel against its plain version in f32 and bf16
           at 64 rows x max_seq_len over the config's pyramid; a
           GroundingService serving 3 requests (lengths below max_seq_len)
           in f32 (detections against the plain versions) and bf16 (the
           decode's outputs by the noise-floor rule), launches by route and
           dtype per decode call, wall, busy share (one profiled call) and
           peak memory; the eval CLI's entry point over 8 synthetic videos
           x 4 queries (device SoftNMS and the plain versions, tables,
           detections and losses equal); one f32 train step through the
           train CLI's entry point at the config's own batch and
           microbatch. Then the widths legs, configs/ego4d_nlq.yaml at
           --set model.vid_net.n_heads 8 (band D 16), embd_dim 256 (D 64,
           conv3 at 256 tuned and 288 wide), embd_dim 512 (conv3 at 512 and
           544, band attention at D 128 and the trio at C 512 on their wide
           kernels) and embd_dim 1024 (conv3 at 1024 wide and 1056 on the
           pass kernels, band attention at D 256 and the trio at C 1024 on
           their wide kernels): kernels against plain and served in f32 and
           bf16, as above;
  serve    builds GroundingService at the Ego4D-NLQ width
           (configs/ego4d_nlq.yaml) with seeded random weights on the card,
           answers requests through ground() and ground_many(), checks the
           detections, the kernel launch counts per decode call, and the
           same requests through the plain versions; then profiles one
           stacked decode (device time by kernel, torch.profiler);
  eval     writes a synthetic val split (12 videos x 4 queries, 900-3000
           clips, so both the 2304 bucket and the 2x bucket with its PE
           interpolation plans run) and an experiment directory
           (configs/ego4d_nlq.yaml, seeded random weights in models/last.pth),
           and runs the eval CLI's entry point in-process three times: device
           SoftNMS, eval.reference_exact (host C++ SoftNMS), and device
           SoftNMS through the plain versions. Checks the R@k tables are
           equal, the detections agree, the eval losses are finite, and the
           kernel launches per eval decode call. With random weights those
           tables are all zeros, so the three modes' detections are also
           scored against annotations made from the device detections, where
           the meter counts hits, and those tables must be equal too;
  http     serves the eval phase's experiment directory over HTTP
           (service_from_logdir, as ``python -m decafnet_tpu_torch.serve``
           does) on 127.0.0.1 (a free port, a thread): /healthz, /ground and
           /ground_batch answer as the serve phase's service does;
  train    writes a synthetic train split (32 videos x 2 queries, 1000-2304
           clips) and val split (4 videos x 3 queries) and runs the train
           CLI's entry point in-process on configs/ego4d_nlq.yaml: 16 videos
           x 2 queries = 32 rows per step at T = 2304, dropout as configured,
           two epochs (lr 0 on the first step, in warmup) with train-time eval
           of the EMA after each. Checks the kernel launches (8 / 7 / 1 per
           forward microbatch and per eval decode call, none from the
           backward, which recomputes through the plain versions), finite
           losses and weights, that the weights move from step 2 on, the
           experiment through the eval CLI's entry point, the conv3 weight
           operands after optimizer steps and load_state_dict, one
           microbatch's loss and gradients against the plain versions with
           the same dropout masks, and two microbatches of 8 against one of 16
           with dropout off; times steps with kernels and plain versions and
           profiles one (device busy share, top kernels), and reports the
           peak memory. Its remat leg (lines with "leg": "remat") builds
           three Trainers through the CLI's build_trainer from the same seed,
           tpu.remat off, "nothing" and "dots", and on one batch of the same
           shape (dropout on) checks the losses equal, the gradients within
           the relative-L2 rule of the unwrapped step, and the launches per
           forward microbatch (8 / 7 / 1 off, 8 / 14 / 2 with remat: the
           recompute runs the encoders' kernels again), and reports each
           policy's peak memory and step wall times; then ("leg":
           "remat_mad") one step of the mad task (configs/mad.yaml) at
           T = 32768, 4 synthetic movies x 2 queries = 8 rows in one
           microbatch, remat off and "nothing", with the peak memory of each,
           and ("leg": "remat_mad_bf16") the same in bf16. Its bf16 leg
           ("leg": "bf16") runs the train CLI's entry point again with
           --set tpu.compute_dtype bfloat16: 8 / 7 / 1 launches of the bf16
           kernels per forward microbatch and per eval decode call (the
           train-time eval runs in bf16) and none of the f32 kernels, finite
           losses and f32 weights that move from step 2, each op's bf16
           backward against plain autograd, one microbatch's loss and
           gradients against the plain versions in bf16 by the relative-L2
           rule at the bf16 noise floor (beside the f32 distance), and the
           step walls, busy share and peak memory beside the f32 run's;
  variants every other architecture of make_model at the Ego4D-NLQ width,
           full depth, seeded random weights: iter2 (second fusion), early
           and early2 (early fusion, one classification head), default (late
           fusion over every FPN level) and iter with the identity text net
           and pool_only branches. Each runs forwards of 8 videos x 8
           queries at T = 2304 through the kernels and through the plain
           versions; one line per variant gives the launches per forward
           (8 / 7 / 1 for iter2, 6 / 7 / 1 for the one-head variants,
           8 / 0 / 0 for pool_only), the max |diff| of each output list
           (bound 1e-4) and the wall times. iter2 is also served
           (ground_many, detections checked, kernels vs plain versions), once
           under utils.profiling.trace with an annotate region that the
           trace file must name;
  encode   the on-device front end at full width: 1024 clips of 4 raw uint8
           frames (270 x 360, from the seed) copied to the card and put
           through the EgoVLP eval transform there (short side 256, center
           crop, 224^2 and 112^2, normalize); the factorized sidekick
           (dim 192, depth 2, 112^2) over every clip; salient-clip selection
           (sn 64, ratio 0.3: k = 256); the EgoVLP ViT-B SpaceTimeViT (224^2,
           patch 16, dim 768, depth 12, 4 frames, out 256) over the k clips
           only, scattered and gated; then the serve phase's GroundingService
           grounds 8 queries on the two streams. Checks the card's features
           against the CPU's on 2 clips, delegated encoding against
           encode-all-then-gate at T = 128, the detections, the launches per
           decode call and the ground step against the plain versions; times
           the H2D copy, the transform, each stage, the encode+ground wall
           (video-seconds per second) and the reference's offline structure
           (the expert over all clips), profiles one encode+ground (busy
           share, top device kernels), and reports the peak memory. Its
           bf16 leg ("leg": "bf16") runs the sidekick with dtype bf16 and
           the ViT on bf16 frames, grounding with the bf16 phase's service:
           the selected clips against the f32 leg's (differences only in
           bins tied within the bf16 shift of the saliency), the features
           against the f32 leg's, 8 / 7 / 1 bf16 launches per decode call,
           ms per expert clip, the encode+ground wall, video-seconds per
           second and peak memory beside f32. Then the encode CLI over two
           synthetic frame files (~100 clips at 224^2) and the port's
           Evaluator over the features it wrote;
  multi    data parallelism, each leg launched by ``python -m
           torch.distributed.run --standalone --nproc_per_node N`` in a
           subprocess, killed with its ranks at a timeout; every rank runs
           what the train or eval CLI's ``main`` runs and writes a report
           of its launches and peak memory: ddp1, training as one NCCL rank
           at the train phase's shape (16 videos x 2 queries per step,
           T = 2304, 2 steps, dropout off, SGD), against the one-process
           Trainer of the same argv (losses; the update of the weights and
           of the EMA from the common start by the train phase's
           relative-L2 rule, max |diff| printed, beside two one-process
           runs' distance); ddp2, the same as two ranks sharing the card
           over gloo with CUDA tensors (losses rtol 1e-5, the same update
           rule, 8 / 7 / 1 launches per forward microbatch on each rank,
           peak memory and step walls per rank);
           eval2, the eval CLI over the eval phase's experiment as two gloo
           ranks (eval.shard_processes: every rank's table, the merged
           dumps' detections and annotated-recall table equal the eval
           phase's); stack, eval.shard_videos 4 in this process against
           V = 1 (the same checks, launches per stacked decode call, wall
           per video). Then sequence parallelism, each video's time axis
           split over two gloo ranks sharing the card: seq2, training with
           tpu.shard_time at ddp2's shape and by its rules against the
           one-process Trainer, with each rank's peak memory and step walls,
           then one more forward and backward of a step's batch profiled on
           rank 0 (the device time of the halo exchanges and of the halos'
           copies, and the exchanges per step); dt2x2, the same with
           tpu.mesh_shape [2, 2] over four gloo ranks (8 videos x 1152
           columns each, exchanges inside 2-rank time subgroups), by ddp2's
           rules, its update's distance to ddp2's beside two one-process
           runs', per-rank peak memory, 8 / 7 / 1 launches per forward
           microbatch and rank 0's exchanges per forward; seq2_global, seq2
           with global video self-attention (model.vid_net.mha_win_size
           -1: the ranks gather every attention's keys) against a
           one-process run of the same override, 8 / 0 / 1 launches, the
           per-rank peak beside the one-process peak;
           seq2_mad, one step of the remat_mad leg's MAD task (T = 32768, 8
           rows, dropout as configured, drawn from one seed), remat off and
           "nothing", with each rank's peak memory beside the one-process
           peak of the remat_mad leg and its loss at rtol 1e-4; evalseq2, the eval CLI
           with eval.shard_time 2 over the eval phase's experiment: every
           rank's table equals the eval phase's, the lead's detections and
           annotated-recall table too, 8 / 7 / 1 launches per decode call
           on each rank; evalseq2_global, the same with the global window
           against a one-process eval of that override (tables equal,
           detections within 1e-3 s / 1e-4, 8 / 0 / 1 launches per decode
           call); ddp2_bf16 and seq2_bf16, ddp2 and seq2 with
           tpu.compute_dtype bfloat16 against a one-process bf16 run (losses
           and updates at the bf16 noise floor: the one-process bf16 run's
           distance from the f32 one; 8 / 7 / 1 launches of the bf16
           kernels per forward microbatch); evalseq2_mad, the mad phase's
           T = 32768 eval with eval.shard_time 2 (every rank's table and the
           lead's detections equal the one-process run's, per-rank peak
           memory beside the one-process peak).
Then a "walls" line (each phase's seconds) and one {"kernels": [...]} line:
the three f32 kernels with their launches summed over the serve, eval,
http, train, remat, variants, encode, encode CLI, mad serve, eval and pe,
configs (tuned launches), multi, seq2, dt2x2, seq2_global, seq2_mad,
evalseq2, evalseq2_global and evalseq2_mad paths, and the three bf16
variants with theirs over the bf16 phase's serve, eval and http paths, the
bf16 train, MAD remat and encode legs, the mad phase's bf16 serve and
eval, the configs phase's bf16 serve calls and the ddp2_bf16 and seq2_bf16
legs, each with the breakdown; each kernel also carries its record at the
MAD decode shape ("mad_decode"); the bf16 records also carry ptxas's
registers, spills and shared memory of their kernels, conv3's HGMMA count,
and the f32 kernel's time; then the six general kernels, band attention's
two wide ones and conv3's two wide and two pass ones, f32 and bf16, with
their launches over the configs phase's paths, their ptxas report and their
times summed over the shapes phase's timed calls, per shape in "shapes" (the
wide and pass ones beside the general kernel's time at the same shapes,
"general_ms"). Every kernel of a path must have launched on the main path;
the general conv3 kernel is on none since the pass kernels (C_out above
4096 only), the general band kernel none since the wide ones (D off 8 or
over 256, windows over 33 only: "on_path" false). Then the nvidia-smi
name/power-limit line, and last {"ok": true, "device": {...}}. Any failed check raises: the
script exits non-zero and prints no result. Without CUDA it exits 2.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit): f32
# outside the tensor cores, dense TF32 and bf16 on the tensor cores, HBM3
# bandwidth. Every kernel here computes in f32; conv3_ln_act runs its
# products on the tensor cores as three TF32 passes (3xTF32), or one bf16
# pass in its bf16 variant, the others on the CUDA cores.
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

# the served shape: 8 videos x 8 queries of a 2304-clip bucket
ROWS, T0, LEVELS, EMBD, RDIM, HEADS, WINDOW = 64, 2304, 7, 128, 32, 4, 5
VIDEO_LENS = (2304, 2304, 2200, 2000, 1800, 1500, 1100, 700)
# the kernels phases' decode call shapes: rows, level-0 length and each
# row's valid level-0 length. "served": the served shape above; "MAD": the
# mad phase's served movie (configs/mad.yaml at T = 32768), 32 query rows
# of one 32768-clip movie, every column valid
MAD_T, MAD_QUERIES = 32768, 32
SERVED = {"name": "served", "rows": ROWS, "t0": T0,
          "lens": tuple(n for n in VIDEO_LENS for _ in range(8)),
          "per": "one served decode call (64 rows, T=2304, all levels)"}
MAD = {"name": "MAD", "rows": MAD_QUERIES, "t0": MAD_T,
       "lens": (MAD_T,) * MAD_QUERIES,
       "per": f"one MAD decode call ({MAD_QUERIES} rows, T={MAD_T}, all levels)"}
# SDPA, the library call of band attention, reads a float bias of B*T^2
# elements per head: at the MAD shape it is timed only at T <= 4096 (at
# level 0, 550 GB of bias reads per call in f32)
SDPA_MAX_T = 4096

# tolerances of kernel vs plain version on the card (max |diff|):
# conv3_ln_act sums 3*C_in (up to 480) f32 products in another order than
# cuDNN before a LayerNorm; the trio and band attention sum 3 and 5*32 terms
TOL = {"conv3_ln_act": 1e-4, "qkv_depthwise_ln": 1e-5, "band_attention": 1e-5}
# conv3_ln_act against an f64 run of the same function: 3xTF32 must keep
# f32 accuracy (one TF32 pass is off by ~1e-3 at these widths)
TOL_F64 = 1e-5
# served detections, kernels vs plain versions and ground vs ground_many
SEG_TOL_S, SCORE_TOL = 1e-3, 1e-4
# launches of each kernel per forward of the 2-layer-head arch (2, 0, 7),
# by model: conv3 runs once in each of the 2 embedding convs and once per
# trunk layer of the heads, over all 7 levels in one launch (the live
# model's 3 heads, the one-head variants' 2, x 2 layers), band attention
# once per FPN encoder, the trio in the stride-1 encoder; pool_only has no
# encoders; global video attention (vid_net.mha_win_size -1) runs no band
# attention. A remat train microbatch
# (forward and backward) runs the encoders' kernels again in the recompute
PER_FORWARD = {
    "iter": {"conv3_ln_act": 8, "band_attention": 7, "qkv_depthwise_ln": 1},
    "iter2": {"conv3_ln_act": 8, "band_attention": 7, "qkv_depthwise_ln": 1},
    "early": {"conv3_ln_act": 6, "band_attention": 7, "qkv_depthwise_ln": 1},
    "early2": {"conv3_ln_act": 6, "band_attention": 7, "qkv_depthwise_ln": 1},
    "default": {"conv3_ln_act": 6, "band_attention": 7, "qkv_depthwise_ln": 1},
    "identity_pool_only": {"conv3_ln_act": 8, "band_attention": 0,
                           "qkv_depthwise_ln": 0},
    "remat": {"conv3_ln_act": 8, "band_attention": 14, "qkv_depthwise_ln": 2},
    "global": {"conv3_ln_act": 8, "band_attention": 0, "qkv_depthwise_ln": 1},
}
# the override of the global video self-attention legs
GLOBAL = ["model.vid_net.mha_win_size", "-1"]
# the serve, eval, http, train and encode paths run the live model
PER_DECODE = PER_FORWARD["iter"]
# eval losses, kernels vs plain versions (sums over up to ~4600 points)
LOSS_RTOL, LOSS_ATOL = 1e-3, 1e-4
# one train microbatch (16 videos x 2 queries), kernels vs plain versions
# with the same dropout masks: the loss at rtol 1e-4; the gradients at a
# relative L2 distance of 1e-2 over all leaves together and 0.25 for each
# leaf (leaves noise-sized on both sides skipped), with the elementwise
# distance at rtol 1e-3 + 1e-4 of each leaf's largest |g| reported. The
# kernels' forward differs from the plain versions' by up to ~5e-6 per op,
# and the gradient is not continuous in the forward: a ReLU input near 0, a
# near-tie in a masked max pool takes the other branch, and on leaves whose
# 37k-term sums cancel one such position moves the result. Over 8 batches
# (scripts/torch_train_grad_spread.py) that moved all leaves together by
# 3.9e-7 to 4.5e-4 and single leaves by up to 3.5e-2, elements by up to 719
# times the elementwise tolerance. A backward wired wrongly moves its leaves
# by ~1; each op's backward is also held exactly against plain autograd at
# the train shapes (OP_GRAD_RTOL), where no branch can differ
LOSS_RTOL_TRAIN, GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-3, 1e-4
GRAD_REL_L2_ALL, GRAD_REL_L2_LEAF, OP_GRAD_RTOL = 1e-2, 0.25, 1e-6
# least distance of a scored IoU from an IoU threshold in the annotated
# recall check: SEG_TOL_S moves the IoU of a segment of 0.5 s or more by
# at most 4e-3
IOU_MARGIN = 1e-2


def emit(obj):
    print(json.dumps(obj), flush=True)


def bound_ms(n_bytes, n_flops, tc_flops=0, tc_rate=TF32_FLOPS):
    """Least time for the work: bytes at the HBM rate, f32 operations at the
    CUDA-core rate, tensor-core operations at ``tc_rate`` (TF32 or bf16);
    the units run side by side, so the largest of the three."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(n_flops / F32_FLOPS, tc_flops / tc_rate)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, iters, warmup=2):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events, after warm-up). The card first spins for ~0.5 ms per call, so
    the host has queued every call before the first one starts: a kernel
    shorter than its Python wrapper is timed on the card, not on the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1_000_000 * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def prefix_mask(lens, T, dev):
    return torch.arange(T, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]


def row_lens(level, shape=SERVED):
    """Valid lengths of the rows of ``shape`` (SERVED or MAD) at one FPN
    level."""
    return [math.ceil(n / 2 ** level) for n in shape["lens"]]


# -------------------------------------------------------------------- build

def ptxas_report(log):
    """Per kernel of one source: registers, static shared memory and spill
    bytes, from nvcc's -Xptxas=-v output."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"kernel": m.group(1)}
            out.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                cur.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", line)
                cur["static_smem"] = int(m.group(1)) if m else 0
    return out


def bf16_kernel_name(name):
    """Whether a compiled kernel's (mangled) name is a bf16 variant: its
    name says so, or its first template argument is ``true``
    (conv3_ln_act_passes_kernel<BF16, NS>)."""
    return "bf16" in name or "bfloat16" in name or "ILb1E" in name


def sass_counts(lib_path, name, ops):
    """Instructions per compiled kernel whose name holds ``name``, from
    cuobjdump -sass of the built library: each SASS line counts for the
    first of ``ops`` (opcode names, in order) that it holds."""
    from decafnet_tpu_torch.ops import cuda

    sass = subprocess.run([cuda.toolkit_binary("cuobjdump"), "-sass", lib_path],
                          capture_output=True, text=True, check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1) if name in m.group(1) else None
            if cur:
                counts[cur] = {op: 0 for op in ops}
        elif cur:
            for op in ops:
                if op in line:
                    counts[cur][op] += 1
                    break
    return counts


def sass_mma(lib_path, name):
    """Tensor-core instructions per compiled kernel whose name holds
    ``name``: ``HMMA`` (the warp-level mma.sync) and ``HGMMA`` (the
    warpgroup-level wgmma)."""
    return sass_counts(lib_path, name, ("HGMMA", "HMMA"))


# ------------------------------------------------------------------ kernels

def conv3_f64(x, mask, w, bias, ln_w, ln_b, act="relu", eps=1e-5):
    """conv3_ln_act in f64 end to end (the plain version's channel LN keeps
    its statistics in f32): the yardstick of the kernel's accuracy."""
    d = torch.float64
    xm = x.to(d) * mask[:, None, :].to(d)
    y = torch.nn.functional.conv1d(xm, w.to(d), None if bias is None
                                   else bias.to(d), padding=1)
    y = y - y.mean(dim=1, keepdim=True)
    y = y * torch.rsqrt(y.square().mean(dim=1, keepdim=True) + eps)
    if ln_w is not None:
        y = y * ln_w.reshape(-1, 1).to(d) + ln_b.reshape(-1, 1).to(d)
    return torch.relu(y) if act == "relu" else y


def trio_f64(x, mask, ws, ln_ws, ln_bs, eps=1e-5):
    """The q/k/v trio in f64 end to end: the yardstick of the wide kernel's
    statistics, merged over chunks and a cluster's blocks."""
    d = torch.float64
    xm = x.to(d) * mask[:, None, :].to(d)
    outs = []
    for w, lw, lb in zip(ws, ln_ws, ln_bs):
        y = torch.nn.functional.conv1d(xm, w.to(d), padding=1, groups=x.shape[1])
        y = y - y.mean(dim=1, keepdim=True)
        y = y * torch.rsqrt(y.square().mean(dim=1, keepdim=True) + eps)
        outs.append(y * lw.reshape(-1, 1).to(d) + lb.reshape(-1, 1).to(d))
    return tuple(outs)


def conv3_case(dev, g, B, C, T, lens, bias=False, act="relu", how="as_is",
               dtype=torch.float32):
    x = moved(torch.randn(B, C, T, generator=g, device=dev).to(dtype), how)
    w = torch.randn(C, C, 3, generator=g, device=dev) / math.sqrt(3 * C)
    b = torch.randn(C, generator=g, device=dev) if bias else None
    lw = 1 + 0.1 * torch.randn(C, 1, generator=g, device=dev)
    lb = 0.1 * torch.randn(C, 1, generator=g, device=dev)
    return (x, prefix_mask(lens, T, dev), w, b, lw, lb), {"act": act}


def moved(x, how):
    """``x`` (B, C, T) with the same values and dtype at another address:
    "offset" is contiguous one element past a 16-byte boundary, "padded"
    sits in rows
    padded to a multiple of 4 columns (16-byte aligned rows, the last 16
    bytes of a row partly outside it); "as_is" is ``x``."""
    if how == "as_is":
        return x
    B, C, T = x.shape
    if how == "offset":
        buf = torch.empty(B * C * T + 1, device=x.device,
                          dtype=x.dtype)[1:].view(B, C, T)
    else:
        buf = torch.empty(B, C, T // 4 * 4 + 4, device=x.device,
                          dtype=x.dtype)[..., :T]
    return buf.copy_(x)


def conv3_levels_case(dev, g, B, C, Ts, lens, how="as_is", dtype=torch.float32,
                      c_in=None):
    """One head layer over FPN levels: per level x (B, c_in, T) laid out as
    ``how`` says and a mask of valid prefixes ``lens[i]``; one weight set
    (C, c_in, 3); c_in is C unless given."""
    c_in = c_in or C
    xs = [moved(torch.randn(B, c_in, T, generator=g, device=dev).to(dtype), how)
          for T in Ts]
    masks = [prefix_mask(n, T, dev) for n, T in zip(lens, Ts)]
    w = torch.randn(C, c_in, 3, generator=g, device=dev) / math.sqrt(3 * c_in)
    lw = 1 + 0.1 * torch.randn(C, 1, generator=g, device=dev)
    lb = 0.1 * torch.randn(C, 1, generator=g, device=dev)
    return xs, masks, (w, None, lw, lb)


# the served conv3 call shapes of one decode call: the 2 level-0 embedding
# convs (one level each, C = 128) and the head layers over all 7 levels,
# 2 at C = 128 (cls_head) and 4 at C = 160 (cls_head2, reg_head)
EMBD_CONVS = 2
HEAD_LAYERS = ((EMBD, 2), (EMBD + RDIM, 4))


def time_in_turns(old, new, iters):
    """Device ms of two ways to do the same work, timed old, new, new, old:
    each one's mean and the spread of its two repeats."""
    a1, b1, b2, a2 = (time_ms(f, iters) for f in (old, new, new, old))
    return {"old_ms": (a1 + a2) / 2, "new_ms": (b1 + b2) / 2,
            "old_spread_ms": abs(a1 - a2), "new_spread_ms": abs(b1 - b2)}


def conv3_heads(dev, g, dtype, per_level, grouped_check, shape=SERVED):
    """The conv3 head layers of one decode call of ``shape`` in ``dtype``:
    at C = 128 and 160, every level through ``per_level(level, count, args, kw)``
    (one launch each: the per-level check, timing and bound), then the
    grouped launch over the 7 levels checked level by level by
    ``grouped_check(xs, masks, params, what)`` and timed in turns against
    the per-level launches (one launch per level). Returns
    a record per layer shape and the time per decode call of each way."""
    from decafnet_tpu_torch.ops import conv3_ln_act, conv3_ln_act_levels

    heads = []
    for C, layers in HEAD_LAYERS:
        Ts = [shape["t0"] // 2 ** lvl for lvl in range(LEVELS)]
        xs, masks, params = conv3_levels_case(
            dev, g, shape["rows"], C, Ts,
            [row_lens(lvl, shape) for lvl in range(LEVELS)], dtype=dtype)
        for level, (x, m) in enumerate(zip(xs, masks)):
            count = layers + (EMBD_CONVS if level == 0 and C == EMBD else 0)
            per_level(level, count, (x, m, *params), {"act": "relu"})
        grouped_check(xs, masks, params,
                      f"{shape['name']} head layer, C={C}, 7 levels")
        t = time_in_turns(
            lambda: [conv3_ln_act(x, m, *params) for x, m in zip(xs, masks)],
            lambda: conv3_ln_act_levels(xs, masks, *params), 10)
        heads.append({"C": C, "layers_per_decode": layers, **t,
                      "slower_beyond_spread": t["new_ms"] - t["old_ms"]
                      > max(t["old_spread_ms"], t["new_spread_ms"])})
        del xs, masks
    return heads


def conv3_launch_bound(levels, tc_rate):
    """Bound of one launch over ``levels`` (records of conv3_level): each
    level's activations, mask and output bytes, the weights and LN
    parameters once, every level's operations; also its byte and operation
    times and the f32 CUDA-core bound (products on the CUDA cores)."""
    n_bytes = (sum(lv["work"]["act_bytes"] for lv in levels)
               + levels[0]["work"]["param_bytes"])
    n_flops, tc_flops, gemm_flops = (sum(lv["work"][k] for lv in levels)
                                     for k in ("n_flops", "tc_flops", "gemm_flops"))
    b_ms, _ = bound_ms(n_bytes, n_flops, tc_flops, tc_rate)
    cc_ms, _ = bound_ms(n_bytes, n_flops + gemm_flops)
    return {"bound_ms": b_ms, "byte_ms": 1e3 * n_bytes / HBM_BYTES_PER_S,
            "flop_ms": 1e3 * max(n_flops / F32_FLOPS, tc_flops / tc_rate),
            "bound_f32_ms": cc_ms}


def conv3_grouped_summary(r, tc_rate):
    """Fold the head layers' grouped launches into a conv3 record, per decode
    call as the port runs it (the embedding convs' level-0 launches and one
    grouped launch per head layer): ``ms`` from the timing in turns, and
    ``per_level_launch_ms`` for the same work launched once per level (that
    timing's other side); the bounds per launch, so a head layer's weights
    and LN parameters count once, not once per level."""
    embd = next(lv for lv in r["levels"]
                if lv["level"] == 0 and lv["shape"][1] == EMBD)
    launches = [([embd], EMBD_CONVS)] + [
        ([lv for lv in r["levels"] if lv["shape"][1] == h["C"]],
         h["layers_per_decode"]) for h in r["heads"]]
    for key in ("bound_ms", "byte_ms", "flop_ms") + (
            ("bound_f32_ms",) if "bound_f32_ms" in r else ()):
        r[key] = sum(n * conv3_launch_bound(lvs, tc_rate)[key]
                     for lvs, n in launches)
    r["ms"] = EMBD_CONVS * embd["ms"] + sum(
        h["layers_per_decode"] * h["new_ms"] for h in r["heads"])
    r["per_level_launch_ms"] = EMBD_CONVS * embd["ms"] + sum(
        h["layers_per_decode"] * h["old_ms"] for h in r["heads"])
    r["grouping_rule"] = {
        "faster_in_sum": r["ms"] < r["per_level_launch_ms"],
        "no_shape_slower_beyond_spread": not any(
            h["slower_beyond_spread"] for h in r["heads"])}


def trio_case(dev, g, B, C, T, lens, how="as_is", dtype=torch.float32):
    x = moved(torch.randn(B, C, T, generator=g, device=dev).to(dtype), how)
    ws = [torch.randn(C, 1, 3, generator=g, device=dev) / math.sqrt(3)
          for _ in range(3)]
    lws = [1 + 0.1 * torch.randn(C, 1, generator=g, device=dev) for _ in range(3)]
    lbs = [0.1 * torch.randn(C, 1, generator=g, device=dev) for _ in range(3)]
    return (x, prefix_mask(lens, T, dev), ws, lws, lbs), {}


def band_case(dev, g, B, T, lens, D=EMBD // HEADS, how="as_is",
              dtype=torch.float32, window=WINDOW):
    """Strided (B, H, T, D) head views of (B, C, T) projections, as the
    model hands them over, scaled by 1/sqrt(sqrt(D)) like q and k there
    (``how``: see :func:`moved`; "contiguous" gives (B, H, T, D) tensors)."""
    s = float(D) ** -0.25
    qkv = [moved((torch.randn(B, HEADS * D, T, generator=g, device=dev) * s)
                 .to(dtype), "as_is" if how == "contiguous" else how)
           .reshape(B, HEADS, D, T).transpose(2, 3) for _ in range(3)]
    if how == "contiguous":
        qkv = [t.contiguous() for t in qkv]
    return (*qkv, prefix_mask(lens, T, dev), window), {}


def check(op, plain, args, kw, name, what):
    from decafnet_tpu_torch.ops import cuda

    got = op(*args, **kw)
    with cuda.plain_versions():
        want = op(*args, **kw)
    torch.cuda.synchronize()
    err = max_err(got, want)
    finite = all(torch.isfinite(t).all() for t in
                 (got if isinstance(got, tuple) else (got,)))
    ok = finite and err <= TOL[name]
    emit({"phase": "kernels", "kernel": name, "check": what,
          "max_abs_err": err, "tol": TOL[name], "ok": ok})
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version at "
                             f"{what}: max |diff| {err}")
    return err


def sdpa_band(q, k, v, mask, window):
    """The one PyTorch call computing banded attention: SDPA with a band &
    key mask (timed as library_ms only; the port never calls it)."""
    T = q.shape[2]
    i = torch.arange(T, device=q.device)
    band = (i[:, None] - i[None, :]).abs() <= window // 2
    # every key valid (the MAD shape): the band alone, one (T, T) mask
    # instead of one per row
    attn_mask = (band[None, None] if bool(mask.all())
                 else band[None, None] & mask[:, None, None, :])
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask, scale=1.0)


def library_time(lib, args, kw, shape):
    """Device ms of the library call, or None where ``shape`` is the MAD one
    and T exceeds SDPA_MAX_T (not timed)."""
    if shape is MAD and args[0].shape[2] > SDPA_MAX_T:
        return None
    iters = 3 if shape is SERVED else 1
    return time_ms(lambda: lib(*args, **kw), iters, warmup=1)


def drop_partial_library(r, shape):
    """Null the library call's ms per decode call of record ``r`` unless
    every level's was timed (``r["levels"]``' library_ms), with a note."""
    times = [lv["library_ms"] for lv in r["levels"]]
    if any(t is None for t in times):
        r["library_ms"] = None
        r["library_ms_note"] = (f"SDPA timed at T <= {SDPA_MAX_T} only "
                                f"({shape['name']} shape)")


def run_kernels(dev, shape=SERVED):
    """Hold each kernel against its plain version, time the decode call
    shapes of ``shape`` (SERVED, then the edge shapes; or MAD). Returns
    per-kernel records summed over one decode call of ``shape``."""
    from decafnet_tpu_torch.ops import (band_attention, band_attention_torch,
                                        conv3_ln_act, conv3_ln_act_levels,
                                        conv3_ln_act_torch, cuda,
                                        qkv_depthwise_ln, qkv_depthwise_ln_torch)

    g = torch.Generator(device=dev).manual_seed(SEED)
    rows, t0, where = shape["rows"], shape["t0"], shape["name"]
    rec = {n: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "flop_ms": 0.0, "byte_ms": 0.0, "library_ms": None, "levels": []}
           for n in ("conv3_ln_act", "band_attention", "qkv_depthwise_ln")}
    rec["conv3_ln_act"].update(bound_f32_ms=0.0, max_abs_err_f64=0.0,
                               plain_max_abs_err_f64=0.0)

    def add(name, count, args, kw, op, plain, n_bytes, n_flops, level, lib=None,
            tc_flops=0):
        err = check(op, plain, args, kw, name, f"{where} level {level}, "
                    f"shape {tuple(args[0].shape)}")
        ms = time_ms(lambda: op(*args, **kw), 20)
        plain_ms = time_ms(lambda: plain(*args, **kw), 5, warmup=1)
        b_ms, _ = bound_ms(n_bytes, n_flops, tc_flops)
        lib_ms = library_time(lib, args, kw, shape) if lib else None
        r = rec[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += count * ms
        r["plain_ms"] += count * plain_ms
        r["bound_ms"] += count * b_ms
        r["byte_ms"] += count * 1e3 * n_bytes / HBM_BYTES_PER_S
        r["flop_ms"] += count * 1e3 * max(n_flops / F32_FLOPS,
                                          tc_flops / TF32_FLOPS)
        if lib_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + count * lib_ms
        r["levels"].append({"level": level, "shape": list(args[0].shape),
                            "calls": count, "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": b_ms, "share_of_bound": b_ms / ms,
                            "library_ms": lib_ms})
        return r["levels"][-1]

    def conv3_accuracy(args, kw, lvl, n_bytes, gemm_flops, ln_flops):
        """Kernel and plain version against f64, and the f32 CUDA-core bound
        beside the 3xTF32 one."""
        from decafnet_tpu_torch.ops import cuda

        want = conv3_f64(*args, **kw)
        got = conv3_ln_act(*args, **kw)
        with cuda.plain_versions():
            plain = conv3_ln_act(*args, **kw)
        err, err_plain = max_err(got.double(), want), max_err(plain.double(), want)
        f32_ms, _ = bound_ms(n_bytes, gemm_flops + ln_flops)
        r = rec["conv3_ln_act"]
        r["max_abs_err_f64"] = max(r["max_abs_err_f64"], err)
        r["plain_max_abs_err_f64"] = max(r["plain_max_abs_err_f64"], err_plain)
        lvl.update(bound_f32_ms=f32_ms, max_abs_err_f64=err,
                   plain_max_abs_err_f64=err_plain)
        ok = err <= TOL_F64
        emit({"phase": "kernels", "kernel": "conv3_ln_act", "check":
              f"vs f64, {where} level {lvl['level']}, shape {lvl['shape']}",
              "max_abs_err_f64": err, "plain_max_abs_err_f64": err_plain,
              "tol": TOL_F64, "ok": ok})
        if not ok:
            raise AssertionError(f"conv3_ln_act is off f64 by {err} at "
                                 f"{lvl['shape']}")

    def conv3_level(level, count, args, kw):
        C, T = args[0].shape[1], args[0].shape[2]
        act_bytes, param_bytes = 4 * 2 * rows * C * T + rows * T, 4 * (3 * C * C + 2 * C)
        n_bytes = act_bytes + param_bytes
        gemm_flops = 2 * rows * T * C * 3 * C
        ln_flops = 8 * rows * C * T
        lvl = add("conv3_ln_act", count, args, kw, conv3_ln_act,
                  conv3_ln_act_torch, n_bytes, ln_flops, level,
                  tc_flops=3 * gemm_flops)
        lvl["work"] = {"act_bytes": act_bytes, "param_bytes": param_bytes,
                       "n_flops": ln_flops, "tc_flops": 3 * gemm_flops,
                       "gemm_flops": gemm_flops}
        conv3_accuracy(args, kw, lvl, n_bytes, gemm_flops, ln_flops)

    def conv3_grouped(xs, masks, params, what):
        """One launch over the levels; each level against the plain version
        and f64."""
        before = conv3_ln_act.launches
        got = conv3_ln_act_levels(xs, masks, *params)
        assert conv3_ln_act.launches == before + 1
        r = rec["conv3_ln_act"]
        for x, m, y in zip(xs, masks, got):
            with cuda.plain_versions():
                want = conv3_ln_act(x, m, *params)
            err = max_err(y, want)
            err64 = max_err(y.double(), conv3_f64(x, m, *params))
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["max_abs_err_f64"] = max(r["max_abs_err_f64"], err64)
            ok = bool(torch.isfinite(y).all()) and err <= TOL["conv3_ln_act"] \
                and err64 <= TOL_F64
            emit({"phase": "kernels", "kernel": "conv3_ln_act", "check":
                  f"{what}: level T={x.shape[2]}", "max_abs_err": err,
                  "max_abs_err_f64": err64, "tol": TOL["conv3_ln_act"],
                  "tol_f64": TOL_F64, "ok": ok})
            if not ok:
                raise AssertionError(f"grouped conv3_ln_act disagrees at {what}, "
                                     f"T={x.shape[2]}: {err}, f64 {err64}")

    # every FPN level of one decode call of the shape
    rec["conv3_ln_act"]["heads"] = conv3_heads(dev, g, torch.float32,
                                               conv3_level, conv3_grouped, shape)
    for level in range(LEVELS):
        T = t0 // 2 ** level
        lens = row_lens(level, shape)
        n_valid = sum(min(n, T) for n in lens)
        args, kw = band_case(dev, g, rows, T, lens)
        D = EMBD // HEADS
        n_bytes = 4 * (3 * n_valid * HEADS * D + rows * HEADS * T * D) + rows * T
        n_flops = n_valid * HEADS * (4 * WINDOW * D + 4 * WINDOW)
        add("band_attention", 1, args, kw, band_attention, band_attention_torch,
            n_bytes, n_flops, level, lib=sdpa_band)
        if level == 0:
            args, kw = trio_case(dev, g, rows, EMBD, T, lens)
            n_bytes = 4 * (4 * rows * EMBD * T + 15 * EMBD) + rows * T
            n_flops = 3 * rows * EMBD * T * (5 + 8)
            add("qkv_depthwise_ln", 1, args, kw, qkv_depthwise_ln,
                qkv_depthwise_ln_torch, n_bytes, n_flops, level)
        del args

    conv3_grouped_summary(rec["conv3_ln_act"], TF32_FLOPS)
    drop_partial_library(rec["band_attention"], shape)
    if shape is not SERVED:
        return rec
    # edge shapes: ragged and odd T, masked tails, an all-masked row, tiny
    # level-6 lengths, T shorter than the attention window, base pointers
    # off 16 bytes, rows padded past T; and the unused options
    edge_Ts = (1000, 301, 36, 17, 9, 4, 3)
    for how in ("as_is", "offset"):
        xs, masks, params = conv3_levels_case(
            dev, g, 4, EMBD + RDIM, edge_Ts,
            [[T, max(T - 3, 1), T // 2, 0] for T in edge_Ts], how=how)
        conv3_grouped(xs, masks, params, f"edge levels T={edge_Ts}, x {how}")
    for T in edge_Ts:
        lens = [T, max(T - 3, 1), T // 2, 0]
        args, kw = conv3_case(dev, g, 4, EMBD + RDIM, T, lens)
        check(conv3_ln_act, conv3_ln_act_torch, args, kw, "conv3_ln_act",
              f"edge T={T}")
        for how in ("as_is", "offset"):
            args, kw = trio_case(dev, g, 4, EMBD, T, lens, how)
            check(qkv_depthwise_ln, qkv_depthwise_ln_torch, args, kw,
                  "qkv_depthwise_ln", f"edge T={T}, x {how}")
        for how in ("as_is", "contiguous", "offset", "padded"):
            args, kw = band_case(dev, g, 4, T, lens, how=how)
            check(band_attention, band_attention_torch, args, kw,
                  "band_attention", f"edge T={T}, q/k/v {how}")
    # B*H above 65535 (the old kernel's gridDim.y cap) at a tiny T
    args, kw = band_case(dev, g, 16400, 3, [3, 2, 1, 0] * 4100)
    check(band_attention, band_attention_torch, args, kw, "band_attention",
          "edge B*H = 65600, T=3")
    args, kw = conv3_case(dev, g, 3, 24, 100, [100, 50, 0], bias=True, act="none")
    args = (args[0][:, :16].contiguous(), args[1],
            torch.randn(24, 16, 3, generator=g, device=dev), args[3], None, None)
    check(conv3_ln_act, conv3_ln_act_torch, args, kw, "conv3_ln_act",
          "C_in 16 -> C_out 24, bias, no LN affine, no activation")
    # the widest build (C_out 256), not served
    args, kw = conv3_case(dev, g, 4, 256, 301, [301, 298, 150, 0])
    check(conv3_ln_act, conv3_ln_act_torch, args, kw, "conv3_ln_act",
          "edge C=256, T=301")
    return rec


# -------------------------------------------------------------------- serve

def make_request(rng, cfg, t, q, tokens=(5, 20)):
    """One request: t clips, q queries of ``tokens`` (lo, hi) tokens."""
    cv = cfg.model.vid_net.in_dim
    ct = cfg.model.text_net.in_dim
    return dict(vid=rng.standard_normal((cv, t), np.float32),
                shallow_vid=rng.standard_normal((cv, t), np.float32),
                texts=[rng.standard_normal((ct, int(n)), np.float32)
                       for n in rng.integers(tokens[0], tokens[1] + 1, q)],
                text_cls=rng.standard_normal((q, cv), np.float32),
                fps=30.0, clip_size=32, clip_stride=16)


def check_detections(results, request, k, least=1):
    """Each query's answer: ``least`` to ``k`` detections, finite, inside
    the video, scores non-increasing."""
    duration = request["vid"].shape[1] * request["clip_stride"] / request["fps"]
    assert len(results) == len(request["texts"])
    for r in results:
        segs = np.asarray(r["segments"], np.float64).reshape(-1, 2)
        scores = np.asarray(r["scores"], np.float64)
        assert least <= len(scores) <= k and len(segs) == len(scores), r
        assert np.isfinite(segs).all() and np.isfinite(scores).all(), r
        assert (segs >= 0).all() and (segs <= duration + 1e-4).all(), r
        assert (np.diff(scores) <= 0).all(), r


def same_detections(a, b):
    """Max |diff| of the scores and segments of two answer lists (inf when
    detection counts differ). Scores compare in their non-increasing order;
    each segment of ``a`` is matched to the closest segment of ``b`` among
    detections whose score is within SCORE_TOL, so two near-tied SoftNMS
    picks emitted in the other order still count as the same detections."""
    seg, sc = 0.0, 0.0
    for ra, rb in zip(a, b, strict=True):
        for x, y in zip(ra, rb, strict=True):
            if len(x["scores"]) != len(y["scores"]):
                return math.inf, math.inf
            if not x["scores"]:
                continue
            sx, sy = np.asarray(x["scores"]), np.asarray(y["scores"])
            gx, gy = np.asarray(x["segments"]), np.asarray(y["segments"])
            sc = max(sc, float(np.abs(sx - sy).max()))
            for i in range(len(sx)):
                near = np.abs(sy - sx[i]) <= SCORE_TOL
                d = np.abs(gy[near] - gx[i]).max(axis=1) if near.any() else [math.inf]
                seg = max(seg, float(np.min(d)))
    return seg, sc


def profile_decode(service, batch, top=12, phase="serve"):
    """Device time by kernel over one stacked 8x8 decode (torch.profiler):
    see :func:`profile_call`."""
    return profile_call(lambda: service.ground_many(batch), "one ground_many "
                        "of 8 videos x 8 queries at 2304 clips (profiler on)",
                        phase, top)


def profile_call(fn, what, phase, top=12):
    """Device time by kernel over one call of ``fn``, a served call that
    returns host results (torch.profiler): the busy share of the call's
    wall time and the kernels that take it. Kernels run on one stream, so
    their summed time is the busy time. Emits the record under ``phase``
    and returns it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    record = {"phase": phase, "profile": what, "wall_ms": wall_ms,
              "device_busy_ms": busy_ms,
              "kernel_launches": sum(r[2] for r in rows),
              "top_kernels": [{"name": n[:120], "ms": ms, "count": c}
                              for n, ms, c in rows[:top]]}
    emit(record)
    return record


def run_serve(dev):
    from decafnet_tpu_torch import ops
    from decafnet_tpu_torch.core import load_config
    from decafnet_tpu_torch.models import random_params
    from decafnet_tpu_torch.ops import cuda
    from decafnet_tpu_torch.serve import GroundingService

    cfg = load_config(os.path.join(REPO, "configs", "ego4d_nlq.yaml"))
    m = cfg.model
    service = GroundingService(cfg, params=random_params(cfg, SEED))
    assert service.device.type == "cuda"
    n_params = sum(p.numel() for p in service.model.parameters())
    emit({"phase": "serve", "config": "configs/ego4d_nlq.yaml",
          "model": m.name, "vid_in": m.vid_net.in_dim, "embd": m.vid_net.embd_dim,
          "max_seq_len": m.vid_net.max_seq_len, "arch": list(m.vid_net.arch),
          "window": m.vid_net.mha_win_size, "text_in": m.text_net.in_dim,
          "text_layers": len(service.model.text_net.transformer),
          "fusion_layers": len(service.model.fusion.layers),
          "sratio": m.sratio, "sn": m.sn, "msf": m.msf, "nms": dict(cfg.nms),
          "params": n_params, "weights": f"random, seed {SEED}"})

    rng = np.random.default_rng(SEED)
    clips = (900, 1500, 2304, 2304, 2304, 3000)
    queries = (1, 3, 8, 5, 2, 4)
    requests = [make_request(rng, cfg, t, q) for t, q in zip(clips, queries)]
    # one 64-row decode: 9-16 tokens put every query in the 16-token bucket
    batch = [make_request(rng, cfg, T0, 8, tokens=(9, 16)) for _ in range(8)]
    k = cfg.nms.max_num_segs

    # warm-up of every shape bucket (cuDNN/cuBLAS handles, allocator)
    # outside the counted run, so the timed requests are steady state
    for req in requests:
        service.ground(**req)
    service.ground_many(batch)
    torch.cuda.synchronize()

    # the main path: counts to 0 just before, read just after
    dec = service.decoder
    calls0 = dec.decode_calls
    ops.reset_launch_counts()
    per_request, answers = [], []
    for req in requests:
        t0 = time.perf_counter()
        answers.append(service.ground(**req))
        per_request.append(1e3 * (time.perf_counter() - t0))
    t0 = time.perf_counter()
    many = service.ground_many(requests)
    many_ms = 1e3 * (time.perf_counter() - t0)
    batch_ms = []
    for _ in range(3):
        c0, t0 = dec.decode_calls, time.perf_counter()
        batch_answers = service.ground_many(batch)
        batch_ms.append(1e3 * (time.perf_counter() - t0))
        assert dec.decode_calls - c0 == 1, "the 8x8 batch is one decode call"
    launches = ops.launch_counts()
    calls = dec.decode_calls - calls0

    want = {n: c * calls for n, c in PER_DECODE.items()}
    emit({"phase": "serve", "decode_calls": calls, "launches": launches,
          "expected": want, "per_decode_call": {n: launches[n] / calls
                                                for n in launches}})
    assert launches == want, (launches, want)

    for req, ans in zip(requests, answers):
        check_detections(ans, req, k)
    for req, ans in zip(batch, batch_answers):
        check_detections(ans, req, k)
    seg_d, sc_d = same_detections(answers, many)
    assert seg_d <= SEG_TOL_S and sc_d <= SCORE_TOL, (seg_d, sc_d)

    # the same requests through the plain versions on the card
    with cuda.plain_versions():
        plain = [service.ground(**req) for req in requests]
        t0 = time.perf_counter()
        plain_batch = service.ground_many(batch)
        plain_batch_ms = 1e3 * (time.perf_counter() - t0)
    assert ops.launch_counts() == launches
    seg_p, sc_p = same_detections(answers, plain)
    seg_pb, sc_pb = same_detections(batch_answers, plain_batch)
    emit({"phase": "serve", "check": "detections",
          "ground_vs_ground_many": {"seg_s": seg_d, "score": sc_d},
          "kernels_vs_plain": {"seg_s": max(seg_p, seg_pb),
                               "score": max(sc_p, sc_pb)},
          "tol": {"seg_s": SEG_TOL_S, "score": SCORE_TOL}})
    assert max(seg_p, seg_pb) <= SEG_TOL_S and max(sc_p, sc_pb) <= SCORE_TOL

    profile_decode(service, batch)
    for i, (req, ans, ms) in enumerate(zip(requests, answers, per_request)):
        emit({"phase": "serve", "request": i, "clips": req["vid"].shape[1],
              "queries": len(req["texts"]), "wall_ms": ms,
              "detections": [{"segments": a["segments"], "scores": a["scores"]}
                             for a in ans]})
    emit({"phase": "serve", "ground_many_6_requests_ms": many_ms,
          "batch_8x8_at_2304": {"wall_ms": batch_ms, "per_video_ms":
                                [b / 8 for b in batch_ms],
                                "plain_versions_wall_ms": plain_batch_ms},
          "stats": service.stats(),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    return launches, service, requests


# --------------------------------------------------------------------- eval

def write_experiment(root):
    """A synthetic val split and an experiment directory over it: opt.yaml
    (configs/ego4d_nlq.yaml pointed at the data) and models/last.pth (seeded
    random weights, reference layout)."""
    from decafnet_tpu_torch.core import load_config
    from decafnet_tpu_torch.data import apply_synthetic_cfg, make_synthetic_dataset
    from decafnet_tpu_torch.models import random_params, save_pth

    t0 = time.perf_counter()
    cfg = load_config(os.path.join(REPO, "configs", "ego4d_nlq.yaml"))
    paths = make_synthetic_dataset(
        os.path.join(root, "data"), num_videos=12, num_queries=4,
        clip_range=(900, 3000), vid_dim=cfg.model.vid_net.in_dim,
        shallow_dim=cfg.model.vid_net.in_dim, text_dim=cfg.model.text_net.in_dim,
        splits=("val",), seed=SEED)
    apply_synthetic_cfg(cfg, paths)
    logdir = os.path.join(root, "exp")
    os.makedirs(os.path.join(logdir, "models"))
    cfg.dump_to_file(os.path.join(logdir, "opt.yaml"))
    save_pth(os.path.join(logdir, "models", "last.pth"), random_params(cfg, SEED))
    with open(paths["anno_file"]) as f:
        clips = [v["num_clips"] for v in json.load(f)["val"].values()]
    emit({"phase": "eval", "experiment": "configs/ego4d_nlq.yaml over a "
          "synthetic val split", "videos": len(clips), "queries_per_video": 4,
          "clips": clips, "setup_s": time.perf_counter() - t0})
    assert min(clips) <= cfg.model.vid_net.max_seq_len < max(clips), clips
    return logdir


def eval_answers(results):
    """An EvalResults dump as lists of per-query answers, one per video."""
    return [[{"segments": d["segments"].tolist(), "scores": d["scores"].tolist()}
             for d in v["detections"]] for v in results.videos]


def annotated_recall(runs, ranks, threshs):
    """R@k tables of each mode's detections against annotations made from
    the device-NMS detections, where the meter counts hits. A query's target
    is its device top-1 segment shifted by a seeded fraction f of its length
    (top-1 IoU (1 - f) / (1 + f)); f is drawn again until every scored
    device IoU lies IOU_MARGIN or more from each threshold and detections
    whose scores are within SCORE_TOL (which may swap places) hit and miss
    alike. Returns ({mode: table}, number of queries)."""
    from decafnet_tpu_torch.eval.metrics import RecallMeter, interval_iou

    rng = np.random.default_rng(SEED)
    th = np.asarray(threshs, np.float64)
    targets = []
    for v in eval_answers(runs["device_nms"][1]):
        for q in v:
            segs = np.asarray(q["segments"], np.float64).reshape(-1, 2)[:max(ranks)]
            sc = np.asarray(q["scores"], np.float64)[:max(ranks)]
            if not len(segs):
                targets.append(np.array([0.0, 1.0]))
                continue
            tied = np.abs(sc[:, None] - sc[None]) <= SCORE_TOL
            for _ in range(1000):
                t = segs[0] + rng.uniform(0.0, 0.9) * (segs[0, 1] - segs[0, 0])
                iou = interval_iou(segs, np.broadcast_to(t, segs.shape))
                hit = iou[:, None] >= th[None]
                if (np.abs(iou[:, None] - th[None]).min() >= IOU_MARGIN
                        and all((hit[i] == hit[j]).all()
                                for i, j in zip(*np.nonzero(tied)))):
                    break
            else:
                raise AssertionError(f"no annotation clear of {th}: {segs}")
            targets.append(t)
    tables = {}
    for mode, (_, results, _) in runs.items():
        meter = RecallMeter(ranks, threshs)
        answers = [q for v in eval_answers(results) for q in v]
        for q, t in zip(answers, targets, strict=True):
            meter.update(np.asarray(q["segments"]).reshape(-1, 2), q["scores"], t)
        tables[mode] = meter.table()[0]
    return tables, len(targets)


def eval_modes(argv, modes, phase, n_calls, n_videos, n_queries,
               per_decode=PER_DECODE):
    """The eval CLI's entry point (``build_evaluator`` + ``run``, what
    ``python -m decafnet_tpu_torch.eval`` does) on ``argv``, once per mode
    ({mode: extra --set pairs}; "plain_versions" runs through the plain
    versions): each run's table, launches per decode call (``per_decode``;
    none for the plain versions), wall, per-video wall and peak memory, under
    ``phase``. Returns ({mode: (metrics, results, losses)}, the kernel
    launches of the other modes, the last Evaluator, {mode: peak GB})."""
    from decafnet_tpu_torch import ops
    from decafnet_tpu_torch.eval.__main__ import build_evaluator
    from decafnet_tpu_torch.ops import cuda
    from decafnet_tpu_torch.utils import EvalResults

    runs, peaks, launches = {}, {}, {n: 0 for n in per_decode}
    for mode, sets in modes.items():
        torch.cuda.reset_peak_memory_stats()
        ev = build_evaluator(argv + sets)
        assert ev.device.type == "cuda" and ev.decoder.reference_exact == \
            (mode == "reference_exact")
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        if mode == "plain_versions":
            with cuda.plain_versions():
                metrics = ev.run()
        else:
            metrics = ev.run()
        wall_s = time.perf_counter() - t0
        counts, calls = ops.launch_counts(), ev.decoder.decode_calls
        want = {n: 0 if mode == "plain_versions" else c * calls
                for n, c in per_decode.items()}
        results = EvalResults.load(os.path.join(ev.cfg.aux.logdir,
                                                "results_last.pk"))
        losses = [l for v in results.videos for l in v["losses"]]
        peaks[mode] = torch.cuda.max_memory_allocated() / 2 ** 30
        emit({"phase": phase, "mode": mode, "recall": metrics.tolist(),
              "table": ev.meter.table()[1].replace("\n", " | "),
              "decode_calls": calls, "launches": counts, "expected": want,
              "wall_s": wall_s, "video_ms": ev.video_ms,
              "phase_s": {k: sum(v) for k, v in ev.decoder.time_dict.items()},
              "mean_loss": {k: float(np.mean([l[k] for l in losses]))
                            for k in ("cls_loss", "reg_loss")},
              "mean_top1_iou": float(np.mean([i for _, i in
                                              results.top1_ious()])),
              "peak_mem_gb": peaks[mode]})
        assert (calls, len(ev.video_ms), len(losses)) == (
            n_calls, n_videos, n_queries), (calls, len(ev.video_ms), len(losses))
        assert counts == want, (mode, counts, want)
        assert all(np.isfinite(l[k]) for l in losses
                   for k in ("cls_loss", "reg_loss")), mode
        runs[mode] = (metrics, results, losses)
        if mode != "plain_versions":
            launches = {n: launches[n] + counts[n] for n in per_decode}
    return runs, launches, ev, peaks


def check_eval_modes(runs, cfg, phase):
    """Every mode's run against the "device_nms" one: the R@k tables equal,
    and so are the tables on annotations made from the device detections
    (:func:`annotated_recall`, which must hold hits and misses); the
    detections within 1e-3 s / 1e-4 and the losses at LOSS_RTOL."""
    base_m, base_r, base_l = runs["device_nms"]
    annotated, n_q = annotated_recall(runs, tuple(cfg.eval.ranks),
                                      tuple(cfg.eval.iou_threshs))
    base_a = annotated["device_nms"]
    emit({"phase": phase, "check": "annotated recall", "queries": n_q,
          "annotations": "device top-1 shifted by a seeded fraction of its "
          "length", "tables": {m: t.tolist() for m, t in annotated.items()}})
    assert 0 < base_a.max() and base_a.min() < 1, base_a   # hits and misses
    for mode in runs:
        if mode == "device_nms":
            continue
        metrics, results, losses = runs[mode]
        assert np.array_equal(metrics, base_m), (mode, metrics, base_m)
        assert np.array_equal(annotated[mode], base_a), (mode, annotated)
        seg_d, sc_d = same_detections(eval_answers(base_r), eval_answers(results))
        loss_d = max(abs(a[k] - b[k]) / (LOSS_ATOL / LOSS_RTOL + abs(b[k]))
                     for a, b in zip(losses, base_l) for k in a)
        emit({"phase": phase, "check": f"device_nms vs {mode}",
              "recall_equal": True, "recall_nonzero": bool(base_m.any()),
              "annotated_recall_equal": True, "seg_s": seg_d, "score": sc_d,
              "loss_rel": loss_d, "tol": {"seg_s": SEG_TOL_S, "score": SCORE_TOL,
                                         "loss_rel": LOSS_RTOL}})
        assert seg_d <= SEG_TOL_S and sc_d <= SCORE_TOL, (mode, seg_d, sc_d)
        assert loss_d <= LOSS_RTOL, (mode, loss_d)


def run_eval(root):
    """The eval CLI's entry point on the card: device SoftNMS, reference_exact
    and the plain versions, over an experiment directory written under
    ``root``. Returns the kernel launches of the first two, the
    experiment directory and the device-NMS run (metrics, results,
    losses)."""
    from decafnet_tpu_torch.ops.nms import build_host

    t0 = time.perf_counter()
    lib, build_s = build_host()
    emit({"phase": "eval", "host_nms": os.path.relpath(lib, REPO),
          "g++_s": build_s, "seconds": time.perf_counter() - t0})
    logdir = write_experiment(root)
    argv = ["--name", logdir, "--set", "eval.save_results", "True"]
    modes = {"device_nms": [], "reference_exact":
             ["eval.reference_exact", "True"], "plain_versions": []}
    runs, launches, ev, _ = eval_modes(argv, modes, "eval", 12, 12, 48)
    check_eval_modes(runs, ev.cfg, "eval")
    return launches, logdir, runs["device_nms"]


# --------------------------------------------------------------------- http

def run_http(logdir, serve_service, requests):
    """The HTTP endpoint over the experiment directory ``logdir`` (its
    opt.yaml and models/last.pth, loaded as the serve CLI loads them) on a
    free local port, in a thread: /healthz, /ground with one request,
    /ground_batch with two; answers must equal those of the serve phase's
    service, built from the same seeded weights in memory. Returns the
    kernel launches of the HTTP calls."""
    from http.server import ThreadingHTTPServer

    from decafnet_tpu_torch import ops
    from decafnet_tpu_torch.serve import make_handler, service_from_logdir

    service = service_from_logdir(logdir)
    assert service.device.type == "cuda"

    def as_json(req):
        return {k: ([x.tolist() for x in v] if k == "texts" else
                    v.tolist() if isinstance(v, np.ndarray) else v)
                for k, v in req.items()}

    one, two = requests[2], [requests[0], requests[5]]
    want_one = serve_service.ground(**one)
    want_two = serve_service.ground_many(two)
    bodies = {"/ground": json.dumps(as_json(one)).encode(),
              "/ground_batch": json.dumps(
                  {"requests": [as_json(r) for r in two]}).encode()}

    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        calls0 = service.decoder.decode_calls
        ops.reset_launch_counts()
        answers, walls = {}, {}
        for path, body in bodies.items():
            req = urllib.request.Request(url + path, data=body, headers={
                "Content-Type": "application/json"})
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=300) as r:
                answers[path] = json.loads(r.read())
            walls[path] = 1e3 * (time.perf_counter() - t0)
        launches = ops.launch_counts()
        calls = service.decoder.decode_calls - calls0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    assert not thread.is_alive()

    want = {n: c * calls for n, c in PER_DECODE.items()}
    seg_d, sc_d = same_detections([want_one] + want_two,
                                  [answers["/ground"]["detections"]]
                                  + answers["/ground_batch"]["detections_batch"])
    emit({"phase": "http", "healthz": {k: health[k] for k in
                                       ("status", "device", "device_name",
                                        "n_devices")},
          "request_bytes": {p: len(b) for p, b in bodies.items()},
          "wall_ms": walls, "decode_calls": calls, "launches": launches,
          "expected": want, "vs_service": {"seg_s": seg_d, "score": sc_d}})
    assert health["status"] == "ok" and health["device"].startswith("cuda")
    assert health["device_name"] == torch.cuda.get_device_name(0)
    assert launches == want and calls > 0, (launches, want)
    assert seg_d <= SEG_TOL_S and sc_d <= SCORE_TOL, (seg_d, sc_d)
    return launches


# --------------------------------------------------------------------- bf16

# bf16 kernels vs their bf16 plain versions on the card:
# |diff| <= 2 bf16 eps (2 * 2**-7) times max(1, |plain|), the CPU tests' rule.
# Both round at the same places (the conv outputs, the result); their f32
# sums run in another order, which can move a rounding by one bf16 step
TOL_BF16 = 2 * 2.0 ** -7
# the served bf16 decode's outputs, kernels vs plain versions, held to the
# bf16 noise floor (plain bf16 vs the f32 kernels), as tests/test_torch_bf16.py
# holds the port's bf16 model to JAX's: the mean |diff| within 1.5x, the max
# within 3x; bf16 vs f32 logits within 0.15 on average (JAX's own rule)
BF16_MEAN_X, BF16_MAX_X, BF16_DRIFT = 1.5, 3.0, 0.15


def bf16_err(got, want):
    """(max |diff|, max |diff| / max(1, |want|)) over the outputs, in f32."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    d = [((g.float() - w.float()).abs(), w.float().abs().clamp_min(1.0))
         for g, w in zip(got, want, strict=True)]
    return max(float(a.max()) for a, _ in d), max(float((a / m).max()) for a, m in d)


def check_bf16(op, args, kw, name, what):
    """One bf16 kernel call against its plain version on the same inputs."""
    from decafnet_tpu_torch.ops import cuda

    got = op(*args, **kw)
    with cuda.plain_versions():
        want = op(*args, **kw)
    torch.cuda.synchronize()
    outs = got if isinstance(got, tuple) else (got,)
    abs_err, rel_err = bf16_err(got, want)
    ok = (all(t.dtype == torch.bfloat16 and torch.isfinite(t).all() for t in outs)
          and rel_err <= TOL_BF16)
    emit({"phase": "bf16", "kernel": name + "_bf16", "check": what,
          "max_abs_err": abs_err, "max_rel_err": rel_err, "tol": TOL_BF16,
          "ok": ok})
    if not ok:
        raise AssertionError(f"{name}_bf16 disagrees with its plain version at "
                             f"{what}: max |diff| / max(1, |plain|) {rel_err}")
    return abs_err, rel_err


def run_bf16_kernels(dev, rec32, shape=SERVED):
    """Hold each bf16 kernel against its plain version in bf16 at the decode
    call shapes of ``shape`` (SERVED, then the edge shapes of the kernels
    phase; or MAD) and time them (kernel, plain version, SDPA in bf16 for
    band attention), each level beside the f32 kernel's time in ``rec32``
    (the kernels phase's records of the same shape). Bounds count 2 bytes
    per activation element, conv3's products at the dense bf16 rate.
    Returns per-kernel records summed over one decode call of ``shape``."""
    from decafnet_tpu_torch.ops import (band_attention, band_attention_torch,
                                        conv3_ln_act, conv3_ln_act_levels,
                                        conv3_ln_act_torch, cuda,
                                        qkv_depthwise_ln, qkv_depthwise_ln_torch)

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    rows, t0, where = shape["rows"], shape["t0"], shape["name"]
    rec = {n: {"max_abs_err": 0.0, "max_rel_err": 0.0, "ms": 0.0,
               "plain_ms": 0.0, "bound_ms": 0.0, "flop_ms": 0.0, "byte_ms": 0.0,
               "library_ms": None, "levels": []}
           for n in ("conv3_ln_act", "band_attention", "qkv_depthwise_ln")}

    def add(name, count, args, kw, op, plain, n_bytes, n_flops, level, lib=None,
            tc_flops=0):
        abs_err, rel_err = check_bf16(op, args, kw, name, f"{where} level {level}, "
                                      f"shape {tuple(args[0].shape)}")
        ms = time_ms(lambda: op(*args, **kw), 20)
        plain_ms = time_ms(lambda: plain(*args, **kw), 5, warmup=1)
        b_ms, _ = bound_ms(n_bytes, n_flops, tc_flops, BF16_FLOPS)
        lib_ms = library_time(lib, args, kw, shape) if lib else None
        r = rec[name]
        r["max_abs_err"] = max(r["max_abs_err"], abs_err)
        r["max_rel_err"] = max(r["max_rel_err"], rel_err)
        r["ms"] += count * ms
        r["plain_ms"] += count * plain_ms
        r["bound_ms"] += count * b_ms
        r["byte_ms"] += count * 1e3 * n_bytes / HBM_BYTES_PER_S
        r["flop_ms"] += count * 1e3 * max(n_flops / F32_FLOPS,
                                          tc_flops / BF16_FLOPS)
        if lib_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + count * lib_ms
        dims = list(args[0].shape)
        f32 = [lv["ms"] for lv in rec32[name]["levels"]
               if (lv["level"], lv["shape"]) == (level, dims)]
        r["levels"].append({"level": level, "shape": dims,
                            "calls": count, "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": b_ms, "share_of_bound": b_ms / ms,
                            "library_ms": lib_ms, "f32_ms": f32[0] if f32 else None})
        return r["levels"][-1]

    def conv3_level(level, count, args, kw):
        C, T = args[0].shape[1], args[0].shape[2]
        # x and the output in bf16 and the mask bytes; the weight image in
        # bf16 and the LN parameters in f32
        act_bytes, param_bytes = 2 * 2 * rows * C * T + rows * T, 2 * 3 * C * C + 4 * 2 * C
        gemm_flops = 2 * rows * T * C * 3 * C
        lvl = add("conv3_ln_act", count, args, kw, conv3_ln_act, conv3_ln_act_torch,
                  act_bytes + param_bytes, 8 * rows * C * T, level, tc_flops=gemm_flops)
        lvl["work"] = {"act_bytes": act_bytes, "param_bytes": param_bytes,
                       "n_flops": 8 * rows * C * T, "tc_flops": gemm_flops,
                       "gemm_flops": gemm_flops}

    def conv3_grouped(xs, masks, params, what):
        """One launch of the bf16 kernel over the levels; each level against
        the plain version in bf16."""
        before = (conv3_ln_act.launches, conv3_ln_act.launches_bf16)
        got = conv3_ln_act_levels(xs, masks, *params)
        assert (conv3_ln_act.launches, conv3_ln_act.launches_bf16) == (
            before[0], before[1] + 1)
        r = rec["conv3_ln_act"]
        for x, m, y in zip(xs, masks, got):
            with cuda.plain_versions():
                want = conv3_ln_act(x, m, *params)
            abs_err, rel_err = bf16_err(y, want)
            r["max_abs_err"] = max(r["max_abs_err"], abs_err)
            r["max_rel_err"] = max(r["max_rel_err"], rel_err)
            ok = (y.dtype == bf and bool(torch.isfinite(y).all())
                  and rel_err <= TOL_BF16)
            emit({"phase": "bf16", "kernel": "conv3_ln_act_bf16", "check":
                  f"{what}: level T={x.shape[2]}", "max_abs_err": abs_err,
                  "max_rel_err": rel_err, "tol": TOL_BF16, "ok": ok})
            if not ok:
                raise AssertionError(f"grouped conv3_ln_act_bf16 disagrees at "
                                     f"{what}, T={x.shape[2]}: {rel_err}")

    rec["conv3_ln_act"]["heads"] = conv3_heads(dev, g, bf, conv3_level,
                                               conv3_grouped, shape)
    conv3_grouped_summary(rec["conv3_ln_act"], BF16_FLOPS)
    for level in range(LEVELS):
        T = t0 // 2 ** level
        lens = row_lens(level, shape)
        n_valid = sum(min(n, T) for n in lens)
        args, kw = band_case(dev, g, rows, T, lens, dtype=bf)
        D = EMBD // HEADS
        n_bytes = 2 * (3 * n_valid * HEADS * D + rows * HEADS * T * D) + rows * T
        add("band_attention", 1, args, kw, band_attention, band_attention_torch,
            n_bytes, n_valid * HEADS * (4 * WINDOW * D + 4 * WINDOW), level,
            lib=sdpa_band)
        if level == 0:
            args, kw = trio_case(dev, g, rows, EMBD, T, lens, dtype=bf)
            n_bytes = 2 * 4 * rows * EMBD * T + 4 * 15 * EMBD + rows * T
            add("qkv_depthwise_ln", 1, args, kw, qkv_depthwise_ln,
                qkv_depthwise_ln_torch, n_bytes, 3 * rows * EMBD * T * (5 + 8),
                level)
        del args
    drop_partial_library(rec["band_attention"], shape)
    if shape is not SERVED:
        return rec

    def edge(name, op, args, kw, what):
        abs_err, rel_err = check_bf16(op, args, kw, name, what)
        r = rec[name]
        r["max_abs_err"] = max(r["max_abs_err"], abs_err)
        r["max_rel_err"] = max(r["max_rel_err"], rel_err)

    # band attention's other windows at one served level (64 rows, T=576),
    # and the served level 0 with an all-masked row
    for window in (3, 7, 9):
        args, kw = band_case(dev, g, ROWS, T0 // 4, row_lens(2), dtype=bf,
                             window=window)
        edge("band_attention", band_attention, args, kw,
             f"served level 2, window {window}")
    args, kw = band_case(dev, g, ROWS, T0, [0] + row_lens(0)[1:], dtype=bf)
    edge("band_attention", band_attention, args, kw,
         "served level 0, row 0 all masked")
    edge_Ts = (1000, 301, 36, 17, 9, 4, 3)
    for how in ("as_is", "offset"):
        xs, masks, params = conv3_levels_case(
            dev, g, 4, EMBD + RDIM, edge_Ts,
            [[T, max(T - 3, 1), T // 2, 0] for T in edge_Ts], how=how, dtype=bf)
        conv3_grouped(xs, masks, params, f"edge levels T={edge_Ts}, x {how}")
    for T in edge_Ts:
        lens = [T, max(T - 3, 1), T // 2, 0]
        for how in ("as_is", "offset"):
            args, kw = conv3_case(dev, g, 4, EMBD + RDIM, T, lens, how=how, dtype=bf)
            edge("conv3_ln_act", conv3_ln_act, args, kw, f"edge T={T}, x {how}")
            args, kw = trio_case(dev, g, 4, EMBD, T, lens, how, dtype=bf)
            edge("qkv_depthwise_ln", qkv_depthwise_ln, args, kw,
                 f"edge T={T}, x {how}")
        for how in ("as_is", "contiguous", "offset", "padded"):
            args, kw = band_case(dev, g, 4, T, lens, how=how, dtype=bf)
            edge("band_attention", band_attention, args, kw,
                 f"edge T={T}, q/k/v {how}")
    args, kw = band_case(dev, g, 16400, 3, [3, 2, 1, 0] * 4100, dtype=bf)
    edge("band_attention", band_attention, args, kw, "edge B*H = 65600, T=3")
    # a seq2 rank's level-0 block widened by the halo (32 rows, T = 1156):
    # time-minor as band_attention hands it over under time sharding (the
    # pipeline's 8-byte copies), and as (B, H, T, D) tensors (split 4)
    for how in ("as_is", "contiguous"):
        args, kw = band_case(dev, g, 32, T0 // 2 + 4, row_lens(1)[:32], how=how, dtype=bf)
        edge("band_attention", band_attention, args, kw,
             f"seq2 rank level 0, T={T0 // 2 + 4}, q/k/v {how}")
    args, kw = conv3_case(dev, g, 3, 16, 100, [100, 50, 0], bias=True, act="none",
                          dtype=bf)
    args = (args[0], args[1], torch.randn(24, 16, 3, generator=g, device=dev),
            torch.randn(24, generator=g, device=dev), None, None)
    edge("conv3_ln_act", conv3_ln_act, args, kw,
         "C_in 16 -> C_out 24, bias, no LN affine, no activation")
    # the widest build (C_out 256), not served
    args, kw = conv3_case(dev, g, 4, 256, 301, [301, 298, 150, 0], dtype=bf)
    edge("conv3_ln_act", conv3_ln_act, args, kw, "edge C=256, T=301")
    return rec


# the card test step: the bf16 autograd cases of the kernel tests
CARD_TESTS = ("tests/test_torch_kernels.py", "bf16_autograd", 9)
CARD_TESTS_TIMEOUT_S = 600


def run_card_tests():
    """``python -m pytest --noconftest`` over the card cases of
    tests/test_torch_kernels.py that CARD_TESTS selects (each op's bf16
    forward and backward under autograd against plain bf16 autograd), in a
    subprocess killed at CARD_TESTS_TIMEOUT_S; all of them must pass."""
    path, select, count = CARD_TESTS
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-q",
                           "-p", "no:cacheprovider", path, "-k", select],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=CARD_TESTS_TIMEOUT_S)
    lines = proc.stdout.strip().splitlines()
    passed = re.search(r"(\d+) passed", lines[-1] if lines else "")
    emit({"phase": "card_tests", "tests": f"{path} -k {select}", "rc": proc.returncode,
          "summary": lines[-1] if lines else proc.stderr[-2000:],
          "seconds": time.perf_counter() - t0})
    assert proc.returncode == 0 and passed and int(passed.group(1)) == count, (
        proc.stdout[-4000:], proc.stderr[-2000:])


def floor_rule(kern16, plain16, f32):
    """The bf16 noise-floor rule on flattened outputs: (mean, max) of
    |kernels - plain| in bf16 against those of |plain bf16 - f32 kernels|."""
    got, floor = (kern16 - plain16).abs(), (plain16 - f32).abs()
    return {"mean": float(got.mean()), "max": float(got.max()),
            "floor_mean": float(floor.mean()), "floor_max": float(floor.max()),
            "ok": bool(got.mean() <= BF16_MEAN_X * floor.mean()
                       and got.max() <= BF16_MAX_X * floor.max())}


def top1_agreement(a, b):
    """Mean IoU of two eval runs' top-1 segments, query by query."""
    ious = []
    for va, vb in zip(a.videos, b.videos, strict=True):
        assert va["vid_id"] == vb["vid_id"]
        for da, db in zip(va["detections"], vb["detections"], strict=True):
            if not len(da["scores"]) or not len(db["scores"]):
                ious.append(0.0)
                continue
            x, y = da["segments"][0], db["segments"][0]
            inter = max(0.0, min(x[1], y[1]) - max(x[0], y[0]))
            ious.append(inter / (max(x[1], y[1]) - min(x[0], y[0])))
    return float(np.mean(ious))


def run_bf16(dev, service32, logdir, eval_base, requests):
    """The bf16 compute mode (``tpu.compute_dtype: bfloat16``) on the card:
    GroundingService at the Ego4D-NLQ width with the serve phase's seeded
    weights, 8 x 8 at T = 2304 (launches of the bf16 kernels per decode call,
    none of the f32 ones; outputs against the plain versions in bf16 by the
    noise-floor rule and against f32; wall, busy share, kernel launches and
    peak memory beside the f32 service's on the same batch); the eval CLI's
    entry point over the eval phase's 12 videos (launches; R@k count flips
    and top-1 agreement against the f32 run, printed, not gated: with random
    weights the scores are near flat); one /ground over HTTP. Returns the
    bf16 kernel launches of those paths and the bf16 service."""
    from http.server import ThreadingHTTPServer

    from decafnet_tpu_torch import ops
    from decafnet_tpu_torch.core import load_config
    from decafnet_tpu_torch.eval.__main__ import build_evaluator
    from decafnet_tpu_torch.models import random_params
    from decafnet_tpu_torch.ops import cuda
    from decafnet_tpu_torch.serve import (GroundingService, make_handler,
                                          service_from_logdir)
    from decafnet_tpu_torch.utils import EvalResults

    bf = torch.bfloat16
    t_phase = time.perf_counter()
    cfg = load_config(os.path.join(REPO, "configs", "ego4d_nlq.yaml"))
    cfg.tpu.compute_dtype = "bfloat16"
    service = GroundingService(cfg, params=random_params(cfg, SEED))
    assert service.device.type == "cuda" and service.model.compute_dtype == bf
    rng = np.random.default_rng(SEED + 5)
    batch = [make_request(rng, cfg, T0, 8, tokens=(9, 16)) for _ in range(8)]
    k = cfg.nms.max_num_segs
    for s in (service, service32):           # warm-up outside the counts
        s.ground_many(batch)
    torch.cuda.synchronize()

    # the main path in bf16: counts to 0 just before, read just after
    dec = service.decoder
    calls0 = dec.decode_calls
    ops.reset_launch_counts()
    walls = {"bfloat16": [], "float32": []}
    for _ in range(3):
        t0 = time.perf_counter()
        answers = service.ground_many(batch)
        walls["bfloat16"].append(1e3 * (time.perf_counter() - t0))
    launches = ops.launch_counts(bf)
    f32_launches = ops.launch_counts()
    calls = dec.decode_calls - calls0
    want = {n: c * calls for n, c in PER_DECODE.items()}
    emit({"phase": "bf16", "path": "serve", "decode_calls": calls,
          "launches_bf16": launches, "launches_f32": f32_launches,
          "expected": want})
    assert launches == want, (launches, want)
    assert not any(f32_launches.values()), f32_launches
    for req, ans in zip(batch, answers):
        check_detections(ans, req, k)
    for _ in range(3):
        t0 = time.perf_counter()
        service32.ground_many(batch)
        walls["float32"].append(1e3 * (time.perf_counter() - t0))

    # the decode's outputs: kernels vs plain versions in bf16, vs f32
    inputs = variant_inputs(cfg, dev)
    with torch.inference_mode():
        out16 = service.model(*inputs, queries_per_video=8)
        with cuda.plain_versions():
            plain16 = service.model(*inputs, queries_per_video=8)
        out32 = service32.model(*inputs, queries_per_video=8)
    checks = {}
    for group, key in ((1, "logits2"), (2, "offsets")):
        assert all(t.dtype == bf for t in out16[group] + plain16[group])
        flat = [torch.cat([t.float().reshape(-1) for t in out[group]])
                for out in (out16, plain16, out32)]
        checks[key] = floor_rule(*flat)
        checks[key]["bf16_vs_f32_mean"] = float((flat[0] - flat[2]).abs().mean())
    emit({"phase": "bf16", "check": "served decode outputs, kernels vs plain "
          "versions in bf16 (noise floor: plain bf16 vs f32 kernels)",
          "rule": {"mean_x": BF16_MEAN_X, "max_x": BF16_MAX_X,
                   "bf16_vs_f32_mean": BF16_DRIFT}, **checks})
    for key, c in checks.items():
        assert c["ok"] and c["bf16_vs_f32_mean"] < BF16_DRIFT, (key, c)

    # wall, busy share, kernel launches and peak memory, f32 beside bf16
    side = {}
    for name, s in (("float32", service32), ("bfloat16", service)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        s.ground_many(batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        prof = profile_decode(s, batch, phase="bf16")
        side[name] = {"wall_ms": walls[name], "profiled_wall_ms": prof["wall_ms"],
                      "device_busy_ms": prof["device_busy_ms"],
                      "busy_share": prof["device_busy_ms"] / prof["wall_ms"],
                      "kernel_launches": prof["kernel_launches"],
                      "peak_mem_gb": peak}
    emit({"phase": "bf16", "decode": "ground_many of 8 videos x 8 queries at "
          "2304 clips, f32 and bf16 services, same batch", **side})

    # the eval CLI's entry point over the eval phase's 12 videos in bf16
    ev = build_evaluator(["--name", logdir, "--set", "eval.save_results", "True",
                          "tpu.compute_dtype", "bfloat16"])
    assert ev.device.type == "cuda" and ev.model.compute_dtype == bf
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = ev.run(tag="bf16")
    wall_s = time.perf_counter() - t0
    eval_launches, calls = ops.launch_counts(bf), ev.decoder.decode_calls
    f32_launches = ops.launch_counts()
    results = EvalResults.load(os.path.join(logdir, "results_bf16.pk"))
    base_m, base_r, _ = eval_base
    n_q = ev.meter.text_cnt
    flips = np.abs(np.round(metrics * n_q) - np.round(base_m * n_q)).sum(axis=1)
    want = {n: c * calls for n, c in PER_DECODE.items()}
    emit({"phase": "bf16", "path": "eval", "recall": metrics.tolist(),
          "recall_f32": base_m.tolist(), "queries": n_q,
          "count_flips_by_rank": dict(zip(map(str, ev.cfg.eval.ranks),
                                          flips.tolist())),
          "top1_agreement_iou": top1_agreement(results, base_r),
          "decode_calls": calls, "launches_bf16": eval_launches,
          "launches_f32": f32_launches, "expected": want, "wall_s": wall_s,
          "video_ms": ev.video_ms})
    assert calls == 12 and eval_launches == want, (eval_launches, want)
    assert not any(f32_launches.values()), f32_launches
    assert all(np.isfinite(loss[key]) for v in results.videos
               for loss in v["losses"] for key in ("cls_loss", "reg_loss"))

    # one /ground over HTTP, the serve CLI's service with --set
    http = service_from_logdir(logdir, set_cfgs=["tpu.compute_dtype", "bfloat16"])
    assert http.model.compute_dtype == bf
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(http))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    req = requests[2]
    body = json.dumps({k: ([x.tolist() for x in v] if k == "texts" else
                           v.tolist() if isinstance(v, np.ndarray) else v)
                       for k, v in req.items()}).encode()
    try:
        calls0 = http.decoder.decode_calls
        ops.reset_launch_counts()
        with urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{server.server_address[1]}/ground", data=body,
                headers={"Content-Type": "application/json"}), timeout=300) as r:
            answer = json.loads(r.read())["detections"]
        http_launches = ops.launch_counts(bf)
        calls = http.decoder.decode_calls - calls0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    assert not thread.is_alive()
    check_detections(answer, req, k)
    want = {n: c * calls for n, c in PER_DECODE.items()}
    emit({"phase": "bf16", "path": "http", "decode_calls": calls,
          "launches_bf16": http_launches, "expected": want,
          "seconds": time.perf_counter() - t_phase})
    assert calls > 0 and http_launches == want, (http_launches, want)
    return {"bf16_serve": launches, "bf16_eval": eval_launches,
            "bf16_http": http_launches}, service


# ---------------------------------------------------------------------- mad

# the mad phase's synthetic val split at configs/mad.yaml's feature widths
# and clip grid: movie 0 in the 16384 bucket, the longest that the shipped
# max_seq_len 2048 decodes (8x the base: both packages buffer candidate
# points for 10 x max_seq_len, decafnet_tpu/eval/evaluator.py:111, so the
# 32768 bucket would ask for more), with 40 queries (a chunk of 32 and one
# of 8); movie 1 at 24576-32768 clips with 8 queries
MAD_MOVIES = ({"clips": 14001, "queries": 40}, {"clips": None, "queries": 8})
# the T = 32768 decode: the JAX package's own setting for MAD-length decodes
# (scripts/mad_eval_ab.py, tests/test_time_sharded_long.py) and the
# remat_mad leg's: the PE table and the point buffer at the movie length
MAD_LONG = ["model.vid_net.max_seq_len", str(MAD_T)]
BF16 = ["tpu.compute_dtype", "bfloat16"]


def write_mad_experiment(root):
    """A synthetic MAD val split (MAD_MOVIES: split "val" holds both movies,
    split "pe" movie 0 only) and an experiment directory over it: opt.yaml
    (configs/mad.yaml as shipped, pointed at the data) and models/last.pth
    (seeded random weights). Returns the directory."""
    from decafnet_tpu_torch.core import load_config
    from decafnet_tpu_torch.data import apply_synthetic_cfg, make_synthetic_dataset
    from decafnet_tpu_torch.models import random_params, save_pth

    t0 = time.perf_counter()
    cfg = load_config(os.path.join(REPO, "configs", "mad.yaml"))
    d = cfg.data
    paths = make_synthetic_dataset(
        os.path.join(root, "mad_eval_data"), num_videos=len(MAD_MOVIES),
        num_queries=max(m["queries"] for m in MAD_MOVIES),
        clip_range=(3 * MAD_T // 4, MAD_T + 1), vid_dim=cfg.model.vid_net.in_dim,
        shallow_dim=cfg.model.vid_net.in_dim, text_dim=cfg.model.text_net.in_dim,
        clip_size=d.clip_size, clip_stride=d.clip_stride, splits=("val",),
        seed=SEED + 6)
    with open(paths["anno_file"]) as f:
        anno = json.load(f)
    clips = []
    for i, movie in enumerate(MAD_MOVIES):
        vid = f"val_vid{i:03d}"
        info = anno["val"][vid]
        n = movie["clips"] or info["num_clips"]
        if n != info["num_clips"]:       # cut to its bucket
            for key in ("vid_feat_dir", "shallow_vid_feat_dir"):
                path = os.path.join(paths[key], vid + ".npy")
                np.save(path, np.load(path)[:n])
            info["num_clips"] = n
            info["num_frames"] = (n - 1) * d.clip_stride + d.clip_size
            info["duration"] = info["num_frames"] / info["fps"]
        info["annotations"] = [
            dict(a, segment=[min(a["segment"][0], 0.8 * info["duration"]),
                             min(a["segment"][1], info["duration"])])
            for a in info["annotations"][:movie["queries"]]]
        clips.append(n)
    anno["pe"] = {"val_vid000": anno["val"]["val_vid000"]}
    with open(paths["anno_file"], "w") as f:
        json.dump(anno, f)
    shutil.copy(paths["text_cls_fname"].format(split="val"),
                paths["text_cls_fname"].format(split="pe"))
    apply_synthetic_cfg(cfg, paths, clip_size=d.clip_size,
                        clip_stride=d.clip_stride)
    logdir = os.path.join(root, "mad_exp")
    os.makedirs(os.path.join(logdir, "models"))
    cfg.dump_to_file(os.path.join(logdir, "opt.yaml"))
    save_pth(os.path.join(logdir, "models", "last.pth"), random_params(cfg, SEED))
    emit({"phase": "mad", "experiment": "configs/mad.yaml over a synthetic "
          "val split", "clips": clips,
          "queries": [m["queries"] for m in MAD_MOVIES],
          "max_seq_len": cfg.model.vid_net.max_seq_len,
          "setup_s": time.perf_counter() - t0})
    assert 8 * cfg.data.max_vid_len < MAD_T and \
        4 * cfg.data.max_vid_len < clips[0] <= 8 * cfg.data.max_vid_len
    assert 3 * MAD_T // 4 <= clips[1] <= MAD_T, clips
    return logdir


def run_mad(root, smi):
    """The MAD movie-length path (configs/mad.yaml at full width and depth,
    seeded random weights) through the serve and eval entry points:

    serve  GroundingService of the experiment directory (as the serve CLI
           builds it, --set model.vid_net.max_seq_len 32768) grounding one
           32768-clip movie with 32 queries: 8 / 7 / 1 launches per decode
           call, detections against the plain versions (1e-3 s / 1e-4),
           wall, busy share and device kernels per decode (torch.profiler),
           peak memory of the kernels and of the plain versions;
    eval   the eval CLI's entry point at T = 32768 over both movies: device
           SoftNMS, eval.reference_exact and the plain versions, tables
           equal, also on annotations made from the device detections;
           wall per movie and peak memory;
    pe     the eval CLI at the shipped max_seq_len 2048 over movie 0 (the
           16384 bucket, through the PE interpolation plans): device
           SoftNMS against the plain versions by the same checks;
    bf16   the serve and eval paths in bf16 (tpu.compute_dtype bfloat16):
           launches of the bf16 kernels only, the detections' form, wall,
           busy share and peak memory; R@k count flips and top-1 agreement
           with f32, printed only (the weights are random).

    Returns the f32 kernel launches by path, the bf16 ones, the experiment
    directory and the f32 T = 32768 eval (device-NMS run, peak GB)."""
    from decafnet_tpu_torch import ops
    from decafnet_tpu_torch.data.batching import bucket_length
    from decafnet_tpu_torch.eval.__main__ import build_evaluator
    from decafnet_tpu_torch.eval.metrics import interval_iou
    from decafnet_tpu_torch.ops import cuda
    from decafnet_tpu_torch.serve import service_from_logdir
    from decafnet_tpu_torch.utils import EvalResults

    t_phase = time.perf_counter()
    logdir = write_mad_experiment(root)
    paths, paths16 = {}, {}

    def serve(service, label):
        """One movie through ``service``: launches, detections, walls,
        profile, peak memory."""
        dtype = service.model.compute_dtype or torch.float32
        cfg = service.decoder.cfg
        assert service.device.type == "cuda" and cfg.data.max_vid_len == MAD_T
        # 9-16 tokens: every query in the 16-token bucket that warmup runs
        req = make_request(np.random.default_rng(SEED + 7), cfg, MAD_T,
                           MAD_QUERIES, tokens=(9, 16))
        service.warmup(MAD_T, MAD_QUERIES, text_len=16)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dec = service.decoder
        calls0 = dec.decode_calls
        ops.reset_launch_counts()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            answer = service.ground(**req)
            walls.append(1e3 * (time.perf_counter() - t0))
        launches, other = ops.launch_counts(dtype), ops.launch_counts(
            torch.bfloat16 if dtype == torch.float32 else torch.float32)
        calls = dec.decode_calls - calls0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        want = {n: c * calls for n, c in PER_DECODE.items()}
        check_detections(answer, req, cfg.nms.max_num_segs)
        torch.cuda.reset_peak_memory_stats()
        with cuda.plain_versions():
            t0 = time.perf_counter()
            plain = service.ground(**req)
            plain_ms = 1e3 * (time.perf_counter() - t0)
        plain_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if dtype == torch.float32:
            vs_plain = dict(zip(("seg_s", "score"),
                                same_detections([answer], [plain])))
        else:   # bf16 scores tie: the top-1 segments' mean IoU, printed
            vs_plain = {"top1_iou": float(np.mean([interval_iou(
                np.asarray(a["segments"][:1], np.float64),
                np.asarray(b["segments"][:1], np.float64))[0]
                for a, b in zip(answer, plain)]))}
        prof = profile_call(lambda: service.ground(**req),
                            f"one ground of a {MAD_T}-clip movie x "
                            f"{MAD_QUERIES} queries, {label} (profiler on)", "mad")
        rec = {"phase": "mad", "path": f"serve_{label}", "clips": MAD_T,
               "queries": MAD_QUERIES, "decode_calls": calls,
               "launches": launches, "launches_other_dtype": other,
               "expected": want, "wall_ms": walls,
               "plain_versions_wall_ms": plain_ms,
               "busy_share": prof["device_busy_ms"] / prof["wall_ms"],
               "device_kernels_per_decode": prof["kernel_launches"],
               "kernels_vs_plain": vs_plain,
               "tol": {"seg_s": SEG_TOL_S, "score": SCORE_TOL},
               "peak_mem_gb": peak, "plain_versions_peak_mem_gb": plain_peak,
               "stats": service.stats(), "card": smi}
        emit(rec)
        assert calls == 3 and launches == want, (launches, want)
        assert not any(other.values()), other
        if dtype == torch.float32:
            assert vs_plain["seg_s"] <= SEG_TOL_S and \
                vs_plain["score"] <= SCORE_TOL, vs_plain
        return launches, answer

    # serve in f32 and bf16 (the service of the serve CLI's --set)
    service = service_from_logdir(logdir, set_cfgs=MAD_LONG)
    paths["mad_serve"], answer32 = serve(service, "f32")
    del service
    service = service_from_logdir(logdir, set_cfgs=MAD_LONG + BF16)
    assert service.model.compute_dtype == torch.bfloat16
    paths16["bf16_mad_serve"], answer16 = serve(service, "bf16")
    del service
    torch.cuda.empty_cache()
    emit({"phase": "mad", "check": "served movie, bf16 vs f32 (printed only)",
          "top1": [{"f32": a["segments"][0] if a["segments"] else None,
                    "bf16": b["segments"][0] if b["segments"] else None}
                   for a, b in zip(answer32[:4], answer16[:4])]})

    # the eval CLI at T = 32768 over both movies, three modes
    argv = ["--name", logdir, "--set", "eval.save_results", "True", *MAD_LONG]
    modes = {"device_nms": [], "reference_exact":
             ["eval.reference_exact", "True"], "plain_versions": []}
    n_q = sum(m["queries"] for m in MAD_MOVIES)
    # a chunk of 32 queries and one of 8 for movie 0, one of 8 for movie 1
    runs, paths["mad_eval"], ev, peaks = eval_modes(argv, modes, "mad", 3, 2, n_q)
    assert ev.cfg.data.max_vid_len == MAD_T
    check_eval_modes(runs, ev.cfg, "mad")
    base = runs["device_nms"]

    # the shipped max_seq_len 2048 over movie 0: the 16384 bucket, 8x
    pe_argv = ["--name", logdir, "--set", "eval.save_results", "True",
               "data.eval_split", "pe"]
    pe_runs, paths["mad_pe"], ev_pe, _ = eval_modes(
        pe_argv, {"device_nms": [], "plain_versions": []}, "mad", 2, 1,
        MAD_MOVIES[0]["queries"])
    # movie 0 decoded in the bucket 8x the shipped base length, where the
    # 32768 one asks for more candidate points than the Decoder buffers
    pe_base = ev_pe.cfg.data.max_vid_len
    assert bucket_length(MAD_MOVIES[0]["clips"], ev_pe.decoder.chunk, pe_base) \
        == 8 * pe_base and len(ev_pe.decoder.all_points[0]) < MAD_T
    check_eval_modes(pe_runs, ev_pe.cfg, "mad")

    # the eval CLI in bf16 at T = 32768
    bf = torch.bfloat16
    ev = build_evaluator(argv + BF16)
    assert ev.model.compute_dtype == bf
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = ev.run(tag="bf16")
    wall_s = time.perf_counter() - t0
    launches16, calls = ops.launch_counts(bf), ev.decoder.decode_calls
    launches32 = ops.launch_counts()
    results = EvalResults.load(os.path.join(logdir, "results_bf16.pk"))
    base_m, base_r, _ = base
    flips = np.abs(np.round(metrics * n_q) - np.round(base_m * n_q)).sum(axis=1)
    want = {n: c * calls for n, c in PER_DECODE.items()}
    emit({"phase": "mad", "path": "eval_bf16", "recall": metrics.tolist(),
          "recall_f32": base_m.tolist(), "queries": n_q,
          "count_flips_by_rank": dict(zip(map(str, ev.cfg.eval.ranks),
                                          flips.tolist())),
          "top1_agreement_iou": top1_agreement(results, base_r),
          "decode_calls": calls, "launches_bf16": launches16,
          "launches_f32": launches32, "expected": want, "wall_s": wall_s,
          "video_ms": ev.video_ms,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
          "f32_peak_mem_gb": peaks["device_nms"], "card": smi,
          "seconds": time.perf_counter() - t_phase})
    assert calls == 3 and launches16 == want, (launches16, want)
    assert not any(launches32.values()), launches32
    assert all(np.isfinite(loss[key]) for v in results.videos
               for loss in v["losses"] for key in ("cls_loss", "reg_loss"))
    paths16["bf16_mad_eval"] = launches16
    return paths, paths16, logdir, (base, peaks["device_nms"])


# ----------------------------------------------------------------- variants

# make_model's other architectures at the Ego4D-NLQ width: model-tree
# overrides of configs/ego4d_nlq.yaml (the same random weights as the serve
# phase where the tree is the same)
VARIANTS = {
    "iter2": {"name": "iter2"},
    "early": {"name": "early"},
    "early2": {"name": "early2"},
    "default": {"name": "default"},
    "identity_pool_only": {"name": "iter", "text_net.name": "identity",
                           "vid_net.pool_only": True},
}
# each output list of a variant's forward, kernels vs plain versions
VARIANT_TOL = 1e-4
VARIANT_RUNS = 3


def variant_cfg(overrides):
    from decafnet_tpu_torch.core import load_config, update_opt

    cfg = load_config(os.path.join(REPO, "configs", "ego4d_nlq.yaml"))
    for key, value in overrides.items():
        node, *path = [cfg.model] + key.split(".")
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = value
    return update_opt(cfg)


def variant_inputs(cfg, dev, V=8, Q=8, L=16, T=T0, lens=VIDEO_LENS):
    """One video-major batch: V videos at T (``lens`` valid) and V*Q
    queries of 9-16 tokens, from the seed, on the card."""
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    cv, ct = cfg.model.vid_net.in_dim, cfg.model.text_net.in_dim
    n_tokens = torch.randint(9, L + 1, (V * Q,), generator=g, device=dev)
    return (torch.randn(V, cv, T, generator=g, device=dev),
            torch.randn(V, cv, T, generator=g, device=dev),
            prefix_mask(lens, T, dev),
            torch.randn(V * Q, ct, L, generator=g, device=dev),
            torch.randn(V * Q, cv, generator=g, device=dev),
            torch.arange(L, device=dev)[None, :] < n_tokens[:, None])


def synced_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), out


def run_variants(dev, root):
    """Every other architecture of make_model at the Ego4D-NLQ width and full
    depth, seeded random weights: iter2, early, early2, default and iter with
    the identity text net and pool_only branches. Each runs a forward of 8
    videos x 8 queries at T = 2304 through the kernels (VARIANT_RUNS times,
    counted) and through the plain versions, output lists held within
    VARIANT_TOL. iter2 is also served: ground_many of the same shape with the
    detections checked, once more under utils.profiling.trace with an
    annotate region, whose trace file must name the region, and through the
    plain versions. Returns the kernel launches of the counted runs."""
    from decafnet_tpu_torch import ops
    from decafnet_tpu_torch.models import init_random, make_model, random_params
    from decafnet_tpu_torch.ops import cuda
    from decafnet_tpu_torch.serve import GroundingService
    from decafnet_tpu_torch.utils import annotate, trace

    models = {}
    for name, overrides in VARIANTS.items():
        cfg = variant_cfg(overrides)
        model = init_random(make_model(cfg), SEED).to(dev).eval()
        models[name] = (cfg, model)
    inputs = variant_inputs(models["iter2"][0], dev)
    cfg2 = models["iter2"][0]
    service = GroundingService(cfg2, params=random_params(cfg2, SEED))
    rng = np.random.default_rng(SEED + 3)
    batch = [make_request(rng, cfg2, T0, 8, tokens=(9, 16)) for _ in range(8)]
    k = cfg2.nms.max_num_segs

    def forward(model):
        with torch.inference_mode():
            return model(*inputs, queries_per_video=8)

    # warm-up outside the counted run
    for _, model in models.values():
        forward(model)
    service.ground_many(batch)
    torch.cuda.synchronize()

    # the main path: counts to 0 just before, read just after
    ops.reset_launch_counts()
    outs, walls, counted = {}, {}, {}
    for name, (_, model) in models.items():
        before = ops.launch_counts()
        runs = [synced_ms(lambda: forward(model)) for _ in range(VARIANT_RUNS)]
        after = ops.launch_counts()
        counted[name] = {n: after[n] - before[n] for n in after}
        walls[name] = [ms for ms, _ in runs]
        outs[name] = runs[0][1]
    dec = service.decoder
    calls0 = dec.decode_calls
    ground_ms, answers = synced_ms(lambda: service.ground_many(batch))
    trace_dir = os.path.join(root, "variants_trace")
    region = "variants/iter2_ground_many"
    with trace(trace_dir):
        with annotate(region):
            traced_ms, traced = synced_ms(lambda: service.ground_many(batch))
    calls = dec.decode_calls - calls0
    launches = ops.launch_counts()

    want = {n: VARIANT_RUNS * sum(PER_FORWARD[v][n] for v in VARIANTS)
            + calls * PER_FORWARD["iter2"][n] for n in PER_DECODE}
    for name, count in counted.items():
        per = {n: c / VARIANT_RUNS for n, c in count.items()}
        assert per == PER_FORWARD[name], (name, per, PER_FORWARD[name])
    assert calls == 2 and launches == want, (calls, launches, want)
    for req, ans in zip(batch, answers):
        check_detections(ans, req, k)
    seg_t, sc_t = same_detections(answers, traced)
    assert seg_t <= SEG_TOL_S and sc_t <= SCORE_TOL, (seg_t, sc_t)
    files = [os.path.join(dp, f) for dp, _, fs in os.walk(trace_dir) for f in fs]
    assert len(files) == 1 and files[0].endswith(".json"), files
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    named = sum(e.get("name") == region for e in events)
    device_events = sum(e.get("cat") == "kernel" for e in events)
    assert named >= 1 and device_events > 0, (named, device_events)

    # the same forwards and requests through the plain versions
    with cuda.plain_versions():
        plain = {}
        for name, (_, model) in models.items():
            plain[name] = [synced_ms(lambda: forward(model))
                           for _ in range(VARIANT_RUNS)]
        plain_answers = service.ground_many(batch)
    assert ops.launch_counts() == launches
    seg_p, sc_p = same_detections(answers, plain_answers)
    for name, (cfg, model) in models.items():
        got, ref = outs[name], plain[name][0][1]
        lists = ("cls_logits", "cls2_logits", "offsets", "masks")
        if len(got) == 3:
            lists = ("cls_logits", "offsets", "masks")
        diff, masks_equal = {}, True
        for label, a, b in zip(lists, got, ref, strict=True):
            if a[0].dtype == torch.bool:
                masks_equal &= all(torch.equal(x, y) for x, y in zip(a, b))
            else:
                diff[label] = max(float((x - y).abs().max()) for x, y in zip(a, b))
                assert all(torch.isfinite(x).all() for x in a), (name, label)
        emit({"phase": "variants", "variant": name, "model": type(model).__name__,
              "overrides": VARIANTS[name], "params": sum(
                  p.numel() for p in model.parameters()),
              "outputs": len(got), "levels": len(got[0]),
              "shape": "8 videos x 8 queries at T=2304",
              "launches_per_forward": {n: c / VARIANT_RUNS
                                       for n, c in counted[name].items()},
              "expected": PER_FORWARD[name], "max_abs_diff": diff,
              "masks_equal": masks_equal, "tol": VARIANT_TOL,
              "wall_ms": walls[name],
              "plain_wall_ms": [ms for ms, _ in plain[name]]})
        assert masks_equal and max(diff.values()) <= VARIANT_TOL, (name, diff)
    emit({"phase": "variants", "served": "iter2", "decode_calls": calls,
          "launches": launches, "expected": want,
          "ground_many_8x8_ms": ground_ms, "traced_ms": traced_ms,
          "trace": {"file": os.path.basename(files[0]),
                    "bytes": os.path.getsize(files[0]), "region": region,
                    "region_events": named, "kernel_events": device_events},
          "kernels_vs_plain": {"seg_s": seg_p, "score": sc_p},
          "traced_vs_untraced": {"seg_s": seg_t, "score": sc_t},
          "tol": {"seg_s": SEG_TOL_S, "score": SCORE_TOL}})
    assert seg_p <= SEG_TOL_S and sc_p <= SCORE_TOL, (seg_p, sc_p)
    del models, service
    torch.cuda.empty_cache()
    return launches


# -------------------------------------------------------------------- train

def write_train_data(root):
    """A synthetic train split (32 videos x 2 queries, 1000-2304 clips) and
    a val split (4 videos x 3 queries) at the Ego4D-NLQ feature widths, and a
    config file pointing the train and eval data trees at them."""
    import yaml

    from decafnet_tpu_torch.core import load_config
    from decafnet_tpu_torch.data import make_synthetic_dataset

    t0 = time.perf_counter()
    cfg = load_config(os.path.join(REPO, "configs", "ego4d_nlq.yaml"))
    dims = dict(vid_dim=cfg.model.vid_net.in_dim,
                shallow_dim=cfg.model.vid_net.in_dim,
                text_dim=cfg.model.text_net.in_dim)
    train = make_synthetic_dataset(os.path.join(root, "train_data"),
                                   num_videos=32, num_queries=2,
                                   clip_range=(1000, 2305), splits=("train",),
                                   seed=SEED + 1, **dims)
    val = make_synthetic_dataset(os.path.join(root, "val_data"), num_videos=4,
                                 num_queries=3, clip_range=(900, 2305),
                                 splits=("val",), seed=SEED + 2, **dims)
    keys = ("anno_file", "vid_feat_dir", "shallow_vid_feat_dir",
            "clip_token_fname", "text_cls_fname")
    # both streams of the synthetic data sit on one clip grid
    data = {"data": {**{k: train[k] for k in keys}, "shallow_ds": 1},
            "eval": {"data": {**{k: val[k] for k in keys}, "shallow_ds": 1}}}
    path = os.path.join(root, "synthetic_data.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(data, f)
    emit({"phase": "train", "data": "synthetic train split 32 videos x 2 "
          "queries (1000-2304 clips), val split 4 videos x 3 queries",
          "widths": dims, "setup_s": time.perf_counter() - t0})
    return path


class StepProbe:
    """Wraps a Trainer's ``train_step`` to record, per step, the device-
    synchronised wall time of the step (data loading excluded), its
    metrics and how far the weights moved."""

    def __init__(self, trainer):
        self.trainer, self.step_fn = trainer, trainer.train_step
        self.prev = [p.detach().clone() for p in trainer.model.parameters()]
        self.records = []
        trainer.train_step = self

    def __call__(self, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = self.step_fn(batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        params = list(self.trainer.model.parameters())
        moved = max(float((p - q).abs().max()) for p, q in zip(params, self.prev))
        self.prev = [p.detach().clone() for p in params]
        step = self.trainer.step
        self.records.append({"step": step, "ms": ms,
                             "lr": self.trainer.optimizer.schedule(step - 1),
                             "max_weight_change": moved,
                             **{k: float(v) for k, v in metrics.items()}})
        return metrics


def conv3_sites(model):
    """(conv weight, bias, LN) of every conv3_ln_act call site of a model."""
    vn = model.vid_net
    sites = [(c.conv, n) for c, n in zip(vn.embd_convs, vn.embd_norms)
             if c.conv.kernel_size == 3 and c.stride == 1]
    for head in (model.cls_head, model.cls_head2, model.reg_head):
        sites += [(c.conv, n) for c, n in zip(head.convs, head.norms)]
    return [(c.weight, c.bias, n.weight, n.bias) for c, n in sites]


def grads_close(got, want, top=4):
    """Worst ratio of |a - b| to rtol 1e-3 * |b| + atol 1e-4 * max|b| over
    the gradient leaves; leaves noise-sized on both sides (max |g| <= 1e-8,
    tests/test_grouped_eval.py:181-187) are skipped. Returns (worst ratio,
    leaves skipped, the ``top`` leaves by ratio with their max |a - b| and
    max |b|)."""
    rows, skipped = [], 0
    for name, b in want.items():
        a = got[name]
        if max(float(a.abs().max()), float(b.abs().max())) <= 1e-8:
            skipped += 1
            continue
        lim = GRAD_RTOL * b.abs() + GRAD_ATOL * float(b.abs().max())
        rows.append((float(((a - b).abs() / lim).max()), name,
                     float((a - b).abs().max()), float(b.abs().max())))
    rows.sort(reverse=True)
    return rows[0][0], skipped, [
        {"leaf": n, "over_tol": r, "max_abs_diff": d, "max_abs": m}
        for r, n, d, m in rows[:top]]


def grads_rel_l2(got, want, top=4):
    """Relative L2 distance ||a - b|| / ||b|| of all gradient leaves
    together, and the ``top`` leaves by their own (leaves noise-sized on
    both sides skipped, as in :func:`grads_close`)."""
    num = sum(float((got[n] - b).square().sum()) for n, b in want.items())
    den = sum(float(b.square().sum()) for b in want.values())
    leaves = sorted(((float((got[n] - b).norm() / b.norm()), n)
                     for n, b in want.items()
                     if max(float(got[n].abs().max()),
                            float(b.abs().max())) > 1e-8), reverse=True)
    return (num / den) ** 0.5, [{"leaf": n, "rel_l2": r}
                                for r, n in leaves[:top]]


def op_backward_check(dev, rows=32, dtype=torch.float32):
    """Each kernel op under autograd at the level-0 train shape (32 rows,
    T = 2304), activations in ``dtype`` (f32 parameters, as training runs
    them): the forward launches the kernel of that dtype once and the
    backward launches nothing; its gradients, given the same output
    gradient, equal those of autograd through the plain version (cuDNN's
    deterministic algorithms), max |diff| within OP_GRAD_RTOL of the
    largest |g|."""
    from decafnet_tpu_torch import ops

    g = torch.Generator(device=dev).manual_seed(SEED)
    lens = [VIDEO_LENS[i % len(VIDEO_LENS)] for i in range(rows)]
    cases = {"conv3_ln_act": conv3_case(dev, g, rows, EMBD + RDIM, T0, lens,
                                        dtype=dtype),
             "qkv_depthwise_ln": trio_case(dev, g, rows, EMBD, T0, lens,
                                           dtype=dtype),
             "band_attention": band_case(dev, g, rows, T0, lens, dtype=dtype)}
    count = "launches_bf16" if dtype == torch.bfloat16 else "launches"

    def leaf(a):
        if isinstance(a, list):
            return [leaf(t) for t in a]
        if torch.is_tensor(a) and a.is_floating_point():
            return a.detach().requires_grad_()
        return a

    def grads(leaves):
        flat = []
        for a in leaves:
            for t in (a if isinstance(a, list) else [a]):
                if torch.is_tensor(t) and t.requires_grad:
                    flat.append(t.grad)
        return flat

    report = {}
    torch.backends.cudnn.deterministic = True
    try:
        for name, (args, kw) in cases.items():
            op, plain = getattr(ops, name), getattr(ops, name + "_torch")
            runs = []
            for fn in (op, plain):
                leaves = [leaf(a) for a in args]
                ops.reset_launch_counts()
                outs = fn(*leaves, **kw)
                outs = outs if isinstance(outs, tuple) else (outs,)
                fwd = getattr(op, count)
                gen = torch.Generator(device=dev).manual_seed(1)
                torch.autograd.backward(outs, [torch.randn(
                    o.shape, generator=gen, device=dev).to(o.dtype) for o in outs])
                other = op.launches + op.launches_bf16 - getattr(op, count)
                runs.append(((fwd, getattr(op, count) - fwd, other), grads(leaves)))
            (launched, got), (plain_launched, want) = runs
            err = max(float((a - b).abs().max()) / float(b.abs().max())
                      for a, b in zip(got, want, strict=True))
            report[name] = {"launches_forward_backward_otherdtype": launched,
                            "grad_dtypes": sorted({str(a.dtype) for a in got}),
                            "max_rel_diff": err}
            assert launched == (1, 0, 0) and plain_launched == (0, 0, 0), (
                name, launched, plain_launched)
            assert all(a.dtype == b.dtype for a, b in zip(got, want)), name
            assert err <= OP_GRAD_RTOL, (name, err)
    finally:
        torch.backends.cudnn.deterministic = False
    emit({"phase": "train", "check": "each op's backward vs autograd of its "
          "plain version, 32 rows at T=2304", "dtype": str(dtype),
          "ops": report, "tol_rel": OP_GRAD_RTOL})


def profile_step(step_fn, batch, top=12):
    """Device time by kernel over one train step (torch.profiler): the busy
    share of the step's wall time and the kernels that take it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms,
            "kernel_launches": sum(r[2] for r in rows),
            "top_kernels": [{"name": n[:120], "ms": ms, "count": c}
                            for n, ms, c in rows[:top]]}


def run_train(root, cfg_file):
    """The train CLI's entry point on the card (``build_trainer`` + ``train``,
    what ``python -m decafnet_tpu_torch.train`` does) at the Ego4D-NLQ width:
    16 videos x 2 queries per step, T = 2304, dropout as configured, two
    epochs with train-time eval of the EMA. Then the checks: launches, losses
    and weights, the eval CLI on the experiment, the conv3 operand cache,
    kernels vs plain versions and one vs two microbatches on one batch, and
    the timings. Returns the kernel launches of the train run."""
    from decafnet_tpu_torch import ops
    from decafnet_tpu_torch.eval.__main__ import build_evaluator
    from decafnet_tpu_torch.ops import conv3_ln_act, cuda
    from decafnet_tpu_torch.train.__main__ import build_trainer, train
    from decafnet_tpu_torch.train.trainer import _to_device

    argv = train_phase_argv(root, cfg_file, "log")
    t0 = time.perf_counter()
    trainer = build_trainer(argv)
    cfg, model = trainer.cfg, trainer.model
    assert trainer.device.type == "cuda"
    n_micro = max(cfg.train.batch_size // trainer.micro, 1)
    m = cfg.model
    emit({"phase": "train", "config": "configs/ego4d_nlq.yaml", "argv": argv,
          "videos_per_step": cfg.train.batch_size,
          "rows_per_step": cfg.train.batch_size * cfg.data.max_num_text,
          "T": cfg.data.max_vid_len, "arch": list(m.vid_net.arch),
          "embd": m.vid_net.embd_dim, "window": m.vid_net.mha_win_size,
          "dropout": {"proj": m.vid_net.proj_pdrop, "path": m.vid_net.path_pdrop,
                      "tcn": m.get("tcn_dropout", 0.5)},
          "microbatches": n_micro, "itrs_per_epoch": trainer.itrs_per_epoch,
          "epochs": trainer.num_epochs, "params": sum(
              p.numel() for p in model.parameters()),
          "setup_s": time.perf_counter() - t0})

    # the main path: counts to 0 just before, read just after
    probe = StepProbe(trainer)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    train(trainer)
    run_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    steps, evals = trainer.step, trainer.evaluator.decoder.decode_calls
    want = {n: c * (steps * n_micro + evals) for n, c in PER_DECODE.items()}
    logdir = cfg.aux.logdir
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    emit({"phase": "train", "run_s": run_s, "steps": steps,
          "forward_microbatches": steps * n_micro, "eval_decode_calls": evals,
          "launches": launches, "expected": want, "per_step": probe.records,
          "logged": logged, "peak_mem_gb": peak_gb})
    assert steps == trainer.num_epochs * trainer.itrs_per_epoch >= 4, steps
    assert launches == want, (launches, want)
    assert all(np.isfinite([r[k] for k in ("cls", "reg", "total")]).all()
               for r in probe.records)
    assert all(np.isfinite(r[f"train/{k}"]) for r in logged
               for k in ("cls", "reg", "total")) and len(logged) == steps
    assert probe.records[0]["lr"] == 0.0 and probe.records[0]["max_weight_change"] == 0.0
    assert probe.records[1]["max_weight_change"] > 0.0
    for module in (model, trainer.ema):
        assert all(torch.isfinite(p).all() for p in module.parameters())
    for rel in ("opt.yaml", "finished", "models/last.pth", "states/last.pt"):
        assert os.path.exists(os.path.join(logdir, rel)), rel
    ema = {k: v.clone() for k, v in trainer.ema.state_dict().items()}

    # the trained experiment through the eval CLI's entry point
    ev = build_evaluator(["--name", logdir])
    assert ev.device.type == "cuda"
    metrics = ev.run()
    for k, v in ev.model.state_dict().items():
        assert torch.equal(v, ema[k]), k
    assert np.isfinite(metrics).all()

    # conv3 weight operands after optimizer steps (the trainer's weights)
    # and after load_state_dict (the train-time evaluator, given the
    # trained weights in place of the EMA it last ran)
    trainer.evaluator.model.load_state_dict(model.state_dict())
    g = torch.Generator(device="cuda").manual_seed(SEED)
    mask = prefix_mask([2304, 2000, 1500, 700] * 4, 2304, "cuda")
    op_err = 0.0
    with torch.no_grad():
        for net in (model, trainer.evaluator.model):
            for w, b, lw, lb in conv3_sites(net):
                x = torch.randn(16, w.shape[1], 2304, generator=g, device="cuda")
                got = conv3_ln_act(x, mask, w, b, lw, lb)
                with cuda.plain_versions():
                    plain = conv3_ln_act(x, mask, w, b, lw, lb)
                op_err = max(op_err, max_err(got, plain))
    emit({"phase": "train", "check": "conv3 weight operands after optimizer "
          "steps and load_state_dict", "sites": 2 * len(conv3_sites(model)),
          "max_abs_err": op_err, "tol": TOL["conv3_ln_act"]})
    assert op_err <= TOL["conv3_ln_act"], op_err

    op_backward_check(trainer.device)

    # one microbatch's loss and gradients, kernels vs plain versions, the
    # same dropout masks (the generator reseeded), with cuDNN's
    # deterministic algorithms: its default weight-gradient convolutions
    # sum with atomics, which alone move the cancelling sums
    trainer.loader.set_epoch(0)
    batch = _to_device(trainer.loader.transform(
        [trainer.dataset[i] for i in range(cfg.train.batch_size)]),
        trainer.device)

    def loss_and_grads(data, plain, micro=None):
        trainer.generator.manual_seed(SEED)
        if plain:
            with cuda.plain_versions():
                out = trainer.accumulate(data, micro)
        else:
            out = trainer.accumulate(data, micro)
        return float(out["total"]), {n: p.grad.detach().clone() for n, p in
                                     model.named_parameters()
                                     if p.grad is not None}

    torch.backends.cudnn.deterministic = True
    try:
        loss_k, grads_k = loss_and_grads(batch, False)
        _, grads_k2 = loss_and_grads(batch, False)
        loss_p, grads_p = loss_and_grads(batch, True)
    finally:
        torch.backends.cudnn.deterministic = False
    elem, skipped, elem_top = grads_close(grads_k, grads_p)
    rel_all, rel_top = grads_rel_l2(grads_k, grads_p)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    emit({"phase": "train", "check": "one microbatch of 16 videos, kernels vs "
          "plain versions, same dropout masks", "loss": [loss_k, loss_p],
          "loss_rel": loss_rel, "grad_leaves": len(grads_p),
          "noise_sized_skipped": skipped, "rel_l2_all": rel_all,
          "rel_l2_worst_leaves": rel_top, "elementwise_worst_over_tol": elem,
          "elementwise_worst_leaves": elem_top,
          "kernels_twice_rel_l2_all": grads_rel_l2(grads_k2, grads_k)[0],
          "tol": {"loss_rtol": LOSS_RTOL_TRAIN, "rel_l2_all": GRAD_REL_L2_ALL,
                  "rel_l2_leaf": GRAD_REL_L2_LEAF, "elementwise_rtol":
                  GRAD_RTOL, "elementwise_atol_of_max": GRAD_ATOL}})
    assert loss_rel <= LOSS_RTOL_TRAIN, loss_rel
    assert rel_all <= GRAD_REL_L2_ALL, rel_all
    assert rel_top[0]["rel_l2"] <= GRAD_REL_L2_LEAF, rel_top

    # timings: whole steps (forward + backward + optimizer, EMA, loss norm)
    # on one batch, kernels and plain versions, then one profiled step
    def step_ms(plain, n=3):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if plain:
                with cuda.plain_versions():
                    probe.step_fn(batch)
            else:
                probe.step_fn(batch)
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t0))
        return out

    kernel_ms, plain_ms = step_ms(False), step_ms(True)
    prof = profile_step(probe.step_fn, batch)
    timing = {"run_step_ms": [r["ms"] for r in probe.records],
              "median_run_step_ms": float(np.median([r["ms"] for r in probe.records])),
              "kernels_step_ms": kernel_ms, "median_kernels_step_ms":
              float(np.median(kernel_ms)), "plain_step_ms": plain_ms,
              "median_plain_step_ms": float(np.median(plain_ms)),
              "peak_mem_gb": peak_gb, "profile": prof}
    emit({"phase": "train", "timing": "one step of 16 videos x 2 queries at "
          "2304 clips", **timing})

    # dropout off: two microbatches of 8 give the gradients of one of 16,
    # elementwise at rtol 1e-3 + 1e-4 of each leaf's max. In f64 through
    # the plain versions (the kernels are f32): in f32 the split reorders
    # the cancelling sums (reported as f32_worst_over_tol), while a wrong
    # split would move them by far more
    model.eval()
    _, grads_f32_1 = loss_and_grads(batch, False, micro=16)
    _, grads_f32_2 = loss_and_grads(batch, False, micro=8)
    batch64 = {k: v.double() if v.is_floating_point() else v
               for k, v in batch.items()}
    model.double()
    try:
        loss_1, grads_1 = loss_and_grads(batch64, True, micro=16)
        loss_2, grads_2 = loss_and_grads(batch64, True, micro=8)
    finally:
        model.float().train()
    worst, skipped, top = grads_close(grads_2, grads_1)
    emit({"phase": "train", "check": "dropout off, 2 microbatches of 8 vs 1 "
          "of 16, f64 plain versions", "loss": [loss_2, loss_1],
          "grad_worst_over_tol": worst, "noise_sized_skipped": skipped,
          "worst_leaves": top,
          "f32_worst_over_tol": grads_close(grads_f32_2, grads_f32_1)[0]})
    assert abs(loss_2 - loss_1) <= LOSS_RTOL_TRAIN * abs(loss_1) and worst <= 1.0
    f32 = {"peak_mem_gb": peak_gb, "median_run_step_ms": timing["median_run_step_ms"],
           "median_kernels_step_ms": timing["median_kernels_step_ms"],
           "device_busy_ms": prof["device_busy_ms"], "busy_share": prof["busy_share"],
           "kernels_vs_plain_rel_l2_all": rel_all, "run_s": run_s}
    return launches, f32


def train_phase_argv(root, cfg_file, log):
    """The train phase's CLI arguments: configs/ego4d_nlq.yaml plus the
    synthetic data file, logs under ``root/log``, two epochs (one in
    warmup), train-time eval after each."""
    return ["--cfg", os.path.join(REPO, "configs", "ego4d_nlq.yaml"), cfg_file,
            "--set", "log.root", os.path.join(root, log), "seed", str(SEED),
            "train.epochs", "1", "train.warmup_epochs", "1",
            "aux.eval_run", "1", "aux.log_interval", "1"]


def run_train_bf16(root, cfg_file, f32):
    """The train phase in bf16: the train CLI's entry point (``build_trainer``
    + ``train``) with ``--set tpu.compute_dtype bfloat16`` at the same shape
    (16 videos x 2 queries per step, T = 2304, two epochs, train-time eval
    of the EMA, also in bf16). Checks 8 / 7 / 1 launches of the bf16
    kernels per forward microbatch and per eval decode call and none of the
    f32 kernels (so none from the backward), finite losses and weights
    (f32), the weights moving from step 2, the checkpoint files, each op's
    bf16 backward against plain autograd; one microbatch's loss and
    gradients, kernels vs plain versions in bf16 with the same dropout
    masks, by the relative-L2 rule at the bf16 noise floor (BF16_MEAN_X
    times the distance of the plain versions in bf16 from the same weights
    in f32, and at least the f32 rule's limits), with the f32 distance of
    kernels vs plain versions beside it; step walls, busy share and peak
    memory beside the f32 run's ``f32``. Returns the bf16 kernel launches
    of the train run."""
    import gc

    from decafnet_tpu_torch import ops
    from decafnet_tpu_torch.ops import cuda
    from decafnet_tpu_torch.train.__main__ import build_trainer, train
    from decafnet_tpu_torch.train.trainer import _to_device

    bf = torch.bfloat16
    argv = train_phase_argv(root, cfg_file, "log_bf16") + ["tpu.compute_dtype", "bfloat16"]
    t0 = time.perf_counter()
    trainer = build_trainer(argv)
    cfg, model = trainer.cfg, trainer.model
    assert trainer.device.type == "cuda" and model.compute_dtype == bf
    assert all(p.dtype == torch.float32 for p in model.parameters())
    n_micro = max(cfg.train.batch_size // trainer.micro, 1)
    setup_s = time.perf_counter() - t0

    # the main path: counts to 0 just before, read just after
    probe = StepProbe(trainer)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    train(trainer)
    run_s = time.perf_counter() - t0
    launches, launches_f32 = ops.launch_counts(bf), ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    steps, evals = trainer.step, trainer.evaluator.decoder.decode_calls
    want = {n: c * (steps * n_micro + evals) for n, c in PER_DECODE.items()}
    logdir = cfg.aux.logdir
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    emit({"phase": "train", "leg": "bf16", "argv": argv, "setup_s": setup_s,
          "run_s": run_s, "steps": steps, "forward_microbatches": steps * n_micro,
          "eval_decode_calls": evals, "launches_bf16": launches,
          "launches_f32": launches_f32, "expected": want,
          "per_step": probe.records, "logged": logged, "peak_mem_gb": peak_gb})
    assert steps == trainer.num_epochs * trainer.itrs_per_epoch >= 4, steps
    assert launches == want and not any(launches_f32.values()), (launches, launches_f32)
    assert trainer.evaluator.model.compute_dtype == bf
    assert all(np.isfinite([r[k] for k in ("cls", "reg", "total")]).all()
               for r in probe.records)
    assert all(np.isfinite(r[f"train/{k}"]) for r in logged
               for k in ("cls", "reg", "total")) and len(logged) == steps
    assert probe.records[0]["lr"] == 0.0 and probe.records[0]["max_weight_change"] == 0.0
    assert probe.records[1]["max_weight_change"] > 0.0
    for module in (model, trainer.ema):
        assert all(p.dtype == torch.float32 and torch.isfinite(p).all()
                   for p in module.parameters())
    assert trainer.loss_norm.dtype == torch.float32
    assert all(m.dtype == torch.float32 for v in trainer.optimizer.state.values()
               for m in v)
    for rel in ("opt.yaml", "finished", "models/last.pth", "states/last.pt"):
        assert os.path.exists(os.path.join(logdir, rel)), rel

    op_backward_check(trainer.device, dtype=bf)

    # one microbatch's loss and gradients with the same dropout masks:
    # kernels and plain versions in bf16, then the same weights in f32 (the
    # model's compute dtype switched off) through both
    trainer.loader.set_epoch(0)
    batch = _to_device(trainer.loader.transform(
        [trainer.dataset[i] for i in range(cfg.train.batch_size)]), trainer.device)

    def loss_and_grads(plain, dtype):
        model.compute_dtype = dtype
        trainer.generator.manual_seed(SEED)
        try:
            with cuda.plain_versions() if plain else contextlib.nullcontext():
                out = trainer.accumulate(batch)
        finally:
            model.compute_dtype = bf
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        assert all(g.dtype == torch.float32 for g in grads.values())
        return float(out["total"]), grads

    torch.backends.cudnn.deterministic = True
    try:
        (loss_k, grads_k), (loss_p, grads_p) = (loss_and_grads(False, bf),
                                                loss_and_grads(True, bf))
        (loss_k32, grads_k32), (loss_p32, grads_p32) = (loss_and_grads(False, None),
                                                        loss_and_grads(True, None))
    finally:
        torch.backends.cudnn.deterministic = False
    # leaves noise-sized in the f32 run (the attention key biases, whose
    # exact gradient is 0) carry bf16 rounding noise only: skipped per leaf
    live = {n for n, g in grads_p32.items() if float(g.abs().max()) > 1e-8}
    rel_all, _ = grads_rel_l2(grads_k, grads_p)
    floor_all, _ = grads_rel_l2(grads_p, grads_p32)
    leaves = []
    for n in sorted(live):
        a, b, c = grads_k[n], grads_p[n], grads_p32[n]
        leaves.append((float((a - b).norm() / b.norm()), float((b - c).norm() / c.norm()), n))
    leaves.sort(reverse=True)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    loss_floor = abs(loss_p - loss_p32) / abs(loss_p32)
    lim_all = max(GRAD_REL_L2_ALL, BF16_MEAN_X * floor_all)
    lim_loss = max(LOSS_RTOL_TRAIN, BF16_MEAN_X * loss_floor)
    over_leaf = [(r, f, n) for r, f, n in leaves
                 if r > max(GRAD_REL_L2_LEAF, BF16_MEAN_X * f)]
    emit({"phase": "train", "leg": "bf16", "check": "one microbatch of 16 videos, "
          "kernels vs plain versions in bf16, same dropout masks",
          "loss": {"kernels_bf16": loss_k, "plain_bf16": loss_p,
                   "kernels_f32": loss_k32, "plain_f32": loss_p32},
          "loss_rel": loss_rel, "loss_floor_bf16_vs_f32": loss_floor,
          "rel_l2_all": rel_all, "floor_rel_l2_all_bf16_vs_f32": floor_all,
          "f32_kernels_vs_plain_rel_l2_all": grads_rel_l2(grads_k32, grads_p32)[0],
          "f32_leg_kernels_vs_plain_rel_l2_all": f32["kernels_vs_plain_rel_l2_all"],
          "worst_leaves": [{"leaf": n, "rel_l2": r, "floor": f}
                           for r, f, n in leaves[:4]],
          "leaves": len(live), "noise_sized_skipped": len(grads_p32) - len(live),
          "tol": {"loss": lim_loss, "rel_l2_all": lim_all,
                  "rel_l2_leaf": f"max({GRAD_REL_L2_LEAF}, {BF16_MEAN_X} x floor)"}})
    assert loss_rel <= lim_loss, (loss_rel, lim_loss)
    assert rel_all <= lim_all, (rel_all, lim_all)
    assert not over_leaf, over_leaf[:4]

    def step_ms(plain, n=3):
        out = []
        for _ in range(n):
            with cuda.plain_versions() if plain else contextlib.nullcontext():
                out.append(synced_ms(lambda: probe.step_fn(batch))[0])
        return out

    kernel_ms, plain_ms = step_ms(False), step_ms(True)
    prof = profile_step(probe.step_fn, batch)
    run_ms = [r["ms"] for r in probe.records]
    emit({"phase": "train", "leg": "bf16", "timing": "one step of 16 videos x 2 "
          "queries at 2304 clips, bf16 beside f32", "run_step_ms": run_ms,
          "median_run_step_ms": float(np.median(run_ms)),
          "kernels_step_ms": kernel_ms, "median_kernels_step_ms": float(np.median(kernel_ms)),
          "plain_step_ms": plain_ms, "median_plain_step_ms": float(np.median(plain_ms)),
          "peak_mem_gb": peak_gb, "profile": prof, "f32": f32,
          "peak_vs_f32": peak_gb / f32["peak_mem_gb"],
          "busy_vs_f32": prof["device_busy_ms"] / f32["device_busy_ms"]})
    # the probe and the trainer refer to each other: free them here, so
    # the remat leg's peaks count what they counted before this leg
    del trainer, model, probe, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# -------------------------------------------------------------------- remat

REMAT_POLICIES = (None, "nothing", "dots")
# the MAD leg: one step of the mad task at its full eval length
MAD_VIDEOS = 4


def write_mad_data(root):
    """A synthetic MAD-scale train split: 4 movies of 24576-32768 clips x 2
    queries at the configs/mad.yaml feature widths (512, clip size and
    stride 5), and a config file pointing the train data tree at it."""
    import yaml

    from decafnet_tpu_torch.core import load_config
    from decafnet_tpu_torch.data import make_synthetic_dataset

    t0 = time.perf_counter()
    cfg = load_config(os.path.join(REPO, "configs", "mad.yaml"))
    d = cfg.data
    paths = make_synthetic_dataset(
        os.path.join(root, "mad_data"), num_videos=MAD_VIDEOS, num_queries=2,
        clip_range=(3 * MAD_T // 4, MAD_T + 1), vid_dim=cfg.model.vid_net.in_dim,
        shallow_dim=cfg.model.vid_net.in_dim, text_dim=cfg.model.text_net.in_dim,
        clip_size=d.clip_size, clip_stride=d.clip_stride, splits=("train",),
        seed=SEED + 4)
    keys = ("anno_file", "vid_feat_dir", "shallow_vid_feat_dir",
            "clip_token_fname", "text_cls_fname")
    path = os.path.join(root, "mad_data.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({"data": {k: paths[k] for k in keys}}, f)
    emit({"phase": "train", "leg": "remat_mad", "data": f"synthetic train "
          f"split {MAD_VIDEOS} movies x 2 queries ({3 * MAD_T // 4}-{MAD_T} "
          f"clips)",
          "setup_s": time.perf_counter() - t0})
    return path


def remat_runs(argv, tag, policies, compare, dtype=torch.float32):
    """For each remat policy (None: off), a Trainer from the train CLI's
    ``build_trainer(argv + remat settings)`` (the same seeded weights), one
    batch of the first Trainer's data, and: the microbatch losses and
    gradients of ``accumulate`` with the generator at the seed (cuDNN's
    deterministic algorithms), its peak memory above what was allocated
    before it and the launches per forward microbatch of the kernels for
    ``dtype`` activations (``argv`` sets the compute dtype; none of the
    other dtype's kernels may launch); then ``train_step`` three times,
    timed. Returns ({policy: record}, the launches of every run, the
    gradients of each policy when ``compare``)."""
    import gc

    from decafnet_tpu_torch import ops
    from decafnet_tpu_torch.train.__main__ import build_trainer
    from decafnet_tpu_torch.train.trainer import _to_device

    records, grads, batch = {}, {}, None
    launches = {n: 0 for n in PER_DECODE}
    for policy in policies:
        label = policy or "off"
        trainer = build_trainer(argv + [
            "log.root", os.path.join(tag, label), "tpu.remat", str(policy is not None),
            "tpu.remat_policy", policy or "nothing"])
        assert trainer.model.vid_net.remat == (policy is not None)
        cfg = trainer.cfg
        n_micro = max(cfg.train.batch_size // trainer.micro, 1)
        if batch is None:
            trainer.loader.set_epoch(0)
            batch = _to_device(trainer.loader.transform(
                [trainer.dataset[i] for i in range(cfg.train.batch_size)]),
                trainer.device)
        trainer.generator.manual_seed(SEED)
        other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
        assert trainer.model.compute_dtype == (dtype if dtype == torch.bfloat16 else None)
        torch.cuda.synchronize()
        base_gb = torch.cuda.memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        torch.backends.cudnn.deterministic = True
        try:
            acc_ms, metrics = synced_ms(lambda: trainer.accumulate(batch))
        finally:
            torch.backends.cudnn.deterministic = False
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        counts = ops.launch_counts(dtype)
        if compare:
            grads[label] = {n: p.grad.detach().clone() for n, p in
                            trainer.model.named_parameters() if p.grad is not None}
        torch.cuda.reset_peak_memory_stats()
        before = ops.launch_counts(dtype)
        step_ms = [synced_ms(lambda: trainer.train_step(batch))[0]
                   for _ in range(3)]
        step_peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        after = ops.launch_counts(dtype)
        per = PER_FORWARD["remat" if policy else "iter"]
        assert counts == {n: n_micro * c for n, c in per.items()}, (label, counts)
        assert {n: after[n] - before[n] for n in after} == {
            n: 3 * n_micro * c for n, c in per.items()}, (label, before, after)
        assert not any(ops.launch_counts(other).values()), (label, "other dtype")
        launches = {n: launches[n] + after[n] for n in launches}
        records[label] = {
            "loss": float(metrics["total"]), "cls": float(metrics["cls"]),
            "reg": float(metrics["reg"]), "rows": int(batch["text"].shape[0]),
            "T": int(batch["vid"].shape[-1]), "microbatches": n_micro,
            "launches_per_forward_microbatch": {n: c / n_micro
                                                for n, c in counts.items()},
            "accumulate_ms": acc_ms, "peak_gb": peak_gb,
            "peak_above_start_gb": peak_gb - base_gb, "step_ms": step_ms,
            "median_step_ms": float(np.median(step_ms)),
            "step_peak_gb": step_peak_gb}
        assert all(np.isfinite([records[label][k] for k in ("loss", "cls", "reg")]))
        del trainer, metrics
        gc.collect()
        torch.cuda.empty_cache()
    return records, launches, grads


def run_remat(root, cfg_file):
    """The train phase's remat leg. At the train phase's shape (16 videos x
    2 queries = 32 rows, T = 2304, configs/ego4d_nlq.yaml, dropout on): a
    step with tpu.remat off, "nothing" and "dots" from the same weights and
    generator seed; losses equal, gradients within the train phase's
    relative L2 rule of the unwrapped step, peak memory and step wall time
    of each, launches 8 / 14 / 2 per forward microbatch with remat. Then
    one step of the mad task at T = 32768 (8 rows in one microbatch), remat
    off and "nothing": peak memory of each, in f32 and then in bf16. Returns
    the f32 kernel launches of the f32 legs, the bf16 kernel launches of
    the bf16 MAD leg, and the f32 MAD step's argv and records per policy
    (the multi phase's seq2_mad leg holds its two ranks against them)."""
    argv = ["--cfg", os.path.join(REPO, "configs", "ego4d_nlq.yaml"), cfg_file,
            "--set", "seed", str(SEED), "aux.eval_run", "0"]
    records, launches, grads = remat_runs(argv, os.path.join(root, "remat"),
                                          REMAT_POLICIES, compare=True)
    off = records["off"]
    for label in ("nothing", "dots"):
        rel, top = grads_rel_l2(grads[label], grads["off"])
        loss_rel = abs(records[label]["loss"] - off["loss"]) / abs(off["loss"])
        records[label].update(grad_rel_l2_vs_off=rel, worst_leaves=top,
                              loss_rel_vs_off=loss_rel,
                              peak_vs_off=records[label]["peak_gb"] / off["peak_gb"],
                              step_vs_off=(records[label]["median_step_ms"]
                                           / off["median_step_ms"]))
        assert grads[label].keys() == grads["off"].keys()
        assert loss_rel <= 1e-6 and rel <= GRAD_REL_L2_ALL, (label, loss_rel, rel)
    emit({"phase": "train", "leg": "remat", "shape": "16 videos x 2 queries "
          "= 32 rows at T=2304, one microbatch, dropout on", "runs": records,
          "tol": {"loss_rel": 1e-6, "grad_rel_l2": GRAD_REL_L2_ALL}})

    mad_file = write_mad_data(root)
    argv = ["--cfg", os.path.join(REPO, "configs", "mad.yaml"), mad_file,
            "--set", "seed", str(SEED), "aux.eval_run", "0",
            "model.vid_net.max_seq_len", str(MAD_T),
            "train.batch_size", str(MAD_VIDEOS),
            "train.microbatch_size", str(MAD_VIDEOS)]
    mad, mad_launches, _ = remat_runs(argv, os.path.join(root, "remat_mad"),
                                      (None, "nothing"), compare=False)
    mad["nothing"]["peak_vs_off"] = mad["nothing"]["peak_gb"] / mad["off"]["peak_gb"]
    emit({"phase": "train", "leg": "remat_mad", "shape": f"{MAD_VIDEOS} movies "
          f"x 2 queries = 8 rows at T={MAD_T}, one microbatch, configs/mad.yaml",
          "runs": mad})
    assert mad["off"]["T"] == MAD_T and mad["off"]["rows"] == 2 * MAD_VIDEOS

    # the same step in bf16 (tpu.compute_dtype bfloat16), remat off and on
    mad16, mad16_launches, _ = remat_runs(
        argv + ["tpu.compute_dtype", "bfloat16"], os.path.join(root, "remat_mad_bf16"),
        (None, "nothing"), compare=False, dtype=torch.bfloat16)
    for label, r in mad16.items():
        r["peak_vs_f32"] = r["peak_gb"] / mad[label]["peak_gb"]
    emit({"phase": "train", "leg": "remat_mad_bf16", "shape": f"{MAD_VIDEOS} movies "
          f"x 2 queries = 8 rows at T={MAD_T}, one microbatch, configs/mad.yaml, "
          "tpu.compute_dtype bfloat16", "runs": mad16,
          "f32_peak_gb": {label: r["peak_gb"] for label, r in mad.items()}})
    assert mad16["off"]["T"] == MAD_T and mad16["off"]["rows"] == 2 * MAD_VIDEOS
    return ({n: launches[n] + mad_launches[n] for n in launches},
            mad16_launches, (argv, mad))


# ------------------------------------------------------------------- encode

# the encode phase: T clips of raw uint8 frames made from the seed, the
# factorized sidekick at scripts/encode_ground_bench.py's width (at 112^2)
# over every clip, the salient bins picked as bench.py's encode leg picks
# them (sn 64, ratio 0.3: k = 256 at T = 1024), and the EgoVLP ViT-B
# (Frozen-in-Time SpaceTimeTransformer + vid_proj) over those k clips only
ENC_T, ENC_FRAMES, RAW_HW, ENC_QUERIES = 1024, 4, (270, 360), 8
ENC_SN, ENC_RATIO = 64, 0.3
SIDEKICK = dict(patch_size=16, dim=192, depth=2, heads=4, out_dim=256,
                frames=ENC_FRAMES, img_size=112)
EXPERT = dict(img_size=224, patch_size=16, dim=768, depth=12, heads=12,
              frames=ENC_FRAMES, out_dim=256)
# transforms on the card, clips at a time (f32 copies of the raw frames)
TRANSFORM_CLIPS = 128
# card vs CPU features of the same clips and weights (TF32 would be ~1e-3
# off), and delegated encoding vs encoding all clips then gating (the bound
# of tests/test_encode.py), at T = 128 with bins of 16 clips so that a
# strict subset is selected (sn 64 keeps every bin of a 2-bin video)
FEAT_RTOL, FEAT_ATOL, FEAT_CLIPS = 1e-4, 1e-5, 2
DELEGATE_TOL, DELEGATE_T, DELEGATE_SN = 2e-5, 128, 16
CLIP_STRIDE_S = 16 / 30.0      # video-seconds per clip on the NLQ grid


def walls_ms(fn, n):
    """Host-clock wall times (ms) of ``n`` calls of ``fn``, each between
    device syncs; the last call's result."""
    out, ms = None, []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return ms, out


def run_encode_cli(dev, root, smi):
    """``python -m decafnet_tpu_torch.encode``'s entry point on the card over
    two synthetic frame files (~100 clips of 4 frames at 224^2 each): the
    EgoVLP ViT-B expert and the sidekick, seeded synthetic weights. Then the
    port's Evaluator at the configs/ego4d_nlq.yaml width reads the written
    features as its dataset. Returns the Evaluator's kernel launches."""
    from decafnet_tpu_torch import ops
    from decafnet_tpu_torch.core import load_config, update_eval_data, update_opt
    from decafnet_tpu_torch.data import apply_synthetic_cfg, make_synthetic_dataset
    from decafnet_tpu_torch.encode.__main__ import main as encode_main
    from decafnet_tpu_torch.eval import Evaluator
    from decafnet_tpu_torch.models import random_params

    cfg = load_config(os.path.join(REPO, "configs", "ego4d_nlq.yaml"))
    paths = make_synthetic_dataset(
        os.path.join(root, "encode_data"), num_videos=2, num_queries=2,
        clip_range=(90, 110), vid_dim=EXPERT["out_dim"],
        shallow_dim=SIDEKICK["out_dim"], text_dim=cfg.model.text_net.in_dim,
        splits=("val",), seed=SEED)
    with open(paths["anno_file"]) as f:
        clips = {v: i["num_clips"] for v, i in json.load(f)["val"].items()}
    frames_dir = os.path.join(root, "encode_frames")
    os.makedirs(frames_dir)
    rng = np.random.default_rng(SEED)
    for vid, n in clips.items():
        np.save(os.path.join(frames_dir, vid + ".npy"), rng.integers(
            0, 256, (n, ENC_FRAMES, 224, 224, 3), dtype=np.uint8))
    out_e, out_s = (os.path.join(root, "encode_out", s) for s in ("expert", "sidekick"))
    sk_opt = {k: v for k, v in SIDEKICK.items() if k not in ("img_size", "frames")}
    t0 = time.perf_counter()
    assert encode_main(["--frames_dir", frames_dir, "--out_expert_dir", out_e,
                        "--out_sidekick_dir", out_s, "--expert", "spacetime",
                        "--sidekick", "factorized", "--sidekick_opt",
                        json.dumps(sk_opt), "--frames", str(ENC_FRAMES),
                        "--sidekick_res", str(SIDEKICK["img_size"]),
                        "--seed", str(SEED)]) == 0
    cli_s = time.perf_counter() - t0
    for vid, n in clips.items():
        for d in (out_e, out_s):
            feat = np.load(os.path.join(d, vid + ".npy"))
            assert feat.shape == (n, 256) and feat.dtype == np.float32, feat.shape
            assert np.isfinite(feat).all() and feat.std() > 0

    apply_synthetic_cfg(cfg, paths)
    for tree in (cfg.data, cfg.eval.data):
        tree.vid_feat_dir, tree.shallow_vid_feat_dir = out_e, out_s
    cfg.train.num_workers = 0
    update_eval_data(update_opt(cfg))
    ev = Evaluator(cfg, params=random_params(cfg, SEED))
    assert ev.device.type == dev.type
    calls0 = ev.decoder.decode_calls
    ops.reset_launch_counts()
    metrics = ev.run()
    launches = ops.launch_counts()
    calls = ev.decoder.decode_calls - calls0
    want = {n: c * calls for n, c in PER_DECODE.items()}
    emit({"phase": "encode", "cli": "python -m decafnet_tpu_torch.encode, then "
          "the port's Evaluator over its features", "clips": clips,
          "frames": [ENC_FRAMES, 224, 224], "cli_s": cli_s,
          "eval_queries": ev.meter.text_cnt, "eval_video_ms": ev.video_ms,
          "recall_finite": bool(np.isfinite(metrics).all()), "decode_calls": calls,
          "launches": launches, "expected": want, "card": smi})
    assert ev.meter.text_cnt == 2 * len(clips) and np.isfinite(metrics).all()
    assert launches == want and calls == len(clips), (launches, want)
    return launches


def run_encode(dev, service, smi, root, service16):
    """The on-device front end at full width: raw frames through the eval
    transform on the card, the sidekick over every clip, salient-clip
    selection, the EgoVLP ViT-B over the k selected clips only, then
    GroundingService (the serve phase's) over the two streams for 8
    queries. Checks the card's features against the CPU's, delegated
    against encode-all-then-gate, the detections and the kernel launches;
    times the stages, the encode+ground wall and the reference's offline
    structure (the expert over every clip). Then the same front end in bf16
    (:func:`run_encode_bf16`, grounding with ``service16``). Returns the
    kernel launches of the counted encode+ground run, of the CLI run and the
    bf16 kernel launches of the bf16 encode+ground run."""
    import copy

    from decafnet_tpu_torch import ops
    from decafnet_tpu_torch.ops import cuda
    from decafnet_tpu_torch.encode import (ClipEncoder, ClipEncoderRunner, SpaceTimeViT,
                                           encode_delegate_ground, eval_transform,
                                           expert_budget, gather_clips,
                                           select_salient_clips)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    seed = torch.Generator().manual_seed
    expert_cpu = SpaceTimeViT(**EXPERT).reset_parameters(seed(SEED)).eval()
    sidekick_cpu = ClipEncoder(**SIDEKICK).reset_parameters(seed(SEED + 1)).eval()
    run_e = ClipEncoderRunner(copy.deepcopy(expert_cpu).to(dev))
    run_s = ClipEncoderRunner(copy.deepcopy(sidekick_cpu).to(dev))
    k = expert_budget(ENC_T, ENC_SN, ENC_RATIO)
    emit({"phase": "encode", "T": ENC_T, "frames_per_clip": ENC_FRAMES,
          "raw_hw": list(RAW_HW), "sn": ENC_SN, "ratio": ENC_RATIO, "k": k,
          "expert": {"model": "SpaceTimeViT (EgoVLP layout)", **EXPERT,
                     "params": sum(p.numel() for p in expert_cpu.parameters())},
          "sidekick": {"model": "ClipEncoder", **SIDEKICK,
                       "params": sum(p.numel() for p in sidekick_cpu.parameters())},
          "max_clips_per_forward": run_e.max_clips,
          "weights": f"random, seeds {SEED} / {SEED + 1}",
          "setup_s": time.perf_counter() - t0})

    rng = np.random.default_rng(SEED)
    raw = rng.integers(0, 256, (ENC_T, ENC_FRAMES, *RAW_HW, 3), dtype=np.uint8)
    h2d_ms, raw_dev = walls_ms(lambda: torch.from_numpy(raw).to(dev), 1)

    def transform(res):
        return torch.cat([eval_transform(raw_dev[i:i + TRANSFORM_CLIPS].float() / 255.0,
                                         center=256, input_res=res)
                          for i in range(0, ENC_T, TRANSFORM_CLIPS)])

    # twice: a process's first call may also pay for allocations and loading
    transform_ms, (frames_e, frames_s) = walls_ms(
        lambda: (transform(EXPERT["img_size"]), transform(SIDEKICK["img_size"])), 2)
    del raw_dev
    text_cls = torch.from_numpy(rng.standard_normal((ENC_QUERIES, 256), np.float32))
    request = dict(texts=[rng.standard_normal((service.decoder.cfg.model.text_net.in_dim,
                                               int(n)), np.float32)
                          for n in rng.integers(5, 21, ENC_QUERIES)],
                   text_cls=text_cls.numpy(), fps=30.0, clip_size=32, clip_stride=16)
    emit({"phase": "encode", "raw_frames_gb": raw.nbytes / 1e9,
          "h2d_pageable_ms": h2d_ms[0], "transform_ms_first_second": transform_ms,
          "frames": {"expert": list(frames_e.shape), "sidekick": list(frames_s.shape)},
          "card": smi})

    # the card's features against the CPU's, same weights and clips
    with torch.no_grad():
        errs = {}
        for name, model_cpu, runner, frames in (("expert", expert_cpu, run_e, frames_e),
                                                ("sidekick", sidekick_cpu, run_s, frames_s)):
            want = model_cpu(frames[:FEAT_CLIPS].cpu())
            got = runner.encode(frames[:FEAT_CLIPS]).T.cpu()
            errs[name] = {"max_abs": float((got - want).abs().max()),
                          "max_over_tol": float(((got - want).abs() / (
                              FEAT_ATOL + FEAT_RTOL * want.abs())).max())}
    emit({"phase": "encode", "check": "card vs CPU features", "clips": FEAT_CLIPS,
          "errors": errs, "tol": {"rtol": FEAT_RTOL, "atol": FEAT_ATOL}})
    assert all(e["max_over_tol"] <= 1.0 for e in errs.values()), errs

    # delegated encoding == encoding every clip, then gating
    sub_e, sub_s = frames_e[:DELEGATE_T], frames_s[:DELEGATE_T]
    dense, _, w_sub = encode_delegate_ground(run_e, run_s, sub_e, sub_s, text_cls[0],
                                             DELEGATE_SN, ENC_RATIO)
    gated = run_e.encode(sub_e) * w_sub[None]
    over = float(((dense - gated).abs() / (DELEGATE_TOL + DELEGATE_TOL * gated.abs())).max())
    emit({"phase": "encode", "check": "delegated vs encode-all-then-gate",
          "T": DELEGATE_T, "sn": DELEGATE_SN, "selected": int(w_sub.sum()),
          "max_abs": float((dense - gated).abs().max()), "max_over_tol": over,
          "tol": {"rtol": DELEGATE_TOL, "atol": DELEGATE_TOL}})
    assert 0 < int(w_sub.sum()) < DELEGATE_T and over <= 1.0

    def encode_and_ground():
        expert, sidekick, weight = encode_delegate_ground(
            run_e, run_s, frames_e, frames_s, text_cls[0], ENC_SN, ENC_RATIO)
        streams = dict(vid=expert.cpu().numpy(), shallow_vid=sidekick.cpu().numpy(),
                       **request)
        return service.ground(**streams), streams, weight

    def offline():
        expert, sidekick = run_e.encode(frames_e), run_s.encode(frames_s)
        return service.ground(vid=expert.cpu().numpy(),
                              shallow_vid=sidekick.cpu().numpy(), **request)

    encode_and_ground()      # warm-up outside the count (handles, allocator)
    # the main path: counts to 0 just before, read just after
    dec = service.decoder
    calls0 = dec.decode_calls
    ops.reset_launch_counts()
    walls, (answers, streams, weight) = walls_ms(encode_and_ground, 3)
    launches = ops.launch_counts()
    calls = dec.decode_calls - calls0
    want = {n: c * calls for n, c in PER_DECODE.items()}
    emit({"phase": "encode", "decode_calls": calls, "launches": launches,
          "expected": want, "selected_clips": int(weight.sum())})
    assert launches == want and calls > 0, (launches, want)
    assert 0 < int(weight.sum()) <= k
    check_detections(answers, dict(request, vid=np.zeros((256, ENC_T))),
                     service.decoder.cfg.nms.max_num_segs)

    # the stages, each between syncs
    sk_ms, sidekick = walls_ms(lambda: run_s.encode(frames_s), 3)
    sel_ms, (idx, _) = walls_ms(lambda: select_salient_clips(
        sidekick, text_cls[0].to(dev), ENC_SN, ENC_RATIO, k), 3)
    gather_ms, clips = walls_ms(lambda: gather_clips(frames_e, idx), 3)
    ex_ms, _ = walls_ms(lambda: run_e.encode(clips), 3)
    ground_ms, grounded = walls_ms(lambda: service.ground(**streams), 3)
    # the ground step's kernels against their plain versions at this path's shapes
    with cuda.plain_versions():
        plain = service.ground(**streams)
    seg_p, sc_p = same_detections([grounded], [plain])
    emit({"phase": "encode", "check": "ground, kernels vs plain versions",
          "seg_s": seg_p, "score": sc_p, "tol": {"seg_s": SEG_TOL_S, "score": SCORE_TOL}})
    assert seg_p <= SEG_TOL_S and sc_p <= SCORE_TOL, (seg_p, sc_p)
    offline_ms, offline_answers = walls_ms(offline, 2)
    check_detections(offline_answers, dict(request, vid=np.zeros((256, ENC_T))),
                     service.decoder.cfg.nms.max_num_segs)
    med = float(np.median(walls))
    video_s = ENC_T * CLIP_STRIDE_S
    f32 = {"encode_ground_wall_ms": walls,
           "video_seconds_per_s": video_s / (med / 1e3),
           "video_seconds": video_s,
           "stages_ms": {"sidekick_all_clips": sk_ms, "select": sel_ms,
                         "gather_k_clips": gather_ms, "expert_k_clips": ex_ms,
                         "ground_8_queries": ground_ms},
           "ms_per_clip": {"sidekick": float(np.median(sk_ms)) / ENC_T,
                           "expert": float(np.median(ex_ms)) / k},
           "offline_expert_all_clips_wall_ms": offline_ms,
           "offline_over_delegated": float(np.median(offline_ms)) / med,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "profile": profile_step(lambda _: encode_and_ground(), None)}
    emit({"phase": "encode", **f32, "card": smi})
    del clips
    launches16 = run_encode_bf16(
        dev, service16, smi, run_e, sidekick_cpu, frames_e, frames_s, text_cls,
        request, f32, sidekick, streams["vid"])
    del frames_e, frames_s
    return launches, run_encode_cli(dev, root, smi), launches16


def saliency_bins(sidekick, text_cls, sn):
    """Per-bin means of the sidekick / query-CLS correlation (the scores
    delegation ranks) of a (C, T) stream, T a multiple of ``sn``."""
    from decafnet_tpu_torch.ops.delegation import saliency_correlation

    correl = saliency_correlation(sidekick[None].float(), text_cls[None].float())[0]
    return correl.reshape(-1, sn).mean(dim=1)


def run_encode_bf16(dev, service16, smi, run_e, sidekick_cpu, frames_e, frames_s,
                    text_cls, request, f32, sidekick32, expert32):
    """The encode phase in bf16 at the same width: the factorized sidekick
    with ``dtype`` bf16 (its output f32) and the ViT on the frames rounded
    to bf16 (a bf16 ViT), then the bf16 GroundingService of the bf16 phase.
    Checks the selected clips against the f32 leg's (they may differ only
    in bins whose f32 saliency lies within twice the largest bf16-vs-f32
    bin-score shift of the selection boundary; the differing indices are
    counted), prints the features against the f32 leg's (|diff| / max(1,
    |f32|)), the launches of the bf16 kernels per decode call (none of the
    f32 ones), the detections; times the expert per clip, the
    encode+ground wall and video-seconds per second beside the f32 leg's
    ``f32``, the peak memory and a profile of one encode+ground (busy share,
    top device kernels). Returns the bf16 kernel launches of the counted
    encode+ground run."""
    import copy

    from decafnet_tpu_torch import ops
    from decafnet_tpu_torch.encode import (ClipEncoderRunner, encode_delegate_ground,
                                           expert_budget, select_salient_clips)

    bf = torch.bfloat16
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk16 = copy.deepcopy(sidekick_cpu)
    sk16.dtype = bf
    run_s16 = ClipEncoderRunner(sk16.to(dev))
    frames_e16, frames_s16 = frames_e.to(bf), frames_s.to(bf)
    k = expert_budget(ENC_T, ENC_SN, ENC_RATIO)

    def encode_and_ground():
        expert, sidekick, weight = encode_delegate_ground(
            run_e, run_s16, frames_e16, frames_s16, text_cls[0], ENC_SN, ENC_RATIO)
        streams = dict(vid=expert.cpu().numpy(), shallow_vid=sidekick.cpu().numpy(),
                       **request)
        return service16.ground(**streams), streams, weight

    encode_and_ground()      # warm-up outside the count
    # the main path in bf16: counts to 0 just before, read just after
    dec = service16.decoder
    calls0 = dec.decode_calls
    ops.reset_launch_counts()
    walls, (answers, streams, weight) = walls_ms(encode_and_ground, 3)
    launches, launches_f32 = ops.launch_counts(bf), ops.launch_counts()
    calls = dec.decode_calls - calls0
    want = {n: c * calls for n, c in PER_DECODE.items()}
    emit({"phase": "encode", "leg": "bf16", "decode_calls": calls,
          "launches_bf16": launches, "launches_f32": launches_f32,
          "expected": want, "selected_clips": int(weight.sum())})
    assert launches == want and calls > 0 and not any(launches_f32.values()), (
        launches, launches_f32)
    check_detections(answers, dict(request, vid=np.zeros((256, ENC_T))),
                     dec.cfg.nms.max_num_segs)

    # the selection and the features against the f32 leg
    sidekick16 = torch.from_numpy(streams["shallow_vid"]).to(dev)
    tc = text_cls[0].to(dev)
    idx32, w32 = select_salient_clips(sidekick32, tc, ENC_SN, ENC_RATIO, k)
    idx16, w16 = select_salient_clips(sidekick16, tc, ENC_SN, ENC_RATIO, k)
    s32, s16 = saliency_bins(sidekick32, tc, ENC_SN), saliency_bins(sidekick16, tc, ENC_SN)
    shift = float((s16 - s32).abs().max())
    kept = int(w32.reshape(-1, ENC_SN)[:, 0].sum())
    top = torch.sort(s32, descending=True).values
    boundary = float(top[kept - 1] + top[kept]) / 2
    b32, b16 = w32.reshape(-1, ENC_SN)[:, 0] > 0, w16.reshape(-1, ENC_SN)[:, 0] > 0
    swapped = torch.nonzero(b32 != b16).flatten()
    tied = all(abs(float(s32[b]) - boundary) <= 2 * shift for b in swapped.tolist())
    differing = int((idx16.cpu() != idx32.cpu()).sum())
    exp16 = torch.from_numpy(streams["vid"])
    exp32 = torch.from_numpy(expert32)
    both = (w16 > 0).cpu() & (w32 > 0).cpu()

    def rel(a, b):
        d = (a - b).abs() / b.abs().clamp_min(1.0)
        return {"max": float(d.max()), "mean": float(d.mean())}

    emit({"phase": "encode", "leg": "bf16", "check": "selection and features vs "
          "the f32 leg", "differing_indices": differing,
          "bins_swapped": swapped.tolist(), "bins_kept": kept,
          "bf16_bin_score_shift_max": shift, "boundary": boundary,
          "swapped_bins_f32_distance_to_boundary": [
              abs(float(s32[b]) - boundary) for b in swapped.tolist()],
          "sidekick_vs_f32": rel(sidekick16.cpu(), sidekick32.cpu()),
          "expert_vs_f32_on_clips_selected_in_both": rel(exp16[:, both], exp32[:, both]),
          "clips_selected_in_both": int(both.sum())})
    assert tied, (swapped.tolist(), shift, boundary)
    assert torch.isfinite(exp16).all() and torch.isfinite(sidekick16).all()

    # the stages, each between syncs
    sk_ms, _ = walls_ms(lambda: run_s16.encode(frames_s16), 3)
    clips = frames_e16.index_select(0, idx16)
    ex_ms, feats = walls_ms(lambda: run_e.encode(clips), 3)
    assert feats.dtype == bf
    med = float(np.median(walls))
    f32_med = float(np.median(f32["encode_ground_wall_ms"]))
    record = {"encode_ground_wall_ms": walls,
              "video_seconds_per_s": f32["video_seconds"] / (med / 1e3),
              "stages_ms": {"sidekick_all_clips": sk_ms, "expert_k_clips": ex_ms},
              "ms_per_clip": {"sidekick": float(np.median(sk_ms)) / ENC_T,
                              "expert": float(np.median(ex_ms)) / k},
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
              "profile": profile_step(lambda _: encode_and_ground(), None)}
    emit({"phase": "encode", "leg": "bf16", **record,
          "f32": {key: f32[key] for key in ("encode_ground_wall_ms",
                                            "video_seconds_per_s", "ms_per_clip",
                                            "peak_mem_gb")},
          "busy_vs_f32": (record["profile"]["device_busy_ms"]
                          / f32["profile"]["device_busy_ms"]),
          "wall_vs_f32": med / f32_med,
          "expert_ms_per_clip_vs_f32": (record["ms_per_clip"]["expert"]
                                        / f32["ms_per_clip"]["expert"]),
          "card": smi})
    return launches


# -------------------------------------------------------------------- multi

# the DDP legs' config file: dropout off (each rank draws its own masks),
# and SGD with momentum: under AdamW the attention key biases, whose exact
# gradient is 0 (softmax ignores a bias shared by every key), take lr-sized
# steps out of rounding noise, so their weights cannot be held against
# another run
MULTI_CFG = {"model": {"tcn_dropout": 0.0,
                       "vid_net": {"proj_pdrop": 0.0, "path_pdrop": 0.0},
                       "fusion": {"proj_pdrop": 0.0, "path_pdrop": 0.0}},
             "optimizer": {"name": "sgd", "lr": 0.01, "momentum": 0.9}}
MULTI_TIMEOUT_S = 300
# DDP losses against the one-process Trainer on the same batches (the
# updates of the weights and EMA by the train phase's relative-L2 rule)
MULTI_LOSS_RTOL = 1e-5


def torchrun(nproc, kind, args, report):
    """``python -m torch.distributed.run --standalone --nproc_per_node
    nproc chip_smoke.py --rank-worker kind report args`` in its own session,
    killed with all its ranks at MULTI_TIMEOUT_S: every rank runs the
    ``kind`` CLI's own functions on ``args`` (:func:`rank_worker`). Returns
    each rank's report, the output and the wall seconds."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), os.path.abspath(__file__),
           "--rank-worker", kind, report, *args]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=MULTI_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        raise
    wall = time.perf_counter() - t0
    if proc.returncode:
        raise RuntimeError(f"{' '.join(cmd)} exited {proc.returncode}:\n"
                           f"{out[-6000:]}")
    reports = []
    for r in range(nproc):
        with open(f"{report}.r{r}.json") as f:
            reports.append(json.load(f))
    return reports, out, wall


def rank_worker(kind, report, argv):
    """One rank of a multi-phase leg, started by ``torchrun``: what the
    ``kind`` (train or eval) CLI's ``main`` runs on ``argv`` (its
    ``build_trainer`` + ``train``, or ``build_evaluator`` + ``run``), then
    this rank's ``{report}.r<rank>.json`` (rank, world size, backend, kernel
    launches, peak memory, wall, and the run's steps and their synchronised
    walls, or decode calls, videos, queries and table) before it leaves the
    group. ``seqtrain`` is ``train`` and then one more forward and backward
    of a step's batch, profiled on rank 0 (:func:`seq_profile`);
    ``mad`` builds the Trainer and runs the remat_mad leg's one step (its
    batch, the generator at the seed, cuDNN's deterministic algorithms):
    loss, peak memory and walls."""
    sys.path.insert(0, REPO)
    from decafnet_tpu_torch import ops, parallel

    t0 = time.perf_counter()
    try:
        if kind in ("train", "seqtrain"):
            from decafnet_tpu_torch.train.__main__ import build_trainer, train
            from decafnet_tpu_torch.train.trainer import _to_device

            trainer = build_trainer(argv)
            step_fn, step_ms = trainer.train_step, []

            def timed(batch):
                ms, out = synced_ms(lambda: step_fn(batch))
                step_ms.append(ms)
                return out
            trainer.train_step = timed
            train(trainer)
            fields = {"steps": trainer.step, "device": str(trainer.device),
                      "time_sharded": trainer.shard is not None,
                      "data_rank": trainer.data_rank,
                      "time_rank": trainer.shard.rank if trainer.shard else 0,
                      "logdir": trainer.cfg.aux.logdir, "step_ms": step_ms}
            if kind == "seqtrain":
                # one more forward and backward of a step's batch (this
                # rank's data block of it) after training, profiled on rank
                # 0 (every rank runs it: the exchanges are collectives); the
                # launches are the run's
                fields["launches"] = ops.launch_counts()
                fields["launches_bf16"] = ops.launch_counts(torch.bfloat16)
                n = trainer.cfg.train.batch_size // trainer.data_world
                batch = _to_device(trainer.loader.transform(
                    [trainer.dataset[i] for i in range(
                        trainer.data_rank * n, (trainer.data_rank + 1) * n)]),
                    trainer.device)
                def run():
                    trainer.accumulate(batch)
                if parallel.rank() == 0:
                    fields["profile"] = seq_profile(run)
                else:
                    run()
        elif kind == "mad":
            fields = mad_step(argv)
        else:
            from decafnet_tpu_torch.eval.__main__ import build_evaluator

            ev = build_evaluator(argv)
            metrics = ev.run()
            fields = {"device": str(ev.device),
                      "time_sharded": ev.shard is not None,
                      "decode_calls": ev.decoder.decode_calls,
                      "videos": len(ev.loader), "recall": metrics.tolist(),
                      "queries": ev.meter.text_cnt}
        rep = {"rank": parallel.rank(), "world_size": parallel.world_size(),
               "backend": parallel.backend(), "launches": ops.launch_counts(),
               "launches_bf16": ops.launch_counts(torch.bfloat16),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
               "run_s": time.perf_counter() - t0, **fields}
        with open(f"{report}.r{parallel.rank()}.json", "w") as f:
            json.dump(rep, f)
    finally:
        parallel.destroy()
    return 0


def bf16_update_check(got, want, f32, start):
    """The update of ``got`` from ``start`` against the one-process bf16
    run's ``want`` at the bf16 noise floor: all leaves together within
    max(GRAD_REL_L2_ALL, BF16_MEAN_X x the distance of ``want``'s update
    from the one-process f32 run's ``f32``), as the train phase's bf16 leg
    holds its gradients; each leaf that moves in f32 within
    max(GRAD_REL_L2_LEAF, BF16_MAX_X x its own distance). Both runs carry
    their own bf16 roundings, so they lie ~sqrt(2) floors apart, and one
    leaf spreads more than their sum: per leaf the noise-floor rule's
    bound on maxima. A run whose gradients were halved, or never summed
    over the ranks, lands ~0.5 apart over all leaves."""
    start = {k: v.detach().double().cpu() for k, v in start.items()}
    g, w, f = ({k: x[k].detach().double().cpu() - b for k, b in start.items()}
               for x in (got, want, f32))
    rel, top = grads_rel_l2(g, w)
    floor, _ = grads_rel_l2(w, f)
    lim = max(GRAD_REL_L2_ALL, BF16_MEAN_X * floor)
    over = []
    for k in f:
        if float(f[k].abs().max()) > 1e-8:
            r = float((g[k] - w[k]).norm() / w[k].norm())
            fl = float((w[k] - f[k]).norm() / f[k].norm())
            if r > max(GRAD_REL_L2_LEAF, BF16_MAX_X * fl):
                over.append({"leaf": k, "rel_l2": r, "floor": fl})
    return {"update_rel_l2_all": rel, "floor_bf16_vs_f32": floor, "limit": lim,
            "worst_leaves": top, "leaves_over_limit": over,
            "ok": rel <= lim and not over}


def update_rel_l2(got, want, start):
    """Two runs from the same ``start`` (state dicts): the relative L2
    distance of their updates ``got - start`` and ``want - start``, in
    float64 (all leaves together, the worst leaves), and the max |diff| of
    the end states. A run whose gradients were halved, or never summed over
    the ranks, lands about 0.5 or more apart."""
    start = {k: v.detach().double().cpu() for k, v in start.items()}
    rel, top = grads_rel_l2(
        {k: got[k].detach().double().cpu() - b for k, b in start.items()},
        {k: want[k].detach().double().cpu() - b for k, b in start.items()})
    return {"update_rel_l2_all": rel, "worst_leaves": top, "max_abs_diff": max(
        float((got[k].detach().cpu() - want[k].detach().cpu()).abs().max())
        for k in start)}


def seq_profile(fn):
    """``fn()`` under torch.profiler: its wall, the device busy time, and the
    calls, host time and device time of the sequence-parallel ranges
    (``seq.halo``, ``seq.halo_backward``, ``seq.gather``, ``seq.crop``:
    the exchanges and the halos' copies, parallel/seq.py)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    # the host-side ranges, each with the device time of the kernels
    # launched inside it (the profiler also emits a device-side span of
    # each range, which runs from its first kernel to its last and so
    # holds the waits for the other rank: not counted)
    ranges = {}
    for e in prof.events():
        if e.name.startswith("seq.") and e.device_type == DeviceType.CPU:
            r = ranges.setdefault(e.name, {"calls": 0, "host_ms": 0.0,
                                           "device_ms": 0.0})
            r["calls"] += 1
            r["host_ms"] += e.cpu_time_total / 1e3
            r["device_ms"] += e.device_time_total / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "ranges": ranges}


def mad_step(argv):
    """One step of the remat_mad leg's task from the train CLI's
    ``build_trainer``, with tpu.remat off and then "nothing" (the remat
    settings go into ``argv``'s ``--set`` list): the first
    ``train.batch_size`` samples, the generator at the seed, cuDNN's
    deterministic algorithms, as :func:`remat_runs` takes it. Returns, per
    policy, the loss terms, the peak memory of ``accumulate``, the launches
    of the kernels in it, its wall and the optimizer update's."""
    import gc

    cut = argv.index("--device") if "--device" in argv else len(argv)
    out = {}
    for policy in (None, "nothing"):
        label = policy or "off"
        out[label] = mad_policy_step(argv[:cut] + [
            "tpu.remat", str(policy is not None), "tpu.remat_policy",
            policy or "nothing"] + argv[cut:])
        gc.collect()
        torch.cuda.empty_cache()
    return {"policies": out, "time_sharded": all(
        p["time_sharded"] for p in out.values()),
        "launches": {n: sum(p["launches"][n] for p in out.values())
                     for n in out["off"]["launches"]}}


def mad_policy_step(argv):
    """:func:`mad_step` for one remat policy."""
    from decafnet_tpu_torch import ops
    from decafnet_tpu_torch.train.__main__ import build_trainer
    from decafnet_tpu_torch.train.trainer import _to_device

    trainer = build_trainer(argv)
    cfg = trainer.cfg
    trainer.loader.set_epoch(0)
    batch = _to_device(trainer.loader.transform(
        [trainer.dataset[i] for i in range(cfg.train.batch_size)]),
        trainer.device)
    trainer.generator.manual_seed(SEED)
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    torch.backends.cudnn.deterministic = True
    try:
        acc_ms, metrics = synced_ms(lambda: trainer.accumulate(batch))
    finally:
        torch.backends.cudnn.deterministic = False
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = ops.launch_counts()
    update_ms, _ = synced_ms(lambda: trainer.update(metrics))
    return {"remat": trainer.model.vid_net.remat, "launches": launches,
            "loss": float(metrics["total"]), "cls": float(metrics["cls"]),
            "reg": float(metrics["reg"]), "rows": int(batch["text"].shape[0]),
            "T": int(batch["vid"].shape[-1]), "peak_gb": peak_gb,
            "peak_above_start_gb": peak_gb - base_gb, "accumulate_ms": acc_ms,
            "update_ms": update_ms, "time_sharded": trainer.shard is not None,
            "device": str(trainer.device)}


def merged_results(shards, order):
    """The ranks' result dumps as one, videos in ``order`` (vid ids)."""
    from decafnet_tpu_torch.utils import EvalResults

    by_id = {v["vid_id"]: v for s in shards for v in s.videos}
    assert sorted(by_id) == sorted(order), (sorted(by_id), sorted(order))
    out = EvalResults("merged")
    out.videos = [by_id[v] for v in order]
    return out


def run_multi(root, cfg_file, eval_logdir, eval_base, smi, mad_ref, mad_eval):
    """Data parallelism on the card, each leg launched by ``python -m
    torch.distributed.run``, its ranks running the CLI's own functions
    (:func:`rank_worker`):

    ddp1   training as one NCCL rank at the train phase's shape (16 videos
           x 2 queries per step, T = 2304, one epoch = 2 steps, dropout
           off, SGD), against the one-process Trainer of the same argv:
           losses at rtol 1e-5, and the updates of the weights and of the
           EMA from the common start by the train phase's relative-L2 rule
           (1e-2 over all leaves, 0.25 per leaf; a run with halved or
           unsummed gradients lands ~0.5 apart). Expected: the difference
           of two one-process runs, which is printed beside it, as is the
           weights' max |diff|;
    ddp2   the same as two ranks on the one card over gloo (8 videos per
           rank, CUDA tensors), with 8 / 7 / 1 launches per forward
           microbatch on each rank, peak memory and step walls per rank
           (the two ranks share one card: no speed is read from them);
    eval2  the eval CLI's run over the eval phase's experiment as two gloo ranks
           (``eval.shard_processes``): every rank's table equals the eval
           phase's, and so do the detections (1e-3 s / 1e-4) and the
           annotated-recall table of the ranks' merged dumps;
    stack  ``eval.shard_videos`` 4 in this process through the eval CLI's
           build_evaluator, against V = 1: the same checks, the launches per
           stacked decode call and the wall per video at V = 4 and V = 1;
    seq2   ddp2 with ``tpu.shard_time``: each rank holds half of every
           video's time axis (parallel/seq.py), by ddp2's rules against
           the one-process run; then one more forward and backward of a
           step's batch, rank 0's profiled (the exchanges' and the halos'
           copies' device time);
    dt2x2  seq2 with ``tpu.mesh_shape [2, 2]`` over four ranks: rank r holds
           data block r // 2 (8 videos) and time block r % 2 (1152
           columns), exchanging inside its 2-rank time subgroup; ddp2's
           rules against the one-process run, its update's distance to
           ddp2's beside the one-process runs', per-rank peak memory,
           launches and rank 0's exchanges per forward;
    seq2_global  seq2 with ``model.vid_net.mha_win_size -1`` (global video
           self-attention: the ranks gather each attention's keys), against
           a one-process run of the same override (another function), with
           8 / 0 / 1 launches per forward microbatch and each rank's peak
           memory beside the one-process run's;
    ddp2_bf16, seq2_bf16  ddp2 and seq2 with ``tpu.compute_dtype
           bfloat16``, against a one-process bf16 run of the same argv at
           the bf16 noise floor, the distance of the one-process bf16 run
           from the one-process f32 run (:func:`bf16_update_check`): the
           updates of the weights and EMA within BF16_MEAN_X floors over
           all leaves (at least the f32 limits), each leaf and each step's
           loss within BF16_MAX_X floors; 8 / 7 / 1 launches of the bf16
           kernels per forward microbatch and none of the f32 ones;
    seq2_mad  one step of the remat_mad leg (``mad_ref``: its argv and its
           records) as two gloo ranks, remat off and "nothing": each rank's
           peak memory beside the one-process peak, the loss at rtol 1e-4;
    evalseq2  eval2 with ``eval.shard_time`` 2 instead: every rank decodes
           every video, one time block of each; the same checks, the lead's
           dump against the eval phase's;
    evalseq2_global  evalseq2 with the global window, against a one-process
           eval of the same override: the tables equal, the detections
           within 1e-3 s / 1e-4, 8 / 0 / 1 launches per decode call;
    evalseq2_mad  the mad phase's T = 32768 eval (``mad_eval``: its
           experiment directory, device-NMS run and peak memory) with
           ``eval.shard_time`` 2: every rank's table equals the one-process
           table, the lead's detections too, 8 / 7 / 1 launches per decode
           call, each rank's peak memory beside the one-process peak.

    Returns the launches of each f32 path: "multi" (the four legs above
    seq2: every rank's, and the V = 4 run's), "seq2", "dt2x2",
    "seq2_global", "seq2_mad", "evalseq2", "evalseq2_global" and
    "evalseq2_mad" (every rank's); and of each bf16 path: "ddp2_bf16" and
    "seq2_bf16"."""
    import gc

    from decafnet_tpu_torch import ops
    from decafnet_tpu_torch.eval.__main__ import build_evaluator
    from decafnet_tpu_torch.train.__main__ import build_trainer, train
    from decafnet_tpu_torch.utils import EvalResults

    import yaml

    torch.cuda.empty_cache()
    mroot = os.path.join(root, "multi")
    os.makedirs(mroot)
    multi_cfg = os.path.join(mroot, "multi.yaml")
    with open(multi_cfg, "w") as f:
        yaml.safe_dump(MULTI_CFG, f)

    def train_argv(tag):
        return ["--cfg", os.path.join(REPO, "configs", "ego4d_nlq.yaml"),
                cfg_file, multi_cfg, "--set", "log.root",
                os.path.join(mroot, tag), "seed", str(SEED), "train.epochs",
                "1", "train.warmup_epochs", "0", "aux.log_interval", "1"]

    def logged(logdir):
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    def snapshot(trainer):
        return {"model": {k: v.detach().clone() for k, v in
                          trainer.model.state_dict().items()},
                "ema": {k: v.detach().clone() for k, v in
                        trainer.ema.state_dict().items()}}

    # the one-process reference on the same batches, twice: the second run
    # measures how far two runs of one process land apart (cuDNN's weight
    # gradients and the loss's scatters add in no fixed order)
    t0 = time.perf_counter()
    ref = build_trainer(train_argv("ref"))
    start = snapshot(ref)
    train(ref)
    ref_s = time.perf_counter() - t0
    ref_end = snapshot(ref)
    again = snapshot(train(build_trainer(train_argv("ref_again"))))
    noise = {k: update_rel_l2(again[k], ref_end[k], start[k])
             for k in ("model", "ema")}
    ref_dir = ref.cfg.aux.logdir
    ref_log = logged(ref_dir)
    steps = ref.step
    n_micro = max(ref.cfg.train.batch_size // ref.micro, 1)
    assert steps == 2 and n_micro == 1, (steps, n_micro)
    launches = {n: 0 for n in PER_DECODE}

    # the global-window model (vid_net.mha_win_size -1) is another function:
    # its own one-process run, the reference of seq2_global, with the peak
    # memory of its run (above what this process held before it)
    gc.collect()
    torch.cuda.empty_cache()
    base_gb = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ref_g = build_trainer(train_argv("ref_global") + GLOBAL)
    start_g = snapshot(ref_g)
    train(ref_g)
    refs = {"window": (ref_log, start, ref_end, ref_s, None),
            "global": (logged(ref_g.cfg.aux.logdir), start_g, snapshot(ref_g),
                       time.perf_counter() - t0,
                       torch.cuda.max_memory_allocated() / 2 ** 30 - base_gb)}
    assert ref_g.cfg.model.vid_net.mha_win_size == -1 and ref_g.step == steps
    del ref_g
    # how far the global-window model's update lies from the window-5 one's
    # (LayerScale's 1e-4 start keeps the attention branches small)
    global_vs_window = update_rel_l2(refs["global"][2]["model"],
                                     ref_end["model"], start["model"])
    # the reference of the bf16 legs: one process in bf16 from the same
    # seeded start
    t0 = time.perf_counter()
    ref16 = build_trainer(train_argv("ref_bf16") + BF16)
    start16 = snapshot(ref16)
    train(ref16)
    refs["bf16"] = (logged(ref16.cfg.aux.logdir), start16, snapshot(ref16),
                    time.perf_counter() - t0, None)
    assert ref16.model.compute_dtype == torch.bfloat16 and ref16.step == steps
    assert all(torch.equal(start16[k][n], start[k][n])
               for k in start for n in start[k])
    del ref16
    # the bf16 run's losses against the f32 run's, step by step: the loss
    # floor of the bf16 legs
    loss_floor16 = max(abs(a[k] - b[k]) / abs(b[k])
                       for a, b in zip(refs["bf16"][0], ref_log)
                       for k in ("train/cls", "train/reg", "train/total"))

    on_card = ["--device", "cuda:0", "--dist-backend", "gloo"]
    seq_on = ["tpu.shard_time", "True"]
    paths = {"multi": launches}
    ends = {}
    # leg: (ranks, data indices, worker kind, --set pairs, reference)
    legs = {"ddp1": (1, 1, "train", [], "window"),
            "ddp2": (2, 2, "train", [], "window"),
            "seq2": (2, 1, "seqtrain", seq_on, "window"),
            "dt2x2": (4, 2, "seqtrain", seq_on + ["tpu.mesh_shape", "[2, 2]"],
                      "window"),
            "seq2_global": (2, 1, "seqtrain", seq_on + GLOBAL, "global"),
            "ddp2_bf16": (2, 2, "train", BF16, "bf16"),
            "seq2_bf16": (2, 1, "seqtrain", seq_on + BF16, "bf16")}
    paths16 = {}
    for leg, (nproc, n_data, kind, sets, ref_name) in legs.items():
        want_log, want_start, want_end, want_s, want_peak = refs[ref_name]
        reports, out, wall = torchrun(
            nproc, kind, train_argv(leg) + sets + (on_card if nproc > 1 else []),
            os.path.join(mroot, leg))
        logdir = reports[0]["logdir"]
        got = logged(logdir)
        assert [g["itr"] for g in got] == [r["itr"] for r in want_log]
        loss_diff = max(abs(g[k] - r[k]) for g, r in zip(got, want_log)
                        for k in ("train/cls", "train/reg", "train/total"))
        loss_rel = max(abs(g[k] - r[k]) / abs(r[k]) for g, r in zip(got, want_log)
                       for k in ("train/cls", "train/reg", "train/total"))
        ckpt = torch.load(os.path.join(logdir, "models", "last.pth"),
                          weights_only=True)
        assert not [k for k in ckpt["model"] if k.startswith("module.")]
        ends[leg] = {"model": ckpt["model"], "ema": ckpt["model_ema"]}
        bf16 = ref_name == "bf16"
        if bf16:
            upd = {k: bf16_update_check(ends[leg][k], want_end[k],
                                        ref_end[k], want_start[k])
                   for k in ("model", "ema")}
            # each step's loss is one number, held as one leaf is
            loss_lim = max(MULTI_LOSS_RTOL, BF16_MAX_X * loss_floor16)
        else:
            upd = {k: update_rel_l2(ends[leg][k], want_end[k], want_start[k])
                   for k in ("model", "ema")}
            loss_lim = MULTI_LOSS_RTOL
        per_forward = PER_FORWARD[ref_name if ref_name == "global" else "iter"]
        want = {n: c * steps * n_micro for n, c in per_forward.items()}
        count_key = "launches_bf16" if bf16 else "launches"
        backend = "nccl" if nproc == 1 else "gloo"
        sharded = kind == "seqtrain"
        n_time = nproc // n_data
        extra = {}
        if sharded:
            ranges = reports[0]["profile"]["ranges"]
            extra = {"tpu.shard_time": True, "mesh": [n_data, n_time],
                     "peak_mem_gb": [r["peak_mem_gb"] for r in reports],
                     "rank_step_ms": [r["step_ms"] for r in reports],
                     "exchanges_per_forward_rank0": {
                         k: ranges.get(k, {}).get("calls", 0)
                         for k in ("seq.halo", "seq.gather")},
                     "profile_rank0_microbatch": reports[0]["profile"]}
        if leg == "dt2x2":
            extra["update_vs_ddp2"] = {
                k: update_rel_l2(ends[leg][k], ends["ddp2"][k], want_start[k])
                for k in ("model", "ema")}
        if want_peak is not None:
            extra.update(one_process_peak_gb=want_peak,
                         one_process_vs_window_5_model=global_vs_window,
                         peak_per_rank_vs_one_process=[
                             r["peak_mem_gb"] / want_peak for r in reports])
        emit({"phase": "multi", "leg": leg, "launch": f"python -m "
              f"torch.distributed.run --standalone --nproc_per_node {nproc} "
              f"chip_smoke.py --rank-worker {kind} (decafnet_tpu_torch.train's "
              f"build_trainer + train)", "backend": backend,
              "sets": sets, "videos_per_rank": ref.cfg.train.batch_size // n_data,
              "T_per_rank": ref.cfg.data.max_vid_len // (n_time if sharded else 1),
              **extra, "steps": steps,
              "losses": [{k: g[k] for k in g if k.startswith("train/")}
                         for g in got],
              "ref_losses": [{k: r[k] for k in r if k.startswith("train/")}
                             for r in want_log],
              "loss_max_abs_diff": loss_diff, "loss_max_rel": loss_rel,
              "weights": upd["model"], "ema": upd["ema"],
              "one_process_twice": noise,
              "ranks": reports, "expected_launches_per_rank": want,
              "launches_per_forward_microbatch": [
                  {n: r[count_key][n] / (steps * n_micro) for n in PER_DECODE}
                  for r in reports], "launch_counter": count_key,
              "step_ms": [1e3 * g["itr_time"] for g in got],
              "ref_step_ms": [1e3 * r["itr_time"] for r in want_log],
              "ref_run_s": want_s, "wall_s": wall, "card": smi,
              "note": f"{nproc} ranks share one card: no speed is read from "
                      f"these walls" if nproc > 1 else "world 1 over NCCL",
              "tol": {"loss_rtol": loss_lim,
                      "update_rel_l2_all": "bf16 rule: see weights.limit"
                      if bf16 else GRAD_REL_L2_ALL,
                      "update_rel_l2_leaf": GRAD_REL_L2_LEAF}})
        assert [(r["rank"], r["world_size"], r["backend"]) for r in reports] \
            == [(i, nproc, backend) for i in range(nproc)], reports
        assert all(r["time_sharded"] == sharded for r in reports)
        # rank r at (r // n_time, r % n_time) of the (data, time) mesh
        assert [(r["data_rank"], r["time_rank"]) for r in reports] == [
            (i // n_time, i % n_time) if sharded else (i, 0)
            for i in range(nproc)], reports
        path = leg if sharded or bf16 else "multi"
        into = paths16 if bf16 else paths
        into.setdefault(path, {n: 0 for n in PER_DECODE})
        for r in reports:
            assert r[count_key] == want, (leg, r[count_key], want)
            if bf16:
                assert not any(r["launches"].values()), (leg, r["launches"])
            into[path] = {n: into[path][n] + r[count_key][n]
                          for n in PER_DECODE}
        assert loss_rel <= loss_lim, (leg, loss_rel, loss_lim)
        for what, u in upd.items():
            if bf16:
                assert u["ok"], (leg, what, u)
            else:
                assert u["update_rel_l2_all"] <= GRAD_REL_L2_ALL and \
                    u["worst_leaves"][0]["rel_l2"] <= GRAD_REL_L2_LEAF, (leg, what, u)

    # one MAD step with each movie's time axis over the two ranks, remat
    # off and "nothing" (the recompute exchanges halos in the backward)
    mad_argv, mad_one = mad_ref
    reports, out, wall = torchrun(
        2, "mad", mad_argv + ["log.root", os.path.join(mroot, "seq2_mad"),
                              "tpu.shard_time", "True", *on_card],
        os.path.join(mroot, "seq2_mad"))
    per = {}
    for label, one in mad_one.items():
        got = [r["policies"][label] for r in reports]
        per[label] = {
            "peak_gb_per_rank": [g["peak_gb"] for g in got],
            "one_process_peak_gb": one["peak_gb"],
            "peak_per_rank_vs_one_process": [g["peak_gb"] / one["peak_gb"]
                                             for g in got],
            "loss": [g["loss"] for g in got], "one_process_loss": one["loss"],
            "loss_max_rel": max(abs(g["loss"] - one["loss"]) / abs(one["loss"])
                                for g in got),
            "accumulate_ms": [g["accumulate_ms"] for g in got],
            "one_process_accumulate_ms": one["accumulate_ms"],
            "launches_per_rank": [g["launches"] for g in got]}
    emit({"phase": "multi", "leg": "seq2_mad", "launch": "python -m "
          "torch.distributed.run --standalone --nproc_per_node 2 chip_smoke.py "
          "--rank-worker mad (decafnet_tpu_torch.train's build_trainer, one "
          "accumulate + update per remat policy)", "backend": "gloo",
          "tpu.shard_time": True,
          "shape": f"{MAD_VIDEOS} movies x 2 queries = 8 rows at T={MAD_T} "
          f"({MAD_T // 2} per rank), one microbatch",
          "policies": per, "ranks": reports, "wall_s": wall, "card": smi,
          "note": "two ranks share one card: no speed is read from these "
                  "walls", "tol": {"loss_rtol": 1e-4}})
    paths["seq2_mad"] = {n: 0 for n in PER_DECODE}
    for r in reports:
        assert r["time_sharded"], r
        for label, g in r["policies"].items():
            assert g["T"] == MAD_T and g["remat"] == (label != "off"), g
            assert g["launches"] == PER_FORWARD["remat" if g["remat"]
                                                else "iter"], (label, g)
            assert np.isfinite([g["loss"], g["cls"], g["reg"]]).all(), g
        assert r["launches"] == {n: PER_FORWARD["iter"][n]
                                 + PER_FORWARD["remat"][n]
                                 for n in PER_DECODE}, r["launches"]
        paths["seq2_mad"] = {n: paths["seq2_mad"][n] + r["launches"][n]
                             for n in PER_DECODE}
    for label, p in per.items():
        assert p["loss_max_rel"] <= 1e-4, (label, p)

    # process-sharded eval over the eval phase's experiment
    base_m, base_r, base_l = eval_base
    order = [v["vid_id"] for v in base_r.videos]
    reports, out, wall = torchrun(
        2, "eval",
        ["--name", eval_logdir, "--device", "cuda:0", "--dist-backend", "gloo",
         "--set", "eval.save_results", "True"], os.path.join(mroot, "eval2"))
    shards = [EvalResults.load(os.path.join(eval_logdir, f"results_last.pk.r{r}"))
              for r in (0, 1)]
    eval2 = merged_results(shards, order)
    runs = {"device_nms": eval_base,
            "eval2": (None, eval2, [l for v in eval2.videos for l in v["losses"]])}

    # time-sharded eval over the same experiment: the lead dumps every video
    seq_reports, _, seq_wall = torchrun(
        2, "eval",
        ["--name", eval_logdir, "--device", "cuda:0", "--dist-backend", "gloo",
         "--set", "eval.save_results", "True", "eval.shard_time", "2"],
        os.path.join(mroot, "evalseq2"))
    evalseq2 = merged_results([EvalResults.load(os.path.join(
        eval_logdir, "results_last.pk"))], order)
    runs["evalseq2"] = (None, evalseq2,
                        [l for v in evalseq2.videos for l in v["losses"]])

    # stacked videos in this process: V = 4 (the path) and V = 1, in turns
    stack = {}
    for V in (4, 1, 1, 4):
        ev = build_evaluator(["--name", eval_logdir, "--set", "eval.save_results",
                              "True", "eval.shard_videos", str(V)])
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = ev.run()
        torch.cuda.synchronize()
        wall_v = time.perf_counter() - t0
        counts, calls = ops.launch_counts(), ev.decoder.decode_calls
        # stacked videos finish in group order: the dump in the base order
        results = merged_results([EvalResults.load(os.path.join(
            eval_logdir, "results_last.pk"))], order)
        prev = stack.get(V, {"wall_s": [], "ms_per_video": []})
        stack[V] = {"calls": calls, "launches": counts,
                    "wall_s": prev["wall_s"] + [wall_v],
                    "ms_per_video": prev["ms_per_video"] + [1e3 * wall_v / len(order)],
                    "phase_s": {k: sum(v) for k, v in ev.decoder.time_dict.items()}}
        runs[f"stack{V}"] = (metrics, results,
                             [l for v in results.videos for l in v["losses"]])
        assert counts == {n: c * calls for n, c in PER_DECODE.items()}, (V, counts)
        assert np.array_equal(metrics, base_m), (V, metrics, base_m)
        if V == 4:
            paths["multi"] = {n: paths["multi"][n] + counts[n]
                              for n in PER_DECODE}
    annotated, n_q = annotated_recall(runs, tuple(ev.cfg.eval.ranks),
                                      tuple(ev.cfg.eval.iou_threshs))
    checks = {}
    for mode in ("eval2", "evalseq2", "stack4", "stack1"):
        _, results, losses = runs[mode]
        seg_d, sc_d = same_detections(eval_answers(base_r), eval_answers(results))
        loss_d = max(abs(a[k] - b[k]) / (LOSS_ATOL / LOSS_RTOL + abs(b[k]))
                     for a, b in zip(losses, base_l) for k in a)
        checks[mode] = {"seg_s": seg_d, "score": sc_d, "loss_rel": loss_d,
                        "annotated": annotated[mode].tolist()}
    emit({"phase": "multi", "leg": "eval2", "launch": "python -m "
          "torch.distributed.run --standalone --nproc_per_node 2 chip_smoke.py "
          "--rank-worker eval (decafnet_tpu_torch.eval's build_evaluator + "
          "run)", "backend": "gloo", "ranks": reports,
          "recall": base_m.tolist(), "annotated_base":
          annotated["device_nms"].tolist(), "check": checks["eval2"],
          "wall_s": wall, "card": smi})
    emit({"phase": "multi", "leg": "evalseq2", "launch": "python -m "
          "torch.distributed.run --standalone --nproc_per_node 2 chip_smoke.py "
          "--rank-worker eval (decafnet_tpu_torch.eval's build_evaluator + "
          "run) --set eval.shard_time 2", "backend": "gloo",
          "ranks": seq_reports, "launches_per_decode_call": [
              {n: r["launches"][n] / r["decode_calls"] for n in PER_DECODE}
              for r in seq_reports],
          "recall": base_m.tolist(), "check": checks["evalseq2"],
          "wall_s": seq_wall, "card": smi,
          "note": "two ranks share one card: no speed is read from the wall"})
    emit({"phase": "multi", "leg": "stack", "shard_videos": 4,
          "runs": "V = 4, 1, 1, 4 in turns; phase_s of the last run of each",
          "decode_calls": {V: stack[V]["calls"] for V in stack},
          "launches_per_decode_call": PER_DECODE,
          "launches": {V: stack[V]["launches"] for V in stack},
          "wall_s": {V: stack[V]["wall_s"] for V in stack},
          "ms_per_video": {V: stack[V]["ms_per_video"] for V in stack},
          "phase_s": {V: stack[V]["phase_s"] for V in stack},
          "check": {"stack4": checks["stack4"], "stack1": checks["stack1"]},
          "note": "the wall is recorded, not claimed", "card": smi})
    for r in reports:
        assert r["recall"] == base_m.tolist() and r["queries"] == 48, r
        assert r["launches"] == {n: c * r["decode_calls"]
                                 for n, c in PER_DECODE.items()}, r
        paths["multi"] = {n: paths["multi"][n] + r["launches"][n]
                          for n in PER_DECODE}
    assert sorted(r["videos"] for r in reports) == [6, 6], reports
    for r in seq_reports:
        assert r["time_sharded"] and r["videos"] == 12, r
        assert r["recall"] == base_m.tolist() and r["queries"] == 48, r
        assert r["decode_calls"] == 12 and r["launches"] == {
            n: c * r["decode_calls"] for n, c in PER_DECODE.items()}, r
    paths["evalseq2"] = {n: sum(r["launches"][n] for r in seq_reports)
                         for n in PER_DECODE}
    assert stack[4]["calls"] < stack[1]["calls"] == 12, stack
    for mode, c in checks.items():
        assert np.array_equal(annotated[mode], annotated["device_nms"]), mode
        assert c["seg_s"] <= SEG_TOL_S and c["score"] <= SCORE_TOL, (mode, c)
        assert c["loss_rel"] <= LOSS_RTOL, (mode, c)

    # global video self-attention over the same checkpoint: one process,
    # then every video's time axis over two ranks that gather the keys
    ev = build_evaluator(["--name", eval_logdir, "--set", "eval.save_results",
                          "True", *GLOBAL])
    one_m = ev.run()
    one_r = merged_results([EvalResults.load(os.path.join(
        eval_logdir, "results_last.pk"))], order)
    g_reports, _, g_wall = torchrun(
        2, "eval",
        ["--name", eval_logdir, "--device", "cuda:0", "--dist-backend", "gloo",
         "--set", "eval.save_results", "True", "eval.shard_time", "2", *GLOBAL],
        os.path.join(mroot, "evalseq2_global"))
    seq_r = merged_results([EvalResults.load(os.path.join(
        eval_logdir, "results_last.pk"))], order)
    seg_d, sc_d = same_detections(eval_answers(one_r), eval_answers(seq_r))
    loss_d = max(abs(a[k] - b[k]) / (LOSS_ATOL / LOSS_RTOL + abs(b[k]))
                 for a, b in zip([l for v in seq_r.videos for l in v["losses"]],
                                 [l for v in one_r.videos for l in v["losses"]])
                 for k in a)
    # the distance to the window-5 model's detections (printed only)
    win_seg, win_sc = same_detections(eval_answers(base_r), eval_answers(one_r))
    check_g = {"seg_s": seg_d, "score": sc_d, "loss_rel": loss_d}
    emit({"phase": "multi", "leg": "evalseq2_global", "launch": "python -m "
          "torch.distributed.run --standalone --nproc_per_node 2 chip_smoke.py "
          "--rank-worker eval (decafnet_tpu_torch.eval's build_evaluator + "
          "run) --set eval.shard_time 2 model.vid_net.mha_win_size -1",
          "backend": "gloo", "ranks": g_reports,
          "launches_per_decode_call": [
              {n: r["launches"][n] / r["decode_calls"] for n in PER_DECODE}
              for r in g_reports],
          "recall": one_m.tolist(), "check": check_g,
          "vs_window_5_model": {"seg_s": win_seg, "score": win_sc},
          "wall_s": g_wall, "card": smi,
          "note": "two ranks share one card: no speed is read from the wall"})
    for r in g_reports:
        assert r["time_sharded"] and r["videos"] == 12, r
        assert r["recall"] == one_m.tolist() and r["queries"] == 48, r
        assert r["decode_calls"] == 12 and r["launches"] == {
            n: c * r["decode_calls"]
            for n, c in PER_FORWARD["global"].items()}, r
    paths["evalseq2_global"] = {n: sum(r["launches"][n] for r in g_reports)
                                for n in PER_DECODE}
    assert seg_d <= SEG_TOL_S and sc_d <= SCORE_TOL, check_g
    assert loss_d <= LOSS_RTOL, check_g

    # the mad phase's T = 32768 eval with each movie's time axis over two
    # ranks: the lead dumps every movie
    mad_logdir, ((mad_m, mad_r, mad_l), mad_peak) = mad_eval
    mad_order = [v["vid_id"] for v in mad_r.videos]
    m_reports, _, m_wall = torchrun(
        2, "eval",
        ["--name", mad_logdir, "--device", "cuda:0", "--dist-backend", "gloo",
         "--set", "eval.save_results", "True", "eval.shard_time", "2",
         *MAD_LONG], os.path.join(mroot, "evalseq2_mad"))
    seq_r = merged_results([EvalResults.load(os.path.join(
        mad_logdir, "results_last.pk"))], mad_order)
    seg_d, sc_d = same_detections(eval_answers(mad_r), eval_answers(seq_r))
    loss_d = max(abs(a[k] - b[k]) / (LOSS_ATOL / LOSS_RTOL + abs(b[k]))
                 for a, b in zip([l for v in seq_r.videos for l in v["losses"]],
                                 mad_l) for k in a)
    check_m = {"seg_s": seg_d, "score": sc_d, "loss_rel": loss_d}
    n_q = len(mad_l)
    emit({"phase": "multi", "leg": "evalseq2_mad", "launch": "python -m "
          "torch.distributed.run --standalone --nproc_per_node 2 chip_smoke.py "
          "--rank-worker eval (decafnet_tpu_torch.eval's build_evaluator + "
          "run) --set eval.shard_time 2 model.vid_net.max_seq_len "
          f"{MAD_T}", "backend": "gloo", "ranks": m_reports,
          "launches_per_decode_call": [
              {n: r["launches"][n] / r["decode_calls"] for n in PER_DECODE}
              for r in m_reports],
          "recall": mad_m.tolist(), "check": check_m,
          "peak_mem_gb": [r["peak_mem_gb"] for r in m_reports],
          "one_process_peak_gb": mad_peak,
          "peak_per_rank_vs_one_process": [r["peak_mem_gb"] / mad_peak
                                           for r in m_reports],
          "wall_s": m_wall, "card": smi,
          "note": "two ranks share one card: no speed is read from the wall"})
    for r in m_reports:
        assert r["time_sharded"] and r["videos"] == len(mad_order), r
        assert r["recall"] == mad_m.tolist() and r["queries"] == n_q, r
        assert r["decode_calls"] == 3 and r["launches"] == {
            n: c * r["decode_calls"] for n, c in PER_DECODE.items()}, r
    paths["evalseq2_mad"] = {n: sum(r["launches"][n] for r in m_reports)
                             for n in PER_DECODE}
    assert seg_d <= SEG_TOL_S and sc_d <= SCORE_TOL, check_m
    assert loss_d <= LOSS_RTOL, check_m
    return paths, paths16


# ------------------------------------------------------------------- shapes
# The kernels of the shapes the tuned kernels are not built for: the general
# kernels (csrc/*_general.cu), the wide ones (csrc/*_wide.cu) and conv3's pass
# ones (csrc/conv3_ln_act_passes.cu). At the JAX package's own kernel-test shapes
# (tests/test_local_attention.py, tests/test_fused_conv.py; the launch
# helpers force the general kernels there) and at the widths of the widths
# legs of the configs phase, 64 rows x T = 2304 x 7 levels.
REPLACES = {"band_attention": "decafnet_tpu/ops/local_attention.py:244",
            "conv3_ln_act": "decafnet_tpu/ops/fused_conv.py:79",
            "qkv_depthwise_ln": "decafnet_tpu/ops/fused_conv.py:294"}
# the records of the shapes phase, (op, route): the kernel's source
SHAPE_KERNELS = {
    ("band_attention", "general"): "decafnet_tpu_torch/csrc/band_attention_general.cu",
    ("band_attention", "wide"): "decafnet_tpu_torch/csrc/band_attention_wide.cu",
    ("conv3_ln_act", "general"): "decafnet_tpu_torch/csrc/conv3_ln_act_general.cu",
    ("conv3_ln_act", "wide"): "decafnet_tpu_torch/csrc/conv3_ln_act_wide.cu",
    ("conv3_ln_act", "passes"): "decafnet_tpu_torch/csrc/conv3_ln_act_passes.cu",
    ("qkv_depthwise_ln", "wide"): "decafnet_tpu_torch/csrc/qkv_depthwise_ln_wide.cu",
    ("qkv_depthwise_ln", "general"): "decafnet_tpu_torch/csrc/qkv_depthwise_ln_general.cu"}
# the kernels of the shapes phase that no path launches, and why
OFF_PATH = {("conv3_ln_act", "general"):
            "no path runs conv3 above C_out 4096: the embd-1024 heads' 1056 take "
            "the pass kernels; timed here forced, at the wide and pass kernels' "
            "widths",
            ("band_attention", "general"):
            "no path runs band attention at a D off 8 or over 256 or a window "
            "over 33: the widths legs' D 16, 64, 128 and 256 at window 5 take the "
            "wide kernels; held here forced at the JAX test shapes and timed "
            "forced, in turns with the wide kernels, at their shapes",
            ("qkv_depthwise_ln", "general"):
            "no path runs the trio above C 4096: the embd-512 and embd-1024 legs' "
            "C 512 and 1024 take the wide kernels; held here forced at the JAX "
            "test shapes and timed forced, in turns with the wide kernels, at "
            "C 512 and 1024"}
JAX_BAND_SHAPES = ((96, 5), (40, 9), (130, 5), (8, 5), (7, 5), (96, 9), (7, 9))
JAX_CONV3_T = (100, 256, 700)
JAX_TRIO_T = (200, 384)
# band attention at head widths 16, 64 and 128 with window 11, at the
# embd-1024 leg's (D 256, the shipped window 5), and at the other widths
# legs' (D 16, 64, 128 at window 5)
SHAPES_BAND = ((16, 11), (64, 11), (128, 11), (256, WINDOW), (16, WINDOW),
               (64, WINDOW), (128, WINDOW))
# the wide band kernel at other views, 4 rows x 4 heads at window 5, D 16
# and 256: (layout, T); "time_minor" is a time-sharded rank's level-0 block
# (T0 / 2 columns) widened by the halo on each side, time-minor as
# band_attention builds it
SHAPES_BAND_LAYOUTS = (("as_is", 301), ("offset", 301), ("padded", 300),
                       ("contiguous", 300), ("time_minor", T0 // 2))
# conv3 at embd 256 plus the heads' 32, and at embd 512 and 512 + 32: the
# wide kernels, timed in turns against the general kernel (forced) there
SHAPES_CONV3_C = (288, 512, 544)
# the wide kernels also at a C_out off 8 and at their widest, over fewer
# rows
SHAPES_WIDE_EDGE_C, SHAPES_WIDE_EDGE_ROWS = (300, 1024), 16
# conv3 at embd 1024 plus the heads' 32: the pass kernels, timed in turns
# against the general kernel (forced); the pass kernels also at C_out 1025
# (off 8) and at their widest, over fewer rows; a head layer over 9 levels
# at a width of each route, the general one routed above the pass kernels
SHAPES_PASSES_C, SHAPES_PASSES_EDGE_C, SHAPES_PASSES_EDGE_ROWS = 1056, (1025, 4096), 4
SHAPES_NINE_LEVELS_C = (EMBD + RDIM, 288, 1056, 4100)
# the trio's wide kernels: timed at the embd-512 and embd-1024 legs' C over
# 64 rows x T0, in turns with the general kernel (forced); held against the
# plain version at SHAPES_TRIO_EDGE (C x T, 4 rows), at its widest over 2
# rows, and at SHAPES_TRIO_LAYOUTS (C, T, layout; 4 rows): a base off 16
# bytes, a time-sharded rank's level-0 block (T0 / 2 and a halo column
# each side)
SHAPES_TRIO_C = (512, 1024)
SHAPES_TRIO_EDGE = [(C, T) for C in (257, 320, 512, 1024) for T in (7, 36, 301, 2304)]
SHAPES_TRIO_WIDEST = 4096
SHAPES_TRIO_LAYOUTS = ((320, 301, "offset"), (1024, 2304, "offset"),
                       (512, T0 // 2 + 2, "as_is"), (1024, T0 // 2 + 2, "offset"),
                       (4096, 36, "offset"))
SHAPES_PER = {
    ("band_attention", "general"): "7 levels at 64 rows x T=2304, 4 heads of "
                                   "D = 16, 64 and 128 each at windows 11 "
                                   "and 5, and D = 256 at window 5; forced",
    ("band_attention", "wide"): "7 levels at 64 rows x T=2304, 4 heads of "
                                "D = 16, 64 and 128 each at windows 11 and 5, "
                                "and D = 256 at window 5",
    ("conv3_ln_act", "wide"): "one launch over 7 levels at 64 rows x T=2304 at "
                              "C_in = C_out = 288, one at 512 and one at 544",
    ("conv3_ln_act", "passes"): "one launch over 7 levels at 64 rows x T=2304 "
                                "at C_in = C_out = 1056",
    ("conv3_ln_act", "general"): "one launch over 7 levels at 64 rows x "
                                 "T=2304 at C_in = C_out = 288, one at 512 and "
                                 "one at 544 (the wide kernels' widths) and one "
                                 "at 1056 (the pass kernels'), forced",
    ("qkv_depthwise_ln", "wide"): "64 rows x T=2304 at C = 512 and at C = 1024",
    ("qkv_depthwise_ln", "general"): "64 rows x T=2304 at C = 512 and at C = 1024, "
                                     "forced"}


def band_layout_case(dev, g, B, D, T, window, how, dtype):
    """Band attention's arguments at B rows x HEADS heads laid out as ``how``
    says: a :func:`moved` layout of the (B, C, T) projections ("as_is",
    "offset", "padded"), "contiguous" (B, H, T, D) tensors, or "time_minor"
    views of (B, H, D, T + 2 halo) buffers (a time-sharded rank's block
    widened by its halo, as band_attention builds it); the rows' valid
    lengths T, T - 5, T / 3 and 1 (of the widened length)."""
    if how == "time_minor":
        T = T + 2 * (window // 2)
        qkv = [(torch.randn(B, HEADS, D, T, generator=g, device=dev)
                * float(D) ** -0.25).to(dtype).transpose(2, 3) for _ in range(3)]
        lens = [T, T - 5, T // 3, 1][:B]
        return (*qkv, prefix_mask(lens, T, dev), window)
    args, _ = band_case(dev, g, B, T, [T, T - 5, T // 3, 1][:B], D=D, how=how,
                        dtype=dtype, window=window)
    return args


def band_by_shape(shapes):
    """A band record's timed levels summed per (D, window): ms, bound,
    plain, SDPA and the other kernel's ms in turns."""
    out = {}
    for sh in shapes:
        key = f"D{sh['shape'][3]}_w{sh['window']}"
        o = out.setdefault(key, {"levels": 0})
        o["levels"] += 1
        for k in ("ms", "bound_ms", "plain_ms", "library_ms", "general_ms", "wide_ms"):
            if sh.get(k) is not None:
                o[k] = o.get(k, 0.0) + sh[k]
    for o in out.values():
        o["share_of_bound"] = o["bound_ms"] / o["ms"]
    return out


def check_outputs(phase, name, dtype, got, want, what, route="general"):
    """One kernel result against its plain version on the same inputs: f32
    max |diff| within TOL, bf16 within TOL_BF16 of max(1, |plain|); a line
    under ``phase`` naming the kernel of ``route``. Returns (max |diff|, max
    relative diff)."""
    outs = got if isinstance(got, tuple) else (got,)
    abs_err, rel_err = bf16_err(got, want)
    bf16 = dtype == torch.bfloat16
    ok = all(t.dtype == dtype and torch.isfinite(t).all() for t in outs) and (
        rel_err <= TOL_BF16 if bf16 else abs_err <= TOL[name])
    kernel = name + ("" if route == "tuned" else "_" + route) + ("_bf16" if bf16 else "")
    emit({"phase": phase, "kernel": kernel, "check": what,
          "max_abs_err": abs_err, "max_rel_err": rel_err,
          "tol": TOL_BF16 if bf16 else TOL[name], "ok": ok})
    if not ok:
        raise AssertionError(f"{kernel} disagrees with its plain version at "
                             f"{what}: {abs_err}, {rel_err}")
    return abs_err, rel_err


def bf16_nearest(x64):
    """f64 to bf16 in one correct rounding (to nearest, ties to even): to f32
    rounding to odd, then to bf16; a plain cast rounds twice."""
    f = x64.float()
    back = f.double()
    inexact = back != x64
    bits = f.view(torch.int32)
    bits = torch.where(inexact & (back.abs() > x64.abs()), bits - 1, bits)
    return torch.where(inexact, bits | 1, bits).view(torch.float32).to(torch.bfloat16)


def conv3_bf16_exact(x, mask, w, bias, ln_w, ln_b, eps=1e-5):
    """The bf16 conv3 composition (conv3_ln_act_torch on bf16 x, then ReLU)
    with each of its roundings made exactly: the conv of the bf16 values in
    f64 rounded once to bf16, the bias added and rounded once, the LN and
    affine in f64, the result rounded once. What the plain bf16 version
    approximates: its conv sums in f32, in cuDNN's order."""
    d = torch.float64
    xm = (x * mask[:, None, :].to(x.dtype)).to(d)
    y = bf16_nearest(torch.nn.functional.conv1d(
        xm, w.to(torch.bfloat16).to(d), padding=1)).to(d)
    if bias is not None:
        y = bf16_nearest(y + bias.to(torch.bfloat16).to(d)[None, :, None]).to(d)
    y = y - y.mean(dim=1, keepdim=True)
    y = y * torch.rsqrt(y.square().mean(dim=1, keepdim=True) + eps)
    y = y * ln_w.reshape(-1, 1).to(d) + ln_b.reshape(-1, 1).to(d)
    return bf16_nearest(torch.relu(y))


# the bf16 conv3 at several seeds: the kernels' f32 sums run in another
# order than cuDNN's, so which pre-LN bf16 roundings flip depends on the data
SWEEP_SEEDS, SWEEP_ROWS, SWEEP_C = 8, 16, (160, 288, 512, 544, 1056)


def conv3_bf16_sweep(dev, recs):
    """The bf16 conv3 kernels (the tuned one at C 160, the wide one at 288,
    512 and 544, the pass one at 1056; ``recs`` the shapes phase's records
    by route, those of the wide and pass routes updated) at SWEEP_SEEDS
    seeds over 7 levels of SWEEP_ROWS rows, x
    randn or relu(randn) (a head layer's input is the layer before's ReLU
    output), without a bias (as every conv3 of the model runs) and with a
    randn one. Each output is held against the plain bf16 version and
    against :func:`conv3_bf16_exact`; the plain version is held against the
    latter too. Every case holds the kernel within TOL_BF16 of the exact
    composition, and those without a bias within TOL_BF16 of the plain
    version; with a bias the plain version itself can be further than that
    from the exact composition (a conv output that a bias cancels keeps its
    rounding flip at its own scale, which the LN magnifies), so that case's
    distance to it is recorded, not held. Returns the largest relative
    errors per case."""
    from decafnet_tpu_torch import ops
    from decafnet_tpu_torch.ops import cuda, fused_conv

    Ts = [T0 // 2 ** lvl for lvl in range(LEVELS)]
    lens = [row_lens(lvl)[::ROWS // SWEEP_ROWS] for lvl in range(LEVELS)]
    out = {"seeds": SWEEP_SEEDS, "rows": SWEEP_ROWS, "levels": Ts, "cases": []}
    for C in SWEEP_C:
        for bias in (False, True):
            for kind in ("randn", "relu"):
                case = {"C": C, "route": fused_conv.conv3_route(C), "bias": bias,
                        "x": kind, "kernel_vs_plain": 0.0,
                        "kernel_vs_exact": 0.0, "plain_vs_exact": 0.0,
                        "seeds_over_tol_vs_plain": 0}
                for seed in range(SWEEP_SEEDS):
                    g = torch.Generator(device=dev).manual_seed(
                        SEED + 1000 * C + 100 * (kind == "relu") + 10 * bias + seed)
                    xs, masks, (w, _, lw, lb) = conv3_levels_case(
                        dev, g, SWEEP_ROWS, C, Ts, lens, dtype=torch.bfloat16)
                    if kind == "relu":
                        xs = [x.relu() for x in xs]
                    b = torch.randn(C, generator=g, device=dev) if bias else None
                    got = tuple(ops.conv3_ln_act_levels(xs, masks, w, b, lw, lb))
                    with cuda.plain_versions():
                        want = tuple(ops.conv3_ln_act(x, m, w, b, lw, lb)
                                     for x, m in zip(xs, masks))
                    exact = tuple(conv3_bf16_exact(x, m, w, b, lw, lb)
                                  for x, m in zip(xs, masks))
                    assert all(y.dtype == torch.bfloat16 and torch.isfinite(y).all()
                               for y in got)
                    kp, ke, pe = (bf16_err(u, v)[1] for u, v in (
                        (got, want), (got, exact), (want, exact)))
                    case["kernel_vs_plain"] = max(case["kernel_vs_plain"], kp)
                    case["kernel_vs_exact"] = max(case["kernel_vs_exact"], ke)
                    case["plain_vs_exact"] = max(case["plain_vs_exact"], pe)
                    case["seeds_over_tol_vs_plain"] += kp > TOL_BF16
                    rec = recs.get(case["route"])
                    if not bias and rec is not None:
                        rec["max_abs_err"] = max(rec["max_abs_err"], bf16_err(got, want)[0])
                        rec["max_rel_err"] = max(rec["max_rel_err"], kp)
                    del xs, masks, got, want, exact
                case["ok"] = case["kernel_vs_exact"] <= TOL_BF16 and (
                    bias or case["kernel_vs_plain"] <= TOL_BF16)
                emit({"phase": "shapes", "kernel": "conv3_ln_act_bf16",
                      "check": "seed sweep", "tol": TOL_BF16, **case})
                out["cases"].append(case)
                assert case["ok"], case
    return out


def run_shapes(dev):
    """Hold every general-kernel path, band attention's wide kernels and
    conv3's wide and pass kernels against their plain versions in f32 and
    bf16 (the JAX kernel tests' shapes, the widths legs' widths, other
    views of band attention, C_out 300, 1024 and 1056, a head layer over 9
    levels), and time the widths' calls: kernel, plain version, bound and,
    for band attention, SDPA; band attention at SHAPES_BAND and conv3 at C
    288, 512, 544 and 1056 the routed kernel and the general one in turns
    (general, routed, routed, general). Returns a record per (op, route,
    dtype)."""
    from decafnet_tpu_torch import ops
    from decafnet_tpu_torch.ops import cuda, fused_conv, local_attention

    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    recs = {}
    for dtype in (torch.float32, torch.bfloat16):
        bf16, esz = dtype == torch.bfloat16, 2 if dtype == torch.bfloat16 else 4
        # the least time of conv3's products is the tensor cores', as the
        # tuned rows count it: f32 products as three TF32 passes, bf16 ones
        # as one bf16 pass (the general kernel itself runs on the CUDA cores)
        tc_rate, tc_passes = (BF16_FLOPS, 1) if bf16 else (TF32_FLOPS, 3)
        for name, route in SHAPE_KERNELS:
            recs[name, route, dtype] = {
                "max_abs_err": 0.0, "max_rel_err": 0.0, "ms": 0.0,
                "plain_ms": 0.0, "bound_ms": 0.0, "byte_ms": 0.0, "flop_ms": 0.0,
                "library_ms": None, "per": SHAPES_PER[name, route], "shapes": []}

        def hold(name, fn, plain, what, route="general"):
            """``fn()`` against ``plain()`` (under plain_versions), booked
            in the record of (name, route); a tuned route is checked only."""
            got = fn()
            with cuda.plain_versions():
                want = plain()
            torch.cuda.synchronize()
            a, r = check_outputs("shapes", name, dtype, got, want, what, route)
            if route != "tuned":
                rec = recs[name, route, dtype]
                rec["max_abs_err"] = max(rec["max_abs_err"], a)
                rec["max_rel_err"] = max(rec["max_rel_err"], r)
            return got

        def book(name, route, ms, plain_ms, n_bytes, n_flops, shape,
                 lib_ms=None, tc_flops=0, **extra):
            """One timed shape in the record of (name, route)."""
            b_ms, by = bound_ms(n_bytes, n_flops, tc_flops, tc_rate)
            rec = recs[name, route, dtype]
            rec["ms"] += ms
            rec["plain_ms"] += plain_ms
            rec["bound_ms"] += b_ms
            rec["byte_ms"] += 1e3 * n_bytes / HBM_BYTES_PER_S
            rec["flop_ms"] += 1e3 * max(n_flops / F32_FLOPS, tc_flops / tc_rate)
            if lib_ms is not None:
                rec["library_ms"] = (rec["library_ms"] or 0.0) + lib_ms
            rec["shapes"].append({"shape": shape, "ms": ms, "plain_ms": plain_ms,
                                  "bound_ms": b_ms, "bound_by": by,
                                  "share_of_bound": b_ms / ms,
                                  "excess_ms": ms - b_ms, "library_ms": lib_ms,
                                  **extra})

        # band attention: the JAX kernel tests' shapes (B 2, H 4, D 16), the
        # wide kernel routed and the general one forced; then 64 rows x 7
        # levels at each of SHAPES_BAND, both again, timed in turns (general,
        # wide, wide, general) beside the plain version and SDPA; then the
        # wide kernel at SHAPES_BAND_LAYOUTS
        band = ops.band_attention
        band_general = local_attention.launch_band_attention_general
        for T, w in JAX_BAND_SHAPES:
            args, _ = band_case(dev, g, 2, T, [T, max(1, T * 2 // 3)], D=16,
                                dtype=dtype, window=w)
            what = f"JAX test shape B 2, H 4, D 16, T {T}, window {w}"
            hold("band_attention", lambda: band(*args), lambda: band(*args), what,
                 "wide")
            hold("band_attention", lambda: band_general(*args), lambda: band(*args),
                 what + ", forced", "general")
        for D, W in SHAPES_BAND:
            assert local_attention.band_attention_route(D, W) == "wide", (D, W)
            for level in range(LEVELS):
                T = T0 // 2 ** level
                lens = row_lens(level)
                args, _ = band_case(dev, g, ROWS, T, lens, D=D, dtype=dtype,
                                    window=W)
                what = f"64 rows, D {D}, window {W}, level {level} (T {T})"
                hold("band_attention", lambda: band(*args), lambda: band(*args), what,
                     "wide")
                hold("band_attention", lambda: band_general(*args),
                     lambda: band(*args), what + ", forced", "general")
                ab = time_in_turns(lambda: band_general(*args), lambda: band(*args), 5)
                with cuda.plain_versions():
                    plain_ms = time_ms(lambda: band(*args), 3, warmup=1)
                lib_ms = time_ms(lambda: sdpa_band(*args), 3, warmup=1)
                n_valid = sum(min(n, T) for n in lens)
                work = (esz * (3 * n_valid * HEADS * D + ROWS * HEADS * T * D) + ROWS * T,
                        n_valid * HEADS * (4 * W * D + 4 * W), [ROWS, HEADS, T, D])
                at = {"window": W, "level": level}
                book("band_attention", "wide", ab["new_ms"], plain_ms, *work, lib_ms,
                     general_ms=ab["old_ms"], spread_ms=ab["new_spread_ms"], **at)
                book("band_attention", "general", ab["old_ms"], plain_ms, *work, lib_ms,
                     wide_ms=ab["new_ms"], spread_ms=ab["old_spread_ms"], **at)
                del args
        for D in (16, 256):
            for how, T in SHAPES_BAND_LAYOUTS:
                args = band_layout_case(dev, g, 4, D, T, WINDOW, how, dtype)
                hold("band_attention", lambda: band(*args), lambda: band(*args),
                     f"4 rows, D {D}, window {WINDOW}, T {args[0].shape[2]}, {how}",
                     "wide")
                del args
        for route in ("wide", "general"):
            recs["band_attention", route, dtype]["by_shape"] = band_by_shape(
                recs["band_attention", route, dtype]["shapes"])

        # conv3, the general kernel: the JAX kernel tests' shapes (C_in 16,
        # C_out 24, lengths T and 0.6 T; forced); the wide kernels at C_out
        # 288, 512 and 544 over 7 levels beside the general one (forced),
        # and at 300 and 1024; the pass kernels at 1056 beside the general
        # one (forced), and at 1025 and 4096; then 9 levels (two launches)
        # at a tuned, a wide, a pass and a general C_out
        conv3 = ops.conv3_ln_act
        for T in JAX_CONV3_T:
            x = torch.randn(2, 16, T, generator=g, device=dev).to(dtype)
            m = prefix_mask([T, int(0.6 * T)], T, dev)
            p = (torch.randn(24, 16, 3, generator=g, device=dev) * 0.2,
                 torch.randn(24, generator=g, device=dev),
                 1 + 0.1 * torch.randn(24, generator=g, device=dev),
                 0.1 * torch.randn(24, generator=g, device=dev))
            hold("conv3_ln_act", lambda: fused_conv.launch_conv3_ln_act_general(
                [x], [m], *p, "relu", 1e-5)[0],
                lambda: conv3(x, m, *p), f"JAX test shape C_in 16 -> C_out 24, T {T}")
        Ts = [T0 // 2 ** lvl for lvl in range(LEVELS)]
        timed_c = SHAPES_CONV3_C + (SHAPES_PASSES_C,)
        for C in (SHAPES_CONV3_C + SHAPES_WIDE_EDGE_C + (SHAPES_PASSES_C,)
                  + SHAPES_PASSES_EDGE_C):
            route = fused_conv.conv3_route(C)
            if C in timed_c:
                rows = ROWS
            elif route == "wide":
                rows = SHAPES_WIDE_EDGE_ROWS
            else:
                rows = SHAPES_PASSES_EDGE_ROWS
            xs, masks, params = conv3_levels_case(
                dev, g, rows, C, Ts,
                [row_lens(lvl)[::ROWS // rows] for lvl in range(LEVELS)], dtype=dtype)
            assert route == ("wide" if C <= fused_conv.CONV3_WIDE_MAX_C else "passes"), C

            def routed():
                return tuple(ops.conv3_ln_act_levels(xs, masks, *params))

            def general():
                return tuple(fused_conv.launch_conv3_ln_act_general(
                    xs, masks, *params, "relu", 1e-5))

            def plain():
                return tuple(conv3(x, m, *params) for x, m in zip(xs, masks))

            where = f"{rows} rows, C {C}, 7 levels in one launch"
            outs = {route: hold("conv3_ln_act", routed, plain, where, route)}
            if C in timed_c:
                outs["general"] = hold("conv3_ln_act", general, plain,
                                       where + ", forced", "general")
            if not bf16:
                refs = [conv3_f64(x, m, *params) for x, m in zip(xs, masks)]
                with cuda.plain_versions():
                    plain64 = max(max_err(conv3(x, m, *params).double(), r)
                                  for x, m, r in zip(xs, masks, refs))
                for kind, got in outs.items():
                    err64 = max(max_err(y.double(), r) for y, r in zip(got, refs))
                    emit({"phase": "shapes", "kernel": "conv3_ln_act_" + kind,
                          "check": f"vs f64, {where}",
                          "max_abs_err_f64": err64, "plain_max_abs_err_f64": plain64,
                          "tol": TOL_F64, "ok": err64 <= TOL_F64})
                    assert err64 <= TOL_F64, (kind, C, err64)
                    rec = recs["conv3_ln_act", kind, dtype]
                    rec["max_abs_err_f64"] = max(rec.get("max_abs_err_f64", 0.0), err64)
                del refs
            del outs
            if C in timed_c:
                # the routed and the general kernel in turns (general,
                # routed, routed, general), then the plain version
                ab = time_in_turns(general, routed, 5)
                with cuda.plain_versions():
                    plain_ms = time_ms(plain, 3, warmup=1)
                cols = ROWS * sum(Ts)
                work = (esz * 2 * C * cols + ROWS * sum(Ts) + 4 * (3 * C * C + 2 * C),
                        8 * cols * C, [ROWS, C, Ts])
                tc = tc_passes * 2 * cols * C * 3 * C
                book("conv3_ln_act", route, ab["new_ms"], plain_ms, *work,
                     tc_flops=tc, general_ms=ab["old_ms"],
                     spread_ms=ab["new_spread_ms"])
                book("conv3_ln_act", "general", ab["old_ms"], plain_ms, *work,
                     tc_flops=tc, **{route + "_ms": ab["new_ms"]},
                     spread_ms=ab["old_spread_ms"])
            del xs, masks
        for C in SHAPES_NINE_LEVELS_C:
            route = fused_conv.conv3_route(C)
            Ts = [T0 // 2 ** lvl for lvl in range(9)]
            # above the pass kernels, a narrow input (the general kernel
            # multiplies on the CUDA cores)
            xs, masks, params = conv3_levels_case(
                dev, g, 4, C, Ts, [[T, max(T - 3, 1), T // 2, 0] for T in Ts],
                dtype=dtype, c_in=64 if route == "general" else None)
            counts0 = [getattr(conv3, a) for a in ops.COUNTERS]
            hold("conv3_ln_act", lambda: tuple(ops.conv3_ln_act_levels(
                xs, masks, *params)), lambda: tuple(
                    conv3(x, m, *params) for x, m in zip(xs, masks)),
                f"4 rows, C {C}, 9 levels (two launches)", route)
            made = [getattr(conv3, a) - c for a, c in zip(ops.COUNTERS, counts0)]
            attr = ("launches" + ("" if route == "tuned" else "_" + route)
                    + ("_bf16" if bf16 else ""))
            assert made == [2 * (a == attr) for a in ops.COUNTERS], made
            emit({"phase": "shapes", "check": f"9 levels at C {C} ({dtype})",
                  "route": route, "launches": dict(zip(ops.COUNTERS, made))})
            del xs, masks

        if bf16:
            recs["conv3_ln_act", "wide", dtype]["seed_sweep"] = conv3_bf16_sweep(
                dev, {r: recs["conv3_ln_act", r, dtype] for r in ("wide", "passes")})

        # the trio: the JAX kernel tests' shapes (C 16), the general and the
        # wide kernel forced; the wide kernel routed at SHAPES_TRIO_EDGE, its
        # widest and SHAPES_TRIO_LAYOUTS; then 64 rows x T0 at SHAPES_TRIO_C,
        # the wide and the general kernel in turns (general, wide, wide,
        # general) beside the plain version
        trio = ops.qkv_depthwise_ln
        for T in JAX_TRIO_T:
            args, _ = trio_case(dev, g, 2, 16, T, [T, int(0.6 * T)], dtype=dtype)
            what = f"JAX test shape C 16, T {T}"
            hold("qkv_depthwise_ln", lambda: fused_conv.launch_qkv_depthwise_ln_general(
                *args, 1e-5), lambda: trio(*args), what + ", forced")
            hold("qkv_depthwise_ln", lambda: fused_conv.launch_qkv_depthwise_ln_wide(
                *args, 1e-5, fused_conv.qkv_wide_plan(16, T, dtype)),
                lambda: trio(*args), what + ", forced", "wide")
        edge = ([(C, T, "as_is", 4) for C, T in SHAPES_TRIO_EDGE]
                + [(SHAPES_TRIO_WIDEST, 301, "as_is", 2)]
                + [(C, T, how, 2 if C == SHAPES_TRIO_WIDEST else 4)
                   for C, T, how in SHAPES_TRIO_LAYOUTS])
        for C, T, how, rows in edge:
            assert fused_conv.qkv_route(C) == "wide", C
            lens = [T, max(1, T * 3 // 5), T // 2, 0][:rows]
            args, _ = trio_case(dev, g, rows, C, T, lens, how, dtype)
            what = f"{rows} rows, C {C}, T {T}, x {how}"
            got = hold("qkv_depthwise_ln", lambda: trio(*args), lambda: trio(*args),
                       what, "wide")
            if C == SHAPES_TRIO_WIDEST and not bf16:
                err64 = max_err(tuple(y.double() for y in got), trio_f64(*args))
                emit({"phase": "shapes", "kernel": "qkv_depthwise_ln_wide",
                      "check": f"vs f64, {what}", "max_abs_err_f64": err64,
                      "tol": TOL_F64, "ok": err64 <= TOL_F64})
                assert err64 <= TOL_F64, (C, T, err64)
                rec = recs["qkv_depthwise_ln", "wide", dtype]
                rec["max_abs_err_f64"] = max(rec.get("max_abs_err_f64", 0.0), err64)
            del args, got
        for C in SHAPES_TRIO_C:
            args, _ = trio_case(dev, g, ROWS, C, T0, row_lens(0), dtype=dtype)
            what = f"64 rows, C {C}, T {T0}"

            def wide():
                return trio(*args)

            def general():
                return fused_conv.launch_qkv_depthwise_ln_general(*args, 1e-5)

            hold("qkv_depthwise_ln", wide, wide, what, "wide")
            hold("qkv_depthwise_ln", general, wide, what + ", forced")
            ab = time_in_turns(general, wide, 5)
            with cuda.plain_versions():
                plain_ms = time_ms(wide, 3, warmup=1)
            work = (esz * 4 * ROWS * C * T0 + 4 * 15 * C + ROWS * T0,
                    3 * ROWS * C * T0 * (5 + 8), [ROWS, C, T0])
            book("qkv_depthwise_ln", "wide", ab["new_ms"], plain_ms, *work,
                 general_ms=ab["old_ms"], spread_ms=ab["new_spread_ms"],
                 plan=fused_conv.qkv_wide_plan(C, T0, dtype)._asdict())
            book("qkv_depthwise_ln", "general", ab["old_ms"], plain_ms, *work,
                 wide_ms=ab["new_ms"], spread_ms=ab["old_spread_ms"])
            del args
        torch.cuda.empty_cache()
    return recs


# ------------------------------------------------------------------ configs
# The shipped configurations the other phases do not run, at full width and
# depth with seeded random weights, and the widths legs: configs/ego4d_nlq.yaml
# at other head counts and embedding widths, which the JAX package runs too.
CONFIG_FILES = ("charades", "tacos", "ego4d_goalstep")
WIDTH_LEGS = {"heads8": ["model.vid_net.n_heads", "8"],
              "embd256": ["model.vid_net.embd_dim", "256"],
              "embd512": ["model.vid_net.embd_dim", "512"],
              "embd1024": ["model.vid_net.embd_dim", "1024"]}
CONFIG_VIDEOS, CONFIG_QUERIES = 8, 4


def per_forward(cfg):
    """Launches of each op's kernels per forward of the live model under
    ``cfg``, by route: conv3 once per embedding conv (at embd) and once per
    trunk layer of the three heads (cls_head at embd, cls_head2 and reg_head
    at embd + rdim), CONV3_MAX_LEVELS levels a launch; band attention once
    per FPN level; the trio once (at embd). Returns {route: {op:
    launches}} over ops.ROUTES."""
    from decafnet_tpu_torch import ops
    from decafnet_tpu_torch.ops import fused_conv, local_attention

    m = cfg.model
    E, L = m.vid_net.embd_dim, m.vid_net.arch[-1]
    D = E // m.vid_net.n_heads
    groups = len(fused_conv.conv3_launch_groups(L))
    out = {r: {"conv3_ln_act": 0, "band_attention": 0, "qkv_depthwise_ln": 0}
           for r in ops.ROUTES}
    for C, n in ((E, m.vid_net.arch[0] + 2 * groups),
                 (E + (m.get("rdim") or 32), 4 * groups)):
        out[fused_conv.conv3_route(C)]["conv3_ln_act"] += n
    out[local_attention.band_attention_route(D, m.vid_net.mha_win_size)][
        "band_attention"] += L
    out[fused_conv.qkv_route(E)]["qkv_depthwise_ln"] += 1
    return out


def read_counts():
    """Every launch counter: {(dtype, route): {op: count}}."""
    from decafnet_tpu_torch import ops

    return {(dt, route): ops.launch_counts(dt, route)
            for dt in (torch.float32, torch.bfloat16) for route in ops.ROUTES}


def counts_label(dtype, route):
    """The name of a (dtype, route) counter set in the JSON lines."""
    return (("bf16" if dtype == torch.bfloat16 else "f32")
            + ("" if route == "tuned" else "_" + route))


def expect_counts(counts, cfg, n, dtype, what):
    """The counters after ``n`` forwards in ``dtype`` under ``cfg``: each
    route's per-forward launches times ``n``, nothing in the other dtype."""
    per = per_forward(cfg)
    zero = {k: 0 for k in per["tuned"]}
    want = {(dt, route): ({k: v * n for k, v in per[route].items()}
                          if dt == dtype else zero)
            for dt, route in counts}
    got = {counts_label(dt, route): c for (dt, route), c in counts.items()}
    emit({"phase": "configs", "check": f"launches, {what}", "forwards": n,
          "launches": got})
    assert counts == want, (what, counts, want)


def config_kernels(dev, cfg, tag):
    """Each kernel the config's forward runs against its plain version, in
    f32 and bf16, at 64 rows x max_seq_len over its pyramid: band attention
    at every level, the trio at level 0, conv3's head layers over all levels
    in one launch per CONV3_MAX_LEVELS."""
    from decafnet_tpu_torch import ops

    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    m = cfg.model
    T, L, E = m.vid_net.max_seq_len, m.vid_net.arch[-1], m.vid_net.embd_dim
    D, W = E // m.vid_net.n_heads, m.vid_net.mha_win_size
    lens = [max(1, T - (T // ROWS) * i) for i in range(ROWS)]
    Ts = [T // 2 ** lvl for lvl in range(L)]
    lvl_lens = [[math.ceil(n / 2 ** lvl) for n in lens] for lvl in range(L)]
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        errs = []
        for lvl, Tl in enumerate(Ts):
            args, _ = band_case(dev, g, ROWS, Tl, lvl_lens[lvl], D=D, dtype=dtype,
                                window=W)
            errs.append(config_check("band_attention", ops.band_attention, args,
                                     dtype, f"{tag} level {lvl} (T {Tl})"))
        args, _ = trio_case(dev, g, ROWS, E, T, lens, dtype=dtype)
        errs.append(config_check("qkv_depthwise_ln", ops.qkv_depthwise_ln, args,
                                 dtype, f"{tag} level 0 (T {T})"))
        for C in (E, E + (m.get("rdim") or 32)):
            xs, masks, params = conv3_levels_case(dev, g, ROWS, C, Ts, lvl_lens,
                                                  dtype=dtype)
            errs.append(config_check(
                "conv3_ln_act", lambda *a: tuple(ops.conv3_ln_act_levels(*a)),
                (xs, masks, *params), dtype, f"{tag} C {C}, {L} levels"))
        worst["bf16" if dtype == torch.bfloat16 else "f32"] = max(errs)
    return worst


def config_check(name, op, args, dtype, what):
    """``op(*args)`` against its plain version (:func:`check_outputs`, under
    the configs phase; the kernel named by its route); the error its rule
    holds."""
    from decafnet_tpu_torch.ops import cuda

    got = op(*args)
    with cuda.plain_versions():
        want = op(*args)
    torch.cuda.synchronize()
    a, r = check_outputs("configs", name, dtype, got, want, what, route="tuned")
    return r if dtype == torch.bfloat16 else a


def config_requests(cfg, rng):
    """Three requests on the config's clip grid, lengths spread below
    max_seq_len, 3 / 4 / 2 queries."""
    T = cfg.model.vid_net.max_seq_len
    reqs = [make_request(rng, cfg, t, q, tokens=(9, 16))
            for t, q in ((T, 3), (T * 3 // 4 + 1, 4), (T // 3 + 2, 2))]
    for r in reqs:
        r.update(clip_size=cfg.data.clip_size, clip_stride=cfg.data.clip_stride)
    return reqs


def config_serve(dev, cfg, tag):
    """GroundingService under ``cfg`` with seeded random weights, in f32 and
    bf16 on the same weights: ground_many of a few requests (launches by
    route and dtype per decode call; detections checked, kernels against
    the plain versions within SEG_TOL_S / SCORE_TOL in f32; in bf16 the
    decode's outputs by the noise-floor rule against the plain versions and
    f32). Returns {dtype: counters} of the two main-path calls."""
    from decafnet_tpu_torch import ops
    from decafnet_tpu_torch.models import random_params
    from decafnet_tpu_torch.ops import cuda
    from decafnet_tpu_torch.serve import GroundingService

    params = random_params(cfg, SEED)
    rng = np.random.default_rng(SEED + 3)
    reqs = config_requests(cfg, rng)
    k = cfg.nms.max_num_segs
    services, out = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        c = cfg.clone()
        c.tpu.compute_dtype = "bfloat16" if dtype == torch.bfloat16 else "float32"
        svc = services[dtype] = GroundingService(c, params=params)
        assert svc.device.type == "cuda"
        svc.ground_many(reqs)              # warm-up outside the counts
        torch.cuda.synchronize()
        dec = svc.decoder
        calls0 = dec.decode_calls
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        answers = svc.ground_many(reqs)
        wall_ms = 1e3 * (time.perf_counter() - t0)
        counts, calls = read_counts(), dec.decode_calls - calls0
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        expect_counts(counts, c, calls, dtype, f"{tag} serve {dtype}")
        out[dtype] = counts
        prof = profile_call(lambda: svc.ground_many(reqs),
                            f"{tag}: one ground_many of the 3 requests, "
                            f"{dtype} (profiler on)", "configs", top=5)
        # random weights may leave a query's every score under the
        # config's min_score: no detections for it, but some for the batch
        for req, ans in zip(reqs, answers):
            check_detections(ans, req, k, least=0)
        assert any(a["scores"] for ans in answers for a in ans), tag
        record = {"phase": "configs", "leg": tag, "path": "serve",
                  "dtype": str(dtype), "requests": [
                      (r["vid"].shape[1], len(r["texts"])) for r in reqs],
                  "decode_calls": calls, "wall_ms": wall_ms,
                  "busy_share": prof["device_busy_ms"] / prof["wall_ms"],
                  "peak_mem_gb": peak_gb}
        if dtype == torch.float32:
            with cuda.plain_versions():
                plain = svc.ground_many(reqs)
            seg, sc = same_detections(answers, plain)
            record["kernels_vs_plain"] = {"seg_s": seg, "score": sc}
            emit(record)
            assert seg <= SEG_TOL_S and sc <= SCORE_TOL, (tag, seg, sc)
            continue
        T = c.model.vid_net.max_seq_len
        inputs = variant_inputs(c, dev, V=4, Q=4, T=T, lens=(
            T, T * 3 // 4 + 1, T // 2 + 3, T // 4 + 5))
        with torch.inference_mode():
            out16 = svc.model(*inputs, queries_per_video=4)
            with cuda.plain_versions():
                plain16 = svc.model(*inputs, queries_per_video=4)
            out32 = services[torch.float32].model(*inputs, queries_per_video=4)
        for group, key in ((1, "logits2"), (2, "offsets")):
            flat = [torch.cat([t.float().reshape(-1) for t in o[group]])
                    for o in (out16, plain16, out32)]
            record[key] = floor_rule(*flat)
        emit(record)
        assert record["logits2"]["ok"] and record["offsets"]["ok"], record
    return out


def write_config_data(root, name, cfg, splits, num_videos, num_queries, lo):
    """A synthetic split for ``cfg`` on its clip grid (lengths from ``lo`` to
    max_seq_len clips) and a yaml pointing the train and eval data trees at
    it (both streams on one grid: shallow_ds 1)."""
    import yaml

    from decafnet_tpu_torch.data import make_synthetic_dataset

    T = cfg.model.vid_net.max_seq_len
    paths = make_synthetic_dataset(
        os.path.join(root, name), num_videos=num_videos, num_queries=num_queries,
        clip_range=(lo, T + 1), vid_dim=cfg.model.vid_net.in_dim,
        shallow_dim=cfg.model.vid_net.in_dim, text_dim=cfg.model.text_net.in_dim,
        clip_size=cfg.data.clip_size, clip_stride=cfg.data.clip_stride,
        splits=splits, seed=SEED + 4)
    keys = ("anno_file", "vid_feat_dir", "shallow_vid_feat_dir",
            "clip_token_fname", "text_cls_fname")
    tree = {**{k: paths[k] for k in keys}, "shallow_ds": 1,
            "name": "video_centric_clip_twofeat", "vid_load": "npy",
            "shallow_vid_load": "npy"}
    path = os.path.join(root, name + ".yaml")
    with open(path, "w") as f:
        yaml.safe_dump({"data": tree, "eval": {"data": dict(tree)}}, f)
    return paths, path


def config_eval(root, name, cfg_file, cfg):
    """The eval CLI's entry point over CONFIG_VIDEOS synthetic videos x
    CONFIG_QUERIES queries (lengths spread below max_seq_len) of an
    experiment directory under ``cfg`` with seeded random weights: device
    SoftNMS and the plain versions, tables, detections and losses equal
    (check_eval_modes). Returns the kernel launches of the device run."""
    from decafnet_tpu_torch.core import load_config
    from decafnet_tpu_torch.data import apply_synthetic_cfg
    from decafnet_tpu_torch.models import random_params, save_pth

    T = cfg.model.vid_net.max_seq_len
    data, _ = write_config_data(root, name + "_val", cfg, ("val",), CONFIG_VIDEOS,
                                CONFIG_QUERIES, T // 4)
    full = apply_synthetic_cfg(load_config(cfg_file), data, cfg.data.clip_size,
                               cfg.data.clip_stride)
    logdir = os.path.join(root, name + "_exp")
    os.makedirs(os.path.join(logdir, "models"))
    full.dump_to_file(os.path.join(logdir, "opt.yaml"))
    save_pth(os.path.join(logdir, "models", "last.pth"), random_params(full, SEED))
    tuned = per_forward(full)["tuned"]
    runs, launches, ev, _ = eval_modes(
        ["--name", logdir, "--set", "eval.save_results", "True"],
        {"device_nms": [], "plain_versions": []}, "configs", CONFIG_VIDEOS,
        CONFIG_VIDEOS, CONFIG_VIDEOS * CONFIG_QUERIES, per_decode=tuned)
    check_eval_modes(runs, ev.cfg, "configs")
    return launches


def config_train(root, name, cfg_file):
    """One train step in f32 through the train CLI's entry point
    (``build_trainer`` + ``train`` with aux.dryrun) at the config's own
    batch and microbatch sizes on a synthetic train split: launches per
    forward microbatch, finite losses and weights, wall and peak memory.
    Returns the kernel launches."""
    from decafnet_tpu_torch import ops
    from decafnet_tpu_torch.core import load_config
    from decafnet_tpu_torch.train.__main__ import build_trainer, train

    cfg = load_config(cfg_file)
    _, data = write_config_data(root, name + "_train", cfg, ("train", "val"),
                             cfg.train.batch_size, cfg.data.max_num_text,
                             cfg.model.vid_net.max_seq_len // 2)
    trainer = build_trainer(["--cfg", cfg_file, data, "--set", "log.root",
                             os.path.join(root, name + "_log"), "seed", str(SEED),
                             "aux.dryrun", "True", "aux.eval_run", "0"])
    assert trainer.device.type == "cuda"
    n_micro = max(trainer.cfg.train.batch_size // trainer.micro, 1)
    probe = StepProbe(trainer)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    train(trainer)
    run_s = time.perf_counter() - t0
    counts = read_counts()
    emit({"phase": "configs", "leg": name, "path": "train",
          "videos_per_step": trainer.cfg.train.batch_size,
          "rows_per_step": trainer.cfg.train.batch_size * trainer.cfg.data.max_num_text,
          "microbatches": n_micro, "T": trainer.cfg.data.max_vid_len,
          "steps": trainer.step, "per_step": probe.records, "run_s": run_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    assert trainer.step == 1 and len(probe.records) == 1, trainer.step
    expect_counts(counts, trainer.cfg, n_micro, torch.float32, f"{name} train")
    assert all(np.isfinite(probe.records[0][k]) for k in ("cls", "reg", "total"))
    assert all(torch.isfinite(p).all() for p in trainer.model.parameters())
    return counts[torch.float32, "tuned"]


def run_configs(dev, root):
    """The configs phase: each of CONFIG_FILES at full width and depth
    (kernels vs plain versions at 64 rows x its pyramid, served in f32 and
    bf16, the eval CLI, one train step), then the WIDTH_LEGS of
    configs/ego4d_nlq.yaml (kernels vs plain and served in f32 and bf16).
    Returns {(dtype, route): {path: {op: launches}}}."""
    from decafnet_tpu_torch import ops
    from decafnet_tpu_torch.core import load_config, update_opt

    paths = {(dt, route): {} for dt in (torch.float32, torch.bfloat16)
             for route in ops.ROUTES}

    def book(path, counts):
        for key, c in counts.items():
            paths[key][path] = c

    for name in CONFIG_FILES:
        t0 = time.perf_counter()
        cfg_file = os.path.join(REPO, "configs", name + ".yaml")
        cfg = load_config(cfg_file)
        m = cfg.model
        emit({"phase": "configs", "leg": name, "config": f"configs/{name}.yaml",
              "task": cfg.task, "max_seq_len": m.vid_net.max_seq_len,
              "arch": list(m.vid_net.arch), "embd": m.vid_net.embd_dim,
              "vid_in": m.vid_net.in_dim, "sn": m.sn, "sratio": m.sratio,
              "batch_size": cfg.train.batch_size,
              "microbatch_size": cfg.train.get("microbatch_size"),
              "group_method": cfg.data.get("group_method"),
              "clip": [cfg.data.clip_size, cfg.data.clip_stride]})
        worst = config_kernels(dev, cfg, name)
        served = config_serve(dev, cfg, name)
        for dt, counts in served.items():
            book(f"{name}_serve" + ("_bf16" if dt == torch.bfloat16 else ""),
                 {key: c for key, c in counts.items() if key[0] == dt})
        evals = config_eval(root, name, cfg_file, cfg)
        paths[torch.float32, "tuned"][f"{name}_eval"] = evals
        paths[torch.float32, "tuned"][f"{name}_train"] = config_train(root, name,
                                                                      cfg_file)
        emit({"phase": "configs", "leg": name, "kernels_vs_plain": worst,
              "seconds": time.perf_counter() - t0})
        torch.cuda.empty_cache()
    for leg, override in WIDTH_LEGS.items():
        t0 = time.perf_counter()
        cfg = load_config(os.path.join(REPO, "configs", "ego4d_nlq.yaml"))
        cfg.merge_from_list(override)
        update_opt(cfg)
        m = cfg.model
        emit({"phase": "configs", "leg": leg, "config": "configs/ego4d_nlq.yaml",
              "set": override, "embd": m.vid_net.embd_dim,
              "heads": m.vid_net.n_heads,
              "head_dim": m.vid_net.embd_dim // m.vid_net.n_heads,
              "per_forward": per_forward(cfg)})
        worst = config_kernels(dev, cfg, leg)
        served = config_serve(dev, cfg, leg)
        for dt, counts in served.items():
            book(f"{leg}_serve" + ("_bf16" if dt == torch.bfloat16 else ""),
                 {key: c for key, c in counts.items() if key[0] == dt})
        emit({"phase": "configs", "leg": leg, "kernels_vs_plain": worst,
              "seconds": time.perf_counter() - t0})
        torch.cuda.empty_cache()
    return paths


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import decafnet_tpu_torch  # noqa: F401  (sets full f32: TF32 off)
    from decafnet_tpu_torch.ops import cuda

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "tf32": [torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32],
          "bf16_reduced_precision_reduction":
              torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction})
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction

    t_start = t0 = time.perf_counter()
    path, compile_s = cuda.build()
    cuda.library()
    emit({"phase": "build", "library": os.path.relpath(path, REPO),
          "nvcc_s": compile_s, "seconds": time.perf_counter() - t0})
    for kernel in ("conv3_ln_act", "band_attention", "qkv_depthwise_ln"):
        for source in (kernel, kernel + "_general") + {
                "conv3_ln_act": ("conv3_ln_act_wide", "conv3_ln_act_passes"),
                "band_attention": ("band_attention_wide",),
                "qkv_depthwise_ln": ("qkv_depthwise_ln_wide",)}.get(kernel, ()):
            emit({"phase": "build", "kernel": source, "ptxas":
                  ptxas_report(cuda.build_log(source + ".cu"))})
    # the tuned conv3 kernels, the wide ones (one per slice width of each
    # dtype) and the pass ones (one per pass width of each dtype), on wgmma
    # (HGMMA; the general kernel of csrc/conv3_ln_act_general.cu multiplies
    # on the CUDA cores)
    all_mma = sass_mma(path, "conv3_ln_act")
    mma = {k: c for k, c in all_mma.items()
           if not any(r in k for r in ("general", "wide", "passes"))}
    mma_wide = {k: c for k, c in all_mma.items() if "wide" in k}
    mma_passes = {k: c for k, c in all_mma.items() if "passes" in k}
    emit({"phase": "build", "kernel": "conv3_ln_act", "sass_mma": mma})
    emit({"phase": "build", "kernel": "conv3_ln_act_wide", "sass_mma": mma_wide})
    emit({"phase": "build", "kernel": "conv3_ln_act_passes", "sass_mma": mma_passes})
    assert mma and all(c["HGMMA"] > 0 for c in mma.values()), \
        "conv3_ln_act does not run on the tensor cores"
    from decafnet_tpu_torch.ops.fused_conv import CONV3_PASSES_SLICES, CONV3_WIDE_SLICES
    assert len(mma_wide) == sum(map(len, CONV3_WIDE_SLICES.values())) and all(
        c["HGMMA"] > 0 for c in mma_wide.values()), \
        "conv3_ln_act_wide does not run on the tensor cores"
    assert len(mma_passes) == 2 * len(CONV3_PASSES_SLICES) and all(
        c["HGMMA"] > 0 for c in mma_passes.values()), \
        "conv3_ln_act_passes does not run on the tensor cores"
    # the bf16 band kernel's pipeline (split 1, its instantiations
    # <halo, 1>) loads its tiles by TMA (UTMALDG) under mbarriers (SYNCS)
    tma = sass_counts(path, "band_attention_bf16_kernel", ("UTMALDG", "SYNCS"))
    emit({"phase": "build", "kernel": "band_attention_bf16", "sass_tma": tma})
    piped = [c for k, c in tma.items() if re.search(r"kernelILi\dELi1E", k)]
    assert len(tma) == 8 and len(piped) == 4 and all(
        c["UTMALDG"] > 0 and c["SYNCS"] > 0 for c in piped), \
        "the bf16 band kernel's pipeline does not load by TMA under mbarriers"

    walls, t_mark = {}, [time.perf_counter()]

    def lap(phase):
        """Wall seconds since the last lap, under ``phase``."""
        now = time.perf_counter()
        walls[phase] = walls.get(phase, 0.0) + now - t_mark[0]
        t_mark[0] = now

    lap("device_and_build")
    rec = run_kernels(dev)
    rec16 = run_bf16_kernels(dev, rec)
    mad_rec = run_kernels(dev, MAD)
    mad_rec16 = run_bf16_kernels(dev, mad_rec, MAD)
    torch.cuda.empty_cache()
    lap("kernels_and_bf16_kernels")
    shape_recs = run_shapes(dev)
    lap("shapes")
    run_card_tests()
    lap("card_tests")
    by_path = {}
    by_path["serve"], service, requests = run_serve(dev)
    lap("serve")
    with tempfile.TemporaryDirectory() as root:
        by_path["eval"], logdir, eval_base = run_eval(root)
        by_path["http"] = run_http(logdir, service, requests)
        lap("eval_and_http")
        by_path16, service16 = run_bf16(dev, service, logdir, eval_base, requests)
        lap("bf16")
        mad_paths, mad_paths16, mad_logdir, mad_eval = run_mad(root, smi)
        by_path.update(mad_paths)
        by_path16.update(mad_paths16)
        lap("mad")
        cfg_paths = run_configs(dev, root)
        by_path.update(cfg_paths[torch.float32, "tuned"])
        by_path16.update(cfg_paths[torch.bfloat16, "tuned"])
        lap("configs")
        cfg_file = write_train_data(root)
        by_path["train"], train32 = run_train(root, cfg_file)
        by_path16["bf16_train"] = run_train_bf16(root, cfg_file, train32)
        by_path["remat"], by_path16["bf16_remat_mad"], mad_ref = run_remat(
            root, cfg_file)
        lap("train")
        by_path["variants"] = run_variants(dev, root)
        lap("variants")
        by_path["encode"], by_path["encode_cli"], by_path16["bf16_encode"] = run_encode(
            dev, service, smi, root, service16)
        del service, service16
        lap("encode")
        multi, multi16 = run_multi(root, cfg_file, logdir, eval_base, smi,
                                   mad_ref, (mad_logdir, mad_eval))
        by_path.update(multi)
        by_path16.update(multi16)
        lap("multi")
    launches = {n: sum(p[n] for p in by_path.values()) for n in PER_DECODE}

    sources = {"conv3_ln_act": ("decafnet_tpu_torch/csrc/conv3_ln_act.cu",
                                "decafnet_tpu/ops/fused_conv.py:79"),
               "band_attention": ("decafnet_tpu_torch/csrc/band_attention.cu",
                                  "decafnet_tpu/ops/local_attention.py:244"),
               "qkv_depthwise_ln": ("decafnet_tpu_torch/csrc/qkv_depthwise_ln.cu",
                                    "decafnet_tpu/ops/fused_conv.py:294")}
    ptxas = {n: ptxas_report(cuda.build_log(n + ".cu")) for n in sources}

    def at_mad(r, errs):
        """The MAD decode call's record of one kernel."""
        return {"per": MAD["per"], **{k: r[k] for k in errs},
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"],
                "bound_by": "bytes" if r["byte_ms"] >= r["flop_ms"] else "operations",
                "library_ms": r["library_ms"],
                **{k: r[k] for k in ("library_ms_note", "bound_f32_ms",
                                     "max_abs_err_f64", "plain_max_abs_err_f64",
                                     "per_level_launch_ms", "grouping_rule",
                                     "heads") if k in r},
                "levels": r["levels"]}
    kernels = []
    for n, r in rec.items():
        src, rep = sources[n]
        kernels.append({
            "name": n, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[n],
            "launches_by_path": {p: c[n] for p, c in by_path.items()},
            "max_abs_err": max(r["max_abs_err"], mad_rec[n]["max_abs_err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes" if r["byte_ms"] >= r["flop_ms"] else "operations",
            "library_ms": r["library_ms"],
            "per": "one served decode call (64 rows, T=2304, all levels)",
            "launches_per_forward": {m: c[n] for m, c in PER_FORWARD.items()},
            "mad_decode": at_mad(mad_rec[n], ("max_abs_err",)),
            **{k: r[k] for k in ("bound_f32_ms", "max_abs_err_f64",
                                 "plain_max_abs_err_f64", "per_level_launch_ms",
                                 "grouping_rule", "heads") if k in r},
            **({"sass_mma": {k: c for k, c in mma.items() if "bf16" not in k},
                "ptxas": [k for k in ptxas[n] if "bf16" not in k["kernel"]]}
               if n == "conv3_ln_act" else {}),
            "levels": r["levels"]})
    for n, r in rec16.items():
        bf16_kernels = [k for k in ptxas[n] if "bfloat16" in k["kernel"]
                        or "bf16" in k["kernel"]]
        kernels.append({
            "name": n + "_bf16", "route": "cuda", "source": sources[n][0],
            "replaces": sources[n][1],
            "launches": sum(p[n] for p in by_path16.values()),
            "launches_by_path": {p: c[n] for p, c in by_path16.items()},
            "max_abs_err": max(r["max_abs_err"], mad_rec16[n]["max_abs_err"]),
            "max_rel_err": max(r["max_rel_err"], mad_rec16[n]["max_rel_err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes" if r["byte_ms"] >= r["flop_ms"] else "operations",
            "library_ms": r["library_ms"], "f32_kernel_ms": rec[n]["ms"],
            "per": "one served decode call (64 rows, T=2304, all levels), bf16",
            "launches_per_forward": PER_DECODE[n], "ptxas": bf16_kernels,
            "mad_decode": at_mad(mad_rec16[n], ("max_abs_err", "max_rel_err")),
            **({"sass_mma": {k: c for k, c in mma.items() if "bf16" in k}}
               if n == "conv3_ln_act" else {}),
            **({"sass_tma": tma, "per_level_us": [
                {"level": lv["level"], "us": 1e3 * lv["ms"],
                 "bound_us": 1e3 * lv["bound_ms"],
                 "share_of_bound": lv["share_of_bound"]} for lv in r["levels"]]}
               if n == "band_attention" else {}),
            **{k: r[k] for k in ("per_level_launch_ms", "grouping_rule", "heads")
               if k in r},
            "levels": r["levels"]})
    for (n, route, dtype), r in shape_recs.items():
        bf16 = dtype == torch.bfloat16
        by = cfg_paths[dtype, route]
        src = SHAPE_KERNELS[n, route]
        wgmma = ({"wide": mma_wide, "passes": mma_passes}.get(route)
                 if n == "conv3_ln_act" else None)
        kernels.append({
            "name": f"{n}_{route}" + ("_bf16" if bf16 else ""), "route": "cuda",
            "source": src, "replaces": REPLACES[n],
            "launches": sum(p[n] for p in by.values()),
            "launches_by_path": {p: c[n] for p, c in by.items()},
            "max_abs_err": r["max_abs_err"], "max_rel_err": r["max_rel_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes" if r["byte_ms"] >= r["flop_ms"] else "operations",
            "library_ms": r["library_ms"], "per": r["per"],
            **({"general_ms": sum(sh["general_ms"] for sh in r["shapes"])}
               if route != "general" else {}),
            **({"sass_mma": {k: c for k, c in wgmma.items()
                             if bf16_kernel_name(k) == bf16}}
               if wgmma is not None else {}),
            **({"on_path": False, "off_path": OFF_PATH[n, route]}
               if (n, route) in OFF_PATH else {}),
            "ptxas": [k for k in ptxas_report(cuda.build_log(os.path.basename(src)))
                      if bf16_kernel_name(k["kernel"]) == bf16],
            **{k: r[k] for k in ("max_abs_err_f64", "seed_sweep", "by_shape") if k in r},
            "shapes": r["shapes"]})
    emit({"phase": "walls", "seconds": walls,
          "total_s": time.perf_counter() - t_start})
    # every kernel of the paths ran on the main path
    assert all(k["launches"] > 0 for k in kernels if k.get("on_path", True)), \
        [k["name"] for k in kernels if not k["launches"]]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:
        sys.exit(rank_worker(sys.argv[2], sys.argv[3], sys.argv[4:]))
    sys.exit(main())
