#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (decafnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  device   the card (torch and nvidia-smi);
  build    compiles the CUDA kernels from decafnet_tpu_torch/csrc with nvcc,
           prints ptxas's registers / shared memory / spills of every
           kernel and checks in the conv3 kernels' SASS (cuobjdump) that
           they run on the tensor cores (HMMA);
  kernels  holds each kernel against its plain PyTorch version on the card at
           the served shapes (V=8 videos x Q=8 queries = 64 rows, T=2304, all
           7 FPN levels) and at edge shapes (ragged and odd T, masked tails,
           an all-masked row, base pointers off 16 bytes, padded rows, B*H
           above 65535), holds conv3_ln_act against an f64
           run of the same function at every served shape, and times kernel,
           plain version and, where one exists, the one PyTorch call
           computing the same function (library_ms, timed here only);
  serve    builds GroundingService at the Ego4D-NLQ width
           (configs/ego4d_nlq.yaml) with seeded random weights on the card,
           answers requests through ground() and ground_many(), checks the
           detections, the kernel launch counts per decode call, and the
           same requests through the plain versions; then profiles one
           stacked decode (device time by kernel, torch.profiler).
Then one {"kernels": [...]} line, the nvidia-smi name/power-limit line, and
last {"ok": true, "device": {...}}. Any failed check raises: the script
exits non-zero and prints no result. Without CUDA it exits 2.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit): f32
# outside the tensor cores, dense TF32 on the tensor cores, HBM3 bandwidth.
# Every kernel here computes in f32; conv3_ln_act runs its products on the
# tensor cores as three TF32 passes (3xTF32), the others on the CUDA cores.
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12

# the served shape: 8 videos x 8 queries of a 2304-clip bucket
ROWS, T0, LEVELS, EMBD, RDIM, HEADS, WINDOW = 64, 2304, 7, 128, 32, 4, 5
VIDEO_LENS = (2304, 2304, 2200, 2000, 1800, 1500, 1100, 700)

# tolerances of kernel vs plain version on the card (max |diff|):
# conv3_ln_act sums 3*C_in (up to 480) f32 products in another order than
# cuDNN before a LayerNorm; the trio and band attention sum 3 and 5*32 terms
TOL = {"conv3_ln_act": 1e-4, "qkv_depthwise_ln": 1e-5, "band_attention": 1e-5}
# conv3_ln_act against an f64 run of the same function: 3xTF32 must keep
# f32 accuracy (one TF32 pass is off by ~1e-3 at these widths)
TOL_F64 = 1e-5
# served detections, kernels vs plain versions and ground vs ground_many
SEG_TOL_S, SCORE_TOL = 1e-3, 1e-4


def emit(obj):
    print(json.dumps(obj), flush=True)


def bound_ms(n_bytes, n_flops, tc_flops=0):
    """Least time for the work: bytes at the HBM rate, f32 operations at the
    CUDA-core rate, tensor-core TF32 operations at the TF32 rate; the units
    run side by side, so the largest of the three."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(n_flops / F32_FLOPS, tc_flops / TF32_FLOPS)
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


def row_lens(level):
    """Valid lengths of the 64 served rows at one FPN level."""
    return [math.ceil(n / 2 ** level) for n in VIDEO_LENS for _ in range(8)]


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


def sass_hmma(lib_path, name):
    """Tensor-core (HMMA) instructions per compiled kernel whose name holds
    ``name``, from cuobjdump -sass of the built library."""
    from decafnet_tpu_torch.ops import cuda

    sass = subprocess.run([cuda.toolkit_binary("cuobjdump"), "-sass", lib_path],
                          capture_output=True, text=True, check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1) if name in m.group(1) else None
            if cur:
                counts[cur] = 0
        elif cur and "HMMA" in line:
            counts[cur] += 1
    return counts


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


def conv3_case(dev, g, B, C, T, lens, bias=False, act="relu"):
    x = torch.randn(B, C, T, generator=g, device=dev)
    w = torch.randn(C, C, 3, generator=g, device=dev) / math.sqrt(3 * C)
    b = torch.randn(C, generator=g, device=dev) if bias else None
    lw = 1 + 0.1 * torch.randn(C, 1, generator=g, device=dev)
    lb = 0.1 * torch.randn(C, 1, generator=g, device=dev)
    return (x, prefix_mask(lens, T, dev), w, b, lw, lb), {"act": act}


def moved(x, how):
    """``x`` (B, C, T) with the same values at another address: "offset" is
    contiguous one element past a 16-byte boundary, "padded" sits in rows
    padded to a multiple of 4 columns (16-byte aligned rows, the last 16
    bytes of a row partly outside it); "as_is" is ``x``."""
    if how == "as_is":
        return x
    B, C, T = x.shape
    if how == "offset":
        buf = torch.empty(B * C * T + 1, device=x.device)[1:].view(B, C, T)
    else:
        buf = torch.empty(B, C, T // 4 * 4 + 4, device=x.device)[..., :T]
    return buf.copy_(x)


def trio_case(dev, g, B, C, T, lens, how="as_is"):
    x = moved(torch.randn(B, C, T, generator=g, device=dev), how)
    ws = [torch.randn(C, 1, 3, generator=g, device=dev) / math.sqrt(3)
          for _ in range(3)]
    lws = [1 + 0.1 * torch.randn(C, 1, generator=g, device=dev) for _ in range(3)]
    lbs = [0.1 * torch.randn(C, 1, generator=g, device=dev) for _ in range(3)]
    return (x, prefix_mask(lens, T, dev), ws, lws, lbs), {}


def band_case(dev, g, B, T, lens, D=EMBD // HEADS, how="as_is"):
    """Strided (B, H, T, D) head views of (B, C, T) projections, as the
    model hands them over, scaled by 1/sqrt(sqrt(D)) like q and k there
    (``how``: see :func:`moved`; "contiguous" gives (B, H, T, D) tensors)."""
    s = float(D) ** -0.25
    qkv = [moved(torch.randn(B, HEADS * D, T, generator=g, device=dev) * s,
                 "as_is" if how == "contiguous" else how)
           .reshape(B, HEADS, D, T).transpose(2, 3) for _ in range(3)]
    if how == "contiguous":
        qkv = [t.contiguous() for t in qkv]
    return (*qkv, prefix_mask(lens, T, dev), WINDOW), {}


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
    attn_mask = band[None, None] & mask[:, None, None, :]
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask, scale=1.0)


def run_kernels(dev):
    """Hold each kernel against its plain version, time the served shapes.
    Returns per-kernel records summed over one served decode call."""
    from decafnet_tpu_torch.ops import (band_attention, band_attention_torch,
                                        conv3_ln_act, conv3_ln_act_torch,
                                        qkv_depthwise_ln, qkv_depthwise_ln_torch)

    g = torch.Generator(device=dev).manual_seed(SEED)
    rec = {n: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "flop_ms": 0.0, "byte_ms": 0.0, "library_ms": None, "levels": []}
           for n in ("conv3_ln_act", "band_attention", "qkv_depthwise_ln")}
    rec["conv3_ln_act"].update(bound_f32_ms=0.0, max_abs_err_f64=0.0,
                               plain_max_abs_err_f64=0.0)

    def add(name, count, args, kw, op, plain, n_bytes, n_flops, level, lib=None,
            tc_flops=0):
        err = check(op, plain, args, kw, name, f"served level {level}, "
                    f"shape {tuple(args[0].shape)}")
        ms = time_ms(lambda: op(*args, **kw), 20)
        plain_ms = time_ms(lambda: plain(*args, **kw), 5, warmup=1)
        b_ms, _ = bound_ms(n_bytes, n_flops, tc_flops)
        lib_ms = time_ms(lambda: lib(*args, **kw), 3, warmup=1) if lib else None
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
        r["bound_f32_ms"] += lvl["calls"] * f32_ms
        lvl.update(bound_f32_ms=f32_ms, max_abs_err_f64=err,
                   plain_max_abs_err_f64=err_plain)
        ok = err <= TOL_F64
        emit({"phase": "kernels", "kernel": "conv3_ln_act", "check":
              f"vs f64, served level {lvl['level']}, shape {lvl['shape']}",
              "max_abs_err_f64": err, "plain_max_abs_err_f64": err_plain,
              "tol": TOL_F64, "ok": ok})
        if not ok:
            raise AssertionError(f"conv3_ln_act is off f64 by {err} at "
                                 f"{lvl['shape']}")

    # served shapes: every FPN level of one 64-row decode call
    for level in range(LEVELS):
        T = T0 // 2 ** level
        lens = row_lens(level)
        n_valid = sum(min(n, T) for n in lens)
        for C, count in ((EMBD, 4 if level == 0 else 2), (EMBD + RDIM, 4)):
            args, kw = conv3_case(dev, g, ROWS, C, T, lens)
            n_bytes = 4 * (2 * ROWS * C * T + 3 * C * C + 2 * C) + ROWS * T
            gemm_flops = 2 * ROWS * T * C * 3 * C
            ln_flops = 8 * ROWS * C * T
            lvl = add("conv3_ln_act", count, args, kw, conv3_ln_act,
                      conv3_ln_act_torch, n_bytes, ln_flops, level,
                      tc_flops=3 * gemm_flops)
            conv3_accuracy(args, kw, lvl, n_bytes, gemm_flops, ln_flops)
            del args
        args, kw = band_case(dev, g, ROWS, T, lens)
        D = EMBD // HEADS
        n_bytes = 4 * (3 * n_valid * HEADS * D + ROWS * HEADS * T * D) + ROWS * T
        n_flops = n_valid * HEADS * (4 * WINDOW * D + 4 * WINDOW)
        add("band_attention", 1, args, kw, band_attention, band_attention_torch,
            n_bytes, n_flops, level, lib=sdpa_band)
        if level == 0:
            args, kw = trio_case(dev, g, ROWS, EMBD, T, lens)
            n_bytes = 4 * (4 * ROWS * EMBD * T + 15 * EMBD) + ROWS * T
            n_flops = 3 * ROWS * EMBD * T * (5 + 8)
            add("qkv_depthwise_ln", 1, args, kw, qkv_depthwise_ln,
                qkv_depthwise_ln_torch, n_bytes, n_flops, level)

    # edge shapes: ragged and odd T, masked tails, an all-masked row, tiny
    # level-6 lengths, T shorter than the attention window, base pointers
    # off 16 bytes, rows padded past T; and the unused options
    for T in (1000, 301, 36, 17, 9, 4, 3):
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


def check_detections(results, request, k):
    duration = request["vid"].shape[1] * request["clip_stride"] / request["fps"]
    assert len(results) == len(request["texts"])
    for r in results:
        segs = np.asarray(r["segments"], np.float64).reshape(-1, 2)
        scores = np.asarray(r["scores"], np.float64)
        assert 0 < len(scores) <= k and len(segs) == len(scores), r
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


def profile_decode(service, batch, top=12):
    """Device time by kernel over one stacked 8x8 decode (torch.profiler):
    the busy share of the call's wall time and the kernels that take it.
    Kernels run on one stream, so their summed time is the busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        service.ground_many(batch)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    emit({"phase": "serve", "profile": "one ground_many of 8 videos x 8 queries "
          "at 2304 clips (profiler on)", "wall_ms": wall_ms,
          "device_busy_ms": busy_ms, "kernel_launches": sum(r[2] for r in rows),
          "top_kernels": [{"name": n[:120], "ms": ms, "count": c}
                          for n, ms, c in rows[:top]]})


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

    want = {"conv3_ln_act": 44 * calls, "band_attention": 7 * calls,
            "qkv_depthwise_ln": calls}
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
    return launches


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
                   torch.backends.cudnn.allow_tf32]})
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32

    t0 = time.perf_counter()
    path, compile_s = cuda.build()
    cuda.library()
    emit({"phase": "build", "library": os.path.relpath(path, REPO),
          "nvcc_s": compile_s, "seconds": time.perf_counter() - t0})
    for kernel in ("conv3_ln_act", "band_attention", "qkv_depthwise_ln"):
        emit({"phase": "build", "kernel": kernel, "ptxas":
              ptxas_report(cuda.build_log(kernel + ".cu"))})
    hmma = sass_hmma(path, "conv3_ln_act")
    emit({"phase": "build", "kernel": "conv3_ln_act", "sass_hmma": hmma})
    assert hmma and all(n > 0 for n in hmma.values()), \
        "conv3_ln_act does not run on the tensor cores"

    rec = run_kernels(dev)
    launches = run_serve(dev)

    sources = {"conv3_ln_act": ("decafnet_tpu_torch/csrc/conv3_ln_act.cu",
                                "decafnet_tpu/ops/fused_conv.py:79"),
               "band_attention": ("decafnet_tpu_torch/csrc/band_attention.cu",
                                  "decafnet_tpu/ops/local_attention.py:244"),
               "qkv_depthwise_ln": ("decafnet_tpu_torch/csrc/qkv_depthwise_ln.cu",
                                    "decafnet_tpu/ops/fused_conv.py:294")}
    kernels = []
    for n, r in rec.items():
        src, rep = sources[n]
        kernels.append({
            "name": n, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[n], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes" if r["byte_ms"] >= r["flop_ms"] else "operations",
            "library_ms": r["library_ms"],
            "per": "one served decode call (64 rows, T=2304, all levels)",
            **{k: r[k] for k in ("bound_f32_ms", "max_abs_err_f64",
                                 "plain_max_abs_err_f64") if k in r},
            "levels": r["levels"]})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
