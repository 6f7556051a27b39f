"""The port's bf16 compute mode (``tpu.compute_dtype: bfloat16``) against the
JAX package's on the CPU: bf16 activations, f32 parameters cast at each use,
f32 statistics.

- Each kernel op's plain version in bf16 against the JAX XLA composition in
  bf16 (``conv3_ln_act_xla``, ``qkv_depthwise_ln_xla``,
  ``band_attention_diag`` at T < 4096), within 2 bf16 eps (2 * 2**-7) of
  ``max(1, |ref|)``.
- The ``iter`` model per row (Q = 1) and video-major (Q = 3): port bf16
  against JAX bf16 held to the bf16 noise floor, ``mean|port16 - jax16| <=
  1.5 * mean|jax16 - jax32|`` and ``max <= 3 * max|jax16 - jax32|``; bf16
  outputs; port bf16 within 0.15 (mean) of port f32, JAX's own rule
  (tests/test_model_forward.py).
- The bf16 Evaluator against the JAX Evaluator in bf16 on the eval fixture
  of tests/test_torch_eval.py, by the JAX promotion rule
  (scripts/bf16_promotion_study.py): R@1 counts identical, R@5 count flips
  <= 1 per 100 queries; its mean top-1 agreement IoU (>= 0.99) is held to
  the fixture's noise floor, with bf16-tied top scores interchangeable (see
  the test).
- The HTTP endpoint serving with ``--set tpu.compute_dtype bfloat16``;
  ``resolve_compute_dtype`` against JAX's; unknown dtypes raise; the
  Trainer takes bf16 (tests/test_torch_train_bf16.py trains in it) and
  still refuses ``tpu.shard_time``.

Inputs come from numpy seeds and are cast to bf16 on both sides; weights
are the flax init's, loaded through ``state_dict_from_params``."""

import functools
import threading
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from decafnet_tpu.core import get_cfg_defaults as jax_defaults
from decafnet_tpu.eval import Evaluator as JaxEvaluator
from decafnet_tpu.models import make_model as jax_make_model
from decafnet_tpu.models import resolve_compute_dtype as jax_resolve
from decafnet_tpu.ops import fused_conv as jfc
from decafnet_tpu.ops import local_attention as jla
from decafnet_tpu.utils.analysis import EvalResults as JaxEvalResults
from decafnet_tpu_torch.core import get_cfg_defaults, update_opt
from decafnet_tpu_torch.eval import Evaluator
from decafnet_tpu_torch.models import (load_params, make_model,
                                       resolve_compute_dtype)
from decafnet_tpu_torch.ops import (band_attention_torch, conv3_ln_act_torch,
                                    qkv_depthwise_ln_torch)
from decafnet_tpu_torch.ops import fused_conv as tfc
from decafnet_tpu_torch.serve import make_handler, service_from_logdir
from decafnet_tpu_torch.train import Trainer
from decafnet_tpu_torch.utils import EvalResults
from test_torch_eval import _configs, experiment, setup  # noqa: F401  (fixtures)
from test_torch_http import _as_json, _call, _request
from test_torch_model import _inputs, cfg_pair, flax_params
from test_torch_train import cfg_pair as train_cfg_pair
from test_torch_train_step import synth  # noqa: F401  (fixture)

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)

BF16_EPS = 2.0 ** -7
OP_TOL = 2 * BF16_EPS


def _bf16(a):
    """A numpy f32 array rounded to bf16, as a torch tensor and a JAX array
    holding the same values."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _close(got, want):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= OP_TOL, err.max()


def _mask(B, T):
    lens = [T, T - 3, T // 2, 0][:B]
    return np.arange(T)[None, :] < np.asarray(lens)[:, None]


@pytest.mark.parametrize("c_in,c_out,T,bias,act", [
    (24, 16, 37, False, "relu"), (16, 24, 64, True, "relu"),
    (32, 40, 19, True, "none")])
def test_conv3_ln_act_plain_matches_xla_in_bf16(c_in, c_out, T, bias, act):
    rng = np.random.RandomState(c_in + T)
    x_t, x_j = _bf16(rng.randn(4, c_in, T).astype(np.float32))
    mask = _mask(4, T)
    f32 = [rng.randn(c_out, c_in, 3).astype(np.float32) / np.sqrt(3 * c_in),
           rng.randn(c_out).astype(np.float32) if bias else None,
           (1 + 0.1 * rng.randn(c_out, 1)).astype(np.float32),
           (0.1 * rng.randn(c_out, 1)).astype(np.float32)]
    got = conv3_ln_act_torch(x_t, torch.from_numpy(mask),
                             *[None if a is None else torch.from_numpy(a)
                               for a in f32], act=act)
    want = jax.jit(functools.partial(jfc.conv3_ln_act_xla, act=act))(
        x_j, mask, *[None if a is None else jnp.asarray(a) for a in f32])
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got, want)


@pytest.mark.parametrize("T", [64, 21])
def test_qkv_depthwise_ln_plain_matches_xla_in_bf16(T):
    rng = np.random.RandomState(T)
    C = 16
    x_t, x_j = _bf16(rng.randn(4, C, T).astype(np.float32))
    mask = _mask(4, T)
    ws = [rng.randn(C, 1, 3).astype(np.float32) / np.sqrt(3) for _ in range(3)]
    lws = [(1 + 0.1 * rng.randn(C, 1)).astype(np.float32) for _ in range(3)]
    lbs = [(0.1 * rng.randn(C, 1)).astype(np.float32) for _ in range(3)]
    t = functools.partial(map, torch.from_numpy)
    got = qkv_depthwise_ln_torch(x_t, torch.from_numpy(mask), list(t(ws)),
                                 list(t(lws)), list(t(lbs)))
    want = jax.jit(jfc.qkv_depthwise_ln_xla)(
        x_j, mask, *[[jnp.asarray(a) for a in p] for p in (ws, lws, lbs)])
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        _close(g, w)


@pytest.mark.parametrize("T", [48, 13])
def test_band_attention_plain_matches_diag_in_bf16(T):
    rng = np.random.RandomState(T)
    B, H, D = 4, 4, 8
    qkv = [_bf16((rng.randn(B, H, T, D) * D ** -0.25).astype(np.float32))
           for _ in range(3)]
    mask = _mask(B, T)
    got = band_attention_torch(*[t for t, _ in qkv], torch.from_numpy(mask), 5)
    want = jax.jit(functools.partial(jla.band_attention_diag,
                                     window_size=5))(*[j for _, j in qkv], mask)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got, want)


def _unswizzle_bf16(f):
    """(ceil(C_in/32), 3, N, 32) bf16 weight image back to (N, C_in32, 3):
    row n of chunk c holds the input channels 32c .. 32c + 31, its 16-byte
    piece k at k ^ ((n // 2) % 4), the 64-byte swizzle the wgmma
    descriptor of csrc/conv3_ln_act.cu names (address bits 4-5 XOR 7-8 of a
    64-byte row)."""
    f = f.float().numpy()
    nc, _, N, _ = f.shape
    w = np.full((N, 32 * nc, 3), np.nan, np.float32)
    for n in range(N):
        for k in range(4):
            kp = k ^ ((n // 2) % 4)
            for c in range(nc):
                w[n, 32 * c + 8 * k:32 * c + 8 * k + 8] = f[c, :, n, 8 * kp:8 * kp + 8].T
    return w


@pytest.mark.parametrize("c_in,c_out", [(16, 24), (128, 128), (160, 160),
                                        (200, 256), (13, 40)])
def test_bf16_fragments_follow_the_mma_a_layout(c_in, c_out):
    """The bf16 kernel's weight image is its wgmma B operand, K-major under
    the 64-byte swizzle (before the kernel moved to wgmma it was the A
    fragment of mma.sync.m16n8k16, hence the name)."""
    w = torch.from_numpy(np.random.RandomState(c_in).randn(c_out, c_in, 3)
                         .astype(np.float32))
    f = tfc.conv3_bf16_fragments(w)
    n = next(n for n in tfc.CONV3_WIDTHS if c_out <= n)
    assert f.shape == (-(-c_in // 32), 3, n, 32)
    assert f.dtype == torch.bfloat16 and f.is_contiguous()
    want = np.zeros((n, 32 * -(-c_in // 32), 3), np.float32)
    want[:c_out, :c_in] = w.to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(_unswizzle_bf16(f), want)
    assert tfc.conv3_bf16_operands(w) is tfc.conv3_bf16_operands(w)   # cached


@functools.lru_cache(maxsize=None)
def _model_setup():
    jcfg, tcfg = cfg_pair(msf=True, scat=True)
    jmodel32, params = flax_params(jcfg)
    jcfg.tpu.compute_dtype = "bfloat16"
    return tcfg, jmodel32, jax_make_model(jcfg), params


@pytest.mark.parametrize("Q", [1, 3])
def test_iter_model_bf16_matches_jax_bf16(Q):
    tcfg, jmodel32, jmodel16, params = _model_setup()
    V, T = 3, 64
    args = _inputs(V, Q, T, tcfg.model.vid_net.in_dim,
                   tcfg.model.text_net.in_dim, seed=Q)
    outs = {}
    for key, jm in (("jax32", jmodel32), ("jax16", jmodel16)):
        outs[key] = jax.jit(functools.partial(
            jm.apply, deterministic=True, queries_per_video=Q))(
                {"params": params}, *args)
    for key, dtype in (("port32", None), ("port16", "bfloat16")):
        model = load_params(make_model(tcfg, compute_dtype=dtype), params).eval()
        with torch.inference_mode():
            outs[key] = model(*map(torch.from_numpy, args), queries_per_video=Q)
    assert make_model(tcfg, compute_dtype="bfloat16").compute_dtype == torch.bfloat16

    def flat(key, group):
        levels = outs[key][group]
        if key == "port16":
            assert all(t.dtype == torch.bfloat16 for t in levels)
        if key == "jax16":
            assert all(t.dtype == jnp.bfloat16 for t in levels)
        return np.concatenate([np.asarray(t.float() if torch.is_tensor(t)
                                          else t, np.float32).ravel()
                               for t in levels])

    for group in (1, 2):            # logits2, offsets
        port16, port32 = flat("port16", group), flat("port32", group)
        jax16, jax32 = flat("jax16", group), flat("jax32", group)
        got, floor = np.abs(port16 - jax16), np.abs(jax16 - jax32)
        assert got.mean() <= 1.5 * floor.mean(), (group, got.mean(), floor.mean())
        assert got.max() <= 3 * floor.max(), (group, got.max(), floor.max())
        assert np.abs(port16 - port32).mean() < 0.15


def _top1_agreement(a, b):
    """Per query, the IoU of the two runs' top-1 segments, counting
    detections whose scores lie within one bf16 step of their run's top
    score as the top-1 (bf16 scores tie, and SoftNMS then picks either):
    the largest IoU between the two tied sets."""
    def tied(det):
        s = np.asarray(det["scores"], np.float64)
        step = 2.0 ** (np.floor(np.log2(s[0])) - 7)
        return np.asarray(det["segments"], np.float64)[s >= s[0] - step]

    out = []
    for va, vb in zip(a.videos, b.videos, strict=True):
        assert va["vid_id"] == vb["vid_id"]
        for da, db in zip(va["detections"], vb["detections"], strict=True):
            best = 0.0
            for x in tied(da):
                for y in tied(db):
                    inter = max(0.0, min(x[1], y[1]) - max(x[0], y[0]))
                    best = max(best, inter / (max(x[1], y[1]) - min(x[0], y[0])))
            out.append(best)
    return np.asarray(out)


def test_evaluator_bf16_matches_jax_by_the_promotion_rule(setup):  # noqa: F811
    """R@1 counts equal and R@5 flips <= 1 per 100 queries, as the JAX
    promotion rule. Its top-1 agreement (mean >= 0.99) is held to the
    fixture's noise floor: with random weights the scores are near flat,
    and JAX's own bf16 run agrees with the f32 run (the port's f32 run,
    equal to JAX's to 1e-3 s: tests/test_torch_eval.py) at ~0.985 only, so
    the port's bf16 run must agree with JAX's bf16 run at least as well,
    less 0.01, or at 0.99 where the floor is higher."""
    root, paths, params = setup
    runs = {}
    for who, dtype in (("jax", "bfloat16"), ("port", "bfloat16"),
                       ("port", "float32")):
        d = root / f"{who}_{dtype}"
        d.mkdir()
        jcfg, tcfg = _configs(paths, str(d), "device")
        jcfg.tpu.compute_dtype = tcfg.tpu.compute_dtype = dtype
        if who == "jax":
            ev = JaxEvaluator(jcfg, train_time=True)
            ev.run(ema_params=params)
            results = JaxEvalResults.load(str(d / "results_eval.pk"))
        else:
            ev = Evaluator(tcfg, params=params, device="cpu")
            ev.run()
            assert ev.model.compute_dtype == (torch.bfloat16 if dtype == "bfloat16"
                                              else None)
            results = EvalResults.load(str(d / "results_eval.pk"))
            for v in results.videos:
                for loss in v["losses"]:
                    assert all(np.isfinite(x) for x in loss.values())
        runs[who, dtype] = (ev.meter.counts.copy(), ev.meter.text_cnt, results)

    (jc, n_q, jr), (tc, tn, tr) = runs["jax", "bfloat16"], runs["port", "bfloat16"]
    assert n_q == tn == 9
    np.testing.assert_array_equal(tc[0], jc[0])                 # R@1 counts
    assert 100.0 * np.abs(tc[1] - jc[1]).sum() / n_q <= 1.0     # R@5 flips
    agree = _top1_agreement(tr, jr).mean()
    floor = _top1_agreement(jr, runs["port", "float32"][2]).mean()
    assert agree >= min(0.99, floor - 0.01), (agree, floor)


@pytest.mark.parametrize("value,eval_mode,reference_exact", [
    ("auto", False, False), ("auto", True, False), ("auto", True, True),
    ("float32", True, False), ("bfloat16", False, False),
    ("bfloat16", True, True), ("bf16", True, False)])
def test_resolve_compute_dtype_matches_jax(value, eval_mode, reference_exact):
    jc, tc = jax_defaults("grounder"), get_cfg_defaults("grounder")
    for cfg in (jc, tc):
        cfg.tpu.compute_dtype = value
        cfg.eval.reference_exact = reference_exact
    assert resolve_compute_dtype(tc) == jax_resolve(jc, eval_mode=eval_mode)


def test_unknown_compute_dtypes_raise():
    cfg = update_opt(get_cfg_defaults("grounder"))
    for value in ("float16", "float64"):
        cfg.tpu.compute_dtype = value
        with pytest.raises(ValueError, match="compute_dtype"):
            make_model(cfg)
    cfg.tpu.compute_dtype = "auto"
    assert make_model(cfg).compute_dtype is None


def test_bf16_service_answers_over_http(experiment):  # noqa: F811
    """The serve CLI's service with ``--set tpu.compute_dtype bfloat16``
    behind the HTTP endpoint answers as the service does."""
    service = service_from_logdir(experiment, "last", device="cpu", set_cfgs=[
        "tpu.compute_dtype", "bfloat16"])
    assert service.model.compute_dtype == torch.bfloat16
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        req = _request(40, 3, 1)
        code, body = _call(f"http://127.0.0.1:{server.server_address[1]}",
                           "/ground", _as_json(req))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert code == 200
    assert body["detections"] == service.ground(**req)
    counts = [len(d["scores"]) for d in body["detections"]]
    assert len(counts) == 3 and 0 < max(counts)
    assert max(counts) <= service.decoder.cfg.nms.max_num_segs


def test_trainer_takes_bf16_and_refuses_shard_time(synth, tmp_path):  # noqa: F811
    """An explicit bf16 builds a Trainer whose model (and EMA) computes in
    bf16 on f32 weights; ``auto`` trains in f32; ``tpu.shard_time`` in bf16
    builds one too (one process: nothing to shard;
    tests/test_torch_seq_train.py runs it over two ranks), and with a 2-D
    ``tpu.mesh_shape`` of more ranks than the one process raises, naming
    the rule."""
    def cfg_of(dtype, **tpu):
        _, cfg = train_cfg_pair(synth, str(tmp_path / dtype))
        cfg.tpu.update(compute_dtype=dtype, **tpu)
        return cfg

    for dtype in ("bfloat16", "bf16"):
        trainer = Trainer(cfg_of(dtype), device="cpu")
        assert trainer.model.compute_dtype == trainer.ema.compute_dtype == torch.bfloat16
        assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    assert Trainer(cfg_of("auto"), device="cpu").model.compute_dtype is None
    trainer = Trainer(cfg_of("bfloat16", shard_time=True), device="cpu")
    assert trainer.shard is None and trainer.model.compute_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="names another count"):
        Trainer(cfg_of("bfloat16", shard_time=True, mesh_shape=(1, 2)),
                device="cpu")
