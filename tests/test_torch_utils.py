"""The port's analysis and profiling utilities against the JAX package's
(decafnet_tpu/utils/analysis.py, utils/profiling.py) on the same seeded
inputs: IoU by ground-truth length, the reference's pairwise IoU and array
resampling, the allowlisted reader of reference result pickles, the
PhaseTimer summary; and the torch.profiler trace and annotations on the
CPU."""

import glob
import json
import os
import pickle
import sys
import types

import numpy as np
import pytest
import torch

from decafnet_tpu.utils import PhaseTimer as JaxPhaseTimer
from decafnet_tpu.utils import analysis as jax_analysis
from decafnet_tpu_torch.utils import (EvalResults, PhaseTimer, annotate,
                                      compute_iou, compute_iou_by_length,
                                      interpolate_array,
                                      load_reference_checkpoint, trace)

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)


def _results(cls, seed=0, n_videos=6):
    """The same random records in an EvalResults class of either package:
    targets of 1-60 s, 0-5 detections per query (none for some)."""
    rng = np.random.RandomState(seed)
    res = cls("seeded")
    for v in range(n_videos):
        nq = rng.randint(1, 5)
        starts = rng.uniform(0, 100, nq)
        targets = np.stack([starts, starts + rng.uniform(1, 60, nq)], 1)
        dets = []
        for _ in range(nq):
            k = rng.randint(0, 6)
            s = rng.uniform(0, 120, k)
            dets.append({"segments": np.stack([s, s + rng.uniform(0.5, 50, k)], 1),
                         "scores": rng.uniform(0, 1, k)})
        res.add_video(f"vid{v}", targets, dets)
    return res


@pytest.mark.parametrize("bins", [(0, 5, 10, 20, 40, np.inf), (0, 30, np.inf)])
def test_compute_iou_by_length_matches_jax(bins, tmp_path):
    got = compute_iou_by_length(_results(EvalResults), bins=bins)
    want = jax_analysis.compute_iou_by_length(
        _results(jax_analysis.EvalResults), bins=bins)
    assert got.keys() == want.keys()
    for key, (mean, n) in want.items():
        assert got[key][1] == n
        np.testing.assert_allclose(got[key][0], mean, rtol=1e-12)
    assert sum(n for _, n in got.values()) == len(
        _results(EvalResults).top1_ious())
    # from a dump the Evaluator writes (eval.save_results)
    path = str(tmp_path / "results.pk")
    _results(EvalResults).save(path)
    assert compute_iou_by_length(path, bins=bins).keys() == want.keys()


def test_compute_iou_matches_jax():
    rng = np.random.RandomState(1)
    a = [tuple(x) for x in np.sort(rng.uniform(0, 50, (7, 2)), 1)]
    b = [tuple(x) for x in np.sort(rng.uniform(0, 50, (5, 2)), 1)] + [(3.0, 3.0)]
    got, want = compute_iou(a, b), jax_analysis.compute_iou(a, b)
    assert len(got) == 7 * 6
    assert got == want
    # the union is the enclosing span: disjoint intervals give 0
    assert compute_iou([(0, 1)], [(2, 3)])[0][-1] == 0


@pytest.mark.parametrize("kind", ["linear", "nearest"])
@pytest.mark.parametrize("n,m", [(7, 13), (9, 4), (5, 5), (11, 31), (2, 9)])
def test_interpolate_array_matches_jax(kind, n, m):
    x = np.random.RandomState(n * 100 + m).randn(n)
    got = interpolate_array(x, m, kind=kind)
    np.testing.assert_array_equal(got, jax_analysis.interpolate_array(x, m, kind=kind))
    assert got.shape == (m,)
    if kind == "nearest":
        assert set(got) <= set(x)


def test_interpolate_array_nearest_rounds_half_down():
    # positions linspace(0, 2, 5) = 0, 0.5, 1, 1.5, 2: halves go down
    np.testing.assert_array_equal(
        interpolate_array(np.array([10.0, 20.0, 30.0]), 5, kind="nearest"),
        [10.0, 10.0, 20.0, 20.0, 30.0])
    with pytest.raises(ValueError, match="unsupported"):
        interpolate_array(np.zeros(3), 4, kind="cubic")


def _write_reference_pickle(path, monkeypatch):
    """A result pickle as the reference writes it: its Checkpoint / Video
    instances pickled by the module path libs.helper.utils (registered in
    sys.modules only while pickling), holding torch tensors and numpy
    arrays."""
    mod = types.ModuleType("libs.helper.utils")
    for name in ("Checkpoint", "Video"):
        setattr(mod, name, type(name, (), {"__module__": mod.__name__}))
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "libs", types.ModuleType("libs"))
        m.setitem(sys.modules, "libs.helper", types.ModuleType("libs.helper"))
        m.setitem(sys.modules, "libs.helper.utils", mod)
        ckpt = mod.Checkpoint()
        ckpt.iteration = 36000
        v0, v1 = mod.Video(), mod.Video()
        v0.vname, v1.vname = "vid0", "vid1"
        v0.tid = ["q0", "q1"]
        v0.abs_target = np.array([[0.0, 4.0], [10.0, 40.0]])
        v0.results = [
            {"segments": torch.tensor([[0.0, 4.0], [50.0, 60.0]]),
             "scores": torch.tensor([0.9, 0.5])},
            {"segments": torch.tensor([[10.0, 25.0]]),
             "scores": torch.tensor([0.8])}]
        v0.loss = {"focal": 0.25}
        v1.abs_target = torch.zeros((0, 2))
        v1.results = []
        ckpt.videos = {"vid0": v0, "vid1": v1}
        with open(path, "wb") as f:
            pickle.dump(ckpt, f)
    assert "libs.helper.utils" not in sys.modules


def test_load_reference_checkpoint_matches_jax(tmp_path, monkeypatch):
    path = str(tmp_path / "ckpt-6-36000.pk")
    _write_reference_pickle(path, monkeypatch)
    with open(path, "rb") as f, pytest.raises((ModuleNotFoundError, AttributeError)):
        pickle.load(f)            # plain pickle cannot resolve the classes
    got = load_reference_checkpoint(path)
    want = jax_analysis.load_reference_checkpoint(path)
    assert got.tag == want.tag == "ref-ckpt-36000"
    assert [v["vid_id"] for v in got.videos] == ["vid0", "vid1"]
    for g, w in zip(got.videos, want.videos, strict=True):
        np.testing.assert_array_equal(g["targets"], w["targets"])
        assert g["targets"].dtype == np.float64
        assert g["losses"] == w["losses"]
        assert g["ref_extra"].keys() == w["ref_extra"].keys()
        for a, b in zip(g["detections"], w["detections"], strict=True):
            for k in ("segments", "scores"):
                assert a[k].dtype == np.float32
                np.testing.assert_array_equal(a[k], b[k])
    assert got.videos[0]["ref_extra"]["tid"] == ["q0", "q1"]
    buckets = compute_iou_by_length(got, bins=(0, 5, np.inf))
    assert buckets[(0, 5)] == (1.0, 1)
    np.testing.assert_allclose(buckets[(5, np.inf)][0], 0.5)


class _Evil:
    def __reduce__(self):
        return (os.system, ("echo pwned",))


def test_reference_reader_refuses_off_list_callables(tmp_path):
    path = str(tmp_path / "evil.pk")
    with open(path, "wb") as f:
        pickle.dump(_Evil(), f)
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        load_reference_checkpoint(path)
    # a pickle of something else than a Checkpoint
    with open(path, "wb") as f:
        pickle.dump({"videos": []}, f)
    with pytest.raises(ValueError, match="not a reference Checkpoint"):
        load_reference_checkpoint(path)


def test_phase_timer_summary_matches_jax():
    got, want = PhaseTimer(), JaxPhaseTimer()
    for timer in (got, want):
        for name, s in (("prepare", 0.0123), ("forward", 0.25),
                        ("prepare", 0.004), ("nms", 1.5)):
            timer.add(name, s)
    assert got.summary() == want.summary()
    assert got.summary().startswith("prepare: total 0.016s mean 8.2ms (n=2)")
    with got.phase("post_process"):
        pass
    assert len(got.buckets["post_process"]) == 1
    got.reset()
    assert got.summary() == "" and PhaseTimer(sync=True).sync


def test_phase_timer_syncs_only_with_cuda_in_use(monkeypatch):
    """``sync`` waits for the card at the end of a phase when CUDA is in
    use; on the CPU it never calls into CUDA."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: calls.append(1))
    timer = PhaseTimer(sync=True)
    with timer.phase("forward"):
        pass
    assert calls == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with timer.phase("forward"):
        pass
    with PhaseTimer().phase("forward"):
        pass
    assert calls == [1] and len(timer.buckets["forward"]) == 2


def test_trace_writes_a_file_naming_the_region(tmp_path):
    trace_dir = str(tmp_path / "trace")
    with trace(trace_dir) as prof:
        assert prof is not None
        with annotate("decode_region"):
            torch.ones(64, 64).matmul(torch.ones(64, 64))
    files = glob.glob(os.path.join(trace_dir, "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "decode_region" for e in events)


def test_trace_without_a_directory_is_a_no_op(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with trace(None) as prof, annotate("outside_any_trace"):
        assert prof is None
    with trace("") as prof:
        assert prof is None
    assert os.listdir(tmp_path) == []
