"""The correctness check fails what it must: a run of the harness (its
look for a card skipped, a tiny ``nlq``-shaped cell on the CPU, in f32,
under a cell's limits) with the served path broken underneath reads
``correct`` false, and so does the reference computed in the control
precision (TF32 for an f32 cell, fp8 for a bf16 one) put in the program's
place; the sound run reads true."""

import time

import numpy as np
import pytest
import torch

from portbench import check, harness
from portbench.tests import tiny

torch.set_num_threads(1)


WORKLOADS = ("nlq.batch16x8.f32", "mad32k.movie.f32", "nlq.batch16x8.bf16",
             "mad32k.movie.bf16")


def run(trace=0, limits="nlq.batch16x8.f32"):
    cell = tiny.cell()
    cell.limits = check.load_limits(limits)
    rc, result = harness.run(tiny.args(trace=trace), cell,
                             time.perf_counter(), require_cuda=False)
    assert rc == 0
    return result


@pytest.mark.parametrize("limits", WORKLOADS)
def test_a_sound_run_is_correct(limits):
    result = run(limits=limits)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"


def test_a_traced_sound_run_is_correct():
    result = run(trace=1)
    assert result["correct"], result["checks"]
    assert "prepare_ms" in result["metrics"]
    assert result["device"]["window_s"] > 0


@pytest.mark.parametrize("limits", WORKLOADS)
def test_an_answer_altered_where_it_is_made(monkeypatch, limits):
    from decafnet_tpu_torch.eval.evaluator import Decoder
    made = Decoder.to_seconds

    def altered(self, segs, scores, meta):
        out = made(self, segs, scores, meta)
        out["scores"] = np.asarray(out["scores"]) * 0.9
        return out

    monkeypatch.setattr(Decoder, "to_seconds", altered)
    assert not run(limits=limits)["correct"]


@pytest.mark.parametrize("limits", WORKLOADS)
def test_segments_moved_by_one_clip(monkeypatch, limits):
    from decafnet_tpu_torch.eval.evaluator import Decoder
    made = Decoder.to_seconds

    def moved(self, segs, scores, meta):
        out = made(self, segs, scores, meta)
        out["segments"] = out["segments"] + meta["clip_stride"] / meta["fps"]
        return out

    monkeypatch.setattr(Decoder, "to_seconds", moved)
    assert not run(limits=limits)["correct"]


@pytest.mark.parametrize("limits", WORKLOADS)
def test_half_of_the_batch_left_out(monkeypatch, limits):
    from decafnet_tpu_torch.eval.evaluator import Decoder
    decode = Decoder.decode_group

    def half(self, items, losses=False):
        h = max(1, len(items) // 2)
        kept = [{**it, "chunk": items[i % h]["chunk"]}
                for i, it in enumerate(items)]
        return decode(self, kept, losses)

    monkeypatch.setattr(Decoder, "decode_group", half)
    assert not run(limits=limits)["correct"]


@pytest.mark.parametrize("workload,precision", [
    ("nlq.batch16x8.f32", "tf32"), ("mad32k.movie.f32", "tf32"),
    ("nlq.batch16x8.bf16", "fp8"), ("mad32k.movie.bf16", "fp8")])
def test_the_control_is_not_correct(workload, precision):
    cell = tiny.cell()
    device = torch.device("cpu")
    state = harness.setup(cell, 5, device)
    window = harness.window(state, cell, 0.2, False, device)
    limits = check.load_limits(workload)
    tie = check.tie_of(limits)
    _, refs = harness.check_answers(state, window, device, tie)
    numbers, _ = harness.check_answers(state, window, device, tie, precision,
                                       refs)
    correct, checks = check.judge(numbers, limits)
    assert not correct, checks
