"""The port's spans and counters (utils/profiling.py) on a tiny
GroundingService on the CPU: the decode call's parts and counters, one entry
each per call; the bytes it sends; its rows against its real rows; the
``decafnet.*`` ranges a ``torch.profiler`` trace holds, nested in the call's
own; no range when no profiler runs; the set-up record; the record's bound
and the service's summary. On the card: the stages' stream times."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from decafnet_tpu_torch.core import get_cfg_defaults, update_opt
from decafnet_tpu_torch.models import random_params
from decafnet_tpu_torch.serve import GroundingService
from decafnet_tpu_torch.utils import profiling
from decafnet_tpu_torch.utils.profiling import SETUP, PhaseTimer

# one intra-op thread per test process: the suite runs several processes
# side by side
torch.set_num_threads(1)

CV, CS, CT = 32, 32, 24
PARTS = ("decode.stage", "decode.h2d", "decode.dispatch", "decode.d2h")
COUNTERS = ("decode.h2d_bytes", "decode.rows", "decode.real_rows")
STAGES = ("model.delegation", "model.text", "model.fusion", "model.fpn",
          "model.heads", "decode.select_nms")
SENT = ("vid", "shallow_vid", "vid_masks", "text", "text_cls", "text_masks")


def _config():
    cfg = get_cfg_defaults()
    m = cfg.model
    m.name = "iter"
    m.vid_net.in_dim = CV
    m.vid_net.embd_dim = 16
    m.vid_net.max_seq_len = 64
    m.vid_net.arch = (1, 0, 3)
    m.text_net.in_dim = CT
    m.text_net.embd_dim = 16
    m.text_net.n_layers = 1
    m.fusion.n_layers = 1
    m.sratio = 0.5
    m.sn = 8
    m.msf = True
    update_opt(cfg)
    return cfg


def _service(device="cpu"):
    cfg = _config()
    return GroundingService(cfg, params=random_params(cfg, 0), device=device)


@pytest.fixture(scope="module")
def service():
    return _service()


def _request(t, tokens, seed):
    rng = np.random.RandomState(seed)
    return dict(vid=rng.randn(CV, t).astype(np.float32),
                shallow_vid=rng.randn(CS, t).astype(np.float32),
                texts=[rng.randn(CT, n).astype(np.float32) for n in tokens],
                text_cls=rng.randn(len(tokens), CS).astype(np.float32),
                fps=30.0, clip_size=32, clip_stride=16)


# three videos of one bucket (T 64, 4 query rows, 8 tokens): ground_many
# stacks them and pads the stack to 4 with an inert copy
SAME_BUCKET = [_request(40, [5, 8, 3], 1), _request(57, [8, 2, 6], 2),
               _request(64, [7, 7, 4], 3)]
# past the base length: the 2x bucket with PE interpolation plans
LONG = _request(100, [4, 6], 4)


def _sent_bytes(service, requests):
    """What a ground_many of ``requests`` (one bucket) sends, from the
    items' own arrays: each item's chunk arrays, the stack padded to a
    power of two with copies of the first, and the PE plans once per row
    when stacked (as they are at V > 1)."""
    items = [service._prepare(**r)[1][0] for r in requests]
    v = 1
    while v < len(items):
        v *= 2
    items += [items[0]] * (v - len(items))
    total = sum(it["chunk"][k].nbytes for it in items for k in SENT)
    plans = items[0]["chunk"]["pe_interp"]
    if plans is not None:
        rows = 1 if v == 1 else v * items[0]["chunk"]["text"].shape[0]
        total += rows * sum(p.nbytes for p in plans)
    return total


def test_decode_parts_one_entry_a_call_within_forward(service):
    dec = service.decoder
    dec.timer.reset()
    calls = dec.decode_calls
    service.ground(**LONG)
    service.ground_many(SAME_BUCKET)
    service.ground(**SAME_BUCKET[0])
    n = dec.decode_calls - calls
    rec = dec.time_dict
    assert n == 3
    for key in ("forward", "post_process") + PARTS + COUNTERS + STAGES:
        assert len(rec[key]) == n, key
    for forward, *parts in zip(rec["forward"], *(rec[k] for k in PARTS)):
        assert 0 < sum(parts) <= forward
    # per request: the padding ("prepare"), the lock's wait and the answer
    assert len(rec["prepare"]) == 5
    assert len(rec["serve.queue"]) == len(rec["serve.answer"]) == 3
    # no host SoftNMS ran, and no stream time without a profiler on a card
    assert "nms" not in rec
    assert not [k for k in rec if k.endswith(".stream")]


@pytest.mark.parametrize("requests", [[LONG], SAME_BUCKET[:1], SAME_BUCKET],
                         ids=["pe_plans", "one", "stacked"])
def test_h2d_bytes_count_every_array_sent(service, requests):
    want = _sent_bytes(service, requests)
    dec = service.decoder
    dec.timer.reset()
    if len(requests) == 1:
        service.ground(**requests[0])
    else:
        service.ground_many(requests)
    assert dec.time_dict["decode.h2d_bytes"] == [want]


def test_rows_against_real_rows_of_a_padded_stack(service):
    dec = service.decoder
    dec.timer.reset()
    service.ground_many(SAME_BUCKET)
    # 3 videos padded to 4, each 4 query rows; 3 x 3 real queries
    assert dec.time_dict["decode.rows"] == [16]
    assert dec.time_dict["decode.real_rows"] == [9]
    service.ground(**LONG)
    assert dec.time_dict["decode.rows"] == [16, 2]
    assert dec.time_dict["decode.real_rows"] == [9, 2]


def _ranges(prof):
    """(name, start_ns, end_ns) of the trace's ``decafnet.*`` ranges."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith(profiling.SPAN_PREFIX):
            start = ev.start_ns()
            out.append((ev.name(), start, start + ev.duration_ns()))
    return out


def _within(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_profiler_trace_holds_nested_ranges_of_the_call(service):
    dec = service.decoder
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        service.ground(**SAME_BUCKET[0])
    call = dec.decode_calls
    ranges = _ranges(prof)
    by_name = {}
    for r in ranges:
        by_name.setdefault(r[0], []).append(r)
    (outer,) = by_name[f"decafnet.call.{call}"]
    (forward,) = by_name["decafnet.forward"]
    (dispatch,) = by_name["decafnet.decode.dispatch"]
    assert _within(forward, outer)
    for name in PARTS:
        (r,) = by_name["decafnet." + name]
        assert _within(r, forward), name
    for name in STAGES:
        (r,) = by_name["decafnet." + name]
        assert _within(r, dispatch), name
    (post,) = by_name["decafnet.post_process"]
    assert _within(post, outer) and not _within(post, forward)
    # the request's own spans, outside the call
    for name in ("prepare", "serve.queue", "serve.answer"):
        (r,) = by_name["decafnet." + name]
        assert not _within(r, outer), name
    # one call, one number
    assert [n for n in by_name if n.startswith("decafnet.call.")] == [
        f"decafnet.call.{call}"]


def test_no_range_without_a_profiler(service, monkeypatch):
    entered = []
    real = torch._C._profiler._RecordFunctionFast

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counting)
    service.ground(**SAME_BUCKET[1])
    service.ground_many(SAME_BUCKET)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        service.ground(**SAME_BUCKET[1])
    assert "decafnet.forward" in entered


def test_ranges_are_no_user_annotations(service, tmp_path):
    """A user annotation that launches device work gets a device-side copy
    in the trace; the spans' ranges are operator ranges, which get none."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        service.ground(**SAME_BUCKET[1])
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kinds = {e.get("cat") for e in events
             if e.get("name", "").startswith(profiling.SPAN_PREFIX)}
    assert kinds == {"cpu_op"}


def test_setup_record_one_first_call_a_shape():
    before = {k: len(SETUP.buckets[k])
              for k in ("setup.service", "setup.first_call")}
    svc = _service()
    for _ in range(2):
        svc.ground(**SAME_BUCKET[0])       # (1 video, T 64, 4 rows, 8 tokens)
        svc.ground(**LONG)                 # (1, T 128, 2 rows, 8 tokens)
        svc.ground_many(SAME_BUCKET)       # (4 videos, T 64, 4 rows)
        svc.warmup(64, num_queries=3)      # the first shape again
    assert len(SETUP.buckets["setup.service"]) == before["setup.service"] + 1
    first = SETUP.buckets["setup.first_call"][before["setup.first_call"]:]
    assert len(first) == 3 and all(s > 0 for s in first)


def test_record_keeps_at_most_limit_entries_a_name():
    timer = PhaseTimer()
    for i in range(profiling.LIMIT + 1):
        timer.add("prepare", i)
    v = timer.buckets["prepare"]
    assert len(v) == profiling.LIMIT // 2 + 1
    assert v[0] == profiling.LIMIT // 2 and v[-1] == profiling.LIMIT
    buckets = timer.buckets
    timer.reset()
    assert timer.buckets is buckets and not buckets


def test_stats_reads_without_deleting_and_counts_as_counts(service):
    dec = service.decoder
    dec.timer.reset()
    for _ in range(3):
        service.ground(**SAME_BUCKET[2])
    for k in range(600):
        dec.timer.add("serve.queue", k * 1e-3)
    stats = service.stats()
    assert len(dec.time_dict["serve.queue"]) == 603
    assert stats["serve.queue"]["n"] == 512
    assert stats["serve.queue"]["max_ms"] == pytest.approx(599.0)
    rows = stats["decode.rows"]
    assert rows == {"n": 3, "mean": 4.0, "max": 4}
    assert stats["decode.h2d_bytes"]["max"] == dec.time_dict[
        "decode.h2d_bytes"][0]
    assert "mean_ms" in stats["forward"]
    summary = dec.timer.summary()
    assert "decode.rows: total 12 mean 4.0 (n=3)" in summary


class _Event:
    """A stand-in CUDA event on a clock of its own (ms)."""
    clock = [0.0]

    def __init__(self, enable_timing=False):
        self.at = None

    def record(self):
        _Event.clock[0] += 2.5
        self.at = _Event.clock[0]

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.at - self.at


def test_stage_stream_times_recorded_only_while_tracing(monkeypatch):
    monkeypatch.setattr(profiling, "_cuda_in_use", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    timer = PhaseTimer()
    with timer.recording(call=1):
        with profiling.stage("model.fpn"):
            pass
    timer.stream_times()
    assert "model.fpn.stream" not in timer.buckets
    with profile(activities=[ProfilerActivity.CPU]), timer.recording(call=2):
        with profiling.stage("model.fpn"):
            pass
        with profiling.stage("model.heads"):
            pass
    timer.stream_times()
    assert timer.buckets["model.fpn.stream"] == [2.5e-3]
    assert timer.buckets["model.heads.stream"] == [2.5e-3]
    assert len(timer.buckets["model.fpn"]) == 2
    # outside a record's context a stage records nothing
    with profiling.stage("model.fpn"):
        pass
    assert len(timer.buckets["model.fpn"]) == 2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: stream times come from CUDA events")
    return torch.device("cuda")


@pytest.mark.cuda
def test_stage_stream_times_on_the_card(card):
    svc = _service(card)
    svc.ground(**SAME_BUCKET[0])
    dec = svc.decoder
    dec.timer.reset()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        for _ in range(2):
            svc.ground(**SAME_BUCKET[0])
    svc.ground(**SAME_BUCKET[0])
    rec = dec.time_dict
    for name in STAGES:
        assert len(rec[name + ".stream"]) == 2, name
    for i in range(2):
        streams = sum(rec[name + ".stream"][i] for name in STAGES)
        assert 0 < streams <= rec["forward"][i]
