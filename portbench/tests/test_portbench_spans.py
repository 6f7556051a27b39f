"""The readers of the program's own spans and counters on a synthetic
context: each reads its name's window entries, none raises on a program
without them; the set-up readers read the process's set-up record; the
benchmark lists each for every cell; and a tiny traced run on the CPU
reports those that need no card."""

import time
from types import SimpleNamespace

import pytest
import torch

from portbench import harness
from portbench.tests import tiny

torch.set_num_threads(1)

# metric -> (name in the record, scale): the mean of the window's entries
MEANS = {
    "stage_ms": ("decode.stage", 1e3), "h2d_ms": ("decode.h2d", 1e3),
    "h2d_mb": ("decode.h2d_bytes", 1e-6),
    "dispatch_ms": ("decode.dispatch", 1e3), "d2h_wait_ms": ("decode.d2h", 1e3),
    "delegation_ms": ("model.delegation.stream", 1e3),
    "text_ms": ("model.text.stream", 1e3),
    "fusion_ms": ("model.fusion.stream", 1e3),
    "fpn_ms": ("model.fpn.stream", 1e3),
    "heads_ms": ("model.heads.stream", 1e3),
    "select_nms_ms": ("decode.select_nms.stream", 1e3),
}
SETUP = {"library_load_s": "setup.library", "service_init_s": "setup.service",
         "first_call_s": "setup.first_call"}
NEW = list(MEANS) + ["useful_rows"] + list(SETUP)


def ctx(**phases):
    return SimpleNamespace(phases=phases)


@pytest.mark.parametrize("metric", list(MEANS))
def test_mean_of_the_window_entries(metric):
    name, scale = MEANS[metric]
    got = harness.reader(metric)(ctx(**{name: [0.010, 0.030, 0.020],
                                        "forward": [1.0]}))
    assert got == pytest.approx(0.020 * scale)
    assert harness.reader(metric)(ctx(forward=[1.0])) is None
    assert harness.reader(metric)(ctx(**{name: []})) is None


def test_useful_rows_are_real_rows_over_rows():
    read = harness.reader("useful_rows")
    got = read(ctx(**{"decode.rows": [128, 128, 32],
                      "decode.real_rows": [128, 120, 32]}))
    assert got == pytest.approx(100.0 * 280 / 288)
    assert read(ctx(forward=[1.0])) is None


@pytest.mark.parametrize("metric", list(SETUP))
def test_setup_readers_sum_the_process_record(metric, monkeypatch):
    from decafnet_tpu_torch.utils import profiling
    record = profiling.PhaseTimer()
    record.add(SETUP[metric], 1.5)
    record.add(SETUP[metric], 0.25)
    monkeypatch.setattr(profiling, "SETUP", record)
    assert harness.reader(metric)(ctx()) == pytest.approx(1.75)
    record.reset()
    assert harness.reader(metric)(ctx()) is None
    monkeypatch.delattr(profiling, "SETUP")      # a program without it
    assert harness.reader(metric)(ctx()) is None


def test_every_cell_lists_the_new_metrics():
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    cells = [w["name"] for w in bench["workloads"]]
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = per_layer[name]
        assert m["workloads"] == cells and m["source"] == "program_span"
        assert m["moves"] == ("setup_s" if name in SETUP else "queries_per_s")
        stream = name in MEANS and MEANS[name][0].endswith(".stream")
        assert m["layer"] == ("set-up" if name in SETUP else
                              "model" if stream else "decode call")
    for cell in cells:
        assert set(NEW) <= set(harness.load_cell(cell, bench).per_layer)


def test_a_traced_run_on_the_cpu_reports_the_host_spans():
    cell = tiny.cell()
    rc, result = harness.run(tiny.args(trace=1), cell, time.perf_counter(),
                             require_cuda=False)
    assert rc == 0 and result["correct"], result["checks"]
    got = result["metrics"]
    for name in ("stage_ms", "h2d_ms", "h2d_mb", "dispatch_ms",
                 "d2h_wait_ms", "service_init_s", "first_call_s"):
        assert got[name]["value"] > 0, name
    # 4 requests of 3 queries in 4 rows each a call
    assert got["useful_rows"]["value"] == pytest.approx(75.0)
    parts = sum(got[k]["value"] for k in ("stage_ms", "h2d_ms", "dispatch_ms",
                                          "d2h_wait_ms"))
    assert parts <= got["forward_ms"]["value"]
    # no CUDA events and no kernel library on the CPU
    for name in ("fpn_ms", "select_nms_ms", "library_load_s"):
        assert name not in got
