"""A cell at a size the CPU runs in seconds: the ``nlq`` configuration with
narrow widths and four FPN levels, a small ``batch16x8``-shaped mix, and the
``nlq.batch16x8.f32`` cell's limits and metrics. Test helper."""

from __future__ import annotations

import copy
from types import SimpleNamespace

from portbench import check, harness, traffic

WORKLOAD = "nlq.batch16x8.f32"


def config():
    conf = copy.deepcopy(harness.load_json(harness.HERE, "configs", "nlq.json"))
    cfg = conf["cfg"]
    m = cfg["model"]
    m["vid_net"].update(in_dim=16, embd_dim=16, max_seq_len=64, arch=[2, 0, 4])
    m["text_net"].update(in_dim=12, embd_dim=16)
    m.update(max_vid_len=64, num_fpn_levels=4, sn=6)
    m["fusion"].update(text_dim=16, vid_dim=16)
    m["cls_head"]["embd_dim"] = 16
    m["reg_head"].update(embd_dim=16, num_fpn_levels=4)
    cfg["data"]["max_vid_len"] = 64
    cfg["pt_gen"].update(num_fpn_levels=4, max_seq_len=256)
    return conf


def mix(**kw):
    out = dict(traffic.load("batch16x8"))
    out.update(requests_per_call=4, max_group=4, pool=8, clips=[20, 64],
               queries=3, tokens=[3, 9], trace_calls=2,
               check_requests=4)
    out.update(kw)
    return out


def cell(**mix_kw):
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    real = harness.load_cell(WORKLOAD, bench)
    return SimpleNamespace(
        name=WORKLOAD, entry={"chips": 1}, units=real.units,
        config=config(), mix=mix(**mix_kw),
        limits=check.load_limits(WORKLOAD),
        end_to_end=real.end_to_end, per_layer=real.per_layer)


def args(seed=5, seconds=0.5, trace=0):
    return SimpleNamespace(workload=WORKLOAD, seed=seed, seconds=seconds,
                           trace=trace)
