"""One run of one cell: set-up, the measured window, the traced window's
reading, the correctness check and the result line.

The cell (``BENCHMARK.json`` workload) names a configuration
(``configs/<config>.json``: the full config tree the service is built from,
its compute dtype) and a traffic mix (``traffic/<mix>.json``); each metric
the cell reports is read by ``metrics/<metric>.py``; its correctness limits
are ``limits/<workload>.json``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import check, counts, trace, traffic
from .reference import decode as ref_decode
from .reference.weights import flax_tree, make_weights

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "decafnet_tpu")
SEED_MOD = 1 << 62
WARMUP_CALLS = 2


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(workload, bench=None):
    """The workload's entry, configuration, traffic mix, limits and the
    end-to-end and per-layer metric names it reports."""
    bench = bench or load_json(ROOT, "BENCHMARK.json")
    entry = {w["name"]: w for w in bench["workloads"]}[workload]

    def reported(metrics):
        return [x["name"] for x in metrics
                if workload in x.get("workloads", [workload])]

    return SimpleNamespace(
        name=workload, entry=entry,
        units={x["name"]: x["unit"]
               for x in bench["end_to_end"] + bench["per_layer"]},
        config=load_json(HERE, "configs", f"{entry['config']}.json"),
        mix=traffic.load(entry["traffic"]),
        limits=check.load_limits(workload),
        end_to_end=reported(bench["end_to_end"]),
        per_layer=reported(bench["per_layer"]))


def reader(metric):
    """``metrics/<metric>.py``'s ``read(ctx)``."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def service_config(config):
    """The port's config tree of a configuration file."""
    from decafnet_tpu_torch.core import CfgNode
    cfg = CfgNode.from_dict(config["cfg"])
    cfg.tpu.compute_dtype = config["compute_dtype"]
    return cfg


def call_service(service, mix, requests):
    """One call of the mix's entry point; returns one answer per request."""
    if mix["entry"] == "ground":
        return [service.ground(**r) for r in requests]
    return service.ground_many(requests, max_group=mix["max_group"])


def setup(cell, seed, device):
    """Weights, the service, the request pool and the warm-up of the
    cell's bucket: everything before the window."""
    from decafnet_tpu_torch.serve import GroundingService
    cfg = service_config(cell.config)
    m = cell.config["cfg"]["model"]
    weights = make_weights(m, seed % SEED_MOD, device)
    service = GroundingService(cfg, params=flax_tree(weights), device=device)
    pool = traffic.make_pool(cell.mix, m, seed % SEED_MOD, device)
    calls = traffic.schedule(cell.mix, len(pool), seed % SEED_MOD)
    for _ in range(WARMUP_CALLS):
        call_service(service, cell.mix, [pool[i] for i in next(calls)])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return SimpleNamespace(service=service, weights=weights, pool=pool,
                           calls=calls, m=m, cfg=cell.config["cfg"],
                           check_ids=check_sample(pool, cell.mix, seed))


def check_sample(pool, mix, seed):
    """The requests whose answers the check compares, drawn from the seed:
    the longest of the pool and ``check_requests`` - 1 others."""
    rng = np.random.default_rng([seed % SEED_MOD, 3])
    longest = max(range(len(pool)), key=lambda i: pool[i]["vid"].shape[1])
    others = [i for i in range(len(pool)) if i != longest]
    n = min(len(others), mix["check_requests"] - 1)
    return [longest] + sorted(rng.choice(others, n, replace=False).tolist())


def _spans(service):
    """Benchmark spans around the calls into the service's layers (request
    preparation, the decode call), on the service object only."""
    from torch.profiler import record_function

    def wrap(obj, name, label):
        fn = getattr(obj, name, None)
        if fn is None:      # a program without this layer: no span
            return

        def spanned(*a, **kw):
            with record_function(trace.SPAN_PREFIX + label):
                return fn(*a, **kw)
        setattr(obj, name, spanned)

    wrap(service, "_prepare", "prepare")
    wrap(getattr(service, "decoder", None), "decode_group", "decode_group")


def window(state, cell, seconds, traced, device):
    """The measured window: calls in the schedule's order, back to back,
    until ``seconds`` have passed. With ``traced`` the first
    ``trace_calls`` calls run under the profiler."""
    service, mix = state.service, cell.mix
    phases0 = {k: len(v) for k, v in _timers(service).items()}
    calls0 = _decode_calls(service)
    lat, shapes, failed, attempted, queries = [], [], 0, 0, 0
    kept = {i: [] for i in state.check_ids}     # answers the check reads
    prof = traced_shapes = None
    traced_calls = mix.get("trace_calls", 8) if traced else 0
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function
        _spans(service)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.start()
        span = record_function(trace.WINDOW)
        span.__enter__()
    # the set-up's objects leave the collector's view: its passes in the
    # window then scan only what the window makes
    gc.collect()
    gc.freeze()
    t_start = time.perf_counter()
    deadline = t_start + seconds
    n = 0
    while True:
        ids = next(state.calls)
        requests = [state.pool[i] for i in ids]
        attempted += len(requests)
        t0 = time.perf_counter()
        try:
            answers = call_service(service, mix, requests)
        except Exception as e:  # noqa: BLE001 -- counted, then reported
            failed += len(requests)
            print(f"call failed: {type(e).__name__}: {e}", file=sys.stderr)
            answers = None
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        if answers is not None:
            queries += sum(len(a) for a in answers)
            for i, a in zip(ids, answers):
                if i in kept:
                    kept[i].append(a)
            group = mix.get("max_group", 1) if mix["entry"] != "ground" else 1
            shapes.extend(counts.decode_calls(requests, state.cfg, group))
        n += 1
        if traced and n == traced_calls:
            span.__exit__(None, None, None)
            prof.stop()
            traced_shapes = list(shapes)
            traced_decodes = _decode_calls(service) - calls0
        if t1 >= deadline and n >= traced_calls:
            break
    window_s = t1 - t_start
    gc.unfreeze()
    phases = {k: v[phases0.get(k, 0):] for k, v in _timers(service).items()}
    return SimpleNamespace(
        window_s=window_s, latencies=lat, kept=kept, shapes=shapes,
        attempted=attempted, failed=failed, queries=queries,
        decode_calls=_decode_calls(service) - calls0, phases=phases,
        trace=trace.read(prof) if traced else None, traced_n=traced_calls,
        traced_shapes=traced_shapes,
        traced_decodes=traced_decodes if traced else None)


def _timers(service):
    """The service's phase timers (``Decoder.time_dict``), or none."""
    return getattr(getattr(service, "decoder", None), "time_dict", {})


def _decode_calls(service):
    """The service's count of decode calls (``Decoder.decode_calls``)."""
    return getattr(getattr(service, "decoder", None), "decode_calls", 0)


def check_answers(state, run, device, tie, precision="f32", reference=None):
    """The comparison numbers (:func:`check.compare`) of :func:`answer_pairs`,
    and the reference's answers (to reuse); None when the window answered
    no request of the sample."""
    pairs, refs = answer_pairs(state, run, device, precision, reference)
    if not refs:
        return None, {}
    return check.compare(pairs, state.cfg["nms"]["max_num_segs"], tie), refs


def answer_pairs(state, run, device, precision="f32", reference=None):
    """(program answer, reference answer, grid step) for every answer the
    window gave to the check's sample of requests (:func:`check_sample`),
    and the reference's answers by request id (to reuse). With
    ``reference`` (those answers, in f32) the answers paired are the
    reference's own in ``precision``: the control."""
    sample = [i for i in state.check_ids if run.kept[i]]
    if not sample:
        return [], {}
    k = state.cfg["nms"]["max_num_segs"]
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    refs = dict(reference or {})
    pairs = []
    for i in sample:
        req = state.pool[i]
        if i not in refs:
            refs[i] = ref_decode.ground(state.weights, state.cfg, req, k=2 * k,
                                        device=device, alternates=True)
        step = req["clip_stride"] / req["fps"]
        if reference is None:
            answers = run.kept[i]
        else:
            answers = [ref_decode.ground(state.weights, state.cfg, req, k=k,
                                         precision=precision, device=device)]
        for answer in answers:
            pairs.extend((p, r, step) for p, r in zip(answer, refs[i]))
    return pairs, refs


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def device_of(require_cuda, chips):
    if not require_cuda:
        return torch.device("cpu")
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return None
    return torch.device("cuda", 0)


def run(args, cell, t_process, require_cuda=True):
    """One run of ``cell`` (see the module doc); returns (exit code, result
    dict or None). ``t_process`` is the process's start on the host clock:
    set-up counts from there."""
    device = device_of(require_cuda, cell.entry["chips"])
    if device is None:
        print(f"no CUDA device for {cell.name} (needs {cell.entry['chips']}; "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count()})", file=sys.stderr)
        return 2, None
    state = setup(cell, args.seed, device)
    setup_s = time.perf_counter() - t_process
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    run_ = window(state, cell, args.seconds, bool(args.trace), device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    ctx = SimpleNamespace(
        setup_s=setup_s, dtype=cell.config["compute_dtype"], model=state.m,
        window_s=run_.window_s, latencies=run_.latencies,
        traced_n=run_.traced_n,
        queries=run_.queries, calls=run_.shapes, phases=run_.phases,
        decode_calls=run_.decode_calls, trace=run_.trace,
        traced_calls=run_.traced_shapes, traced_decodes=run_.traced_decodes)
    names = cell.per_layer if args.trace else cell.end_to_end
    units = cell.units
    metrics = {}
    for name in names:
        value = reader(name)(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}

    state.service = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, _ = check_answers(state, run_, device, check.tie_of(cell.limits))
    if numbers is None:
        correct, checks = False, {}
    else:
        correct, checks = check.judge(numbers, cell.limits)
    correct = correct and run_.failed == 0
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 3, None
    result = {"correct": correct, "attempted": run_.attempted,
              "failed": run_.failed, "metrics": metrics,
              "device": device_record(device, cell, peak, run_.trace)}
    if run_.trace is not None:
        result["breakdown"] = {"device_ops": run_.trace.device_ops,
                               "idle_gaps": run_.trace.idle_gaps}
    result["checks"] = checks
    return 0, result


def device_record(device, cell, peak, tr):
    if device.type == "cuda":
        rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": cell.entry["chips"], "memory_peak_bytes": peak}
    else:
        rec = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": peak}
    if tr is not None:
        rec["busy_s"] = tr.busy_s
        rec["window_s"] = tr.window_s
    return rec
