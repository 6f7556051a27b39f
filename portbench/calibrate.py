"""Readings for a cell's correctness limits: for each seed, in one process,
the cell's set-up and a short window at its own load, then the comparison
numbers of the served answers against the reference (the program's
reading) and of the reference computed in the control precision against
the same reference (the control's reading). One JSON line per seed, with
the number of queries whose reference answer carries a delegation
alternate, and the most reference heads that scored within the cell's tie
(``check.tie_of``) of a query's best: at ``reference.decode.HEADS`` the
heads may not hold every candidate the program can pick first. With
``--dump`` each compared pair's first detections also go to a JSON-lines
file (:func:`firsts`), to weigh another number against the same answers.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \
        --seconds 10 --control tf32|fp8 [--dump <file>]

Run on the card the cell asks for.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import check, harness  # noqa: E402


def most_near(pairs, tie):
    """The most reference heads within ``tie`` of their query's best."""
    return max((int((r["heads"][:, 0] >= r["heads"][0, 0] - tie).sum())
                for _, r, _ in pairs if len(r["heads"])), default=0)


def firsts(pairs, heads=8):
    """Per pair: the step, the first score and segment, and the
    reference's ``heads`` best (score, voted segment) rows."""
    rows = []
    for p, r, step in pairs:
        first = ([float(p["scores"][0])] + [float(x) for x in
                                            p["segments"][0]]
                 if len(p["scores"]) else [])
        rows.append([step, first,
                     np.asarray(r["heads"][:heads], np.float64).tolist()])
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--control", choices=("tf32", "fp8"), required=True)
    parser.add_argument("--dump", default=None)
    args = parser.parse_args(argv)
    cell = harness.load_cell(args.workload)
    device = harness.device_of(True, cell.entry["chips"])
    if device is None:
        print("no CUDA device", file=sys.stderr)
        return 2
    tie = check.tie_of(cell.limits)
    k = cell.config["cfg"]["nms"]["max_num_segs"]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        state = harness.setup(cell, seed, device)
        t1 = time.perf_counter()
        run = harness.window(state, cell, args.seconds, False, device)
        state.service = None
        gc.collect()
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        pairs, refs = harness.answer_pairs(state, run, device)
        t3 = time.perf_counter()
        cpairs, _ = harness.answer_pairs(state, run, device, args.control,
                                         refs)
        t4 = time.perf_counter()
        program = check.compare(pairs, k, tie)
        control = check.compare(cpairs, k, tie)
        print(json.dumps({
            "workload": cell.name, "seed": seed,
            "program": program,
            "control": {"precision": args.control, **control},
            "queries_per_s": run.queries / run.window_s,
            "calls": len(run.latencies), "checked_requests": len(refs),
            "most_near_heads": most_near(pairs, tie),
            "alternate_queries": sum("alternates" in a for r in refs.values()
                                     for a in r),
            "setup_s": t1 - t0, "reference_s": t3 - t2,
            "control_s": t4 - t3,
            "device": torch.cuda.get_device_name(device)}), flush=True)
        if args.dump:
            with open(args.dump, "a") as f:
                f.write(json.dumps({"seed": seed, "program": firsts(pairs),
                                    "control": firsts(cpairs)}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
