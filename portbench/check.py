"""The comparison that decides ``correct``: the service's answers against
the reference's, query by query.

For each query the reference gives its first ``2k`` SoftNMS detections
(k = ``nms.max_num_segs``), so a near-tie that the program breaks the other
way still finds its partner there. Numbers, each the worst over the
compared queries:

- ``count_gap``: queries whose number of detections differs from the
  reference's (first k);
- ``top_score_gap``: |program's first score - reference's first score|;
  the first score is the best candidate's, which no tie moves;
- ``top_segment_gap``: the first detection's segment against the nearest
  voted segment of the reference's candidates that score within ``tie`` of
  its best (its heads; the best's is its own first detection): the largest
  end-point distance beyond ``ROUNDING_ULPS`` float32 units in the last
  place of that end-point (both sides state seconds in float32: at a
  32768-second movie's end one unit is 2 ms; each side's vote is a
  float32 weighted mean over the candidates it overlaps, summed in its
  own order, which a sound run was seen to leave 3 units apart at 30125
  s), over that segment's length
  (at least one clip-grid step). Rounding may reorder near-tied
  candidates, so the program's first pick may be any of them, and its
  voted segment is then held to that candidate's. This holds the
  regression head, the voting and the grid-to-seconds conversion;
- ``segment_gap``: for each program detection, the nearest reference
  detection (largest end-point distance), that distance over the
  reference segment's length (at least one clip-grid step).

The later scores are not compared one by one: where two overlapping
candidates nearly tie, which one SoftNMS takes first decides how much the
other decays, so a sound run reads as far off there as a faulty one.
``tie`` is twice the cell's ``top_score_gap`` limit: a lead that the
rounding of a sound run cannot overturn.

Where the reference's delegation nearly ties at the edge of the kept bins
(``reference.model.delegation_weights``), another summation order of the
same correlation keeps the other bin, and the reference's answer then
carries that answer too (``alternates``): the program's is held to the
nearer.

A cell's limits file (``portbench/limits/<workload>.json``) names the
numbers it holds and their limits; ``correct`` is every one within its
limit.
"""

from __future__ import annotations

import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROUNDING_ULPS = 4
NUMBERS = ("count_gap", "top_score_gap", "top_segment_gap", "segment_gap")


def load_limits(workload):
    with open(os.path.join(HERE, "limits", f"{workload}.json")) as f:
        return json.load(f)


def tie_of(limits):
    """How far below the reference's best score a candidate may be that
    the program picks first."""
    return 2.0 * limits.get("top_score_gap", 0.0)


def compare(pairs, k, tie):
    """The numbers over ``pairs`` of (program answer, reference answer,
    grid step in seconds), each answer a dict with ``segments`` and
    ``scores``, the reference's also with ``heads`` ((score, segment) rows,
    best first) and perhaps ``alternates`` (answers as correct as it: a
    near-tie of the delegation). A program answer is held to the one of
    these with its number of detections that is nearest in first score."""
    out = dict.fromkeys(NUMBERS, 0.0)
    for prog, ref, step in pairs:
        each = [pair_numbers(prog, r, step, k, tie)
                for r in [ref] + list(ref.get("alternates", []))]
        best = min(each, key=lambda x: (x["count_gap"], x["top_score_gap"]))
        out["count_gap"] += best["count_gap"]
        for name in NUMBERS[1:]:
            out[name] = max(out[name], best[name])
    return out


def pair_numbers(prog, ref, step, k, tie):
    """The numbers of one program answer against one reference answer
    (``count_gap`` 1 or 0)."""
    out = dict.fromkeys(NUMBERS, 0.0)
    ps = np.asarray(prog["scores"], np.float64).reshape(-1)
    pg = np.asarray(prog["segments"], np.float64).reshape(-1, 2)
    rs = np.asarray(ref["scores"], np.float64).reshape(-1)
    rg = np.asarray(ref["segments"], np.float64).reshape(-1, 2)
    if len(ps) != min(k, len(rs)) or len(pg) != len(ps):
        out["count_gap"] = 1.0
        return out
    if not len(ps):
        return out
    out["top_score_gap"] = float(abs(ps[0] - rs[0]))
    heads = np.asarray(ref["heads"], np.float64).reshape(-1, 3)
    near = heads[heads[:, 0] >= heads[0, 0] - tie, 1:]
    ulp = np.spacing(np.abs(near).astype(np.float32)).astype(np.float64)
    gap = (np.abs(pg[0] - near) - ROUNDING_ULPS * ulp).clip(min=0.0)
    out["top_segment_gap"] = float(
        (gap.max(axis=1) / np.maximum(near[:, 1] - near[:, 0], step)).min())
    dist = np.abs(pg[:, None, :] - rg[None, :, :]).max(axis=2)
    j = dist.argmin(axis=1)
    length = np.maximum(rg[j, 1] - rg[j, 0], step)
    out["segment_gap"] = float((dist[np.arange(len(j)), j] / length).max())
    return out


def judge(numbers, limits):
    """(correct, {name: {"value", "limit"}}) for the numbers the limits
    name."""
    checks = {name: {"value": numbers[name], "limit": limit}
              for name, limit in limits.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
