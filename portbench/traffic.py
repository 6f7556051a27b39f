"""The one traffic generator: reads a mix's parameters
(``portbench/traffic/<mix>.json``) and draws from ``--seed`` the pool of
requests a cell serves and the order the window sends them in.

Parameters of a mix:

- ``entry``: ``ground`` (one request a call) or ``ground_many``;
- ``requests_per_call`` and ``max_group`` (``ground_many`` only);
- ``pool``: distinct requests drawn before the window;
- ``clips`` [lo, hi]: the pool's video lengths, evenly spaced from lo to hi;
- ``queries``: queries per request;
- ``tokens`` [lo, hi]: each request's query lengths, evenly spaced from lo
  to hi;
- ``fps``, ``clip_size``, ``clip_stride``: the clip grid of the features;
- ``trace_calls``: calls traced by the profiler at the start of a
  ``--trace 1`` window;
- ``check_requests``: distinct served requests the correctness check
  compares (the longest always among them).

Every seed gives the same sizes: only which request gets which length, the
order of the calls and the feature values change with it. Features are
standard normal, drawn on the device by a ``torch.Generator`` in one call
per request and handed to the service as host numpy arrays, as a client
sends them.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name):
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def spaced(lo, hi, n):
    """n whole numbers evenly spaced from lo to hi."""
    return [int(round(x)) for x in np.linspace(lo, hi, n)]


def make_pool(mix, m, seed, device="cpu"):
    """The mix's pool of requests for the ``model`` config tree ``m``."""
    rng = np.random.default_rng([int(seed), 1])
    gen = torch.Generator(device=device).manual_seed(int(seed) ^ 0x5EED)
    cv = m["vid_net"]["in_dim"]
    ct = m["text_net"]["in_dim"]
    lengths = rng.permutation(spaced(*mix["clips"], mix["pool"]))
    tokens = spaced(*mix["tokens"], mix["queries"])
    pool = []
    for t in lengths:
        toks = rng.permutation(tokens)
        sizes = [cv * t, cv * t, ct * sum(toks), mix["queries"] * cv]
        flat = torch.randn(sum(sizes), generator=gen, device=device)
        flat = flat.cpu().numpy()
        parts = np.split(flat, np.cumsum(sizes)[:-1])
        texts = np.split(parts[2].reshape(ct, -1), np.cumsum(toks)[:-1], axis=1)
        pool.append({"vid": parts[0].reshape(cv, t),
                     "shallow_vid": parts[1].reshape(cv, t),
                     "texts": [np.ascontiguousarray(x) for x in texts],
                     "text_cls": parts[3].reshape(mix["queries"], cv),
                     "fps": float(mix["fps"]),
                     "clip_size": float(mix["clip_size"]),
                     "clip_stride": float(mix["clip_stride"])})
    return pool


def schedule(mix, n_pool, seed):
    """Endless calls, each a list of pool indices: the pool in a fresh
    seeded order each cycle, ``requests_per_call`` at a time."""
    rng = np.random.default_rng([int(seed), 2])
    per_call = mix.get("requests_per_call", 1)
    stream = []
    while True:
        while len(stream) < per_call:
            stream.extend(rng.permutation(n_pool).tolist())
        call, stream = stream[:per_call], stream[per_call:]
        yield call
