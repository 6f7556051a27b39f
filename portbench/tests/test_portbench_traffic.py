"""The traffic generator: seeded, the same sizes for every seed."""

import numpy as np
import torch

from portbench import traffic

torch.set_num_threads(1)

M = {"vid_net": {"in_dim": 6}, "text_net": {"in_dim": 5}}
MIX = {"entry": "ground_many", "requests_per_call": 3, "max_group": 4,
       "pool": 5, "clips": [10, 30], "queries": 4, "tokens": [2, 5],
       "fps": 30.0, "clip_size": 32, "clip_stride": 16}


def same(a, b):
    return all(np.array_equal(x["vid"], y["vid"])
               and np.array_equal(x["shallow_vid"], y["shallow_vid"])
               and np.array_equal(x["text_cls"], y["text_cls"])
               and all(np.array_equal(s, t) for s, t in zip(x["texts"], y["texts"]))
               for x, y in zip(a, b))


def test_pool_same_for_a_seed_and_differs_for_another():
    a = traffic.make_pool(MIX, M, 3_000_000_017)
    b = traffic.make_pool(MIX, M, 3_000_000_017)
    c = traffic.make_pool(MIX, M, 3_000_000_018)
    assert same(a, b)
    assert not same(a, c)


def test_every_seed_draws_the_same_sizes():
    sizes = set()
    for seed in (1, 2, 99):
        pool = traffic.make_pool(MIX, M, seed)
        sizes.add((tuple(sorted(r["vid"].shape[1] for r in pool)),
                   tuple(sorted(tuple(sorted(t.shape[1] for t in r["texts"]))
                                for r in pool))))
        for r in pool:
            assert r["vid"].shape[0] == 6 and r["text_cls"].shape == (4, 6)
            assert all(t.shape[0] == 5 for t in r["texts"])
    assert len(sizes) == 1
    lengths, tokens = sizes.pop()
    assert lengths == (10, 15, 20, 25, 30)
    assert tokens[0] == (2, 3, 4, 5)


def test_schedule_cycles_the_pool_in_seeded_order():
    a = traffic.schedule(MIX, 5, 7)
    b = traffic.schedule(MIX, 5, 7)
    calls = [next(a) for _ in range(10)]
    assert calls == [next(b) for _ in range(10)]
    flat = [i for c in calls for i in c]
    assert all(len(c) == 3 for c in calls)
    for s in range(0, 30, 5):
        assert sorted(flat[s:s + 5]) == [0, 1, 2, 3, 4]
    other = traffic.schedule(MIX, 5, 8)
    assert [next(other) for _ in range(10)] != calls


def test_shipped_mixes_load():
    for name in ("movie", "batch16x8"):
        mix = traffic.load(name)
        assert mix["entry"] in ("ground", "ground_many")
        assert mix["pool"] >= mix.get("requests_per_call", 1)
