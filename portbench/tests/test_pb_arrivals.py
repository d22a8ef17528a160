"""The generator is deterministic from the seed and gives every seed the
same work."""

import random

from portbench.harness import arrivals, fleet

POISSON = {"process": "poisson", "rate_per_s": 40.0}


def test_same_seed_same_schedule():
    a = arrivals.schedule(POISSON, 30, random.Random(2 ** 33 + 5))
    b = arrivals.schedule(POISSON, 30, random.Random(2 ** 33 + 5))
    assert a == b


def test_every_seed_same_gaps_in_another_order():
    a = arrivals.schedule(POISSON, 30, random.Random(1))
    b = arrivals.schedule(POISSON, 30, random.Random(2))
    assert a != b and len(a) == len(b) == 1200
    gaps = lambda xs: sorted(round(y - x, 9) for x, y in zip([0] + xs, xs))
    assert gaps(a) == gaps(b)
    assert 0 < a[0] and b[-1] < 30 and a[-1] < 30


def test_closed_loop_has_no_schedule():
    assert arrivals.schedule({"process": "closed", "outstanding": 4}, 10,
                             random.Random(0)) is None


def test_ids_from_the_seed():
    from portbench.harness import spec
    cfg = spec.config("c3-10k-batch")
    one = [fleet.build_node(cfg, i, random.Random(9)).ID for i in range(1)]
    two = [fleet.build_node(cfg, i, random.Random(9)).ID for i in range(1)]
    assert one == two
    j1 = fleet.build_job(cfg, random.Random(11))
    j2 = fleet.build_job(cfg, random.Random(11))
    assert j1.ID == j2.ID and j1.TaskGroups[0].Count == 50
