"""The generator: one seed gives the same bytes; another seed gives the
same work in another order."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import spec, traffic

MIXES = ("rag-backlog", "chat-rate", "chat-backlog")


def _mix(name):
    return spec.load_json(spec.HERE / "traffic" / f"{name}.json")


@pytest.mark.parametrize("name", MIXES)
def test_one_seed_gives_identical_bodies(name):
    mix = _mix(name)
    a = traffic.Prompts(mix["prompt"], 2 ** 31 + 99, 32000).take(300)
    b = traffic.Prompts(mix["prompt"], 2 ** 31 + 99, 32000).take(300)
    assert [traffic.body(x) for x in a] == [traffic.body(x) for x in b]


@pytest.mark.parametrize("name", MIXES)
def test_another_seed_reorders_the_same_lengths(name):
    mix = _mix(name)
    n = mix["prompt"]["set_size"]
    a = traffic.Prompts(mix["prompt"], 1, 32000).take(n)
    b = traffic.Prompts(mix["prompt"], 2, 32000).take(n)
    assert [traffic.body(x) for x in a] != [traffic.body(x) for x in b]
    assert sorted(map(len, a)) == sorted(map(len, b))
    lengths = [len(x) for x in a]
    assert min(lengths) >= mix["prompt"]["min"]
    assert max(lengths) <= min(mix["prompt"]["max"], mix["bucket"])


def test_rate_arrivals_repeat_and_keep_their_count_and_mean():
    rate = _mix("chat-rate")["rate"]
    a = traffic.arrivals(rate, 7, 0.0, 60.0)
    assert a == traffic.arrivals(rate, 7, 0.0, 60.0)
    b = traffic.arrivals(rate, 8, 0.0, 60.0)
    assert a != b and len(a) == len(b)
    assert abs(len(a) / 60.0 - rate["per_s"]) <= 0.1 * rate["per_s"]
    # every period holds the same count
    per_period = np.bincount((np.asarray(a) // rate["period_s"]).astype(int))
    assert per_period.min() == per_period.max()


def test_seeds_past_32_bits_and_negative_ones_work():
    mix = _mix("chat-backlog")
    for seed in (2 ** 33 + 5, -3):
        assert len(traffic.Prompts(mix["prompt"], seed, 100).take(3)) == 3
