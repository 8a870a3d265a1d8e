"""The yardstick's counts against hand counts."""

from __future__ import annotations

import pytest

from portbench import flops, models, spec


def _sizes(name):
    return models.sizes(spec.load_json(spec.HERE / "configs" / f"{name}.json"),
                        4224)


def test_live_pairs_by_hand():
    assert flops.live_pairs(4, None) == 1 + 2 + 3 + 4
    assert flops.live_pairs(5, 2) == 1 + 2 + 2 + 2 + 2
    assert flops.live_pairs(3, 8) == 6


def test_flash_fwd_work_at_one_mistral_row():
    s = _sizes("mistral-7b")
    ops, nbytes = flops.flash_fwd_work(s, 4100)
    pairs = 4096 * 4097 // 2 + 4 * 4096
    assert ops == 4 * 128 * 32 * pairs
    # q and o at 32 heads, k and v at 8, 128 wide, 2 bytes each
    assert nbytes == 4100 * 128 * (32 + 32 + 8 + 8) * 2


def test_forward_flops_by_hand_for_gpt2_xl():
    s = _sizes("gpt2-xl")
    d, ff, v, L = 1600, 6400, 50257, 48
    per_token = 2 * (L * (3 * d * d + d * d + 2 * d * ff) + d * v)
    assert flops.forward_flops(s, 2, 10) == 20 * per_token + L * 2 * 4 * 100 * d


def test_request_flops_is_prefill_plus_each_decode_step():
    s = _sizes("mistral-7b")
    want = flops.forward_flops(s, 1, 100) + sum(
        flops.matmul_flops_per_token(s) + 4.0 * (100 + j) * 4096 * 32
        for j in range(1, 8))
    assert flops.request_flops(s, 100, 8) == pytest.approx(want, rel=1e-12)


def test_mistral_parameters_are_the_published_7_24_billion():
    s = _sizes("mistral-7b")
    per_token = flops.matmul_flops_per_token(s) / 2 + s.vocab * s.d_model
    assert per_token == pytest.approx(7.24e9, rel=0.005)


def test_least_seconds_takes_the_bound_that_binds():
    assert flops.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert flops.least_seconds(0, 3.35e12) == pytest.approx(1.0)
