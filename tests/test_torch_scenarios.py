"""The port's arrival processes and scenario scripts (``sim/scenarios.py``
and ``sim/twin/scenario.py``) against the reference's.

Both are pure Python (numpy for the twin's scripts), so the reference
runs in process: every process integrates to the same float64 bits on
the same windows, the seeded variants draw the same worlds, and the
tenant scripts, token streams and heavy-tail lengths are equal.
"""

from __future__ import annotations

import dataclasses
import math

import pytest

from kube_sqs_autoscaler_tpu.sim import scenarios as ref
from kube_sqs_autoscaler_tpu_torch.sim import scenarios as port


def build(module):
    """The same process family in either module."""
    return [
        module.ConstantArrival(rate=42.0),
        module.StepArrival(before=20.0, after=120.0, at=100.0),
        module.RampArrival(start_rate=10.0, end_rate=150.0, t_start=60.0,
                           t_end=660.0),
        module.DiurnalArrival(base=80.0, amplitude=60.0, period=450.0,
                              phase=33.0),
        module.BurstArrival(base=25.0, burst_rate=250.0, period=300.0,
                            burst_len=45.0, first_burst=120.0),
        module.PulseArrival(rate=60.0, start=30.0, width=20.0),
        module.ComposedArrival(parts=(
            module.ConstantArrival(rate=9.0),
            module.PulseArrival(rate=60.0, start=3.0, width=1.5))),
        module.RegimeSwitchArrival(regimes=(
            (0.0, module.ConstantArrival(rate=8.0)),
            (4.2, module.BurstArrival(base=16.0, burst_rate=56.0,
                                      period=2.4, burst_len=0.84)),
            (9.6, module.ConstantArrival(rate=6.0)))),
    ]


NAMES = [type(p).__name__ for p in build(port)]
WINDOWS = [(0.0, 5.0), (0.0, 900.0), (95.0, 105.0), (100.0, 100.0),
           (119.9, 165.1), (333.3, 666.6), (58.0, 62.0), (2.5, 11.25)]


def plain(value):
    """A value with the module's classes replaced by their field dicts."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return (type(value).__name__,
                {f.name: plain(getattr(value, f.name))
                 for f in dataclasses.fields(value)})
    if isinstance(value, (list, tuple)):
        return type(value)(plain(v) for v in value)
    if isinstance(value, dict):
        return {k: plain(v) for k, v in value.items()}
    return value


@pytest.mark.parametrize("index", range(len(NAMES)), ids=NAMES)
def test_integrals_and_rates_are_the_references_bits(index):
    mine, want = build(port)[index], build(ref)[index]
    for t0, t1 in WINDOWS:
        assert mine.arrivals_between(t0, t1) == want.arrivals_between(t0, t1)
        assert mine.rate_at(t1) == want.rate_at(t1)


@pytest.mark.parametrize("seed", [0, 101, 202, 301])
@pytest.mark.parametrize("index", range(len(NAMES)), ids=NAMES)
def test_variants_draw_the_references_worlds(index, seed):
    mine, want = build(port)[index], build(ref)[index]
    for i in range(3):
        a = port.arrival_variant(mine, seed, "world", i, 0.2)
        b = ref.arrival_variant(want, seed, "world", i, 0.2)
        assert plain(a) == plain(b)
        assert a.arrivals_between(0.0, 50.0) == b.arrivals_between(0.0, 50.0)
    assert port.variant_bounds(mine, 0.3) == ref.variant_bounds(want, 0.3)


@pytest.mark.parametrize("seed", [101, 202])
def test_scenario_variants_of_the_battery(seed):
    from kube_sqs_autoscaler_tpu.sim.evaluate import default_battery as rb
    from kube_sqs_autoscaler_tpu_torch.sim.evaluate import default_battery

    mine = port.scenario_variants(list(default_battery()), 3, seed=seed)
    want = ref.scenario_variants(list(rb()), 3, seed=seed)
    assert [plain(s) for s in mine] == [plain(s) for s in want]


@pytest.mark.parametrize("n,lo,hi,alpha", [(50, 1, 6, 1.1), (200, 2, 64, 0.8),
                                           (7, 3, 3, 2.0)])
def test_heavy_tail_lengths_and_token_streams(n, lo, hi, alpha):
    assert port.heavy_tail_lengths(f"t{n}", n, lo, hi, alpha) == \
        ref.heavy_tail_lengths(f"t{n}", n, lo, hi, alpha)
    assert port.seeded_token_ids(f"p{n}", n, 8192) == \
        ref.seeded_token_ids(f"p{n}", n, 8192)
    assert port.tenant_prefix_ids(f"tenant{n}", lo + 4, 32) == \
        ref.tenant_prefix_ids(f"tenant{n}", lo + 4, 32)


@pytest.mark.parametrize("name", [
    "flood_scenario", "prefix_share_scenario", "coordinated_flood_scenario",
    "zipf_scenario", "flash_crowd_scenario", "admission_scale_scenario",
    "disagg_scenario"])
def test_tenant_scripts_equal_the_references(name):
    mine, want = getattr(port, name)(), getattr(ref, name)()
    assert plain(mine) == plain(want)
    assert mine.schedule() == want.schedule()
    assert mine.total_requests() == want.total_requests()
    assert plain(port.without_flood(mine)) == plain(ref.without_flood(want))


@pytest.mark.parametrize("name", ["default_tenant_battery", "overload_battery",
                                  "admission_scale_battery"])
def test_tenant_batteries_equal_the_references(name):
    assert plain(getattr(port, name)()) == plain(getattr(ref, name)())


def test_draft_probe_prompts_and_as_process():
    assert port.draft_probe_prompts(4, 6, 512, seed=3) == \
        ref.draft_probe_prompts(4, 6, 512, seed=3)
    wrapped = port.as_process(12.5)
    assert isinstance(wrapped, port.ConstantArrival)
    assert wrapped.arrivals_between(0.0, 4.0) == 50.0
    process = port.RampArrival(start_rate=1.0, end_rate=2.0, t_start=0.0,
                               t_end=1.0)
    assert port.as_process(process) is process


def test_validation_messages_match():
    for module in (port, ref):
        with pytest.raises(ValueError) as err:
            module.DiurnalArrival(base=10.0, amplitude=20.0, period=60.0)
        with pytest.raises(ValueError) as err2:
            module.BurstArrival(base=1.0, burst_rate=2.0, period=10.0,
                                burst_len=20.0)
        if module is port:
            mine = (str(err.value), str(err2.value))
        else:
            assert mine == (str(err.value), str(err2.value))


def test_time_varying_world_matches_the_seed_constant_style_closely():
    from kube_sqs_autoscaler_tpu_torch.sim import SimConfig, Simulation

    seed = Simulation(SimConfig(arrival_rate=40.0, duration=300.0)).run()
    const = Simulation(SimConfig(arrival_rate=port.ConstantArrival(40.0),
                                 duration=300.0)).run()
    assert [r for _, _, r in seed.timeline] == \
        [r for _, _, r in const.timeline]
    assert math.isclose(seed.max_depth, const.max_depth, rel_tol=1e-12)
