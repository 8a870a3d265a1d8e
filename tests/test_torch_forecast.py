"""The port's forecasting (``forecast/``) held against the JAX package's.

Mirrors ``tests/test_forecast.py`` whole and the ``TenantAwareDepth``
cases of ``tests/test_overload.py``, on the port with ``device="cpu"``:

- the ring buffer (numpy) equals the reference's sample for sample;
- each forecaster's float32 output equals the reference's within
  ``rtol 1e-5`` / ``atol 1e-4`` on seeded numpy histories: near-empty,
  partly filled, full and wrapped, at epoch-scale clock values;
- ``PredictivePolicy`` and ``TenantAwareDepth`` take the reference's
  decisions, and a ``ControlLoop`` episode over a ramp and a drain gives
  the reference's decisions and replica trajectory for every forecaster;
- the history's durable section round-trips, and a rehydration through
  ``DurableStateStore`` restores the reference's samples;
- the worker binary's tenant fleet (``--fleet-max-replicas --tenants``)
  gates on the SLO-weighted staged backlog, as the reference binary does:
  its replica trajectory equals the reference's on a stepped clock.
"""

from __future__ import annotations

import itertools
import json

import numpy as np
import pytest

from kube_sqs_autoscaler_tpu import forecast as ref
from kube_sqs_autoscaler_tpu.core import durable as ref_durable
from kube_sqs_autoscaler_tpu.core.clock import FakeClock as RefClock
from kube_sqs_autoscaler_tpu.core.loop import ControlLoop as RefLoop
from kube_sqs_autoscaler_tpu.core.loop import LoopConfig as RefLoopConfig
from kube_sqs_autoscaler_tpu.core.policy import PolicyConfig as RefPolicy
from kube_sqs_autoscaler_tpu.core.policy import PolicyState as RefState
from kube_sqs_autoscaler_tpu.forecast import tenants as ref_tenants
from kube_sqs_autoscaler_tpu.metrics import FakeQueueService as RefQueue
from kube_sqs_autoscaler_tpu.metrics import QueueMetricSource as RefSource
from kube_sqs_autoscaler_tpu.scale import FakeDeploymentAPI as RefAPI
from kube_sqs_autoscaler_tpu.scale import PodAutoScaler as RefScaler
from kube_sqs_autoscaler_tpu.workloads.tenancy import (
    TenancyConfig as RefTenancy,
)
from kube_sqs_autoscaler_tpu_torch import forecast
from kube_sqs_autoscaler_tpu_torch.core import durable
from kube_sqs_autoscaler_tpu_torch.core.clock import FakeClock
from kube_sqs_autoscaler_tpu_torch.core.events import (
    CompositeTickObserver,
    TickRecord,
)
from kube_sqs_autoscaler_tpu_torch.core.loop import ControlLoop, LoopConfig
from kube_sqs_autoscaler_tpu_torch.core.policy import PolicyConfig, PolicyState
from kube_sqs_autoscaler_tpu_torch.forecast import (
    DepthHistory,
    EwmaForecaster,
    HoltForecaster,
    LeastSquaresForecaster,
    PredictivePolicy,
    ReactivePolicy,
    forecasters,
    make_forecaster,
)
from kube_sqs_autoscaler_tpu_torch.forecast.tenants import (
    OTHER_TENANTS,
    TenantAwareDepth,
    TenantDepthHistory,
    slo_urgency_weights,
)
from kube_sqs_autoscaler_tpu_torch.metrics.fake import FakeQueueService
from kube_sqs_autoscaler_tpu_torch.metrics.queue import QueueMetricSource
from kube_sqs_autoscaler_tpu_torch.scale.actuator import PodAutoScaler
from kube_sqs_autoscaler_tpu_torch.scale.fake import FakeDeploymentAPI
from kube_sqs_autoscaler_tpu_torch.workloads.tenancy import TenancyConfig

RTOL, ATOL = 1e-5, 1e-4
NAMES = ("ewma", "holt", "lstsq")


def cpu(name: str, **params):
    return make_forecaster(name, device="cpu", **params)


# --------------------------------------------------------------------------
# DepthHistory


def test_history_fills_then_wraps_chronologically():
    h = DepthHistory(capacity=4)
    for i in range(7):
        h.observe(float(i), float(i * 10))
    times, depths, n = h.snapshot()
    assert n == 4
    assert times.tolist() == [3.0, 4.0, 5.0, 6.0]
    assert depths.tolist() == [30.0, 40.0, 50.0, 60.0]


def test_history_partial_snapshot_pads_with_newest_sample():
    h = DepthHistory(capacity=4)
    h.observe(1.0, 5.0)
    h.observe(2.0, 7.0)
    times, depths, n = h.snapshot()
    assert n == 2
    assert times.tolist() == [1.0, 2.0, 2.0, 2.0]
    assert depths.tolist() == [5.0, 7.0, 7.0, 7.0]


def test_with_sample_is_pure_and_drops_oldest_when_full():
    h = DepthHistory(capacity=3)
    for i in range(3):
        h.observe(float(i), float(i))
    times, depths, n = h.with_sample(3.0, 99.0)
    assert n == 3
    assert times.tolist() == [1.0, 2.0, 3.0]
    assert depths.tolist() == [1.0, 2.0, 99.0]
    assert len(h) == 3  # unchanged
    assert h.snapshot()[0].tolist() == [0.0, 1.0, 2.0]


def test_history_is_fed_from_tick_records_and_skips_metric_errors():
    h = DepthHistory(capacity=8)
    h.on_tick(TickRecord(start=5.0, num_messages=120))
    h.on_tick(TickRecord(start=10.0, metric_error="boom"))  # no observation
    h.on_tick(TickRecord(start=15.0, num_messages=130))
    h.on_tick(TickRecord(start=20.0, num_messages=140, stale=True))
    times, depths, n = h.snapshot()
    assert n == 2
    assert times[:2].tolist() == [5.0, 15.0]
    assert depths[:2].tolist() == [120.0, 130.0]


def test_history_rejects_tiny_capacity():
    with pytest.raises(ValueError):
        DepthHistory(capacity=1)


# --------------------------------------------------------------------------
# Forecasters against the reference


def history_pair(capacity: int, samples: int, *, epoch: float = 0.0,
                 seed: int = 0):
    """The same seeded queue-depth walk (a drift, noise, the poll's
    jitter) in the reference's ring buffer and the port's."""
    rng = np.random.default_rng(seed)
    ours, theirs = DepthHistory(capacity), ref.DepthHistory(capacity)
    t, depth = epoch, float(rng.integers(0, 2000))
    drift = float(rng.normal(0.0, 10.0))
    for _ in range(samples):
        t += float(rng.uniform(4.5, 5.5))
        depth = max(0.0, depth + drift + float(rng.normal(0.0, 20.0)))
        ours.observe(t, float(round(depth)))
        theirs.observe(t, float(round(depth)))
    return ours, theirs


# (capacity, samples, epoch): empty, one, two samples; partly filled;
# exactly full; wrapped once and several times; at monotonic clock
# values of a host up for days (3e5 s) and for years (2.7e8 s)
HISTORIES = [
    (16, 0, 0.0), (16, 1, 0.0), (16, 2, 0.0), (16, 3, 2.7e8),
    (32, 20, 0.0), (32, 32, 3e5), (32, 45, 0.0), (64, 200, 2.7e8),
    (128, 77, 3e5), (128, 128, 0.0), (128, 300, 2.7e8), (8, 9, 2.7e8),
]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("capacity,samples,epoch", HISTORIES)
def test_forecasters_match_the_reference(name, capacity, samples, epoch):
    for seed in range(3):
        ours, theirs = history_pair(capacity, samples, epoch=epoch,
                                    seed=seed)
        snap = ours.snapshot()
        for a, b in zip(snap, theirs.snapshot()):
            np.testing.assert_array_equal(a, b)
        for horizon in (0.0, 30.0, 117.0):
            want = ref.make_forecaster(name).predict(*snap, horizon)
            got = cpu(name).predict(*snap, horizon)
            assert isinstance(got, float)
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed,horizon", [(9, 60.0), (16, 60.0),
                                          (164, 117.0), (218, 117.0)])
def test_least_squares_cancellation_is_bounded_by_float32(seed, horizon):
    # windows of pure noise, where the extrapolated line nearly cancels
    # its intercept: the two float32 fits sum the window in their own
    # order and differ by the rounding of the cancelled terms, more than
    # the forecast-level tolerance above (these seeds are 4 of the 8 such
    # cases among 800 noise histories); each fit stays within 16 float32
    # ulps of those terms of the exact float64 fit
    rng = np.random.default_rng(seed)
    h, hr = DepthHistory(64), ref.DepthHistory(64)
    t = 2.7e8
    for _ in range(40):
        t += float(rng.uniform(4.5, 5.5))
        depth = float(rng.integers(0, 1000))
        h.observe(t, depth)
        hr.observe(t, depth)
    times, depths, n = h.snapshot()
    x = times[n - 12:n] - times[n - 1]
    slope, intercept = np.polyfit(x, depths[n - 12:n], 1)
    exact = max(0.0, intercept + slope * horizon)
    ulp = np.finfo(np.float32).eps * (abs(intercept) + abs(slope * horizon))
    got = cpu("lstsq").predict(times, depths, n, horizon)
    want = ref.make_forecaster("lstsq").predict(*hr.snapshot(), horizon)
    assert abs(got - want) > ATOL + RTOL * abs(want)
    assert abs(got - exact) <= 16 * ulp and abs(want - exact) <= 16 * ulp


def test_forecasters_run_on_the_device_asked_for():
    # the classes put the snapshot on their device: cuda unless asked
    # (no card here: an error, never a quiet CPU run)
    for name in NAMES:
        assert make_forecaster(name).device == "cuda"
        with pytest.raises(RuntimeError, match="no usable CUDA card"):
            make_forecaster(name).predict(*linear_history(), 30.0)
    times, depths, n = linear_history(n=20)
    t, d = forecasters.snapshot_tensors(times, depths, n, "cpu")
    assert t.dtype == d.dtype == forecasters.F32 and t[n - 1] == 0.0


def linear_history(capacity=32, n=12, dt=5.0, start=100.0, slope=4.0):
    h = DepthHistory(capacity=capacity)
    for i in range(n):
        h.observe(i * dt, start + slope * (i * dt))
    return h.snapshot()


def test_pure_step_functions_match_their_forecasters():
    # the learned policy's features call the plain functions; the
    # forecasters wrap the same functions
    times64, depths64, n = linear_history(n=20, slope=4.0)
    t, d = forecasters.snapshot_tensors(times64, depths64, n, "cpu")
    assert float(forecasters.ewma_level(d, n, 0.3)) == \
        EwmaForecaster(alpha=0.3, device="cpu").predict(
            times64, depths64, n, 30.0)
    assert float(forecasters.holt_forecast(t, d, n, 30.0, 0.5, 0.3)) == \
        HoltForecaster(device="cpu").predict(times64, depths64, n, 30.0)
    assert float(forecasters.lstsq_forecast(t, d, n, 30.0, 12)) == \
        LeastSquaresForecaster(device="cpu").predict(
            times64, depths64, n, 30.0)


def test_lstsq_is_exact_on_a_linear_trend():
    times, depths, n = linear_history(slope=4.0)
    pred = cpu("lstsq", window=8).predict(times, depths, n, 30.0)
    last = depths[n - 1]
    assert pred == pytest.approx(last + 4.0 * 30.0, rel=1e-4)


def test_holt_tracks_a_linear_trend():
    times, depths, n = linear_history(n=20, slope=4.0)
    pred = cpu("holt").predict(times, depths, n, 30.0)
    last = depths[n - 1]
    assert pred == pytest.approx(last + 4.0 * 30.0, rel=0.15)
    assert pred > last


def test_ewma_converges_to_a_constant_level():
    h = DepthHistory(capacity=32)
    for i in range(20):
        h.observe(float(i * 5), 250.0)
    times, depths, n = h.snapshot()
    assert cpu("ewma").predict(times, depths, n, 60.0) == pytest.approx(
        250.0, rel=1e-5)


def test_forecasts_clamp_at_zero_on_steep_drains():
    h = DepthHistory(capacity=16)
    for i in range(8):
        h.observe(i * 5.0, max(0.0, 700.0 - 100.0 * i))
    times, depths, n = h.snapshot()
    for forecaster in (cpu("holt"), cpu("lstsq", window=8)):
        assert forecaster.predict(times, depths, n, 120.0) >= 0.0


def test_forecasters_handle_degenerate_histories():
    h = DepthHistory(capacity=8)
    h.observe(5.0, 100.0)
    h.observe(5.0, 100.0)  # coincident timestamps
    times, depths, n = h.snapshot()
    for name in NAMES:
        value = cpu(name).predict(times, depths, n, 30.0)
        assert np.isfinite(value) and value >= 0.0
        assert value == ref.make_forecaster(name).predict(times, depths, n,
                                                          30.0)


def test_trend_forecasters_survive_large_clock_epochs():
    offset = 2.7e8
    h0, h1 = DepthHistory(capacity=32), DepthHistory(capacity=32)
    for i in range(12):
        h0.observe(i * 5.0, 100.0 + 4.0 * (i * 5.0))
        h1.observe(offset + i * 5.0, 100.0 + 4.0 * (i * 5.0))
    for name in ("holt", "lstsq"):
        base = cpu(name).predict(*h0.snapshot(), 30.0)
        shifted = cpu(name).predict(*h1.snapshot(), 30.0)
        assert shifted == pytest.approx(base, rel=1e-3), name


def test_make_forecaster_registry():
    for name in NAMES:
        assert make_forecaster(name).name == name
    assert forecast.FORECASTER_NAMES == ref.FORECASTER_NAMES
    with pytest.raises(ValueError) as got:
        make_forecaster("arima")
    with pytest.raises(ValueError) as want:
        ref.make_forecaster("arima")
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------
# PredictivePolicy


def ramping_policy(conservative=True, min_samples=3):
    h = DepthHistory(capacity=32)
    return PredictivePolicy(
        cpu("lstsq", window=16), h,
        horizon=30.0, min_samples=min_samples, conservative=conservative,
    ), h


def test_policy_passes_through_until_warm():
    policy, history = ramping_policy(min_samples=3)
    assert policy.effective_messages(0.0, 50) == 50
    assert policy.last_prediction is None
    history.observe(0.0, 50.0)
    assert policy.effective_messages(5.0, 54) == 54
    history.observe(5.0, 54.0)
    effective = policy.effective_messages(10.0, 58)
    assert policy.last_prediction is not None
    assert effective >= 58


def test_policy_forecasts_ahead_on_a_ramp():
    policy, history = ramping_policy(conservative=False)
    for i in range(10):
        history.observe(i * 5.0, 50.0 + 4.0 * i * 5.0)
    effective = policy.effective_messages(50.0, 250)
    assert effective == pytest.approx(250 + 120, abs=5)


def test_conservative_policy_never_goes_below_observation():
    policy, history = ramping_policy(conservative=True)
    for i in range(10):
        history.observe(i * 5.0, max(0.0, 500.0 - 40.0 * i))
    assert policy.effective_messages(50.0, 100) == 100


def test_policy_scores_matured_forecasts():
    policy, history = ramping_policy(conservative=False)
    for i in range(6):
        history.observe(i * 5.0, 100.0)
    policy.effective_messages(30.0, 100)
    assert policy.last_abs_error is None
    for t in (35.0, 40.0, 45.0, 50.0, 55.0):
        history.observe(t, 100.0)
        policy.effective_messages(t, 100)
    history.observe(60.0, 130.0)
    policy.effective_messages(60.0, 130)
    assert policy.last_abs_error == pytest.approx(30.0, abs=1.0)


def test_policy_rejects_negative_horizon():
    with pytest.raises(ValueError):
        PredictivePolicy(cpu("ewma"), horizon=-1.0)


def test_reactive_policy_is_identity():
    assert ReactivePolicy().effective_messages(123.0, 77) == 77


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("conservative", [True, False])
def test_policy_decisions_equal_the_reference(name, conservative):
    # the same observations through both policies: the same effective
    # depth, prediction and error scoreboard every call
    ours = PredictivePolicy(cpu(name), DepthHistory(16), horizon=45.0,
                            conservative=conservative)
    theirs = ref.PredictivePolicy(ref.make_forecaster(name),
                                  ref.DepthHistory(16), horizon=45.0,
                                  conservative=conservative)
    rng = np.random.default_rng(11)
    depth = 50.0
    for i in range(40):
        depth = max(0.0, depth + 15.0 * np.sin(i / 5) + rng.normal(0, 5))
        now, observed = 1e5 + 5.0 * i, int(depth)
        assert ours.effective_messages(now, observed) == \
            theirs.effective_messages(now, observed)
        assert ours.last_prediction == theirs.last_prediction
        assert ours.last_abs_error == theirs.last_abs_error
        ours.history.observe(now, observed)
        theirs.history.observe(now, observed)


# --------------------------------------------------------------------------
# Loop integration


def _episode(depth_policy, depths, up=100, poll=5.0, port=True):
    """One episode over a queue-depth trace on either package; returns
    (api, loop, clock)."""
    mods = ((FakeDeploymentAPI, PodAutoScaler, FakeQueueService,
             QueueMetricSource, FakeClock, ControlLoop, LoopConfig,
             PolicyConfig) if port else
            (RefAPI, RefScaler, RefQueue, RefSource, RefClock, RefLoop,
             RefLoopConfig, RefPolicy))
    api_cls, scaler_cls, queue_cls, source, clock_cls, loop_cls, \
        config_cls, policy_cls = mods
    api = api_cls.with_deployments("ns", 1, "deploy")
    scaler = scaler_cls(client=api, max=20, min=1, scale_up_pods=1,
                        scale_down_pods=1, deployment="deploy",
                        namespace="ns")
    queue = queue_cls.with_depths(depths[0])
    clock = clock_cls()
    loop = loop_cls(
        scaler, source(client=queue, queue_url="q"),
        config_cls(poll_interval=poll, policy=policy_cls(
            scale_up_messages=up, scale_down_messages=10,
            scale_up_cooldown=10.0, scale_down_cooldown=30.0)),
        clock=clock,
        observer=depth_policy.history if depth_policy else None,
        depth_policy=depth_policy,
    )
    for i, depth in enumerate(depths):
        clock.at(float(i) * poll, lambda d=depth: queue.set_depths(d))
    return api, loop, clock


def test_predictive_loop_fires_before_the_reactive_threshold():
    depths = [20 * i for i in range(12)]

    def first_scale_time(depth_policy):
        api, loop, clock = _episode(depth_policy, depths)
        replicas_at = []
        original_tick = loop.tick

        def recording_tick(state):
            new_state = original_tick(state)
            replicas_at.append((clock.now(), api.replicas("deploy")))
            return new_state

        loop.tick = recording_tick
        loop.run(max_ticks=len(depths))
        return next((t for t, r in replicas_at if r > 1), None)

    reactive_t = first_scale_time(None)
    predictive_t = first_scale_time(PredictivePolicy(
        cpu("lstsq", window=8), DepthHistory(capacity=16), horizon=30.0,
        min_samples=3))
    assert reactive_t is not None and predictive_t is not None
    assert predictive_t < reactive_t


class Recorder:
    def __init__(self):
        self.records = []

    def on_tick(self, record):
        self.records.append(record)


@pytest.mark.parametrize("name", NAMES)
def test_loop_episode_equals_the_reference(name):
    # a ramp, a plateau and a drain: every tick's observation, decision,
    # prediction and gates, and the replica trajectory, are the
    # reference's
    depths = ([15 * i for i in range(14)] + [210] * 6
              + [max(0, 210 - 30 * i) for i in range(12)])
    out = []
    for port in (True, False):
        policy = (PredictivePolicy(cpu(name), DepthHistory(16), horizon=30.0)
                  if port else ref.PredictivePolicy(
                      ref.make_forecaster(name), ref.DepthHistory(16),
                      horizon=30.0))
        api, loop, _ = _episode(policy, depths, port=port)
        recorder = Recorder()
        observers = (CompositeTickObserver if port else
                     ref_core_events().CompositeTickObserver)
        loop.observer = observers([policy.history, recorder])
        trajectory = []
        original_tick = loop.tick

        def tick(state, _orig=original_tick, _api=api, _t=trajectory):
            new_state = _orig(state)
            _t.append(_api.replicas("deploy"))
            return new_state

        loop.tick = tick
        loop.run(max_ticks=len(depths))
        out.append((
            [(r.start, r.num_messages, r.decision_messages,
              r.predicted_messages, r.forecast_error, str(r.up),
              str(r.down)) for r in recorder.records], trajectory))
    assert out[0] == out[1]
    assert max(out[0][1]) > 1


def ref_core_events():
    from kube_sqs_autoscaler_tpu.core import events

    return events


def test_depth_policy_failure_falls_back_to_observed_depth():
    class ExplodingPolicy:
        history = None

        def effective_messages(self, now, num_messages):
            raise RuntimeError("forecast kaboom")

    api, loop, _ = _episode(ExplodingPolicy(), [500] * 3)
    loop.run(max_ticks=3)
    assert api.replicas("deploy") > 1


def test_failing_policy_does_not_export_a_stale_forecast():
    class FlakyPolicy:
        def __init__(self):
            self.inner = PredictivePolicy(
                cpu("lstsq", window=8), DepthHistory(capacity=16),
                horizon=30.0, min_samples=2)
            self.history = self.inner.history
            self.calls = 0

        @property
        def last_prediction(self):
            return self.inner.last_prediction

        @property
        def last_abs_error(self):
            return self.inner.last_abs_error

        def effective_messages(self, now, num_messages):
            self.calls += 1
            if self.calls > 2:
                raise RuntimeError("forecast kaboom")
            return self.inner.effective_messages(now, num_messages)

    policy = FlakyPolicy()
    recorder = Recorder()
    api, loop, _ = _episode(policy, [100, 120, 140, 160])
    loop.observer = CompositeTickObserver([policy.history, recorder])
    loop.run(max_ticks=4)
    records = recorder.records
    assert records[1].predicted_messages is not None
    for record in records[2:]:
        assert record.predicted_messages is None
        assert record.forecast_error is None
        assert record.decision_messages == record.num_messages


def test_tick_record_carries_forecast_fields():
    policy = PredictivePolicy(cpu("lstsq", window=8),
                              DepthHistory(capacity=16), horizon=30.0,
                              min_samples=2)
    recorder = Recorder()
    api, loop, _ = _episode(policy, [100, 120, 140, 160])
    loop.observer = CompositeTickObserver([policy.history, recorder])
    loop.run(max_ticks=4)
    assert len(recorder.records) == 4
    assert any(r.predicted_messages is not None for r in recorder.records)
    for record in recorder.records:
        assert record.decision_messages >= record.num_messages


def test_composite_observer_isolates_failures():
    class Bad:
        def on_tick(self, record):
            raise RuntimeError("observer kaboom")

    good = Recorder()
    CompositeTickObserver([Bad(), good]).on_tick(
        TickRecord(start=0.0, num_messages=5))
    assert len(good.records) == 1


# --------------------------------------------------------------------------
# The durable section


def test_history_durable_section_round_trips_as_the_reference():
    ours, theirs = history_pair(8, 13, epoch=3e5, seed=4)
    state = ours.export_state()
    assert state == theirs.export_state()
    assert json.loads(json.dumps(state)) == state
    for kwargs in ({}, dict(rebase=-3e5, now=60.0, max_age_s=30.0)):
        back, ref_back = DepthHistory(8), ref.DepthHistory(8)
        assert back.import_state(state, **kwargs) == \
            ref_back.import_state(state, **kwargs)
        for a, b in zip(back.snapshot(), ref_back.snapshot()):
            np.testing.assert_array_equal(a, b)
    # malformed samples are skipped, not fatal
    bad = {"times": [1.0, "x", 3.0], "depths": [1.0, 2.0, None]}
    assert DepthHistory(4).import_state(bad) == \
        ref.DepthHistory(4).import_state(bad) == 1


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_history_rehydrates_through_the_durable_store(tmp_path, writer):
    # a snapshot with a forecast-history section, written by either
    # package at t=100 and rehydrated 25 s later by both: the same
    # samples, rebased onto the new boot's clock
    path = tmp_path / "state.json"
    wall = {"t": 100.0}
    ours, theirs = history_pair(16, 20, epoch=40.0, seed=7)
    store_mod, state_cls, history = (
        (ref_durable, RefState, theirs) if writer == "ref"
        else (durable, PolicyState, ours))
    store = store_mod.DurableStateStore(str(path), wall_clock=lambda:
                                        wall["t"])
    store.register("forecast-history", history, ttl_s=3600.0)
    store.snapshot(clock_now=150.0, policy_state=state_cls(
        last_scale_up=140.0, last_scale_down=130.0), ticks=20)
    wall["t"] += 25.0
    restored = []
    for mod, cls in ((ref_durable, ref.DepthHistory),
                     (durable, DepthHistory)):
        fresh = cls(16)
        again = mod.DurableStateStore(str(path),
                                      wall_clock=lambda: wall["t"])
        again.register("forecast-history", fresh, ttl_s=3600.0)
        report = again.rehydrate(10.0)
        assert not report.cold_start
        restored.append((report.records_recovered, fresh.snapshot()))
    assert restored[0][0] == restored[1][0] == 16  # the ring held 16 of 20
    for a, b in zip(restored[0][1], restored[1][1]):
        np.testing.assert_array_equal(a, b)
    # rebased by (now - downtime) - saved clock = (10 - 25) - 150
    times, _, n = restored[1][1]
    assert times[n - 1] == pytest.approx(ours.snapshot()[0][n - 1] - 165.0)


# --------------------------------------------------------------------------
# Per-tenant depth: TenantDepthHistory, weights, TenantAwareDepth


def test_slo_urgency_weights_anchor_at_loosest_slo():
    tenancy = TenancyConfig(tenants=("tight", "loose", "free"),
                            ttft_slo_s=(0.25, 1.0, 0.0))
    assert slo_urgency_weights(tenancy) == {"tight": 4.0, "loose": 1.0,
                                            "free": 1.0}
    assert slo_urgency_weights(tenancy) == ref_tenants.slo_urgency_weights(
        RefTenancy(tenants=("tight", "loose", "free"),
                   ttft_slo_s=(0.25, 1.0, 0.0)))
    assert set(slo_urgency_weights(
        TenancyConfig(tenants=("a", "b"))).values()) == {1.0}


def test_tenant_depth_history_records_and_bounds():
    history = TenantDepthHistory(capacity=8, max_tenants=2)
    history.observe(1.0, {"a": 3, "b": 1})
    history.observe(2.0, {"a": 5, "evil1": 7, "evil2": 9})
    assert history.latest()["a"] == 5.0
    assert history.latest()["b"] == 0.0
    assert set(history.tenants()) == {"a", "b", OTHER_TENANTS}
    assert history.latest()[OTHER_TENANTS] == 16.0
    assert OTHER_TENANTS == ref_tenants.OTHER_TENANTS


def test_tenant_aware_depth_boosts_gates_by_weighted_backlog():
    tenancy = TenancyConfig(tenants=("tight", "loose"),
                            ttft_slo_s=(0.25, 1.0))
    depths = {"tight": 10, "loose": 4}
    policy = TenantAwareDepth(lambda: depths, tenancy)
    assert policy.effective_messages(0.0, 20) == 44
    assert policy.last_weighted == pytest.approx(44.0)
    assert policy.effective_messages(1.0, 100) == 100
    depths = {"stranger": 7}
    assert policy.effective_messages(2.0, 0) == 7


def test_tenant_aware_depth_forecasts_per_tenant():
    tenancy = TenancyConfig(tenants=("tight",), ttft_slo_s=(0.5,))
    feed = {"tight": 0}
    policy = TenantAwareDepth(
        lambda: feed, tenancy, forecaster=EwmaForecaster(alpha=0.9,
                                                         device="cpu"),
        horizon=5.0, min_samples=2)
    for t, depth in enumerate((2, 4, 6, 8)):
        feed = {"tight": depth}
        boosted = policy.effective_messages(float(t), 0)
    assert boosted >= 8
    assert policy.name == "tenant-aware:ewma"


@pytest.mark.parametrize("name", [None, *NAMES])
def test_tenant_aware_depth_equals_the_reference(name):
    # staged depths of three tenants (one unknown) through both policies,
    # with and without per-tenant forecasts and a chained predictive
    # policy: the same gate depth, weighted sum and depths every call
    slos = (0.25, 2.0)
    ours = TenantAwareDepth(
        lambda: feed, TenancyConfig(tenants=("a", "b"), ttft_slo_s=slos),
        forecaster=cpu(name) if name else None, horizon=20.0,
        inner=PredictivePolicy(cpu(name or "holt"), DepthHistory(16)))
    theirs = ref_tenants.TenantAwareDepth(
        lambda: feed, RefTenancy(tenants=("a", "b"), ttft_slo_s=slos),
        forecaster=ref.make_forecaster(name) if name else None,
        horizon=20.0,
        inner=ref.PredictivePolicy(ref.make_forecaster(name or "holt"),
                                   ref.DepthHistory(16)))
    rng = np.random.default_rng(2)
    for i in range(30):
        feed = {"a": int(rng.integers(0, 12)), "b": int(rng.integers(0, 40)),
                "z": int(rng.integers(0, 3))}
        now, observed = 50.0 + 5.0 * i, int(rng.integers(0, 60))
        assert ours.effective_messages(now, observed) == \
            theirs.effective_messages(now, observed)
        assert ours.last_weighted == pytest.approx(theirs.last_weighted,
                                                   rel=RTOL, abs=ATOL)
        assert ours.last_depths.keys() == theirs.last_depths.keys()
        ours.inner.history.observe(now, observed)
        theirs.inner.history.observe(now, observed)
    assert ours.name == theirs.name


# --------------------------------------------------------------------------
# The tenant fleet's gates: the worker binary's wiring (the repair)


def stepped(dt: float):
    """A ``SystemClock.now`` that advances ``dt`` per read: the binary's
    real-clock fleet, made deterministic."""
    count = itertools.count()
    return lambda self: next(count) * dt


TENANT_FLEET = ["--demo", "16", "--seq-len", "8", "--generate-tokens", "4",
                "--batch-size", "2", "--continuous", "--decode-block", "2",
                "--fleet-max-replicas", "3", "--tenants", "a,b",
                "--tenant-slos", "0.25,4"]


def test_tenant_fleet_binary_scales_on_the_weighted_backlog(monkeypatch):
    # tenant a's TTFT SLO is 16x tighter than b's, so each request it has
    # staged weighs 16 at the gates: the fleet climbs to 3 replicas while
    # the queue's own depth would already shed one (the raw-depth loop's
    # trajectory is [1, 2, 1])
    from kube_sqs_autoscaler_tpu.core import clock as ref_clock
    from kube_sqs_autoscaler_tpu.fleet import pool as ref_pool
    from kube_sqs_autoscaler_tpu.workloads import __main__ as ref_binary
    from kube_sqs_autoscaler_tpu_torch.core import clock
    from kube_sqs_autoscaler_tpu_torch.fleet import pool
    from kube_sqs_autoscaler_tpu_torch.workloads import __main__ as binary

    seen = {}
    for name, clock_mod, pool_mod, main, extra in (
            ("ref", ref_clock, ref_pool, ref_binary.main, []),
            ("port", clock, pool, binary.main, ["--device", "cpu"])):
        monkeypatch.setattr(clock_mod.SystemClock, "now", stepped(0.02))
        run = pool_mod.FleetDriver.run

        def recorded(self, *args, _run=run, _name=name, **kwargs):
            stats = _run(self, *args, **kwargs)
            seen[_name] = (stats["replica_trajectory"],
                           self.loop.depth_policy.last_weighted,
                           self.pool.completed_by_tenant)
            return stats

        monkeypatch.setattr(pool_mod.FleetDriver, "run", recorded)
        main([*TENANT_FLEET, *extra])
    assert seen["port"] == seen["ref"]
    assert seen["port"][0] == [1, 2, 3]
