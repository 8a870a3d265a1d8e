"""The port's token-level serving twin (``sim/twin/``) on the CPU.

- ``verify_twin_fidelity``: the compiled twin equals the port's REAL
  ``ShardedBatcher`` plane cycle for cycle (0 divergences), reactive and
  ``SERVING_POLICY.json``, at the reference tests' size (48 cycles);
- the twin's summaries and trajectories equal the reference's compiled
  twin (a child process, ``torch_sim_ref.py``), ``time_over_slo_s``
  within 1e-9, everything else exactly;
- the scenarios' scripts, the encoded rows, the host runner's shard
  ordering (pinned against the port's ``ShardedWorkerPool``), the
  checkpoint seams and the device rule.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import pytest

from kube_sqs_autoscaler_tpu_torch.learn.checkpoint import (
    PolicyCheckpoint,
    load_checkpoint,
)
from kube_sqs_autoscaler_tpu_torch.learn.network import init_params
from kube_sqs_autoscaler_tpu_torch.sim.twin import (
    SERVING_SUMMARY_KEYS,
    TRAJECTORY_KEYS,
    TwinConfig,
    default_twin_battery,
    run_host_episode,
    run_twin_episodes,
    run_twin_grouped,
    score_twin_summary,
    twin_variants,
    verify_twin_fidelity,
)
from kube_sqs_autoscaler_tpu_torch.sim.twin import compiled as twin
from kube_sqs_autoscaler_tpu_torch.sim.twin.host import (
    _scale_down,
    _scale_up,
)
from kube_sqs_autoscaler_tpu_torch.sim.twin.scenario import (
    SHARD_DRAINING,
    SHARD_INACTIVE,
    SHARD_SERVING,
    ServingScenario,
)

from .torch_sim_ref import RefChild

ROOT = Path(__file__).resolve().parents[1]
SERVING = str(ROOT / "SERVING_POLICY.json")
CYCLES = 48


@pytest.fixture(scope="module")
def ref():
    child = RefChild()
    yield child
    child.close()


def battery_rows():
    base = default_twin_battery(cycles=CYCLES)
    checkpoint = load_checkpoint(SERVING, device="cpu")
    return [TwinConfig(scenario=s) for s in base] + [
        TwinConfig(scenario=s, policy="learned", checkpoint=checkpoint)
        for s in base]


LABELS = [f"{c.scenario.name}/{c.policy}" for c in battery_rows()]


@pytest.fixture(scope="module")
def ours():
    rows = battery_rows()
    return dict(zip(LABELS, run_twin_grouped(rows, device="cpu")))


@pytest.fixture(scope="module")
def theirs(ref):
    return {e["label"]: e for e in ref("twin_battery", cycles=CYCLES,
                                        serving_path=SERVING)}


def test_twin_fidelity_against_the_real_plane():
    report = verify_twin_fidelity(battery_rows(), device="cpu")
    assert report.episodes == 12 and report.cycles == 12 * CYCLES
    assert report.ok, report.format_divergences()


@pytest.mark.parametrize("label", LABELS)
def test_twin_summaries_equal_the_reference(label, ours, theirs):
    mine, want = ours[label], theirs[label]
    for key in SERVING_SUMMARY_KEYS:
        if key == "time_over_slo_s":
            assert math.isclose(mine.summary[key], want["summary"][key],
                                rel_tol=1e-9, abs_tol=1e-9), key
        else:
            assert int(mine.summary[key]) == int(want["summary"][key]), key
    for key in TRAJECTORY_KEYS:
        np.testing.assert_array_equal(mine.trajectory[key],
                                      want["trajectory"][key], err_msg=key)


@pytest.mark.parametrize("index", range(12))
def test_encoded_rows_equal_the_reference(index, ref):
    want = ref("twin_encode", cycles=CYCLES)[index]
    base = default_twin_battery(cycles=CYCLES)
    rows = [TwinConfig(scenario=s)
            for s in base + twin_variants(base, 1, seed=301)]
    r_max = max(c.scenario.total_requests() for c in rows)
    t_max = max(1, max(c.scenario.tenants for c in rows))
    got = twin.encode_twin_config(rows[index], r_max, t_max)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype


@pytest.mark.parametrize("index", range(6))
def test_serving_scenarios_script_like_the_reference(index, ref):
    # the reference's twin package imports its compiled module, so its
    # scripts come from the child too
    scripts = ref("twin_scripts", cycles=CYCLES, variants=2, seed=7)
    ours_ = default_twin_battery(cycles=CYCLES)
    ours_ = ours_ + twin_variants(ours_, 2, seed=7)
    assert len(ours_) == len(scripts)
    for mine, want in zip(ours_[index::6], scripts[index::6]):
        assert mine.name == want["name"]
        for key in ("sends", "arrival_cycles", "request_budgets",
                    "request_tenants"):
            np.testing.assert_array_equal(getattr(mine, key)(), want[key],
                                          err_msg=key)


def test_host_scale_ordering_matches_sharded_worker_pool():
    from kube_sqs_autoscaler_tpu_torch.fleet.sharded import (
        DRAINING as POOL_DRAINING,
        INACTIVE as POOL_INACTIVE,
        SERVING as POOL_SERVING,
        ShardedWorkerPool,
    )

    to_pool = {SHARD_INACTIVE: POOL_INACTIVE, SHARD_SERVING: POOL_SERVING,
               SHARD_DRAINING: POOL_DRAINING}
    from_pool = {v: k for k, v in to_pool.items()}

    class _StubBatcher:
        shards = 4

        def set_shard_active(self, shard, active):
            pass

        def shard_busy(self, shard):
            return 0

    class _StubWorker:
        batcher = _StubBatcher()

    pool = ShardedWorkerPool(lambda p: _StubWorker(), min=1, max=4)
    rng = np.random.default_rng(5)
    for trial in range(200):
        states = [int(x) for x in rng.integers(0, 3, size=4)]
        pool.shard_states = [to_pool[s] for s in states]
        twin_states = list(states)
        if rng.integers(0, 2):
            pool.scale_up()
            serving = sum(1 for s in twin_states if s == SHARD_SERVING)
            if serving < 4:
                twin_states[_scale_up(twin_states)] = SHARD_SERVING
        else:
            pool.scale_down()
            serving = sum(1 for s in twin_states if s == SHARD_SERVING)
            if serving > 1:
                twin_states[_scale_down(twin_states)] = SHARD_DRAINING
        assert twin_states == [
            from_pool[s] for s in pool.shard_states
        ], (trial, states)


def test_swept_gate_knobs_keep_fidelity():
    base = default_twin_battery(cycles=CYCLES)
    rows = [TwinConfig(scenario=base[i], scale_up_queue=up,
                       scale_down_queue=down, up_cooldown_s=ucd,
                       down_cooldown_s=dcd)
            for i, (up, down, ucd, dcd) in enumerate(
                ((2, 0, 0.0, 0.25), (10, 3, 1.0, 3.0), (4, 1, 0.25, 0.5)))]
    report = verify_twin_fidelity(rows, device="cpu")
    assert report.ok, report.format_divergences()


def test_host_episode_checks_first_tokens_against_the_engine():
    scenario = default_twin_battery(cycles=20)[0]
    episode = run_host_episode(TwinConfig(scenario=scenario), device="cpu")
    assert set(episode.summary) == set(SERVING_SUMMARY_KEYS)
    assert episode.summary["admitted"] == int(
        np.sum(episode.trajectory["admitted"]))
    assert episode.summary["tokens"] > 0


def test_host_episode_reports_the_engines_counters():
    # the chip run holds the forward kernel's launches to the layers times
    # the attention inserts these counters give
    base = default_twin_battery(cycles=20)
    plain = run_host_episode(TwinConfig(scenario=base[0]), device="cpu")
    assert plain.engine["pooled_inserts"] == 0
    assert plain.engine["prefix_installs"] == 0
    assert plain.engine["insert_dispatches"] == int(
        np.count_nonzero(plain.trajectory["admitted"]))
    pooled = run_host_episode(TwinConfig(scenario=base[5]), device="cpu")
    assert pooled.engine["pooled_inserts"] == \
        pooled.engine["insert_dispatches"] > 0
    assert pooled.engine["prefix_installs"] == pooled.summary["pool_misses"]
    report = verify_twin_fidelity([base[0], base[5]], device="cpu")
    assert report.engines == [plain.engine, pooled.engine]


def test_twin_config_validation_and_seams():
    scenario = default_twin_battery(cycles=CYCLES)[0]
    with pytest.raises(ValueError, match="'reactive' or 'learned'"):
        TwinConfig(scenario=scenario, policy="predictive")
    with pytest.raises(ValueError, match="needs a checkpoint"):
        TwinConfig(scenario=scenario, policy="learned")
    fluid = load_checkpoint(str(ROOT / "LEARNED_POLICY.json"), device="cpu")
    with pytest.raises(ValueError, match="'fluid' twin"):
        TwinConfig(scenario=scenario, policy="learned", checkpoint=fluid)
    TwinConfig(scenario=scenario, policy="learned", checkpoint=fluid,
               allow_twin_mismatch=True)
    knob = PolicyCheckpoint(theta=init_params(2, 8, knob_head=True),
                            hidden=8, knob_head=True,
                            meta={"twin": "serving"})
    with pytest.raises(ValueError, match="knob-action head"):
        twin.encode_twin_config(
            TwinConfig(scenario=scenario, policy="learned",
                       checkpoint=knob), 400, 1)
    with pytest.raises(ValueError, match="use run_twin_grouped"):
        run_twin_episodes([TwinConfig(scenario=scenario),
                           TwinConfig(scenario=default_twin_battery(
                               cycles=24)[0])], device="cpu")
    with pytest.raises(ValueError, match="exceed the group pad"):
        twin.encode_twin_config(TwinConfig(scenario=scenario), 1, 1)


def test_scorecard_and_lex_key():
    scenario = default_twin_battery(cycles=CYCLES)[1]
    episode = run_twin_episodes([TwinConfig(scenario=scenario)],
                                trajectory=False, device="cpu")[0]
    assert episode.trajectory == {}
    row = score_twin_summary(episode.summary, scenario)
    assert row["tokens_per_second"] == round(
        episode.summary["tokens"] / scenario.duration_s, 1)
    assert row["cycles"] == CYCLES
    better = dict(row, tokens_per_second=row["tokens_per_second"] + 1)
    assert twin.serving_lex_key([better]) < twin.serving_lex_key([row])


def test_twin_config_for_point_takes_reactive_points_only():
    from kube_sqs_autoscaler_tpu_torch.sim.sweep import SweepPoint

    scenario = default_twin_battery(cycles=CYCLES)[0]
    point = SweepPoint(scale_up_messages=3, scale_down_messages=1,
                       scale_up_cooldown=0.5, scale_down_cooldown=1.0)
    config = twin.twin_config_for_point(point, scenario)
    assert (config.up_q, config.down_q, config.up_cd, config.down_cd) == (
        3, 1, 0.5, 1.0)
    with pytest.raises(ValueError, match="reactive gate points only"):
        twin.twin_config_for_point(
            SweepPoint(policy="holt"), scenario)


def test_per_row_control_cadence_batches_together():
    # rows ticking on different cycles share one batch: history counts
    # and gates stay per row
    base = default_twin_battery(cycles=CYCLES)
    import dataclasses

    checkpoint = load_checkpoint(SERVING, device="cpu")
    rows = [TwinConfig(scenario=dataclasses.replace(base[i],
                                                    control_every=every),
                       policy="learned", checkpoint=checkpoint)
            for i, every in ((0, 3), (1, 5), (3, 4))]
    report = verify_twin_fidelity(rows, device="cpu")
    assert report.ok, report.format_divergences()


def test_the_device_defaults_to_the_card():
    scenario = ServingScenario(name="s", arrival=default_twin_battery(
        cycles=8)[0].arrival, cycles=8)
    with pytest.raises(RuntimeError, match="no usable CUDA card"):
        run_twin_episodes([TwinConfig(scenario=scenario)])
    with pytest.raises(RuntimeError, match="no usable CUDA card"):
        run_host_episode(TwinConfig(scenario=scenario))
