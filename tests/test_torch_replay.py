"""The port's journal replay and counterfactual (``sim/replay.py``).

The port's journals are the reference's line format, so each case holds
the port against the reference on the SAME file: a journal the port
records replays with 0 divergences through both replays, the inferred
arrival process and every counterfactual row (reactive, each forecaster,
``LEARNED_POLICY.json``) equal the reference's, and the restart stitch,
the rotation rules and the demo's exit codes are the reference's.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import pytest

from kube_sqs_autoscaler_tpu.learn.checkpoint import (
    load_checkpoint as ref_load,
)
from kube_sqs_autoscaler_tpu.sim import replay as ref_replay
from kube_sqs_autoscaler_tpu_torch.core.policy import Gate
from kube_sqs_autoscaler_tpu_torch.learn.checkpoint import load_checkpoint
from kube_sqs_autoscaler_tpu_torch.obs.journal import TickJournal, read_journal
from kube_sqs_autoscaler_tpu_torch.sim import (
    BurstArrival,
    SimConfig,
    Simulation,
    StepArrival,
)
from kube_sqs_autoscaler_tpu_torch.sim import replay

ROOT = Path(__file__).resolve().parents[1]
LEARNED = str(ROOT / "LEARNED_POLICY.json")


def demo_config(**overrides) -> SimConfig:
    defaults = dict(
        arrival_rate=BurstArrival(base=20.0, burst_rate=140.0, period=120.0,
                                  burst_len=40.0, first_burst=30.0),
        service_rate_per_replica=10.0, duration=200.0, initial_replicas=2,
        max_pods=10,
    )
    defaults.update(overrides)
    return SimConfig(**defaults)


def record(tmp_path, name="journal.jsonl", **overrides):
    path = str(tmp_path / name)
    meta, result = replay.record_episode(demo_config(**overrides), path,
                                         device="cpu")
    return path, meta, result


def test_recorded_journal_replays_through_both_replays(tmp_path):
    path, meta, result = record(tmp_path)
    meta_read, records = read_journal(path)
    assert meta_read == meta == ref_replay.sim_journal_meta(
        ref_config_like(demo_config()))
    ours = replay.replay(records, meta_read, device="cpu")
    assert ours.ok and ours.ticks == len(records) == 40
    assert any(r.up is Gate.FIRE for r in records)
    assert any(r.up is Gate.COOLING for r in records)
    theirs = ref_replay.replay_journal(path)
    assert theirs.ok and theirs.ticks == 40
    assert ours.final_replicas == theirs.final_replicas == \
        result.final_replicas


def ref_config_like(config: SimConfig):
    from kube_sqs_autoscaler_tpu.sim import BurstArrival as RefBurst
    from kube_sqs_autoscaler_tpu.sim import SimConfig as RefSimConfig

    arrival = config.arrival_rate
    return RefSimConfig(
        arrival_rate=RefBurst(**dataclasses.asdict(arrival)),
        service_rate_per_replica=config.service_rate_per_replica,
        duration=config.duration, initial_replicas=config.initial_replicas,
        max_pods=config.max_pods)


def test_replay_detects_a_tampered_decision(tmp_path):
    path, _, _ = record(tmp_path)
    meta, records = read_journal(path)
    fired = next(i for i, r in enumerate(records) if r.up is Gate.FIRE)
    records[fired] = dataclasses.replace(records[fired], up=Gate.IDLE)
    result = replay.replay(records, meta, device="cpu")
    assert not result.ok
    assert any(d.tick == fired and d.tick_field == "up"
               for d in result.divergences)


@pytest.mark.parametrize("forecaster", ["ewma", "holt", "lstsq"])
def test_predictive_journal_replays(tmp_path, forecaster):
    path, _, _ = record(tmp_path, policy="predictive", forecaster=forecaster,
                        forecast_horizon=20.0)
    result = replay.replay_journal(path, device="cpu")
    assert result.ok, result.format_divergences()
    assert ref_replay.replay_journal(path).ok


def test_learned_journal_needs_the_matching_checkpoint(tmp_path):
    checkpoint = load_checkpoint(LEARNED, device="cpu")
    path, meta, _ = record(tmp_path, policy="learned",
                           learned_checkpoint=checkpoint,
                           forecast_history=64)
    assert meta["learn"]["checkpoint_hash"] == checkpoint.hash
    with pytest.raises(ValueError, match="pass the matching checkpoint"):
        replay.replay_journal(path, device="cpu")
    result = replay.replay_journal(path, checkpoint=checkpoint, device="cpu")
    assert result.ok, result.format_divergences()
    assert ref_replay.replay_journal(path, checkpoint=ref_load(LEARNED)).ok
    assert replay.main(["--journal", path]) == 2
    assert replay.main(["--journal", path, "--checkpoint", LEARNED,
                        "--device", "cpu"]) == 0


def test_inferred_arrivals_equal_the_reference(tmp_path):
    path, _, _ = record(tmp_path)
    meta, records = read_journal(path)
    mine = replay.infer_arrivals(records, meta)
    ref_meta, ref_records = _ref_read(path)
    want = ref_replay.infer_arrivals(ref_records, ref_meta)
    assert (mine.times, mine.rates) == (want.times, want.rates)
    for t0, t1 in ((0.0, 7.5), (12.0, 150.0), (3.0, 3.0)):
        assert mine.arrivals_between(t0, t1) == want.arrivals_between(t0, t1)


def _ref_read(path):
    from kube_sqs_autoscaler_tpu.obs.journal import read_journal as ref_read

    return ref_read(path)


@pytest.mark.parametrize("policy,forecaster", [
    ("reactive", "holt"), ("predictive", "ewma"), ("predictive", "holt"),
    ("predictive", "lstsq"), ("learned", "holt")])
def test_counterfactual_rows_equal_the_reference(tmp_path, policy,
                                                 forecaster):
    path, _, _ = record(tmp_path, duration=400.0)
    meta, records = read_journal(path)
    ref_meta, ref_records = _ref_read(path)
    kwargs = dict(policy=policy, forecaster=forecaster, horizon=30.0)
    mine = replay.counterfactual(
        records, meta, **kwargs, device="cpu",
        checkpoint=load_checkpoint(LEARNED, device="cpu")
        if policy == "learned" else None)
    want = ref_replay.counterfactual(
        ref_records, ref_meta, **kwargs,
        checkpoint=ref_load(LEARNED) if policy == "learned" else None)
    assert mine == want


def test_counterfactual_needs_world_meta_and_weights(tmp_path):
    path, meta, _ = record(tmp_path)
    _, records = read_journal(path)
    with pytest.raises(ValueError, match="lacks world.service_rate"):
        replay.infer_arrivals(records, {k: v for k, v in meta.items()
                                        if k != "world"})
    with pytest.raises(ValueError, match="needs the trained"):
        replay.counterfactual(records, meta, policy="learned", device="cpu")


def test_replay_journal_takes_the_last_episode(tmp_path):
    path = str(tmp_path / "journal.jsonl")
    replay.record_episode(demo_config(duration=100.0), path)
    _, second = replay.record_episode(demo_config(duration=150.0), path)
    result = replay.replay_journal(path)
    assert result.ok and result.ticks == 30
    assert result.final_replicas == second.final_replicas


def test_rotation_rejoins_or_refuses(tmp_path):
    import os

    config = demo_config()
    path = str(tmp_path / "journal.jsonl")
    with TickJournal(path, meta=replay.sim_journal_meta(config),
                     max_bytes=4096) as journal:
        Simulation(config, extra_observers=(journal,)).run()
    assert os.path.exists(path + ".1")
    result = replay.replay_journal(path)
    assert result.ok and result.ticks == 40
    long_path = str(tmp_path / "long.jsonl")
    config = demo_config(duration=700.0)
    with TickJournal(long_path, meta=replay.sim_journal_meta(config),
                     max_bytes=4096) as journal:
        Simulation(config, extra_observers=(journal,)).run()
    with pytest.raises(ValueError, match="rotation continuation"):
        replay.replay_journal(long_path)


def test_stitch_restart_episodes_equals_the_reference(tmp_path):
    path = str(tmp_path / "journal.jsonl")
    config = demo_config(duration=100.0)
    meta = replay.sim_journal_meta(config)
    with TickJournal(path, meta=meta) as journal:
        Simulation(config, extra_observers=(journal,)).run()
    restart = dict(meta, restart={"snapshot_hash": "abc", "restarts": 1,
                                  "records_recovered": 3,
                                  "records_expired": 0, "cold_start": False,
                                  "downtime_s": 4.0})
    with TickJournal(path, meta=restart) as journal:
        Simulation(demo_config(duration=50.0),
                   extra_observers=(journal,)).run()
    mine = replay.stitch_restart_episodes(path)
    assert len(mine) == 1
    assert json.dumps(mine, sort_keys=True, default=str) == json.dumps(
        ref_replay.stitch_restart_episodes(path), sort_keys=True,
        default=str)


def test_replay_demo_records_verifies_and_fails_on_drift(tmp_path, capsys):
    journal = str(tmp_path / "demo.jsonl")
    assert replay.main(["--record-to", journal]) == 0
    verdict = json.loads(capsys.readouterr().out)
    assert verdict["ok"] is True and verdict["divergences"] == 0
    assert replay.main(["--journal", journal]) == 0
    capsys.readouterr()
    meta, records = read_journal(journal)
    fired = next(i for i, r in enumerate(records) if r.up is Gate.FIRE)
    records[fired] = dataclasses.replace(records[fired], up=Gate.IDLE)
    tampered = str(tmp_path / "tampered.jsonl")
    with TickJournal(tampered, meta=meta) as out:
        for r in records:
            out.on_tick(r)
    assert replay.main(["--journal", tampered]) == 2
    assert json.loads(capsys.readouterr().out)["ok"] is False


def test_predictive_replay_without_a_card_raises(tmp_path):
    path, _, _ = record(tmp_path, policy="predictive", forecaster="ewma")
    with pytest.raises(RuntimeError, match="no usable CUDA card"):
        replay.replay_journal(path)
    step = SimConfig(arrival_rate=StepArrival(before=10.0, after=60.0,
                                              at=50.0), duration=100.0)
    meta, _ = replay.record_episode(step, str(tmp_path / "r.jsonl"))
    assert meta["policy"] == "reactive"
