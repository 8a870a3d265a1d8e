"""The port's chaos and restart demos (``sim/faults.py``'s and
``core/durable.py``'s ``main``), the forecast battery's scoring
(``sim/evaluate.py``) and the knob-headed checkpoint's seams.

Both demos are host-only FakeClock episodes, so they are held to the
reference's demos summary for summary; ``python -m`` runs each one
module copy (no runpy warning) and exits 0.  The forecast battery
mirrors ``tests/test_forecast_eval.py`` with the port's forecasters on
the CPU, and ``tests/test_sched.py``'s knob-head case now reaches the
port's compiled twins.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from kube_sqs_autoscaler_tpu.core import durable as ref_durable
from kube_sqs_autoscaler_tpu.sim import evaluate as ref_evaluate
from kube_sqs_autoscaler_tpu.sim import faults as ref_faults
from kube_sqs_autoscaler_tpu_torch.core import durable
from kube_sqs_autoscaler_tpu_torch.core.events import TickRecord
from kube_sqs_autoscaler_tpu_torch.learn.checkpoint import (
    CheckpointError,
    PolicyCheckpoint,
    load_checkpoint,
    save_checkpoint,
)
from kube_sqs_autoscaler_tpu_torch.learn.network import init_params
from kube_sqs_autoscaler_tpu_torch.sim import evaluate, faults
from kube_sqs_autoscaler_tpu_torch.sim.simulator import SimConfig, SimResult

ROOT = Path(__file__).resolve().parents[1]


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def test_chaos_demo_equals_the_reference(capsys):
    assert faults.main([]) == 0
    mine = last_json(capsys.readouterr().out)
    assert ref_faults.main([]) == 0
    want = last_json(capsys.readouterr().out)
    assert mine == want
    assert mine["ok"] is True and mine["stale_ticks"] > 0
    assert mine["breaker_transitions"] == ["closed", "open", "closed"]


def test_chaos_demo_detects_bad_trajectory():
    records = [TickRecord(start=float(i) * 5.0, num_messages=1)
               for i in range(10)]
    result = SimResult(timeline=[(float(i) * 5.0, 1, 1) for i in range(10)],
                       final_replicas=1, final_depth=0.0, max_depth=1.0,
                       ticks=10)
    problems = faults._check_demo(records, result)
    assert any("stale" in p for p in problems)
    assert any("breaker" in p for p in problems)


def test_restart_demo_equals_the_reference():
    mine, problems = durable._demo()
    want, ref_problems = ref_durable._demo()
    assert mine == want
    assert problems == ref_problems == []
    assert mine["ok"] is True


@pytest.mark.parametrize("module", [
    "kube_sqs_autoscaler_tpu_torch.sim.faults",
    "kube_sqs_autoscaler_tpu_torch.sim.replay"])
def test_demos_run_as_modules_without_a_second_copy(module, tmp_path):
    out = subprocess.run([sys.executable, "-W", "error::RuntimeWarning",
                          "-m", module], capture_output=True, text=True,
                         timeout=120, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                              "TMPDIR": str(tmp_path),
                              "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert last_json(out.stdout)["ok"] is True


def test_restart_demo_runs_as_a_module():
    out = subprocess.run(
        [sys.executable, "-m", "kube_sqs_autoscaler_tpu_torch.core.durable"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert last_json(out.stdout)["ok"] is True


# --- the forecast battery (tests/test_forecast_eval.py) ----------------------


@pytest.fixture(scope="module")
def target_report():
    battery = tuple(s for s in evaluate.default_battery()
                    if s.name in ("ramp", "diurnal"))
    return evaluate.evaluate_battery(scenarios=battery, device="cpu")


def test_best_forecaster_beats_reactive_on_ramp_and_diurnal(target_report):
    summary = evaluate.summarize(target_report)
    winner = summary["winner"]
    assert summary["candidates"][winner]["within_churn_budget"]
    for scenario in ("ramp", "diurnal"):
        reactive = target_report[scenario]["reactive"]
        predictive = target_report[scenario][winner]
        assert predictive["max_depth"] < reactive["max_depth"], scenario
        assert predictive["replica_changes"] <= 1.25 * max(
            reactive["replica_changes"], 1)


def test_forecast_battery_equals_the_reference(target_report):
    battery = tuple(s for s in ref_evaluate.default_battery()
                    if s.name in ("ramp", "diurnal"))
    want = ref_evaluate.evaluate_battery(scenarios=battery)
    assert target_report == want
    assert evaluate.summarize(target_report) == ref_evaluate.summarize(want)


def test_predictive_never_worsens_time_over_slo_on_targets(target_report):
    winner = evaluate.summarize(target_report)["winner"]
    for scenario in ("ramp", "diurnal"):
        assert (target_report[scenario][winner]["time_over_slo_s"]
                <= target_report[scenario]["reactive"]["time_over_slo_s"]), \
            scenario


def test_episodes_are_deterministic(target_report):
    ramp = {s.name: s for s in evaluate.default_battery()}["ramp"]
    again = evaluate.run_episode(ramp, policy="predictive",
                                 forecaster="holt", device="cpu")
    assert again == target_report["ramp"]["predictive:holt"]


# --- the knob-headed checkpoint (tests/test_sched.py) ------------------------


def test_knob_head_checkpoint_roundtrip_and_seam_rejection(tmp_path):
    checkpoint = PolicyCheckpoint(theta=init_params(2, 8, knob_head=True),
                                  hidden=8, knob_head=True)
    headless = PolicyCheckpoint(theta=init_params(2, 8), hidden=8)
    assert checkpoint.hash != headless.hash
    path = tmp_path / "knobhead.json"
    save_checkpoint(str(path), checkpoint)
    loaded = load_checkpoint(str(path), device="cpu")
    assert loaded.knob_head is True and loaded.hash == checkpoint.hash
    np.testing.assert_array_equal(loaded.theta.numpy(),
                                  checkpoint.theta.numpy())
    with pytest.raises(CheckpointError, match="knob_head"):
        PolicyCheckpoint(theta=init_params(2, 8), hidden=8, knob_head=True)
    from kube_sqs_autoscaler_tpu_torch.sim.compiled import encode_config

    with pytest.raises(CheckpointError, match="knob-action head"):
        encode_config(SimConfig(
            arrival_rate=5.0, service_rate_per_replica=2.0, duration=60.0,
            policy="learned", learned_checkpoint=checkpoint))
