"""The port's policy trainers (``learn/rollout.py``, ``train.py``,
``serving.py``, ``__main__.py``) on the CPU.

The two committed checkpoints are the oracle: the reference's recipes
reproduce ``LEARNED_POLICY.json`` and ``SERVING_POLICY.json`` bit for
bit, so the port's trainers are held to their reward curves — the first
4 fluid generations and the first 3 serving generations here, the whole
recipes with their content hashes in the ``slow`` tier.  The population
rollouts and the ES arithmetic are also held to the reference's (a child
process, ``torch_sim_ref.py``).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import kube_sqs_autoscaler_tpu.learn as ref_learn
from kube_sqs_autoscaler_tpu_torch import learn
from kube_sqs_autoscaler_tpu_torch.learn.network import init_params, param_count
from kube_sqs_autoscaler_tpu_torch.learn.rollout import (
    SERVING_TRAIN_KEYS,
    SUMMARY_KEYS,
    evaluate_checkpoint,
    evaluate_population,
    evaluate_population_serving,
)
from kube_sqs_autoscaler_tpu_torch.learn.serving import (
    ServingESConfig,
    train_serving,
)
from kube_sqs_autoscaler_tpu_torch.learn.train import (
    ESConfig,
    _rank_utilities,
    reference_scales,
    reward_vector,
    train,
)
from kube_sqs_autoscaler_tpu_torch.sim.evaluate import default_battery
from kube_sqs_autoscaler_tpu_torch.sim.scenarios import scenario_variants
from kube_sqs_autoscaler_tpu_torch.sim.twin import (
    default_twin_battery,
    twin_variants,
)

from .torch_sim_ref import RefChild

ROOT = Path(__file__).resolve().parents[1]


def committed(name: str) -> dict:
    return json.loads((ROOT / name).read_text())


def fluid_recipe():
    base = list(default_battery())
    return base + scenario_variants(base, 2, seed=101)


FLUID_ES = dict(population=32, seed=0, churn_weight=0.3, replica_weight=0.15)


def serving_recipe():
    base = default_twin_battery(cycles=240)
    return base + twin_variants(base, 1, seed=301)


@pytest.fixture(scope="module")
def ref():
    child = RefChild()
    yield child
    child.close()


def test_fluid_recipe_reproduces_the_committed_curve():
    result = train(fluid_recipe(), ESConfig(generations=4, **FLUID_ES),
                   device="cpu")
    curve = [round(v, 6) for v in result.reward_curve]
    assert curve == [-134.135514, -5.689, -0.355817, -0.348641]
    assert curve == committed("LEARNED_POLICY.json")["meta"][
        "reward_curve"][:4]


def test_serving_recipe_reproduces_the_committed_curve():
    result = train_serving(serving_recipe(),
                           ServingESConfig(population=24, generations=3),
                           device="cpu")
    curve = [round(v, 6) for v in result.reward_curve]
    assert curve == [-29.673204, -29.673204, -4.539354]
    assert curve == committed("SERVING_POLICY.json")["meta"][
        "reward_curve"][:3]
    assert result.checkpoint.meta["twin"] == "serving"


@pytest.mark.slow
def test_whole_fluid_recipe_reproduces_learned_policy_json():
    result = train(fluid_recipe(), ESConfig(generations=40, **FLUID_ES),
                   device="cpu")
    want = committed("LEARNED_POLICY.json")
    assert result.checkpoint.hash == "09f88697cfea"
    assert result.checkpoint.theta.tolist() == want["theta"]
    assert result.checkpoint.meta["reward_curve"] == want["meta"][
        "reward_curve"]


@pytest.mark.slow
def test_whole_serving_recipe_reproduces_serving_policy_json():
    result = train_serving(serving_recipe(),
                           ServingESConfig(population=24, generations=30),
                           device="cpu")
    want = committed("SERVING_POLICY.json")
    assert result.checkpoint.hash == "8daf3b2784a7"
    assert result.checkpoint.theta.tolist() == want["theta"]
    assert result.checkpoint.meta["reward_curve"] == want["meta"][
        "reward_curve"]


def short_scenarios():
    from dataclasses import replace

    named = {s.name: s for s in default_battery()}
    return [replace(named["ramp"], duration=300.0),
            replace(named["burst"], duration=300.0)]


def thetas(population: int, hidden: int, seed: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    center = init_params(seed, hidden)
    return (center[None, :] + 0.3 * rng.standard_normal(
        (population, param_count(hidden)))).astype(np.float32)


@pytest.mark.parametrize("hidden,history,min_samples",
                         [(16, 64, 3), (8, 32, 5)])
def test_population_rollout_equals_the_reference(ref, hidden, history,
                                                 min_samples):
    batch = thetas(5, hidden)
    got = evaluate_population(batch, short_scenarios(), hidden=hidden,
                              history=history, min_samples=min_samples,
                              device="cpu")
    want = ref("population", thetas=batch, recipe="short", hidden=hidden,
               history=history, min_samples=min_samples)
    assert set(got) == set(SUMMARY_KEYS)
    for key in SUMMARY_KEYS:
        assert got[key].shape == (5, 2)
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12,
                                   atol=0, err_msg=key)


def test_serving_population_rollout_equals_the_reference(ref):
    batch = thetas(3, 16, seed=4)
    scenarios = default_twin_battery(cycles=48)
    got = evaluate_population_serving(batch, scenarios, hidden=16,
                                      history=16, device="cpu")
    want = ref("serving_population", thetas=batch, cycles=48, hidden=16,
               history=16)
    assert set(got) == set(SERVING_TRAIN_KEYS)
    for key in SERVING_TRAIN_KEYS:
        assert got[key].shape == (3, len(scenarios))
        if key == "time_over_slo_s":
            np.testing.assert_allclose(got[key], want[key], rtol=1e-9,
                                       atol=1e-9)
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_es_arithmetic_equals_the_reference(ref):
    rng = np.random.default_rng(11)
    rewards = rng.standard_normal(9)
    rewards[3] = rewards[5]  # a tie keeps argsort's order
    summaries = {key: np.abs(rng.standard_normal((4, 2))) * 50
                 for key in SUMMARY_KEYS}
    want = ref("train_math", rewards=rewards, summaries=summaries,
               recipe="short")
    np.testing.assert_array_equal(_rank_utilities(rewards),
                                  want["utilities"])
    scales = reference_scales(short_scenarios(), device="cpu")
    for got, expect in zip((scales.depth, scales.duration, scales.ticks,
                            scales.replica_budget), want["scales"]):
        np.testing.assert_array_equal(got, expect)
    np.testing.assert_array_equal(
        reward_vector(summaries, scales, ESConfig()), want["rewards"])


def test_rollout_refuses_bad_shapes():
    with pytest.raises(ValueError, match="thetas must be \\[population, "):
        evaluate_population(np.zeros((2, 5), np.float32), short_scenarios(),
                            hidden=16, device="cpu")
    with pytest.raises(ValueError, match="need at least one scenario"):
        evaluate_population(thetas(2, 16), [], hidden=16, device="cpu")
    from dataclasses import replace

    mixed = [short_scenarios()[0], replace(short_scenarios()[1],
                                           duration=600.0)]
    with pytest.raises(ValueError, match="must share a tick count"):
        evaluate_population(thetas(2, 16), mixed, hidden=16, device="cpu")
    import dataclasses

    serving = default_twin_battery(cycles=48)
    with pytest.raises(ValueError, match="must share \\(cycles, shards,"):
        evaluate_population_serving(
            thetas(2, 16), [serving[0], dataclasses.replace(
                serving[1], cycles=24)], hidden=16, history=16,
            device="cpu")
    with pytest.raises(ValueError, match="population must be an even"):
        ESConfig(population=3)
    with pytest.raises(ValueError, match="history must be >= 2"):
        ServingESConfig(history=1)


def test_evaluate_checkpoint_scores_like_the_battery():
    checkpoint = learn.load_checkpoint(str(ROOT / "LEARNED_POLICY.json"),
                                       device="cpu")
    rows = evaluate_checkpoint(checkpoint, short_scenarios(), device="cpu")
    assert [r["scenario"] for r in rows] == ["ramp", "burst"]
    assert all(r["policy"] == f"learned@{checkpoint.hash}" for r in rows)
    assert {"max_depth", "time_over_slo_s", "replica_changes"} <= set(rows[0])


def test_exports_name_everything_the_reference_exports():
    assert set(ref_learn._EXPORTS) <= set(learn._EXPORTS)
    for name, where in ref_learn._EXPORTS.items():
        assert learn._EXPORTS[name] == where
    # (``learn.train`` names the submodule once it is imported, as in the
    # reference, so the trainer is resolved through the export table)
    for name in ("ESConfig", "train_serving", "ServingESConfig",
                 "evaluate_population", "evaluate_population_serving",
                 "learned_config"):
        assert callable(getattr(learn, name))


def test_the_device_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="no usable CUDA card"):
        evaluate_population(thetas(2, 16), short_scenarios(), hidden=16)
    with pytest.raises(RuntimeError, match="no usable CUDA card"):
        train(short_scenarios(), ESConfig(population=2, generations=1))


def test_learn_demo_runs_clean():
    out = subprocess.run(
        [sys.executable, "-m", "kube_sqs_autoscaler_tpu_torch.learn",
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["ok"] is True and summary["divergences"] == 0
    assert summary["generations"] == 6
    assert "RuntimeWarning" not in out.stderr
    no_card = subprocess.run(
        [sys.executable, "-m", "kube_sqs_autoscaler_tpu_torch.learn"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert no_card.returncode != 0
    assert "no usable CUDA card" in no_card.stderr
