"""The learned-policy demo: the lifecycle on a FakeClock.

A deterministic walk through the whole subsystem in a few seconds:
a tiny-population ES training run in the compiled twin, checkpoint
save → load with bitwise round-trip, the compiled-vs-Python fidelity
gate on the trained network, and a real ``ControlLoop`` episode on a
``FakeClock`` driven by the loaded checkpoint — exit 0 when every
milestone is observed, exit 2 on any missing one (the same contract as
the chaos and fleet demos).

The port's copy of ``kube_sqs_autoscaler_tpu/learn/__main__.py``: ``python
-m kube_sqs_autoscaler_tpu_torch.learn [--device cpu]``; the rollouts,
the fidelity gate and the deployed policy compute on ``--device`` (the
card by default).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from dataclasses import replace
from typing import Sequence

import numpy as np


def _demo_scenarios():
    """Two short worlds (60 ticks each): one ramp, one burst."""
    from ..sim.evaluate import default_battery

    base = {s.name: s for s in default_battery()}
    return [
        replace(base["ramp"], duration=300.0),
        replace(base["burst"], duration=300.0),
    ]


def _check_demo(device: str = "cuda") -> tuple[dict, list[str]]:
    problems: list[str] = []

    def expect(condition: bool, message: str) -> None:
        if not condition:
            problems.append(message)

    from ..sim.compiled import verify_fidelity
    from ..sim.simulator import Simulation
    from .checkpoint import load_checkpoint, save_checkpoint
    from .rollout import learned_config
    from .train import ESConfig, train

    scenarios = _demo_scenarios()

    # 1. train: a tiny population for a few seeded generations
    result = train(
        scenarios, ESConfig(population=8, generations=6, seed=7),
        device=device,
    )
    curve = result.reward_curve
    expect(
        all(np.isfinite(curve)), f"non-finite training rewards: {curve}"
    )
    # a tiny population is noisy generation-to-generation, so the
    # milestones are the ones train() actually guarantees: some
    # generation beat the seed, and the returned checkpoint is the best
    # center seen (never worse than anything on the curve)
    expect(
        max(curve) > curve[0],
        f"no generation improved on the seed policy: {curve}",
    )
    best = float(result.checkpoint.meta["best_train_reward"])
    expect(
        best >= max(curve) - 1e-12,
        f"returned checkpoint ({best}) is not the best center on the"
        f" curve ({max(curve)})",
    )

    # 2. checkpoint round trip: save -> load is bitwise
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "learned.json")
        save_checkpoint(path, result.checkpoint)
        loaded = load_checkpoint(path, device=device)
    expect(
        np.array_equal(loaded.theta.cpu().numpy(),
                       result.checkpoint.theta.cpu().numpy()),
        "checkpoint theta changed across save -> load",
    )
    expect(
        loaded.hash == result.checkpoint.hash,
        "checkpoint hash changed across save -> load",
    )

    # 3. fidelity: the compiled twin and the real ControlLoop agree
    # tick-for-tick on the trained network
    fidelity = verify_fidelity(
        scenarios=scenarios,
        forecasters=(),
        extra_episodes=[
            (f"{s.name}/learned", learned_config(s, loaded))
            for s in scenarios
        ],
        device=device,
    )
    expect(
        fidelity.ok,
        "compiled-vs-Python divergences: "
        + "; ".join(fidelity.format_divergences(3)),
    )

    # 4. deployment: a real ControlLoop episode on a FakeClock, decisions
    # bitwise identical between the trained and the reloaded weights
    decisions: list[list[int]] = []
    for checkpoint in (result.checkpoint, loaded):
        records: list = []

        class _Recorder:
            def on_tick(self, record):
                records.append(record)

        sim = Simulation(
            learned_config(scenarios[0], checkpoint),
            extra_observers=(_Recorder(),),
            device=device,
        )
        episode = sim.run()
        decisions.append([r.decision_messages for r in records])
    expect(
        decisions[0] == decisions[1],
        "reloaded checkpoint made different decisions than the"
        " freshly-trained one",
    )
    expect(
        episode.final_replicas > scenarios[0].min_pods,
        "the learned episode never scaled the fleet up",
    )

    summary = {
        "generations": len(curve),
        "reward_first": round(curve[0], 4),
        "reward_last": round(curve[-1], 4),
        "checkpoint_hash": loaded.hash,
        "fidelity_episodes": fidelity.episodes,
        "fidelity_ticks": fidelity.ticks,
        "divergences": len(fidelity.divergences),
        "episode_final_replicas": episode.final_replicas,
        "episode_max_depth": round(episode.max_depth, 1),
        "ok": not problems,
    }
    return summary, problems


def main(argv: Sequence[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Deterministic learned-policy lifecycle: tiny ES train,"
        " checkpoint round trip, fidelity gate, FakeClock deployment —"
        " fails on any missing milestone."
    )
    parser.add_argument(
        "--device", default="cuda",
        help="where the rollouts and the policy compute (default: cuda;"
        " 'cpu' to run without a card)",
    )
    args = parser.parse_args(argv)
    summary, problems = _check_demo(args.device)
    print(json.dumps(summary))
    for line in problems:
        print(f"missing milestone: {line}", file=sys.stderr)
    return 0 if not problems else 2


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
