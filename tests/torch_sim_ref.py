"""The reference's compiled twins and trainers as an oracle in a child
process.

The JAX package's ``sim/compiled.py``, ``sim/twin/compiled.py`` and
``learn/rollout.py`` import ``jax.experimental.enable_x64``, which this
JAX release spells ``jax.enable_x64``.  Applying that alias inside a
pytest worker would let the reference modules import there and change
what other test files in the same worker see, so the alias is applied in
a child process only: :class:`RefChild` starts ``python
tests/torch_sim_ref.py`` once (a module-scoped fixture per test module),
sends it ``(job, kwargs)`` pickles on stdin and reads numpy results back
on stdout.  Every job builds its worlds on the reference side from plain
arguments (scenario recipe names, cycle counts, theta arrays), so nothing
of the port crosses the pipe.
"""

from __future__ import annotations

import os
import pickle
import struct
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _send(stream, value) -> None:
    data = pickle.dumps(value)
    stream.write(struct.pack("<Q", len(data)))
    stream.write(data)
    stream.flush()


def _recv(stream):
    head = stream.read(8)
    if len(head) < 8:
        raise EOFError("the reference child closed its pipe")
    (size,) = struct.unpack("<Q", head)
    return pickle.loads(stream.read(size))


class RefChild:
    """One child process serving reference jobs (see the module doc)."""

    def __init__(self) -> None:
        env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "2"}
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve())],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=ROOT,
            env=env)

    def __call__(self, job: str, **kwargs):
        _send(self.proc.stdin, (job, kwargs))
        ok, value = _recv(self.proc.stdout)
        if not ok:
            raise RuntimeError(f"reference job {job} failed:\n{value}")
        return value

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.stdin.close()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


# ---------------------------------------------------------------------------
# The child side: the reference with the enable_x64 alias.
# ---------------------------------------------------------------------------


def fluid_scenarios(recipe: str):
    """Reference-side fluid worlds by recipe name (the tests build the
    port's from the same names)."""
    from dataclasses import replace

    from kube_sqs_autoscaler_tpu.sim.evaluate import default_battery
    from kube_sqs_autoscaler_tpu.sim.scenarios import scenario_variants

    base = list(default_battery())
    if recipe == "battery":
        return base
    if recipe == "short":
        named = {s.name: s for s in base}
        return [replace(named["ramp"], duration=300.0),
                replace(named["burst"], duration=300.0)]
    if recipe == "learn":
        return base + scenario_variants(base, 2, seed=101)
    raise KeyError(recipe)


def _episode_dict(label, episode):
    return {
        "label": label,
        "times": episode.times, "observed": episode.observed,
        "decision": episode.decision, "up": episode.up_codes,
        "down": episode.down_codes,
        "replicas_before": episode.replicas_before,
        "replicas_after": episode.replicas_after,
        "final_replicas": episode.result.final_replicas,
        "final_depth": episode.result.final_depth,
        "max_depth": episode.result.max_depth,
    }


def job_fluid_battery(learned_path: str | None = None,
                      forecasters=("ewma", "holt", "lstsq")):
    from kube_sqs_autoscaler_tpu.learn.checkpoint import load_checkpoint
    from kube_sqs_autoscaler_tpu.learn.rollout import learned_config
    from kube_sqs_autoscaler_tpu.sim import compiled

    scenarios = fluid_scenarios("battery")
    episodes = compiled._fidelity_configs(scenarios, forecasters)
    if learned_path:
        checkpoint = load_checkpoint(learned_path)
        episodes += [(f"{s.name}/learned", learned_config(s, checkpoint))
                     for s in scenarios]
    results = compiled.run_episodes_grouped([c for _, c in episodes])
    return [_episode_dict(label, episode)
            for (label, _), episode in zip(episodes, results)]


def job_population(thetas, recipe: str, hidden: int, history: int,
                   min_samples: int):
    from kube_sqs_autoscaler_tpu.learn.rollout import evaluate_population

    return evaluate_population(thetas, fluid_scenarios(recipe),
                               hidden=hidden, history=history,
                               min_samples=min_samples)


def job_train_math(rewards, summaries, recipe: str):
    from kube_sqs_autoscaler_tpu.learn.train import (
        ESConfig,
        _rank_utilities,
        reference_scales,
        reward_vector,
    )

    scales = reference_scales(fluid_scenarios(recipe))
    return {
        "utilities": _rank_utilities(rewards),
        "scales": [scales.depth, scales.duration, scales.ticks,
                   scales.replica_budget],
        "rewards": reward_vector(summaries, scales, ESConfig()),
    }


def job_sweep(recipe: str, points: list[dict], serving_cycles: int = 0):
    from kube_sqs_autoscaler_tpu.sim.sweep import SweepPoint, run_sweep
    from kube_sqs_autoscaler_tpu.sim.twin.scenario import (
        default_twin_battery,
    )

    scenarios = (default_twin_battery(cycles=serving_cycles)
                 if serving_cycles else fluid_scenarios(recipe))
    report = run_sweep([SweepPoint(**p) for p in points], scenarios)
    return [(row["scenario"], row["label"], row["score"])
            for row in report.rows]


def _twin_configs(cycles: int, serving_path: str | None, variants: int):
    from kube_sqs_autoscaler_tpu.learn.checkpoint import load_checkpoint
    from kube_sqs_autoscaler_tpu.sim.twin.compiled import TwinConfig
    from kube_sqs_autoscaler_tpu.sim.twin.scenario import (
        default_twin_battery,
        twin_variants,
    )

    base = default_twin_battery(cycles=cycles)
    if variants:
        base = base + twin_variants(base, variants, seed=301)
    rows = [TwinConfig(scenario=s) for s in base]
    if serving_path:
        checkpoint = load_checkpoint(serving_path)
        rows += [TwinConfig(scenario=s, policy="learned",
                            checkpoint=checkpoint) for s in base]
    return rows


def job_twin_battery(cycles: int, serving_path: str | None = None,
                     variants: int = 0):
    from kube_sqs_autoscaler_tpu.sim.twin.compiled import run_twin_grouped

    rows = _twin_configs(cycles, serving_path, variants)
    return [
        {"label": f"{c.scenario.name}/{c.policy}", "summary": e.summary,
         "trajectory": e.trajectory}
        for c, e in zip(rows, run_twin_grouped(rows))
    ]


def job_twin_encode(cycles: int):
    from kube_sqs_autoscaler_tpu.sim.twin.compiled import encode_twin_config

    rows = _twin_configs(cycles, None, 1)
    r_max = max(c.scenario.total_requests() for c in rows)
    t_max = max(1, max(c.scenario.tenants for c in rows))
    return [encode_twin_config(c, r_max, t_max) for c in rows]


def job_twin_scripts(cycles: int, variants: int, seed: int):
    from kube_sqs_autoscaler_tpu.sim.twin.scenario import (
        default_twin_battery,
        twin_variants,
    )

    base = default_twin_battery(cycles=cycles)
    return [
        {"name": s.name, "sends": s.sends(),
         "arrival_cycles": s.arrival_cycles(),
         "request_budgets": s.request_budgets(),
         "request_tenants": s.request_tenants()}
        for s in base + twin_variants(base, variants, seed=seed)
    ]


def job_serving_population(thetas, cycles: int, hidden: int, history: int,
                           variants: int = 0):
    from kube_sqs_autoscaler_tpu.learn.rollout import (
        evaluate_population_serving,
    )

    scenarios = [c.scenario for c in _twin_configs(cycles, None, variants)]
    return evaluate_population_serving(thetas, scenarios, hidden=hidden,
                                       history=history)


JOBS = {name[4:]: fn for name, fn in globals().items()
        if name.startswith("job_")}


def serve() -> None:
    import traceback

    import jax
    import jax.experimental

    # the reference's spelling of the x64 context manager, in this child
    # only
    jax.experimental.enable_x64 = jax.enable_x64
    sys.path.insert(0, str(ROOT))
    stdin, stdout = sys.stdin.buffer, sys.stdout.buffer
    sys.stdout = sys.stderr  # stray prints must not corrupt the pipe
    while True:
        try:
            job, kwargs = _recv(stdin)
        except EOFError:
            return
        try:
            _send(stdout, (True, JOBS[job](**kwargs)))
        except Exception:  # the test process shows the child's trace
            _send(stdout, (False, traceback.format_exc()))


if __name__ == "__main__":
    serve()
