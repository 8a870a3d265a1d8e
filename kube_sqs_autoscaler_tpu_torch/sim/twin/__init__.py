"""The token-level compiled serving twin.

The fluid compiled twin simulates a *fluid queue* — the right world for the
reference autoscaler, the wrong one for the sharded serving fleet the
controller actuates: the fleet is scored in tokens/s,
TTFT, and time-over-TTFT-SLO, and its spin-up is a near-free mask flip
(BLITZSCALE), which a fluid replica-rate world cannot express at all.

This package simulates the serving plane itself at token granularity —
slots, decode blocks, refill/admission, freest-first + sticky routing,
prefix-cache hits/misses, shard counts behind the drain/retire state
machine — as one loop over engine cycles on a batch of configs ×
scenarios, the architecture ``sim/compiled.py`` uses for the fluid loop
(the port's copy of ``kube_sqs_autoscaler_tpu/sim/twin/``).  Fidelity is mechanical, not assumed:
:func:`~.fidelity.verify_twin_fidelity` replays the identical scripted
request streams through the REAL :class:`~...workloads.shard_plane.
ShardedBatcher` and compares cycle-for-cycle completions, tokens,
TTFT, queue depths, shard counts, and prefix hits/misses — 0
divergences, reported through replay's ``Divergence`` machinery.

The learned autoscaling policy (``learn/``) retrains inside this twin
with reward in serving units (tokens/s, time-over-TTFT-SLO, churn);
:func:`~...learn.serving.train_serving` trains it.
"""

from .compiled import (  # noqa: F401
    SERVING_SUMMARY_KEYS,
    TRAJECTORY_KEYS,
    TwinConfig,
    TwinEpisode,
    run_twin_episodes,
    run_twin_grouped,
    score_twin_summary,
)
from .fidelity import TwinFidelityReport, verify_twin_fidelity  # noqa: F401
from .host import run_host_episode, tiny_twin_model  # noqa: F401
from .scenario import (  # noqa: F401
    ServingScenario,
    default_twin_battery,
    twin_variants,
)
