"""``python -m kube_sqs_autoscaler_tpu_torch.fleet``: one deterministic
FakeClock fleet episode.

The port's copy of ``python -m kube_sqs_autoscaler_tpu.fleet``: the
:class:`~..core.loop.ControlLoop` autoscales a
:class:`~.pool.WorkerPool` of serving replicas over one shared queue, on
a virtual clock:

1. **spawn** — backlog trips the up gate; new replicas share the params
   and adopt the first replica's engine;
2. **kill** — a :class:`~..sim.faults.FleetFaultPlan` kills a busy
   replica; the supervisor re-dispatches its un-replied requests;
3. **exactly once** — every request is answered once, redeliveries and
   failover notwithstanding;
4. **drain** — the drained queue trips the down gate; replicas stop
   admitting, finish their slots and retire; the fleet returns to min.

Prints one JSON line; exit 0 when every milestone was observed, 2
otherwise.  The model is the reference's tiny one (head dim 16, so its
attention is the dense path on the card too); it runs on the card
(``--device cuda``, the default) and exits with an error when there is
none, or on the CPU with ``--device cpu``.  Only the clocks are virtual.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Sequence

from ..core.clock import FakeClock
from ..core.loop import ControlLoop, LoopConfig
from ..core.policy import PolicyConfig
from ..metrics.fake import FakeMessageQueue
from ..metrics.queue import QueueMetricSource
from ..sim.faults import FleetFaultPlan
from .pool import DRAINING, SERVING, FleetDriver, WorkerPool

MESSAGES = 12
KILL_CYCLE = 8
KILL_REPLICA = 1
QUEUE = "fleet://demo"
RESULTS = "fleet://demo-results"


def demo_model():
    """The reference demo's model: vocab 128, d_model 32, 2 heads (head
    dim 16), 2 layers, bf16."""
    from ..workloads.model import ModelConfig

    return ModelConfig(vocab_size=128, d_model=32, n_heads=2, n_layers=2,
                       d_ff=64, max_seq_len=6 + 24)


def _demo_episode(device="cuda", params=None, model=None):
    """Run the episode; ``params``/``model`` default to :func:`demo_model`
    with weights from seed 0.  Returns ``(pool, params, stats, sent,
    replies, duplicates)``."""
    import numpy as np
    import torch

    from ..workloads.model import init_params
    from ..workloads.service import ServiceConfig, collect_replies

    model = model or demo_model()
    if params is None:
        params = init_params(model, torch.Generator().manual_seed(0), device)
    clock = FakeClock()
    # virtual-time visibility: an in-flight message outliving 30 virtual
    # seconds is redelivered, which the reply dedup must absorb
    queue = FakeMessageQueue(visibility_timeout=30.0, now_fn=clock.now)
    results = FakeMessageQueue(now_fn=clock.now)
    config = ServiceConfig(
        queue_url=QUEUE, batch_size=2, seq_len=6, generate_tokens=24,
        decode_block=4, result_queue_url=RESULTS,
    )
    rng = np.random.default_rng(7)
    sent = [
        queue.send_message(
            QUEUE, json.dumps(rng.integers(1, model.vocab_size, 5).tolist())
        )
        for _ in range(MESSAGES)
    ]
    pool = WorkerPool.serving(
        queue, params, model, config, result_queue=results,
        min=1, max=3, clock=clock, drain_timeout_cycles=200, device=device,
    )
    loop = ControlLoop(
        pool,
        QueueMetricSource(queue, QUEUE, ("ApproximateNumberOfMessages",)),
        LoopConfig(
            poll_interval=1.0,
            policy=PolicyConfig(
                scale_up_messages=4, scale_down_messages=1,
                scale_up_cooldown=1.0, scale_down_cooldown=2.0,
            ),
        ),
        clock=clock,
    )
    plan = FleetFaultPlan(kills=((KILL_CYCLE, KILL_REPLICA),))
    driver = FleetDriver(pool, loop, cycle_dt=0.5, fault_plan=plan)
    stats = driver.run(
        max_cycles=600,
        until=lambda: (
            pool.processed >= MESSAGES
            and pool.idle
            and pool.replicas == pool.min
            and not any(r.state == DRAINING for r in pool.members)
        ),
    )
    replies, duplicates = collect_replies(results, RESULTS)
    return pool, params, stats, sent, replies, duplicates


def _check_demo(pool, params, stats, sent, replies, duplicates) -> list[str]:
    """The expected trajectory, as individually reportable milestones."""
    problems: list[str] = []

    def expect(condition: bool, message: str) -> None:
        if not condition:
            problems.append(message)

    names = [e.name for e in pool.events]
    # 1. spawn: the backlog scaled the fleet past one replica, and spin-up
    #    shared the params and the engine
    expect(names.count("replica-spawn") >= 2,
           "the up gate never spawned a second replica")
    expect(max(stats["replica_trajectory"], default=0) >= 2,
           "the replica trajectory never reached 2")
    expect(
        all(r.worker.batcher.params is params for r in pool.members),
        "a replica rebuilt its params instead of sharing the pool's",
    )
    engines = {id(r.worker.batcher._insert_many) for r in pool.members}
    expect(len(engines) == 1,
           "replicas built separate engines instead of adopting one")
    # 2. kill: the fault plan fired on a busy replica and the supervisor
    #    re-dispatched its in-flight work
    kills = [e for e in pool.events if e.name == "replica-kill"]
    expect(bool(kills), "the kill was never detected")
    expect(
        any(e.args.get("redispatched", 0) > 0 for e in kills),
        "the killed replica had no in-flight requests to re-dispatch "
        "(tune KILL_CYCLE)",
    )
    # 3. every request answered exactly once
    expect(len(replies) == len(sent),
           f"lost replies: {len(replies)}/{len(sent)} requests answered")
    expect(duplicates == 0,
           f"{duplicates} duplicate reply(ies) reached the consumer")
    expect(set(replies) == set(sent),
           "reply request_ids do not match the sent MessageIds")
    # 4. drain: the down gate retired the extra replicas gracefully
    expect("replica-drain-start" in names, "no replica ever drained")
    expect("replica-drain-done" in names, "no drain ever completed")
    expect(pool.replicas == pool.min,
           f"fleet did not return to min={pool.min} "
           f"(serving {pool.replicas})")
    expect(
        sum(1 for r in pool.members if r.state == SERVING) == pool.min,
        "serving-state accounting disagrees with the replicas property",
    )
    expect(bool(pool.trace_events()),
           "the fleet produced no Chrome-trace instant events")
    return problems


def main(argv: Sequence[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="kube-sqs-autoscaler-torch-fleet",
        description="Deterministic fleet episode: spawn -> kill -> "
        "re-dispatch -> drain — fails on any missing milestone.",
    )
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the replicas run (default cuda; no card is an error, "
             "never a quiet CPU run)",
    )
    args = parser.parse_args(argv)
    from ..device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"error: {err}") from None
    pool, params, stats, sent, replies, duplicates = _demo_episode(device)
    problems = _check_demo(pool, params, stats, sent, replies, duplicates)
    print(json.dumps({
        "cycles": stats["cycles"],
        "ticks": stats["ticks"],
        "requests": len(sent),
        "replies": len(replies),
        "duplicate_replies": duplicates,
        "duplicates_suppressed": pool.duplicates_suppressed,
        "redispatched": pool.redispatched_total,
        "replica_trajectory": stats["replica_trajectory"],
        "final_replicas": pool.replicas,
        "events": [e.name for e in pool.events],
        "device": str(device),
        "ok": not problems,
    }))
    for line in problems:
        print(f"unexpected trajectory: {line}", file=sys.stderr)
    return 0 if not problems else 2


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
