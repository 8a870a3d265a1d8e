"""The controller binary: the reference's flags, names and defaults.

The port's copy of ``kube_sqs_autoscaler_tpu/cli.py``, run as ``python -m
kube_sqs_autoscaler_tpu_torch`` or the ``kube-sqs-autoscaler-torch``
console script.  It polls a queue's depth (SQS over SigV4, standard
library only) and scales one Kubernetes Deployment between ``--min-pods``
and ``--max-pods`` through :class:`~.core.loop.ControlLoop`, with the
opt-in resilience layer (``--metric-retries`` … ``--stale-depth-ttl``),
the durable state (``--state-path``, ``--state-max-age``), the flight
journal (``--journal-path`` …), request-lifecycle tracing
(``--request-trace``), the metrics server (``--metrics-port``,
``--healthz-stale-after``) and the three scaling policies: ``reactive``
(the reference's), ``predictive`` (:mod:`.forecast`: ``--forecaster``,
``--forecast-horizon``, ``--forecast-history``) and ``learned``
(:mod:`.learn`: ``--policy-checkpoint``, the reference's JSON
checkpoints).  The reactive controller imports no torch; the predictive
and learned policies run their forecasts and network on ``--device``
(``cuda`` by default, as the worker's; a missing card is an error, never
a quiet CPU run), the one flag the reference does not have (it picks its
platform from ``JAX_PLATFORMS``).

Env vars: ``KUBE_CONFIG_PATH`` selects a kubeconfig file (in-cluster
config when unset or empty); AWS credentials come from the standard AWS
environment chain.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import signal
from typing import Sequence

from .core.loop import ControlLoop, LoopConfig
from .core.policy import PolicyConfig
from .core.resilience import ResilienceConfig
from .metrics.queue import (
    DEFAULT_ATTRIBUTE_NAMES_CSV,
    QueueMetricSource,
    parse_attribute_names,
)
from .utils.duration import parse_duration
from .utils.logging import configure_logging

log = logging.getLogger(__name__)

#: Wall-clock TTL of every registered durable-state section: an hour-old
#: snapshot's forecaster history, breaker verdicts and learned mirror
#: describe a world that no longer exists.
_STATE_SECTION_TTL_S = 3600.0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="kube-sqs-autoscaler-torch",
        description=(
            "Queue-driven pod autoscaler: polls queue depth and scales a "
            "Kubernetes Deployment between --min-pods and --max-pods."
        ),
    )
    parser.add_argument(
        "--poll-period", type=parse_duration, default=5.0, metavar="DURATION",
        help="The interval in seconds for checking if scaling is required",
    )
    parser.add_argument(
        "--scale-down-cool-down", type=parse_duration, default=30.0,
        metavar="DURATION", help="The cool down period for scaling down",
    )
    parser.add_argument(
        "--scale-up-cool-down", type=parse_duration, default=10.0,
        metavar="DURATION", help="The cool down period for scaling up",
    )
    parser.add_argument(
        "--scale-up-messages", type=int, default=100,
        help="Number of sqs messages queued up required for scaling up",
    )
    parser.add_argument(
        "--scale-down-messages", type=int, default=10,
        help="Number of messages required to scaling down",
    )
    parser.add_argument(
        "--scale-up-pods", type=int, default=1, help="Number of Pod in scaling up"
    )
    parser.add_argument(
        "--scale-down-pods", type=int, default=1, help="Number of Pod in scaling down"
    )
    parser.add_argument(
        "--max-pods", type=int, default=5,
        help="Max pods that kube-sqs-autoscaler can scale",
    )
    parser.add_argument(
        "--min-pods", type=int, default=1,
        help="Min pods that kube-sqs-autoscaler can scale",
    )
    parser.add_argument("--aws-region", default="", help="Your AWS region")
    parser.add_argument(
        "--attribute-names", default=DEFAULT_ATTRIBUTE_NAMES_CSV,
        help=(
            "A comma-separated list of queue attribute names to query in "
            "calculating the number of messages"
        ),
    )
    parser.add_argument("--sqs-queue-url", default="", help="The sqs queue url")
    parser.add_argument(
        "--kubernetes-deployment", default="",
        help="Kubernetes Deployment to scale. This field is required",
    )
    parser.add_argument(
        "--kubernetes-namespace", default="default",
        help="The namespace your deployment is running in",
    )
    # 0 disables the server entirely = reference behavior.
    parser.add_argument(
        "--metrics-port", type=int, default=0,
        help=(
            "Serve /metrics (Prometheus), /healthz, /readyz and the "
            "/debug/ticks + /debug/trace flight-recorder endpoints on this "
            "port (0 = disabled)"
        ),
    )
    # Flight recorder (obs/journal.py): an append-only JSONL journal of
    # every tick record, plus an in-memory ring behind the /debug
    # endpoints.  Both disabled by default; the journal's schema is the
    # reference package's, whose replay reads it.
    parser.add_argument(
        "--journal-path", default="", metavar="PATH",
        help=(
            "Append every tick record as one JSON line to this file "
            "(schema-versioned flight journal; empty = disabled)"
        ),
    )
    parser.add_argument(
        "--journal-ring", type=int, default=256, metavar="N",
        help=(
            "Tick records kept in memory for /debug/ticks and /debug/trace "
            "when --metrics-port is enabled (0 = disabled)"
        ),
    )
    parser.add_argument(
        "--journal-max-bytes", type=int, default=64 * 1024 * 1024,
        metavar="BYTES",
        help=(
            "Rotate the journal file (to <path>.1) when it would exceed "
            "this size"
        ),
    )
    # Request-lifecycle tracing (obs/lifecycle.py): a bounded host-side
    # registry of per-request phase chains behind /debug/requests and the
    # request_phase_seconds histograms.  Off by default, and off means no
    # registry at all: every stamp site stays behind an `is None` check.
    parser.add_argument(
        "--request-trace", type=int, default=0, metavar="N",
        help=(
            "Keep per-request phase-chain traces for the newest N open "
            "requests (arrival/staged/admitted/prefill/first_token/"
            "handoff/completed/reply stamps behind /debug/requests and "
            "request_phase_seconds histograms; 0 = disabled, the engine "
            "path is byte-identical). With --state-path, open traces "
            "ride the durable snapshot across restarts"
        ),
    )
    # The scaling policy: 'reactive' is the reference's behavior;
    # --policy=predictive thresholds the forecasted depth at now +
    # --forecast-horizon, --policy=learned a trained network's decision,
    # both through the same gates.
    parser.add_argument(
        "--policy", choices=("reactive", "predictive", "learned"),
        default="reactive",
        help=(
            "Scaling policy: 'reactive' thresholds the observed queue depth "
            "(reference behavior); 'predictive' thresholds the forecasted "
            "depth at now + --forecast-horizon; 'learned' thresholds a "
            "trained network's up/hold/down decision (requires "
            "--policy-checkpoint)"
        ),
    )
    parser.add_argument(
        "--policy-checkpoint", default="", metavar="PATH",
        help=(
            "Trained learned-policy checkpoint (versioned JSON from "
            "the learned-policy trainer, e.g. LEARNED_POLICY.json); "
            "validated at startup — a missing/corrupt/incompatible file is "
            "rejected before the loop starts. Requires --policy=learned"
        ),
    )
    parser.add_argument(
        "--forecaster", choices=("ewma", "holt", "lstsq"), default="holt",
        help=(
            "Forecaster for --policy=predictive: ewma (flat level), holt "
            "(level+trend), lstsq (windowed line fit)"
        ),
    )
    parser.add_argument(
        "--forecast-horizon", type=parse_duration, default=60.0,
        metavar="DURATION",
        help="How far ahead the predictive policy forecasts queue depth",
    )
    parser.add_argument(
        "--forecast-history", type=_history_size, default=128,
        help="Depth observations kept for forecasting (ring buffer size)",
    )
    # Resilience layer (core/resilience.py): retries, per-call deadlines,
    # circuit breaker, stale-depth hold.  Every default is the reference's
    # log-and-skip behavior; each flag opts one mechanism in.
    parser.add_argument(
        "--metric-retries", type=_retry_count, default=0, metavar="N",
        help=(
            "Extra attempts per queue-depth poll, with seeded jittered "
            "exponential backoff budgeted within the poll period "
            "(0 = reference: one attempt, failures skip the tick)"
        ),
    )
    parser.add_argument(
        "--metric-timeout", type=parse_duration, default=0.0,
        metavar="DURATION",
        help=(
            "Per-attempt deadline for queue-depth polls; a poll returning "
            "later counts as failed (0 = no deadline)"
        ),
    )
    parser.add_argument(
        "--scaler-retries", type=_retry_count, default=0, metavar="N",
        help=(
            "Extra attempts per scale actuation, same backoff policy "
            "(0 = reference: one attempt, failures end the tick)"
        ),
    )
    parser.add_argument(
        "--scaler-timeout", type=parse_duration, default=0.0,
        metavar="DURATION",
        help=(
            "Per-attempt deadline for scale actuations; a call returning "
            "later counts as failed (0 = no deadline)"
        ),
    )
    parser.add_argument(
        "--breaker-failures", type=int, default=0, metavar="N",
        help=(
            "Open a circuit breaker around the scaler after N consecutive "
            "actuation failures — further fires fail fast without the RPC "
            "until a half-open probe succeeds (0 = no breaker)"
        ),
    )
    parser.add_argument(
        "--breaker-reset", type=parse_duration, default=60.0,
        metavar="DURATION",
        help=(
            "How long the breaker stays open before admitting one "
            "half-open probe (success re-closes, failure re-opens)"
        ),
    )
    parser.add_argument(
        "--stale-depth-ttl", type=parse_duration, default=0.0,
        metavar="DURATION",
        help=(
            "On a failed poll, reuse the last good queue depth up to this "
            "age (the tick proceeds marked stale; forecasters never see "
            "held depths); past the TTL the tick skips like the reference "
            "(0 = never hold)"
        ),
    )
    parser.add_argument(
        "--healthz-stale-after", type=parse_duration, default=0.0,
        metavar="DURATION",
        help=(
            "/healthz turns 503 when no tick has completed for this long "
            "(0 = always 200 while serving; needs --metrics-port)"
        ),
    )
    # Durable control-plane state (core/durable.py): snapshot the loop's
    # whole control state each tick and rehydrate it on restart.  Empty =
    # reference behavior (a restart loses cooldowns, breaker state,
    # forecaster history, the learned mirror — everything).
    parser.add_argument(
        "--state-path", default="", metavar="PATH",
        help=(
            "Snapshot the control-plane state (cooldown stamps, breaker, "
            "forecaster history, learned-policy mirror) to this file after "
            "every tick, atomically, and rehydrate it on restart; a "
            "corrupt/foreign snapshot cold-starts, never crash-loops "
            "(empty = disabled, reference restart behavior)"
        ),
    )
    parser.add_argument(
        "--state-max-age", type=parse_duration, default=0.0,
        metavar="DURATION",
        help=(
            "Cold-start instead of rehydrating when the snapshot is older "
            "than this (stale memory is worse than no memory; 0 = no "
            "limit — per-section TTLs still apply)"
        ),
    )
    # The port's counterpart of the reference's JAX_PLATFORMS: where the
    # predictive and learned policies compute (the worker's --device).
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help=(
            "Device of the predictive policy's forecasts and the learned "
            "policy's network: cuda (the default; no usable card is an "
            "error) or cpu"
        ),
    )
    return parser


def _retry_count(value: str) -> int:
    """Retry flags: a usage error below 0, like every other flag
    (RetryPolicy would reject it later with a raw traceback otherwise)."""
    count = int(value)
    if count < 0:
        raise argparse.ArgumentTypeError(
            f"retry count must be >= 0, got {count}"
        )
    return count


def _history_size(value: str) -> int:
    """Ring-buffer capacity: a usage error below 2, like every other flag
    (DepthHistory would reject it later with a raw traceback otherwise)."""
    size = int(value)
    if size < 2:
        raise argparse.ArgumentTypeError(
            f"--forecast-history must be >= 2, got {size}"
        )
    return size


def config_from_args(args: argparse.Namespace) -> LoopConfig:
    return LoopConfig(
        poll_interval=args.poll_period,
        policy=PolicyConfig(
            scale_up_messages=args.scale_up_messages,
            scale_down_messages=args.scale_down_messages,
            scale_up_cooldown=args.scale_up_cool_down,
            scale_down_cooldown=args.scale_down_cool_down,
        ),
    )


def resilience_from_args(args: argparse.Namespace) -> ResilienceConfig:
    """The resilience flags as one config (``enabled`` False at defaults,
    so the loop keeps the reference code path)."""
    return ResilienceConfig(
        metric_retries=args.metric_retries,
        metric_timeout=args.metric_timeout,
        scaler_retries=args.scaler_retries,
        scaler_timeout=args.scaler_timeout,
        breaker_failures=args.breaker_failures,
        breaker_reset=args.breaker_reset,
        stale_depth_ttl=args.stale_depth_ttl,
    )


def validate_flag_interactions(parser: argparse.ArgumentParser,
                               args: argparse.Namespace) -> None:
    """Cross-flag checks argparse types cannot express.

    The loop is sleep-first: ``seconds_since_last_tick`` legitimately
    grows to a full poll period between ticks, so a staleness threshold
    at or below the poll period would 503 a perfectly healthy controller
    for most of every interval (and restart-loop the pod).
    """
    if 0 < args.healthz_stale_after <= args.poll_period:
        parser.error(
            f"--healthz-stale-after ({args.healthz_stale_after:g}s) must "
            f"exceed --poll-period ({args.poll_period:g}s): the loop "
            "completes at most one tick per poll period, so a healthy "
            "controller would fail the probe between ticks"
        )
    if args.state_max_age and not args.state_path:
        parser.error(
            "--state-max-age only applies with --state-path (there is "
            "no snapshot to age out)"
        )
    if args.policy == "learned" and not args.policy_checkpoint:
        parser.error(
            "--policy=learned requires --policy-checkpoint (the trained "
            "weights are a deployment artifact, not a default)"
        )
    if args.policy_checkpoint and args.policy != "learned":
        parser.error(
            "--policy-checkpoint only applies to --policy=learned "
            f"(got --policy={args.policy})"
        )


def policy_device(parser: argparse.ArgumentParser,
                  args: argparse.Namespace):
    """The predictive or learned policy's device (``--device``); no
    usable card for ``cuda`` is an error before anything is wired."""
    from .device import resolve_device

    try:
        return resolve_device(args.device)
    except RuntimeError as err:
        parser.exit(1, f"{parser.prog}: error: {err}\n")


def load_learned_checkpoint(parser: argparse.ArgumentParser,
                            args: argparse.Namespace):
    """Load + validate the learned checkpoint, or ``None`` when not learned.

    Runs at startup, after :func:`validate_flag_interactions` and before
    any client wiring: a missing, corrupt, wrong-kind, future-schema,
    geometry-mismatched or serving-twin checkpoint is a *usage error*
    (exit 2 with the loader's message, the reference's words), never a
    mid-tick traceback.  Its weights land on ``--device``.
    """
    if args.policy != "learned":
        return None
    from .learn import CheckpointError, load_checkpoint
    from .learn.checkpoint import TWIN_FLUID, require_twin

    try:
        checkpoint = load_checkpoint(args.policy_checkpoint, device="cpu")
        # deployment seam: this binary drives the fluid control loop, so
        # a SERVING-twin checkpoint (tokens/s reward, shard-count
        # actuation) is a usage error here, not garbage decisions later
        require_twin(checkpoint, TWIN_FLUID, "--policy learned")
    except CheckpointError as err:
        parser.error(str(err))
    device = policy_device(parser, args)
    return dataclasses.replace(checkpoint, theta=checkpoint.theta.to(device))


def main(argv: Sequence[str] | None = None) -> None:
    """Wire the real clients and run until SIGTERM or SIGINT."""
    configure_logging()
    parser = build_parser()
    args = parser.parse_args(argv)
    validate_flag_interactions(parser, args)
    # Learned policy: reject a bad checkpoint NOW, not mid-tick.
    checkpoint = load_learned_checkpoint(parser, args)
    device = (policy_device(parser, args)
              if args.policy == "predictive" else None)

    # Imports deferred so the pure control-plane modules (policy, loop,
    # fakes) never pull in the real-client stacks.
    from .metrics.sqs_aws import AwsSqsService
    from .scale.actuator import PodAutoScaler
    from .scale.kube import KubeDeploymentAPI

    autoscaler = PodAutoScaler(
        client=KubeDeploymentAPI(namespace=args.kubernetes_namespace),
        max=args.max_pods,
        min=args.min_pods,
        scale_up_pods=args.scale_up_pods,
        scale_down_pods=args.scale_down_pods,
        deployment=args.kubernetes_deployment,
        namespace=args.kubernetes_namespace,
    )
    metric_source = QueueMetricSource(
        client=AwsSqsService(region=args.aws_region),
        queue_url=args.sqs_queue_url,
        attribute_names=parse_attribute_names(args.attribute_names),
    )

    # Durable control-plane state: the store is built first so every
    # stateful subsystem can register a section as it is wired up;
    # rehydration runs after the loop exists and BEFORE the journal
    # reopens, so the fresh journal header carries the restart block.
    store = None
    if args.state_path:
        from .core.durable import DurableStateStore

        store = DurableStateStore(
            args.state_path,
            max_age_s=args.state_max_age,
            journal_path=args.journal_path or None,
        )

    # The request-lifecycle registry, built only when asked for, and a
    # durable section, so open traces rejoin their chains after a restart
    lifecycle = None
    if args.request_trace > 0:
        from .obs import LifecycleRegistry

        lifecycle = LifecycleRegistry(capacity=args.request_trace)
        if store is not None:
            store.register("request_trace", lifecycle,
                           ttl_s=_STATE_SECTION_TTL_S)

    server = None
    observers = []
    journal = None
    if args.metrics_port:
        from . import __version__
        from .obs import ControllerMetrics, ObservabilityServer, TickRing

        metrics = ControllerMetrics(
            version=__version__,
            # build_info{policy}: the learned label carries the checkpoint
            # content hash, so a scrape names exactly which weights run
            policy=(
                f"learned@{checkpoint.hash}"
                if checkpoint is not None
                else args.policy
            ),
            forecaster=(
                args.forecaster if args.policy == "predictive" else ""
            ),
        )
        observers.append(metrics)
        if store is not None:
            # /healthz answers 503 ("rehydrating") until the first
            # post-restart tick completes
            store.metrics = metrics
            metrics.begin_rehydration()
        ring = None
        if args.journal_ring > 0:
            ring = TickRing(args.journal_ring)
            observers.append(ring)
        server = ObservabilityServer(
            metrics,
            port=args.metrics_port,
            ring=ring,
            unhealthy_after=args.healthz_stale_after,
            # restart/rehydrate instants land beside the ticks on
            # /debug/trace (their own "restart" category)
            trace_sources=(store,) if store is not None else (),
            # /debug/requests, and per-request lanes on /debug/trace
            lifecycle=lifecycle,
        )
        server.start()

    # Predictive/learned policies: imported only when asked for, so the
    # reactive controller never imports torch.
    depth_policy = None
    if args.policy == "predictive":
        from .forecast import DepthHistory, PredictivePolicy, make_forecaster

        history = DepthHistory(capacity=args.forecast_history)
        depth_policy = PredictivePolicy(
            make_forecaster(args.forecaster, device=str(device)),
            history,
            horizon=args.forecast_horizon,
        )
        observers.append(history)  # fed from the tick-record observer hook
        if store is not None:
            store.register("forecast-history", history,
                           ttl_s=_STATE_SECTION_TTL_S)
    elif checkpoint is not None:
        from .forecast import DepthHistory
        from .learn import LearnedPolicy
        from .learn.checkpoint import checkpoint_history

        # The feature window is part of what the weights mean: it comes
        # from the checkpoint (stamped at training time), not from
        # --forecast-history.
        history_size, min_samples = checkpoint_history(checkpoint)
        depth_policy = LearnedPolicy(
            checkpoint,
            policy=config_from_args(args).policy,
            poll_interval=args.poll_period,
            max_pods=args.max_pods,
            min_pods=args.min_pods,
            scale_up_pods=args.scale_up_pods,
            scale_down_pods=args.scale_down_pods,
            # The controller never reads the deployment's size; the
            # mirror starts at min_pods (the training worlds all start at
            # or above it, and a mirror below it would jump UP on the
            # first scale-DOWN clamp).
            initial_replicas=args.min_pods,
            history=DepthHistory(capacity=history_size),
            min_samples=min_samples,
        )
        # the policy is its own observer: the tick-record hook feeds both
        # the depth history and the replica/cooldown mirror
        observers.append(depth_policy)
        if store is not None:
            store.register("learned-mirror", depth_policy,
                           ttl_s=_STATE_SECTION_TTL_S)
        log.info(
            "Loaded learned policy checkpoint %s (hash %s, hidden %d)",
            args.policy_checkpoint,
            checkpoint.hash,
            checkpoint.hidden,
        )

    loop = ControlLoop(
        autoscaler,
        metric_source,
        config_from_args(args),
        resilience=resilience_from_args(args),
        durable=store,
        depth_policy=depth_policy,
    )
    if store is not None:
        if loop.resilience is not None:
            store.register("resilience", loop.resilience,
                           ttl_s=_STATE_SECTION_TTL_S)
        # Trust the observed world: one deployment GET at boot (only with
        # --state-path; the reference path stays RPC-free at startup).  A
        # dead apiserver degrades to no reconciliation, never a crash;
        # the learned mirror reconciles against the observed count.
        observed = None
        try:
            observed = autoscaler.client.get(
                args.kubernetes_deployment
            ).replicas
        except Exception as err:
            log.warning(
                "Could not observe deployment replicas for "
                "rehydration reconcile (%s); restored state stands", err,
            )
        report = store.rehydrate(
            loop.clock.now(), observed_replicas=observed,
        )
        log.info(
            "Rehydration: %s (%d recovered, %d expired, restart #%d)",
            "cold start" + (f" — {report.reason}" if report.reason else "")
            if report.cold_start else "warm",
            report.records_recovered, report.records_expired,
            report.restarts,
        )
    if args.journal_path:
        from .obs import TickJournal

        meta = _journal_meta(args, checkpoint)
        if store is not None:
            # idempotent: the rehydrate above already ran; this stamps the
            # restart block and pins the order (rehydrate precedes reopen)
            meta = store.journal_meta_after_rehydrate(
                loop.clock.now(), meta
            )
        journal = TickJournal(
            args.journal_path,
            meta=meta,
            max_bytes=args.journal_max_bytes,
        )
        observers.append(journal)
        if lifecycle is not None:
            # closed traces land in the journal as "request" lines
            lifecycle.journal = journal

    if not observers:
        observer = None
    elif len(observers) == 1:
        observer = observers[0]
    else:
        from .core.events import MultiObserver

        observer = MultiObserver(observers)
    loop.observer = observer

    # Exit cleanly on SIGTERM/SIGINT so pod termination ends the current
    # tick instead of hard-killing mid-RPC; takes effect at the next tick
    # boundary (at most one poll period later).
    def _shutdown(signum: int, frame) -> None:
        log.info("Received signal %d, shutting down after current tick", signum)
        loop.stop()

    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)

    log.info("Starting kube-sqs-autoscaler")
    try:
        loop.run()
    finally:
        if server is not None:
            server.stop()
        if journal is not None:
            journal.close()
    log.info("kube-sqs-autoscaler stopped")


def _journal_meta(args: argparse.Namespace, checkpoint=None) -> dict:
    """The flight journal's header meta for a live run, the reference's
    layout: the controller config replay re-drives decisions from, plus
    the scaler world bounds (no ``initial_replicas``: the controller does
    not know the deployment's size without an extra RPC)."""
    return {
        "source": "live",
        "poll_interval": args.poll_period,
        "policy_config": {
            "scale_up_messages": args.scale_up_messages,
            "scale_down_messages": args.scale_down_messages,
            "scale_up_cooldown": args.scale_up_cool_down,
            "scale_down_cooldown": args.scale_down_cool_down,
        },
        "policy": args.policy,
        "world": {
            "min_pods": args.min_pods,
            "max_pods": args.max_pods,
            "scale_up_pods": args.scale_up_pods,
            "scale_down_pods": args.scale_down_pods,
        },
        "forecast": (
            {
                "forecaster": args.forecaster,
                "horizon": args.forecast_horizon,
                "history": args.forecast_history,
            }
            if args.policy == "predictive"
            else {}
        ),
        # learned policy: the content hash names which weights ran, so
        # replay can demand (and verify) the matching checkpoint
        "learn": (
            _learn_meta(args, checkpoint) if checkpoint is not None else {}
        ),
        # enabled resilience knobs only (empty = reference failure handling)
        "resilience": (
            {
                "metric_retries": args.metric_retries,
                "metric_timeout": args.metric_timeout,
                "scaler_retries": args.scaler_retries,
                "scaler_timeout": args.scaler_timeout,
                "breaker_failures": args.breaker_failures,
                "breaker_reset": args.breaker_reset,
                "stale_depth_ttl": args.stale_depth_ttl,
            }
            if resilience_from_args(args).enabled
            else {}
        ),
        "deployment": args.kubernetes_deployment,
        "namespace": args.kubernetes_namespace,
        "queue_url": args.sqs_queue_url,
    }


def _learn_meta(args: argparse.Namespace, checkpoint) -> dict:
    from .learn.checkpoint import checkpoint_history

    history, min_samples = checkpoint_history(checkpoint)
    return {
        "checkpoint_hash": checkpoint.hash,
        "checkpoint_path": args.policy_checkpoint,
        "hidden": int(checkpoint.hidden),
        "history": history,
        "min_samples": min_samples,
    }


if __name__ == "__main__":  # pragma: no cover
    main()
