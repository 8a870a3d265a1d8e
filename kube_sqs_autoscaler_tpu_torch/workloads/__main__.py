"""Worker binary: ``python -m kube_sqs_autoscaler_tpu_torch.workloads``.

Counterpart of ``python -m kube_sqs_autoscaler_tpu.workloads``: one
queue-draining inference worker, the process a scaled Deployment replica
runs.  ``--family gpt`` (the default) serves the built-in GPT,
``--family llama`` the built-in llama (RoPE, GQA with 2 kv heads, RMSNorm,
SwiGLU) through every mode below.

- ``--sqs-queue-url URL [--aws-region R]`` serves that SQS queue until
  the process is stopped, through :class:`~.service.QueueWorker` (or,
  with ``--continuous``, the rolling-slot
  :class:`~.continuous.ContinuousWorker`); with ``--result-queue-url``
  the same client publishes one reply per message.  Credentials come
  from the standard AWS chain (environment, shared file, instance role).
- ``--demo N`` self-feeds an in-memory queue with N random messages (the
  same bodies as the reference binary's demo), drains it and exits.
- ``--shards S`` (with ``--continuous``) stacks S engine shards of
  ``--batch-size`` slots behind one admission plane, gang-stepped in one
  decode dispatch a cycle (:class:`~.shard_plane.ShardedBatcher`).  With
  ``--fleet-max-replicas`` (and ``--continuous``) a
  :class:`~..core.loop.ControlLoop` autoscales a
  :class:`~..fleet.WorkerPool` of continuous replicas over that queue on
  the real clock (with ``--shards``, each replica is a plane).
- ``--metrics-port P`` serves ``/metrics`` (the serve-cycle latency
  summary; the continuous worker's serving gauges and TTFT histogram; the
  fleet's replica gauges) and ``/healthz``.
- ``--quantize int8`` serves per-channel int8 weights
  (:mod:`.quantize`), ``--quantize-kv`` decodes through the int8 KV cache,
  and ``--prefix-ids ID,ID,...`` prefills a shared prompt prefix once at
  start-up that every body continues from (the built-in config's context
  grows by its length); all three compose with every mode above.
- ``--speculative-draft-layers N --speculative-draft-tokens K`` decodes
  by draft and verify, the model's first N layers proposing K tokens a
  round (:mod:`.speculative`); ``--beams W [--length-penalty A]`` runs
  beam search (:mod:`.beam`).  Each serves through the batch worker and
  ``--continuous`` (not ``--decode-block > 1``, ``--shards`` or the fleet)
  and composes with ``--quantize-kv`` and ``--prefix-ids``.

The worker runs on the card (``--device cuda``, the default) and exits
with an error when there is none; ``--device cpu`` runs it on the CPU.
Weights are the built-in config's, drawn from a seeded generator.
Flags of the reference binary whose paths are not ported yet
(``--checkpoint-dir``, ``--hf-checkpoint``, ``--model-parallel``,
``--tenants``, ...) are not accepted; ``--speculative-draft-layers`` with
``--shards``, which the reference serves on its decode plane, exits with a
message naming ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

import argparse
import json
import logging
import time

import numpy as np
import torch

from ..device import resolve_device
from ..metrics.fake import FakeMessageQueue
from ..utils.logging import configure_logging
from .continuous import ContinuousWorker
from .family import family_of
from .llama import LlamaConfig
from .model import ModelConfig
from .quantize import quantize_params, quantized_bytes
from .service import QueueWorker, ServiceConfig, collect_replies, sampling_keys

log = logging.getLogger("worker")

DEMO_QUEUE = "demo://queue"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="kube-sqs-autoscaler-torch-worker")
    parser.add_argument("--sqs-queue-url", default="", help="The sqs queue url")
    parser.add_argument("--aws-region", default="", help="Your AWS region")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument(
        "--family", choices=tuple(BUILTIN_CONFIGS), default="gpt",
        help="model family served: gpt (learned positions, MHA) or llama "
             "(RoPE, GQA: an n_kv_heads-sized KV cache)",
    )
    parser.add_argument("--seq-len", type=int, default=64)
    parser.add_argument(
        "--generate-tokens", type=int, default=0, metavar="N",
        help="decode N continuation tokens per message (KV-cache generate "
             "mode) instead of one classify forward",
    )
    parser.add_argument(
        "--temperature", type=float, default=0.0,
        help="generate-mode sampling temperature (0 = greedy)",
    )
    parser.add_argument(
        "--top-k", type=int, default=0,
        help="sample only the k highest-probability tokens (0 = off)",
    )
    parser.add_argument(
        "--top-p", type=float, default=1.0,
        help="nucleus sampling: smallest token set with cumulative "
             "probability >= p (1.0 = off)",
    )
    parser.add_argument(
        "--eos-id", type=int, default=-1, metavar="ID",
        help="stop generating a row once it emits this token id (-1 = none)",
    )
    parser.add_argument(
        "--result-queue-url", default="",
        help="publish one JSON reply per message to this queue "
             "(classify: {'next_token': N}; generate: {'tokens': [...]})",
    )
    parser.add_argument(
        "--continuous", action="store_true",
        help="continuous batching: rolling decode slots that refill as "
             "each message finishes instead of batch-at-a-time (requires "
             "--generate-tokens >= 1)",
    )
    parser.add_argument(
        "--decode-block", type=int, default=1, metavar="B",
        help="continuous serving: advance every live slot up to B tokens "
             "per decode dispatch, with the eos/budget masks on the device "
             "and the next block dispatched before the last one is read; "
             "greedy results equal --decode-block 1 (requires --continuous)",
    )
    parser.add_argument(
        "--shards", type=int, default=1, metavar="S",
        help="sharded serving plane: stack S gang-stepped engine shards of "
             "--batch-size slots each behind one admission plane; all "
             "shards advance in one decode dispatch a cycle, refills go to "
             "the freest shard first, and greedy outputs equal S independent "
             "workers' (requires --continuous)",
    )
    parser.add_argument(
        "--request-ttl", type=float, default=0.0, metavar="SECONDS",
        help="continuous serving: answer a message already older than this "
             "on arrival (its SentTimestamp) with {'error': 'expired'} "
             "instead of decoding it (0 = off; requires --continuous)",
    )
    parser.add_argument(
        "--metrics-port", type=int, default=0,
        help="serve /metrics with serve-cycle latency summaries "
             "(p50/p99/max from the worker's SpanTimer; 0 = disabled)",
    )
    parser.add_argument(
        "--fleet-max-replicas", type=int, default=0, metavar="N",
        help="autoscale a POOL of continuous workers between "
             "--fleet-min-replicas and N with the control loop: replicas "
             "share the params and the engine, drain gracefully on "
             "scale-down, and survive worker death via supervised "
             "re-dispatch (0 = single worker; requires --continuous and "
             "--demo)",
    )
    parser.add_argument(
        "--fleet-min-replicas", type=int, default=1, metavar="N",
        help="lower replica bound for --fleet-max-replicas",
    )
    parser.add_argument(
        "--quantize", choices=("none", "int8"), default="none",
        help="int8: post-training per-channel weight quantization of the "
             "served matmul weights",
    )
    parser.add_argument(
        "--quantize-kv", action="store_true",
        help="int8 KV cache: decode reads int8 codes and per-position "
             "scales instead of full-precision k/v (requires "
             "--generate-tokens >= 1; composes with --continuous, --shards, "
             "--fleet-max-replicas and --prefix-ids)",
    )
    parser.add_argument(
        "--prefix-ids", default="", metavar="ID,ID,...",
        help="shared prompt prefix (comma-separated token ids), prefilled "
             "once at start-up and reused by every request: message bodies "
             "become per-request suffixes continuing from the cached prefix "
             "(the outputs of prepending it to every prompt; requires "
             "--generate-tokens >= 1)",
    )
    parser.add_argument(
        "--speculative-draft-layers", type=int, default=0, metavar="N",
        help="speculative decoding with an early-exit self-draft: the "
             "model's own first N layers propose tokens and the full "
             "model verifies them in one chunk forward (greedy output "
             "identical to plain greedy decode; --temperature > 0 runs "
             "speculative sampling, every emitted token a warped-target "
             "sample; requires --generate-tokens >= 1; composes with "
             "--continuous, --quantize-kv and --prefix-ids; not with "
             "--beams)",
    )
    parser.add_argument(
        "--speculative-draft-tokens", type=int, default=4, metavar="K",
        help="proposals per speculative round (each round emits 1..K+1 "
             "tokens for one full-model pass)",
    )
    parser.add_argument(
        "--beams", type=int, default=1, metavar="W",
        help="beam-search generation with W beams (deterministic: not with "
             "--temperature or --speculative-draft-layers; 1 = greedy or "
             "sampled decode; composes with --continuous, where each slot "
             "owns W beam rows, --quantize-kv and --prefix-ids)",
    )
    parser.add_argument(
        "--length-penalty", type=float, default=0.0, metavar="ALPHA",
        help="GNMT length normalization for --beams > 1: finished beams "
             "rank by score / ((5 + len) / 6) ** ALPHA (0 = raw log-prob "
             "ranking)",
    )
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the model runs (default cuda; no card is an error, "
             "never a quiet CPU run)",
    )
    parser.add_argument(
        "--demo", type=int, default=0, metavar="N",
        help="process N random messages from a local in-memory queue and exit",
    )
    return parser


def builtin_config(seq_len: int, generate_tokens: int,
                   prefix_len: int = 0, headroom: int = 0) -> ModelConfig:
    """The built-in GPT, with a context that holds a ``prefix_len``-token
    shared prefix, the prompt, its continuation and ``headroom`` more
    positions (the speculative rounds' 2k; at least 64 in all)."""
    return ModelConfig(
        vocab_size=8192, d_model=512, n_heads=8, n_layers=4, d_ff=2048,
        max_seq_len=max(64, prefix_len + seq_len + generate_tokens
                        + headroom),
    )


def builtin_llama_config(seq_len: int, generate_tokens: int,
                         prefix_len: int = 0,
                         headroom: int = 0) -> LlamaConfig:
    """The built-in llama (``--family llama``): the GPT's vocab, width,
    heads and depth, 2 kv heads and d_ff 1408, with the same context."""
    return LlamaConfig(
        vocab_size=8192, d_model=512, n_heads=8, n_kv_heads=2, n_layers=4,
        d_ff=1408,
        max_seq_len=max(64, prefix_len + seq_len + generate_tokens
                        + headroom),
    )


BUILTIN_CONFIGS = {"gpt": builtin_config, "llama": builtin_llama_config}


def builtin_model(family: str, seq_len: int, generate_tokens: int,
                  device: str | torch.device, prefix_len: int = 0,
                  headroom: int = 0):
    """``(config, params)``: the built-in model of ``family`` (``--family``)
    and its weights, drawn from a generator seeded 0."""
    config = BUILTIN_CONFIGS[family](seq_len, generate_tokens, prefix_len,
                                     headroom)
    init = family_of(config).init_params
    return config, init(config, torch.Generator().manual_seed(0), device)


def demo_queue(demo: int, model_config: ModelConfig,
               service_config: ServiceConfig) -> FakeMessageQueue:
    """An in-memory queue holding the demo's ``demo`` random bodies of
    ``seq_len`` token ids (seed 0, the reference binary's bodies); points
    ``service_config`` at it."""
    queue = FakeMessageQueue()
    rng = np.random.default_rng(0)
    for _ in range(demo):
        ids = rng.integers(0, model_config.vocab_size,
                           service_config.seq_len).tolist()
        queue.send_message(DEMO_QUEUE, json.dumps(ids))
    service_config.queue_url = DEMO_QUEUE
    return queue


def serve_metrics(port: int, source):
    """Start ``/metrics`` for a worker or a fleet pool (``port`` 0 =
    disabled, returns None): a worker's serve-cycle SpanTimer; a
    continuous worker's serving gauges and TTFT histogram, or a pool's
    replica gauges and every replica's TTFT samples, refreshed every
    cycle."""
    if not port:
        return None
    from ..obs import ObservabilityServer, WorkloadMetrics

    metrics = WorkloadMetrics()
    if hasattr(source, "timer"):
        metrics.attach_timer("worker", source.timer)
    if hasattr(source, "attach_metrics"):
        source.attach_metrics(metrics)
    server = ObservabilityServer(metrics, port=port)
    server.start()
    return server


def run_demo(
    demo: int,
    params: dict,
    model_config: ModelConfig,
    service_config: ServiceConfig,
    device: torch.device,
    continuous: bool = False,
    metrics_port: int = 0,
    prefix_cache: dict | None = None,
    modes: tuple[dict, dict] = ({}, {}),
) -> dict:
    """Feed ``demo`` random bodies through a :class:`QueueWorker` (or,
    with ``continuous``, drain them through a :class:`ContinuousWorker`)
    and collect the replies; returns the run's counts and rates.
    ``modes`` holds the two workers' decode-mode keywords
    (:func:`decode_modes`)."""
    queue = demo_queue(demo, model_config, service_config)
    result_queue = FakeMessageQueue() if service_config.result_queue_url else None
    if continuous:
        worker = ContinuousWorker(queue, params, model_config, service_config,
                                  result_queue=result_queue, device=device,
                                  prefix_cache=prefix_cache, **modes[1])
        server = serve_metrics(metrics_port, worker)
        start = time.perf_counter()
        worker.drain(total=demo)
        elapsed = time.perf_counter() - start
        batcher = worker.batcher
        generated = batcher.tokens_emitted
        engine = {
            "decode_dispatches": batcher.decode_dispatches,
            "insert_dispatches": batcher.insert_dispatches,
            "host_transfers": batcher.host_transfers,
            "block_settles": batcher.block_settles,
            "overlapped_settles": batcher.overlapped_settles,
            "gang_cycles": getattr(batcher, "gang_cycles", None),
            "summary_transfers": getattr(batcher, "summary_transfers", None),
            "block_utilization": (
                batcher.block_tokens / batcher.block_capacity
                if batcher.block_capacity else None
            ),
            "ttft_mean_s": (batcher.ttft_sum / batcher.ttft_count
                            if batcher.ttft_count else None),
            **{name: getattr(batcher, name) for name in SPEC_STATS},
        }
    else:
        worker = QueueWorker(queue, params, model_config, service_config,
                             result_queue=result_queue, device=device,
                             prefix_cache=prefix_cache, **modes[0])
        server = serve_metrics(metrics_port, worker)
        start = time.perf_counter()
        while worker.processed < demo:
            with worker.timer.span("cycle"):
                worker.run_once()
        elapsed = time.perf_counter() - start
        generated = worker.generated_tokens
        engine = dict.fromkeys((
            "decode_dispatches", "insert_dispatches", "host_transfers",
            "block_settles", "overlapped_settles", "gang_cycles",
            "summary_transfers", "block_utilization", "ttft_mean_s",
            *SPEC_STATS))
    if server is not None:
        server.stop()
    log.info(
        "Processed %d messages in %.2fs (%.1f msg/s%s) on %s",
        worker.processed, elapsed, worker.processed / elapsed,
        ", continuous" if continuous else "", device,
    )
    replies, duplicates = {}, 0
    if result_queue is not None:
        replies, duplicates = collect_replies(
            result_queue, service_config.result_queue_url
        )
        for payload in list(replies.values())[:2]:
            log.info("Reply: %.120s", json.dumps(payload))
    return {
        "device": str(device),
        "processed": worker.processed,
        "elapsed_s": elapsed,
        "msgs_per_s": worker.processed / elapsed,
        "generated_tokens": generated,
        "tokens_per_s": generated / elapsed,
        "replies": replies,
        "duplicate_replies": duplicates,
        "queue_attributes": queue.get_queue_attributes(DEMO_QUEUE, ()),
        "cycle": worker.timer.summary().get("cycle"),
        **engine,
    }


# the continuous engine's speculative counters, in the demo's summary
SPEC_STATS = ("spec_rounds", "spec_accepted", "spec_second_rounds",
              "spec_overlapped")


def decode_modes(args, model_config, service_config: ServiceConfig,
                 device: torch.device,
                 prefix_cache: dict | None = None) -> tuple[dict, dict]:
    """``--beams`` / ``--speculative-draft-*`` as the keywords of the two
    workers: ``(QueueWorker's, ContinuousWorker's)``.  The batch worker
    gets a ``generate_fn`` (:func:`.beam.beam_search`, or
    :func:`.speculative.speculative_generate` with the early-exit
    self-draft), its prompt passes on the bucket's attention pick (the
    CUDA flash forward on the card; under a prefix the suffix prefill runs
    the chunk decoder); the continuous worker gets the knobs."""
    family = family_of(model_config)

    def attention(tokens):
        if prefix_cache is not None:
            return None
        return family.attention_fn_for(model_config, tokens.shape[1], device)

    if args.beams > 1:
        from .beam import beam_search

        def beam_generate(p, tokens, n, lengths):
            return beam_search(
                p, model_config, tokens, n, beams=args.beams,
                length_penalty=args.length_penalty,
                eos_id=service_config.eos_id, attention_fn=attention(tokens),
                lengths=lengths, prefix_cache=prefix_cache,
                quantized_cache=service_config.quantized_kv,
            )

        log.info("Beam search: %d beams", args.beams)
        return ({"generate_fn": beam_generate},
                {"beams": args.beams, "length_penalty": args.length_penalty})
    if not args.speculative_draft_layers:
        return {}, {}
    from .speculative import (
        draft_prefix_from_target, self_draft, speculative_generate,
    )

    n_draft = args.speculative_draft_layers
    k = args.speculative_draft_tokens
    keys = sampling_keys(service_config.sample_seed, device)
    draft_prefix = (draft_prefix_from_target(prefix_cache, n_draft)
                    if prefix_cache is not None else None)

    def spec_generate(p, tokens, n, lengths):
        draft_params, draft_config = self_draft(p, model_config, n_draft)
        return speculative_generate(
            p, model_config, draft_params, draft_config, tokens, n,
            draft_tokens=k, attention_fn=attention(tokens), lengths=lengths,
            temperature=service_config.temperature,
            generator=(next(keys) if service_config.temperature > 0.0
                       else None),
            top_k=service_config.top_k, top_p=service_config.top_p,
            eos_id=service_config.eos_id,
            quantized_cache=service_config.quantized_kv,
            prefix_cache=prefix_cache, draft_prefix_cache=draft_prefix,
        )

    log.info("Speculative decoding: %d-layer early-exit self-draft, "
             "%d proposals/round", n_draft, k)
    return ({"generate_fn": spec_generate},
            {"draft_layers": n_draft, "draft_tokens": k})


def run_fleet_demo(
    demo: int,
    params: dict,
    model_config: ModelConfig,
    service_config: ServiceConfig,
    device: torch.device,
    min_replicas: int,
    max_replicas: int,
    metrics_port: int = 0,
    prefix_cache: dict | None = None,
) -> dict:
    """The closed loop in one process, on the real clock: a
    :class:`~..core.loop.ControlLoop` autoscales a
    :class:`~..fleet.WorkerPool` of continuous replicas between
    ``min_replicas`` and ``max_replicas`` over the demo queue until every
    message is answered; returns the run's counts and rates."""
    from ..core.loop import ControlLoop, LoopConfig
    from ..core.policy import PolicyConfig
    from ..fleet import FleetDriver, WorkerPool
    from ..metrics.queue import QueueMetricSource

    queue = demo_queue(demo, model_config, service_config)
    result_queue = FakeMessageQueue() if service_config.result_queue_url else None
    pool = WorkerPool.serving(
        queue, params, model_config, service_config,
        result_queue=result_queue, min=min_replicas, max=max_replicas,
        device=device, prefix_cache=prefix_cache,
    )
    server = serve_metrics(metrics_port, pool)
    batch = service_config.batch_size
    loop = ControlLoop(
        pool,
        QueueMetricSource(queue, service_config.queue_url,
                          ("ApproximateNumberOfMessages",)),
        LoopConfig(
            poll_interval=0.1,
            policy=PolicyConfig(
                scale_up_messages=2 * batch, scale_down_messages=batch,
                scale_up_cooldown=0.2, scale_down_cooldown=0.4,
            ),
        ),
    )
    driver = FleetDriver(pool, loop)
    start = time.perf_counter()
    stats = driver.run(until=lambda: pool.processed >= demo and pool.idle)
    elapsed = time.perf_counter() - start
    pool.stop_all()
    if server is not None:
        server.stop()
    batchers = [r.worker.batcher for r in pool.members]
    generated = sum(b.tokens_emitted for b in batchers)
    ttft_count = sum(b.ttft_count for b in batchers)
    log.info(
        "Fleet processed %d messages in %.2fs (%.1f msg/s, %d ticks, "
        "replicas %s, redispatched %d, duplicate replies suppressed %d)",
        pool.processed, elapsed, pool.processed / elapsed, stats["ticks"],
        stats["replica_trajectory"] or [1], pool.redispatched_total,
        pool.duplicates_suppressed,
    )
    replies, duplicates = {}, 0
    if result_queue is not None:
        replies, duplicates = collect_replies(
            result_queue, service_config.result_queue_url
        )
    return {
        "device": str(device),
        "processed": pool.processed,
        "elapsed_s": elapsed,
        "msgs_per_s": pool.processed / elapsed,
        "generated_tokens": generated,
        "tokens_per_s": generated / elapsed,
        "ttft_mean_s": (sum(b.ttft_sum for b in batchers) / ttft_count
                        if ttft_count else None),
        "insert_dispatches": sum(b.insert_dispatches for b in batchers),
        # block settles that found the next block still running, and all
        "overlapped_settles": sum(b.overlapped_settles for b in batchers),
        "block_settles": sum(b.block_settles for b in batchers),
        "replica_trajectory": stats["replica_trajectory"],
        "ticks": stats["ticks"],
        "redispatched": pool.redispatched_total,
        "duplicates_suppressed": pool.duplicates_suppressed,
        "replies": replies,
        "duplicate_replies": duplicates,
        "queue_attributes": queue.get_queue_attributes(DEMO_QUEUE, ()),
    }


def serve_sqs(args, params: dict, model_config: ModelConfig,
              service_config: ServiceConfig, device: torch.device,
              prefix_cache: dict | None = None,
              modes: tuple[dict, dict] = ({}, {})) -> None:
    """Serve ``--sqs-queue-url`` until the worker is stopped.  AWS SQS
    addresses queues per call by url, so the same client publishes replies
    when ``--result-queue-url`` is set."""
    from ..metrics.sqs_aws import AwsSqsService

    queue = AwsSqsService(region=args.aws_region)
    result_queue = queue if args.result_queue_url else None
    worker_class = ContinuousWorker if args.continuous else QueueWorker
    worker = worker_class(queue, params, model_config, service_config,
                          result_queue=result_queue, device=device,
                          prefix_cache=prefix_cache,
                          **modes[1 if args.continuous else 0])
    server = serve_metrics(args.metrics_port, worker)
    log.info("Starting %sworker on %s",
             "continuous " if args.continuous else "", args.sqs_queue_url)
    try:
        worker.run_forever()
    finally:
        if server is not None:
            server.stop()


def main(argv=None) -> dict | None:
    """Parse ``argv``, check the flags (a usage error exits before any
    model is built), then run the demo (returning its summary) or serve
    the SQS queue until stopped (returning None)."""
    configure_logging()
    args = build_parser().parse_args(argv)
    check_beams(args)
    if args.generate_tokens < 0:
        raise SystemExit(f"--generate-tokens {args.generate_tokens} must be >= 0")
    if args.decode_block < 1:
        raise SystemExit(f"--decode-block {args.decode_block} must be >= 1")
    if args.decode_block > 1 and not args.continuous:
        raise SystemExit("--decode-block requires --continuous")
    spec_on_plane = bool(args.speculative_draft_layers) and args.shards > 1
    if args.decode_block > 1 and (
            args.beams > 1
            or (args.speculative_draft_layers and not spec_on_plane)):
        raise SystemExit(
            "--decode-block applies to the plain continuous decode path "
            "(not --beams; --speculative-draft-layers only with --shards "
            "/ --tenants, where the decode plane's gang engine carries it)"
        )
    if args.request_ttl < 0:
        raise SystemExit(
            f"--request-ttl {args.request_ttl} must be >= 0 (0 = off)"
        )
    if args.request_ttl > 0 and not args.continuous:
        raise SystemExit("--request-ttl requires --continuous")
    if args.continuous and args.generate_tokens < 1:
        raise SystemExit("--continuous requires --generate-tokens >= 1")
    if args.shards < 1:
        raise SystemExit(f"--shards {args.shards} must be >= 1")
    if args.shards > 1 and not args.continuous:
        raise SystemExit("--shards requires --continuous")
    if args.shards > 1 and args.beams > 1:
        raise SystemExit(
            "--shards applies to the plain continuous decode path "
            "(not --beams)"
        )
    if spec_on_plane:
        # the reference serves this on its decode plane (planes/engine.py)
        raise SystemExit(
            "--speculative-draft-layers with --shards runs on the decode "
            "plane, not yet ported (ROADMAP Queue 1 item 7)"
        )
    if args.quantize_kv and args.generate_tokens < 1:
        raise SystemExit("--quantize-kv requires --generate-tokens >= 1")
    prefix_ids = parse_prefix_ids(args)
    if args.fleet_max_replicas:
        if not args.continuous:
            raise SystemExit("--fleet-max-replicas requires --continuous")
        if args.beams > 1 or args.speculative_draft_layers:
            raise SystemExit(
                "--fleet-max-replicas applies to the plain continuous "
                "decode path (replica spin-up adopts the donor's engine; "
                "not with --beams / --speculative-draft-layers)"
            )
        if not 1 <= args.fleet_min_replicas <= args.fleet_max_replicas:
            raise SystemExit(
                f"need 1 <= --fleet-min-replicas "
                f"({args.fleet_min_replicas}) <= --fleet-max-replicas "
                f"({args.fleet_max_replicas})"
            )
        if not args.demo:
            raise SystemExit(
                "--fleet-max-replicas currently requires --demo (the "
                "in-process fleet autoscales over the demo's in-memory "
                "queue; SQS-backed fleets are one process per replica, "
                "scaled by the autoscaler itself)"
            )
    if not args.demo and not args.sqs_queue_url:
        raise SystemExit(
            "error: pass --sqs-queue-url URL to serve a queue, or --demo N "
            "to drain N random messages from a local in-memory queue"
        )
    # speculative rounds need 2k cache positions past the generated tokens
    # (speculative.speculative_generate's budget)
    spec_headroom = (2 * args.speculative_draft_tokens
                     if args.speculative_draft_layers else 0)
    check_speculative_budget(
        args, BUILTIN_CONFIGS[args.family](args.seq_len, args.generate_tokens,
                                           len(prefix_ids), spec_headroom),
        len(prefix_ids))
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"error: {err}") from None
    model_config, params = builtin_model(args.family, args.seq_len,
                                         args.generate_tokens, device,
                                         prefix_len=len(prefix_ids),
                                         headroom=spec_headroom)
    family = family_of(model_config)
    weight_bytes = None
    if args.quantize == "int8":
        before = quantized_bytes(params)
        params = quantize_params(params, family=family.name)
        weight_bytes = (before, quantized_bytes(params))
        log.info("Quantized weights to int8: %.1f MiB -> %.1f MiB",
                 before / 2**20, weight_bytes[1] / 2**20)
    prefix_cache = None
    if prefix_ids:
        bad = [i for i in prefix_ids if not 0 <= i < model_config.vocab_size]
        if bad:
            raise SystemExit(
                f"--prefix-ids {bad} out of range for vocab_size="
                f"{model_config.vocab_size}"
            )
        with torch.inference_mode():
            prefix_cache = family.layout(args.quantize_kv).prefill_prefix(
                params, prefix_ids, model_config,
                family.attention_fn_for(model_config, len(prefix_ids),
                                        device))
        log.info("Prefix cache: %d shared tokens prefilled once",
                 len(prefix_ids))
    service_config = ServiceConfig(
        queue_url=args.sqs_queue_url, batch_size=args.batch_size,
        seq_len=args.seq_len,
        generate_tokens=args.generate_tokens, temperature=args.temperature,
        top_k=args.top_k, top_p=args.top_p,
        result_queue_url=args.result_queue_url,
        eos_id=None if args.eos_id < 0 else args.eos_id,
        decode_block=args.decode_block, request_ttl_s=args.request_ttl,
        shards=args.shards, quantized_kv=args.quantize_kv,
    )
    modes = decode_modes(args, model_config, service_config, device,
                         prefix_cache)
    if not args.demo:
        serve_sqs(args, params, model_config, service_config, device,
                  prefix_cache, modes)
        return None
    if args.fleet_max_replicas:
        summary = run_fleet_demo(
            args.demo, params, model_config, service_config, device,
            args.fleet_min_replicas, args.fleet_max_replicas,
            metrics_port=args.metrics_port, prefix_cache=prefix_cache,
        )
    else:
        summary = run_demo(args.demo, params, model_config, service_config,
                           device, continuous=args.continuous,
                           metrics_port=args.metrics_port,
                           prefix_cache=prefix_cache, modes=modes)
    summary["weight_bytes"] = weight_bytes
    return summary


def check_beams(args) -> None:
    """The reference binary's first args-only checks, of ``--beams`` and
    ``--length-penalty``: a usage error exits before any model is
    built."""
    if args.beams < 1:
        raise SystemExit(f"--beams {args.beams} must be >= 1")
    if args.beams > 1:
        for flag, bad in (
            ("--temperature > 0 (beam search is deterministic)",
             args.temperature > 0.0),
            ("--speculative-draft-layers",
             bool(args.speculative_draft_layers)),
            ("--generate-tokens >= 1 required", args.generate_tokens < 1),
        ):
            if bad:
                raise SystemExit(f"--beams does not support {flag}")
    if args.length_penalty < 0.0:
        raise SystemExit(
            f"--length-penalty {args.length_penalty} must be >= 0"
        )
    if args.length_penalty > 0.0 and args.beams < 2:
        raise SystemExit("--length-penalty requires --beams > 1")


def check_speculative_budget(args, model_config, prefix_len: int) -> None:
    """The reference binary's start-up checks of the speculative flags
    against the built model: a generate mode, ``K >= 1``, a draft depth
    in ``[1, n_layers - 1]`` and the cache budget with its 2k slack."""
    if not args.speculative_draft_layers:
        return
    if args.generate_tokens < 1:
        raise SystemExit(
            "--speculative-draft-layers requires --generate-tokens >= 1"
        )
    n_draft = args.speculative_draft_layers
    k = args.speculative_draft_tokens
    if k < 1:
        raise SystemExit(f"--speculative-draft-tokens {k} must be >= 1")
    if not 0 < n_draft < model_config.n_layers:
        raise SystemExit(
            f"--speculative-draft-layers {n_draft} must be in "
            f"[1, n_layers-1] (model has n_layers={model_config.n_layers})"
        )
    budget = prefix_len + args.seq_len + args.generate_tokens + 2 * k
    if budget > model_config.max_seq_len:
        raise SystemExit(
            f"prefix + seq_len + generate_tokens + 2*draft_tokens = "
            f"{budget} exceeds the model's max_seq_len="
            f"{model_config.max_seq_len} (the speculative cache budget); "
            "lower --speculative-draft-tokens or the lengths"
        )


def parse_prefix_ids(args) -> list[int]:
    """``--prefix-ids`` as token ids, with the reference binary's checks
    (the vocabulary range is checked once the model is built)."""
    if not args.prefix_ids:
        return []
    try:
        prefix_ids = [int(s) for s in args.prefix_ids.split(",") if s.strip()]
    except ValueError as err:
        raise SystemExit(f"--prefix-ids must be integers ({err})")
    if not prefix_ids:
        raise SystemExit("--prefix-ids is empty")
    if args.generate_tokens < 1:
        raise SystemExit("--prefix-ids requires --generate-tokens >= 1")
    return prefix_ids


if __name__ == "__main__":
    main()
