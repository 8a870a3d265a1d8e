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
  ``--continuous`` (not the fleet) and composes with ``--quantize-kv``
  and ``--prefix-ids``.  Speculative with ``--shards`` or ``--tenants``
  runs on the decode plane (:class:`~..planes.engine.DecodePlaneBatcher`),
  where ``--decode-block`` carries the plain rows' gang block.
- ``--tenants A,B,...`` (with ``--continuous``) admits through per-tenant
  staging by deficit round robin (:mod:`.tenancy`), with
  ``--tenant-weights``, ``--tenant-slos`` and ``--urgency-window`` (the
  EDF jump), ``--shed-tiers`` (the overload ladder), ``--decode-slo-budget``
  (the decode deadline) and ``--prefix-pool N`` (N resident per-tenant
  prefixes of ``--seq-len`` tokens; the built-in context grows by
  ``--seq-len``).  Bodies opt in with ``{"tenant": ..., "prefix": [...],
  "ids": [...]}``; plain bodies land on the first tenant.  With
  ``--shards`` tenants get sticky home shards and per-shard pools;
  ``--admission-shards N`` splits the staging over N crash-tolerant
  admission shards (:mod:`.admission_shards`).

The worker runs on the card (``--device cuda``, the default) and exits
with an error when there is none; ``--device cpu`` runs it on the CPU.
Weights are the built-in config's, drawn from a seeded generator, unless
``--checkpoint-dir DIR`` serves what the port's trainer saved there (its
``model_config.json`` manifest gives the family and dimensions; a MoE
checkpoint is refused, as the reference refuses it) or
``--hf-checkpoint DIR`` a Hugging Face Llama/Mistral directory (this
needs ``transformers``).  ``--tokenizer DIR`` loads a ``transformers``
tokenizer from a local directory: text bodies (plain, a JSON string or
``{"text": ...}``) are encoded, replies carry the decoded ``text``, and
``--eos-id`` defaults to the tokenizer's.
The serving orchestration rides the same flags as the reference's:
``--scheduler`` runs the fleet demo on the event scheduler, ``--knobs``
arms live engine knobs there, ``--journal-path`` records the fleet's
control loop and ``--topology`` attaches a route-planning collective
scheduler to the continuous worker.

``--model-parallel TP`` serves over a ``(data, model)`` mesh of the
launch's ranks (``python -m torch.distributed.run --nproc-per-node N -m
kube_sqs_autoscaler_tpu_torch.workloads --model-parallel TP ...``): every
rank builds the full weights and keeps its slices
(:func:`.train.shard_params`), prompts split over ``data`` and heads over
``model`` (:func:`.decode.make_serving_fns` and its family, beam and
speculative twins, :func:`.train.make_forward_step`, the continuous engine
and the sharded plane on the mesh).  World rank 0 owns the queue: it
receives, replies and deletes, and broadcasts what it received to the
other ranks, which run the same host logic (:class:`.distributed.
RankQueue`).  In one process without a launcher a ``TP`` above 1 is a
usage error (exit 2), as the trainer's mesh flags are.  The fleet demo
(``--fleet-max-replicas``) runs over the mesh too: every rank runs the
control loop and the pool on rank 0's clock and queue depth.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

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
    parser.add_argument(
        "--checkpoint-dir", default="", metavar="DIR",
        help="serve the weights a trainer checkpointed here (reads the "
             "model_config.json manifest for family + dimensions; "
             "default: random init — smoke/bench mode)",
    )
    parser.add_argument(
        "--hf-checkpoint", default="", metavar="DIR",
        help="serve a Hugging Face Llama checkpoint directory "
             "(transformers format; converted via workloads.hf_convert — "
             "implies --family llama)",
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
        help="stop generating a row once it emits this token id (-1 = none "
             "/ auto from --tokenizer)",
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
             "--continuous, --quantize-kv and --prefix-ids, and with "
             "--shards / --tenants on the decode plane; not with --beams)",
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
        "--tenants", default="", metavar="NAME,NAME,...",
        help="multi-tenant fair admission: per-tenant sub-queues feed the "
             "continuous batcher by deficit round robin; bodies opt in via "
             "{'tenant': ..., 'ids': [...]} and unlabeled traffic lands on "
             "the first listed tenant (requires --continuous; not with "
             "--beams)",
    )
    parser.add_argument(
        "--tenant-weights", default="", metavar="W,W,...",
        help="DRR weights aligned with --tenants (floats >= 0.01, one per "
             "tenant; default: all 1.0)",
    )
    parser.add_argument(
        "--tenant-slos", default="", metavar="S,S,...",
        help="per-tenant TTFT SLOs in seconds aligned with --tenants "
             "(floats >= 0; 0 = none): the EDF jump's deadlines and the "
             "overload ladder's shed order",
    )
    parser.add_argument(
        "--urgency-window", type=float, default=0.0, metavar="SECONDS",
        help="EDF-blended admission: a staged request whose TTFT deadline "
             "is within this window of now jumps the DRR quantum, within a "
             "bounded per-tenant urgency budget (0 = off; requires "
             "--tenants)",
    )
    parser.add_argument(
        "--shed-tiers", type=int, default=0, metavar="N",
        help="tiered shedding under overload pressure: 1 = degrade "
             "over-share tenants to half --generate-tokens, 2 = + evict "
             "cold prefix-pool entries, 3 = + shed their staged requests "
             "with error replies (0 = off; requires --tenants)",
    )
    parser.add_argument(
        "--decode-slo-budget", type=float, default=0.0, metavar="SECONDS",
        help="decode-phase deadline: once a request has its first token it "
             "must sustain this many seconds per remaining token or be shed "
             "mid-decode with an error reply (0 = off; requires --tenants)",
    )
    parser.add_argument(
        "--prefix-pool", type=int, default=0, metavar="N",
        help="per-tenant prefix pool: N resident prefix entries with LRU "
             "eviction; a body's {'prefix': [...]} of exactly --seq-len "
             "tokens is prefilled once and gathered into every insert "
             "(0 = off; requires --tenants; not with --prefix-ids)",
    )
    parser.add_argument(
        "--admission-shards", type=int, default=1, metavar="N",
        help="sharded admission plane: split fair-admission staging over "
             "N crash-tolerant admission shards (tenants map to shards by "
             "consistent hash, each shard runs its own DRR/EDF and ladder, "
             "fairness across shards through rate-bounded credit "
             "borrowing, flood classifications gossip between shards; a "
             "killed shard hands its staged requests back to the queue and "
             "rehydrates next cycle; 1 = the single staging plane; "
             "requires --tenants)",
    )
    parser.add_argument(
        "--topology", default="", metavar="SHAPE",
        choices=("", "ring", "mesh2d", "torus", "two-tier"),
        help="topology-aware collective routing: model the fleet as a "
             "link graph of this shape (ring, mesh2d, torus, or "
             "two-tier islands over a slower tier), derived from the live "
             "--shards geometry, and attach a route-planning "
             "CollectiveScheduler: transfers get multi-hop routes over "
             "modeled links, and /metrics gains link_bytes_total / "
             "link_utilization plus a /debug/topology endpoint (default: "
             "off, byte-identical; requires --continuous)",
    )
    parser.add_argument(
        "--scheduler", action="store_true",
        help="run the fleet demo's control loop and serving cycles on the "
             "one event-driven scheduler (sched/: a priority-ordered event "
             "queue over one clock) instead of the hand-rolled interleave: "
             "the same behavior with no knobs armed, and the seam --knobs "
             "actuates through (requires --fleet-max-replicas)",
    )
    parser.add_argument(
        "--knobs", default="", metavar="KNOB,KNOB,...",
        help="arm live engine knobs for actuation between cycles at safe "
             "points: decode-block (re-dispatch boundary; needs "
             "--decode-block >= 2 or --shards >= 2), slot-limit (per-shard "
             "admission cap), shards (drain/retire mask flips; needs "
             "--shards >= 2), speculative (round-overlap toggle; needs "
             "--speculative-draft-layers, not --beams), prefix-pool "
             "(residency ceiling; needs --prefix-pool).  Every change is "
             "journaled, snapshotted, and exported as engine_knob{knob=...} "
             "gauges (requires --continuous and --scheduler)",
    )
    parser.add_argument(
        "--journal-path", default="", metavar="PATH",
        help="append the fleet control loop's tick records to this JSONL "
             "flight journal (the header meta stamps the deployment knobs "
             "incl. the tenancy config; requires --fleet-max-replicas; "
             "empty = disabled)",
    )
    parser.add_argument(
        "--tokenizer", default="", metavar="DIR",
        help="text-in/text-out: load a transformers tokenizer (from a "
             "local directory) and encode plain-text or {'text': ...} "
             "message bodies (and decode generate-mode replies)",
    )
    parser.add_argument(
        "--model-parallel", type=int, default=0, metavar="TP",
        help="serve over a (data, model) mesh of the launch's ranks with "
             "TP-way tensor parallelism (launch them with python -m "
             "torch.distributed.run; 0 = one device)",
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


def serve_metrics(port: int, source, comms=None, build_info=None,
                  metrics=None):
    """Start ``/metrics`` for a worker or a fleet pool (``port`` 0 =
    disabled, returns None): a worker's serve-cycle SpanTimer; a
    continuous worker's serving gauges and TTFT histogram (and, with
    tenancy, the per-tenant gauges, TTFT histogram, shed counters and
    overload gauges), or a pool's replica gauges and every replica's TTFT
    samples, refreshed every cycle.  A topology-attached ``comms``
    scheduler adds ``/debug/topology`` and the per-link gauges;
    ``build_info`` labels stamp a ``build_info`` gauge; ``metrics`` is a
    registry to serve (a fresh one by default).  On a serving mesh world
    rank 0 alone serves it (every rank would bind the same port), and the
    others return None."""
    from .distributed import is_lead

    if not port or not is_lead():
        return None
    from .. import __version__
    from ..obs import ObservabilityServer, WorkloadMetrics

    metrics = metrics if metrics is not None else WorkloadMetrics()
    if build_info is not None:
        metrics.set_build_info(__version__, **build_info)
    if hasattr(source, "timer"):
        metrics.attach_timer("worker", source.timer)
    if hasattr(source, "attach_metrics"):
        source.attach_metrics(metrics)
    server = ObservabilityServer(metrics, port=port, comms=comms)
    server.start()
    return server


def attach_topology(topology: str, shards: int, worker,
                    model_parallel: int = 1):
    """The ``--topology`` route-planning collective scheduler over the
    live ``--shards`` / ``--model-parallel`` geometry, wired through
    ``worker``'s engine; None when the flag is off (the engine byte for
    byte)."""
    if not topology:
        return None
    from ..comms import CollectiveScheduler, topology_from_geometry

    graph = topology_from_geometry(topology, shards=shards,
                                   model_parallel=model_parallel or 1)
    comms = CollectiveScheduler(lifecycle=getattr(worker, "lifecycle", None),
                                topology=graph)
    worker.batcher.attach_comms(comms)
    log.info("Topology-aware routing on: %s (%d nodes, %d links)",
             topology, len(graph.nodes), len(graph.links))
    return comms


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
    tenancy=None,
    topology: str = "",
    tokenizer=None,
    mesh=None,
) -> dict:
    """Feed ``demo`` random bodies through a :class:`QueueWorker` (or,
    with ``continuous``, drain them through a :class:`ContinuousWorker`,
    with ``tenancy`` its fair admission and ``topology`` a route-planning
    collective scheduler) and collect the replies; returns the run's
    counts and rates.  ``modes`` holds the two workers' decode-mode
    keywords (:func:`decode_modes`); ``tokenizer`` encodes text bodies and
    decodes replies.  On a serving ``mesh`` every rank runs this with the
    same arguments and world rank 0's queue serves them all; only rank 0's
    summary holds the replies."""
    queue = demo_queue(demo, model_config, service_config)
    result_queue = FakeMessageQueue() if service_config.result_queue_url else None
    if continuous:
        worker = ContinuousWorker(queue, params, model_config, service_config,
                                  result_queue=result_queue, device=device,
                                  prefix_cache=prefix_cache, tenancy=tenancy,
                                  tokenizer=tokenizer, mesh=mesh, **modes[1])
        comms = attach_topology(topology, service_config.shards, worker,
                                mesh.shape["model"] if mesh else 1)
        server = serve_metrics(metrics_port, worker, comms=comms)
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
            **tenancy_counts(worker),
            "comms": comms.counters() if comms is not None else None,
        }
    else:
        worker = QueueWorker(queue, params, model_config, service_config,
                             result_queue=result_queue, device=device,
                             prefix_cache=prefix_cache, tokenizer=tokenizer,
                             mesh=mesh, **modes[0])
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
            *SPEC_STATS, *TENANCY_STATS, "comms"))
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
# a tenancy worker's counts, in the demo's summary
TENANCY_STATS = ("completed_by_tenant", "shed_by_reason", "prefix_pool")


def tenancy_counts(worker) -> dict:
    """A continuous worker's per-tenant completions, sheds by reason and
    prefix-pool counts (``None`` each without tenancy)."""
    if getattr(worker, "tenancy", None) is None:
        return dict.fromkeys(TENANCY_STATS)
    pool = worker.batcher.prefix_pool
    return {
        "completed_by_tenant": dict(worker.completed_by_tenant),
        "shed_by_reason": dict(worker.shed_by_reason),
        "prefix_pool": pool.stats() if pool is not None else None,
    }


def decode_modes(args, model_config, service_config: ServiceConfig,
                 device: torch.device,
                 prefix_cache: dict | None = None, mesh=None,
                 params: dict | None = None) -> tuple[dict, dict]:
    """``--beams`` / ``--speculative-draft-*`` as the keywords of the two
    workers: ``(QueueWorker's, ContinuousWorker's)``.  The batch worker
    gets a ``generate_fn`` (:func:`.beam.beam_search`, or
    :func:`.speculative.speculative_generate` with the early-exit
    self-draft), its prompt passes on the bucket's attention pick (the
    CUDA flash forward on the card; under a prefix the suffix prefill runs
    the chunk decoder); the continuous worker gets the knobs.  On a
    serving ``mesh`` (``params`` the rank's) the batch worker's compute
    runs over it (:func:`mesh_modes`)."""
    if mesh is not None:
        return mesh_modes(args, model_config, service_config, mesh, params,
                          prefix_cache)
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


def mesh_modes(args, model_config, service_config: ServiceConfig, mesh,
               params: dict, prefix_cache: dict | None) -> tuple[dict, dict]:
    """:func:`decode_modes` on a serving mesh (the reference's ``mesh``
    branches, ``__main__.py:864-890``, :967-973, :1061-1068): the batch
    worker classifies through :func:`.train.make_forward_step` and
    generates through the family's :func:`.decode.make_serving_fns`, or
    :func:`.beam.make_beam_serving_fn` / :func:`.speculative.
    make_speculative_serving_fn`, each with the shared prefix pinned; the
    continuous worker gets the knobs (it runs the mesh itself)."""
    from .train import make_forward_step

    family = family_of(model_config)
    keys = sampling_keys(service_config.sample_seed, mesh.device)
    quantized = service_config.quantized_kv
    if family.name == "llama":
        from .llama import llama_forward, make_llama_serving_fns

        forward = make_forward_step(mesh, model_config, params,
                                    forward_fn=llama_forward)
        make_fns = make_llama_serving_fns
    else:
        from .decode import make_serving_fns

        forward = make_forward_step(mesh, model_config, params)
        make_fns = make_serving_fns
    _, _, gen = make_fns(mesh, model_config, params,
                         quantized_cache=quantized, prefix_cache=prefix_cache)

    def generate(p, tokens, n, lengths):
        return gen(p, tokens, next(keys), lengths, n,
                   service_config.temperature, service_config.top_k,
                   service_config.top_p, service_config.eos_id)

    batch = {"forward_fn": forward, "generate_fn": generate}
    if args.beams > 1:
        from .beam import make_beam_serving_fn

        beam_run = make_beam_serving_fn(
            mesh, model_config, params, beams=args.beams,
            length_penalty=args.length_penalty,
            eos_id=service_config.eos_id, prefix_cache=prefix_cache,
            quantized_cache=quantized)
        batch["generate_fn"] = (
            lambda p, tokens, n, lengths: beam_run(p, tokens, lengths, n))
        log.info("Beam search: %d beams", args.beams)
        return batch, {"beams": args.beams,
                       "length_penalty": args.length_penalty}
    if not args.speculative_draft_layers:
        return batch, {}
    from .speculative import make_speculative_serving_fn, self_draft

    n_draft = args.speculative_draft_layers
    k = args.speculative_draft_tokens
    _, draft_config = self_draft(params, model_config, n_draft)
    spec_run = make_speculative_serving_fn(
        mesh, model_config, params, draft_config, draft_tokens=k,
        temperature=service_config.temperature, top_k=service_config.top_k,
        top_p=service_config.top_p, eos_id=service_config.eos_id,
        prefix_cache=prefix_cache, quantized_cache=quantized)
    batch["generate_fn"] = lambda p, tokens, n, lengths: spec_run(
        p, self_draft(p, model_config, n_draft)[0], tokens, lengths,
        next(keys), n)
    log.info("Speculative decoding: %d-layer early-exit self-draft, "
             "%d proposals/round", n_draft, k)
    return batch, {"draft_layers": n_draft, "draft_tokens": k}


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
    tenancy=None,
    scheduler: bool = False,
    knob_names: tuple = (),
    journal_path: str = "",
    tokenizer=None,
    mesh=None,
) -> dict:
    """The closed loop in one process, on the real clock: a
    :class:`~..core.loop.ControlLoop` autoscales a
    :class:`~..fleet.WorkerPool` of continuous replicas between
    ``min_replicas`` and ``max_replicas`` over the demo queue until every
    message is answered; returns the run's counts and rates.
    ``scheduler`` runs the interleave on the event scheduler
    (:class:`~..sched.fleet.ScheduledFleetDriver`), with ``knob_names``
    armed on a :class:`~..sched.knobs.KnobActuator`; ``journal_path``
    records the loop's ticks (and the knob changes).  With ``tenancy``
    the gates threshold on the SLO-weighted per-tenant staged backlog
    (:class:`~..forecast.tenants.TenantAwareDepth`), never below the
    observed depth.  On a serving ``mesh`` every rank runs the loop and
    the pool: the depth is world rank 0's queue's, the clock rank 0's
    (:class:`~.distributed.RankClock`), and rank 0 alone writes the
    journal and serves ``/metrics``."""
    from ..core.loop import ControlLoop, LoopConfig
    from ..core.policy import PolicyConfig
    from ..fleet import FleetDriver, WorkerPool
    from ..metrics.queue import QueueMetricSource

    queue = demo_queue(demo, model_config, service_config)
    result_queue = FakeMessageQueue() if service_config.result_queue_url else None
    clock, depth_queue, lead = None, queue, True
    if mesh is not None:
        from ..core.clock import SystemClock
        from .distributed import RankClock, RankQueue, is_lead

        # every rank takes the loop's and the pool's decisions alike: on
        # rank 0's clock and its queue's depth (only its queue drains)
        clock, depth_queue, lead = (RankClock(SystemClock()),
                                    RankQueue(queue), is_lead())
    pool = WorkerPool.serving(
        queue, params, model_config, service_config,
        result_queue=result_queue, min=min_replicas, max=max_replicas,
        device=device, prefix_cache=prefix_cache, tenancy=tenancy,
        tokenizer=tokenizer, mesh=mesh, clock=clock,
    )
    journal = None
    if journal_path and lead:
        from ..obs import TickJournal

        journal = TickJournal(journal_path, meta=fleet_journal_meta(
            service_config, min_replicas, max_replicas, tenancy,
            scheduler, knob_names))
        # the sharded admission plane's transitions ride the same journal
        for replica in pool.members:
            fair = getattr(replica.worker, "_fair", None)
            if hasattr(fair, "attach_journal"):
                fair.attach_journal(journal)
    # the registry exists before the server starts, so the knob gauges
    # are on its first scrape
    registry = None
    if metrics_port:
        from ..obs import WorkloadMetrics

        registry = WorkloadMetrics()
    batch = service_config.batch_size

    class _LastDepthSource:
        """Remembers the tick's observation, so the knob policy decides
        on the depth the loop just saw instead of polling again."""

        def __init__(self, source) -> None:
            self.source = source
            self.last = 0

        def num_messages(self) -> int:
            self.last = self.source.num_messages()
            return self.last

    metric_source = _LastDepthSource(QueueMetricSource(
        depth_queue, service_config.queue_url,
        ("ApproximateNumberOfMessages",)))
    depth_policy = None
    if tenancy is not None:
        # who is arriving: a tight-SLO tenant's staged requests move the
        # autoscaler harder than a batch tenant's
        from ..forecast.tenants import TenantAwareDepth

        depth_policy = TenantAwareDepth(pool.staged_by_tenant, tenancy)
    loop = ControlLoop(
        pool,
        metric_source,
        LoopConfig(
            poll_interval=0.1,
            policy=PolicyConfig(
                scale_up_messages=2 * batch, scale_down_messages=batch,
                scale_up_cooldown=0.2, scale_down_cooldown=0.4,
            ),
        ),
        clock=clock,
        observer=journal,
        depth_policy=depth_policy,
    )
    actuator = None
    if scheduler:
        from ..sched import (
            KnobActuator, KnobError, ReactiveKnobPolicy, ScheduledFleetDriver,
        )

        knob_policy = None
        if knob_names:
            try:
                actuator = KnobActuator(pool, armed=knob_names,
                                        journal=journal, metrics=registry)
            except KnobError as err:
                raise SystemExit(str(err))
            if "decode_block" in knob_names:
                # backlog-reactive block size: deep queue -> big block,
                # shallow -> small; decided on the tick's own depth
                knob_policy = ReactiveKnobPolicy(
                    actuator, lambda: metric_source.last,
                    high=2 * batch, low=max(1, batch // 2),
                    block_high=max(service_config.decode_block, 8),
                    block_low=2,
                )
        driver = ScheduledFleetDriver(pool, loop, knobs=actuator,
                                      knob_policy=knob_policy)
    else:
        driver = FleetDriver(pool, loop)
    server = serve_metrics(
        metrics_port, pool, metrics=registry,
        build_info=dict(scheduler=int(bool(scheduler)),
                        knobs=",".join(knob_names) or "none"))
    start = time.perf_counter()
    stats = driver.run(until=lambda: pool.processed >= demo and pool.idle)
    elapsed = time.perf_counter() - start
    pool.stop_all()
    if journal is not None:
        journal.close()
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
        "completed_by_tenant": (pool.completed_by_tenant
                                if tenancy is not None else None),
        "knob_changes": (list(actuator.changes) if actuator is not None
                         else None),
    }


def fleet_journal_meta(service_config: ServiceConfig, min_replicas: int,
                       max_replicas: int, tenancy, scheduler: bool,
                       knob_names: tuple) -> dict:
    """The serving fleet journal's header meta: which deployment knobs
    (the scheduler seam and armed knobs, the tenancy policy) produced its
    tick lines."""
    return {
        "source": "serving-fleet",
        "queue_url": "demo://queue",
        "world": {"min_pods": min_replicas, "max_pods": max_replicas},
        "serving": {
            "batch_size": service_config.batch_size,
            "generate_tokens": service_config.generate_tokens,
            "decode_block": service_config.decode_block,
            "shards": service_config.shards,
        },
        "sched": {"scheduler": bool(scheduler), "knobs": list(knob_names)},
        "tenancy": (
            {
                "tenants": list(tenancy.tenants),
                "weights": list(tenancy.weights),
                "prefix_pool": tenancy.prefix_pool,
                "prefix_len": tenancy.prefix_len,
                "sticky": tenancy.sticky,
                "fair": tenancy.fair,
                "ttft_slo_s": list(tenancy.ttft_slo_s),
                "urgency_window_s": tenancy.urgency_window_s,
                "urgency_budget": tenancy.urgency_budget,
                "shed_tiers": tenancy.shed_tiers,
                "admission_shards": tenancy.admission_shards,
                "decode_slo_s": tenancy.decode_slo_s,
            }
            if tenancy is not None else {}
        ),
    }


def serve_sqs(args, params: dict, model_config: ModelConfig,
              service_config: ServiceConfig, device: torch.device,
              prefix_cache: dict | None = None,
              modes: tuple[dict, dict] = ({}, {}), tenancy=None,
              tokenizer=None, mesh=None) -> None:
    """Serve ``--sqs-queue-url`` until the worker is stopped.  AWS SQS
    addresses queues per call by url, so the same client publishes replies
    when ``--result-queue-url`` is set.  On a serving ``mesh`` world rank
    0 alone talks to SQS."""
    from ..metrics.sqs_aws import AwsSqsService

    queue = AwsSqsService(region=args.aws_region)
    result_queue = queue if args.result_queue_url else None
    if args.continuous:
        worker = ContinuousWorker(queue, params, model_config,
                                  service_config, result_queue=result_queue,
                                  device=device, prefix_cache=prefix_cache,
                                  tenancy=tenancy, tokenizer=tokenizer,
                                  mesh=mesh, **modes[1])
    else:
        worker = QueueWorker(queue, params, model_config, service_config,
                             result_queue=result_queue, device=device,
                             prefix_cache=prefix_cache, tokenizer=tokenizer,
                             mesh=mesh, **modes[0])
    comms = (attach_topology(args.topology, args.shards, worker,
                             args.model_parallel)
             if args.continuous else None)
    server = serve_metrics(args.metrics_port, worker, comms=comms)
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
    parser = build_parser()
    args = parser.parse_args(argv)
    check_beams(args)
    if args.generate_tokens < 0:
        raise SystemExit(f"--generate-tokens {args.generate_tokens} must be >= 0")
    if args.decode_block < 1:
        raise SystemExit(f"--decode-block {args.decode_block} must be >= 1")
    if args.decode_block > 1 and not args.continuous:
        raise SystemExit("--decode-block requires --continuous")
    # speculative with --shards or --tenants runs on the decode plane,
    # whose gang engine carries the plain rows' --decode-block
    spec_on_plane = bool(args.speculative_draft_layers) and (
        args.shards > 1 or bool(args.tenants))
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
    if args.topology and not args.continuous:
        raise SystemExit("--topology requires --continuous")
    if args.shards > 1 and not args.continuous:
        raise SystemExit("--shards requires --continuous")
    if args.shards > 1 and args.beams > 1:
        raise SystemExit(
            "--shards applies to the plain continuous decode path "
            "(not --beams)"
        )
    if spec_on_plane and args.model_parallel:
        raise SystemExit(
            "--speculative-draft-layers with --shards / --tenants runs on "
            "the single-chip decode plane (not with --model-parallel)"
        )
    check_checkpoint_flags(args)
    tenancy = check_tenancy(args)
    knob_names = check_orchestration(args, spec_on_plane)
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
    refusal = mesh_usage(args)
    if refusal:
        parser.error(refusal)  # exit 2, as a usage error
    # speculative rounds need 2k cache positions past the generated tokens
    # (speculative.speculative_generate's budget)
    spec_headroom = (2 * args.speculative_draft_tokens
                     if args.speculative_draft_layers else 0)
    # a pooled row holds a --seq-len prefix ahead of its prompt
    pool_prefix = args.seq_len if args.prefix_pool else 0
    model_config, layout, params = served_model(
        args, len(prefix_ids), pool_prefix, spec_headroom)
    check_speculative_budget(args, model_config, len(prefix_ids))
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"error: {err}") from None
    mesh = open_serving_mesh(args, device)
    if mesh is not None:
        device = mesh.device
    params = served_params(args, model_config, layout, params, device)
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
    if mesh is not None:
        from .train import _check_divisible, shard_params

        # the full weights (and the prefix, prefilled from them above)
        # were built alike on every rank; each keeps its slices
        try:
            _check_divisible(mesh, model_config)
        except ValueError as err:
            raise SystemExit(str(err)) from None
        params = shard_params(params, mesh)
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
    tokenizer = load_tokenizer(args, model_config, service_config)
    modes = decode_modes(args, model_config, service_config, device,
                         prefix_cache, mesh, params)
    if not args.demo:
        serve_sqs(args, params, model_config, service_config, device,
                  prefix_cache, modes, tenancy, tokenizer, mesh)
        return None
    if args.fleet_max_replicas:
        summary = run_fleet_demo(
            args.demo, params, model_config, service_config, device,
            args.fleet_min_replicas, args.fleet_max_replicas,
            metrics_port=args.metrics_port, prefix_cache=prefix_cache,
            tenancy=tenancy, scheduler=args.scheduler, knob_names=knob_names,
            journal_path=args.journal_path, tokenizer=tokenizer, mesh=mesh,
        )
    else:
        summary = run_demo(args.demo, params, model_config, service_config,
                           device, continuous=args.continuous,
                           metrics_port=args.metrics_port,
                           prefix_cache=prefix_cache, modes=modes,
                           tenancy=tenancy, topology=args.topology,
                           tokenizer=tokenizer, mesh=mesh)
    summary["weight_bytes"] = weight_bytes
    if mesh is not None:
        summary["mesh"] = dict(mesh.shape)
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


def served_model(args, prefix_len: int, pool_prefix: int, headroom: int):
    """``(config, layout, params)`` of the model the worker serves: an HF
    directory's (its weights converted on the host, ``params`` set), the
    trainer's manifest and its parameter layout (``params`` ``None``: read
    on the device by :func:`served_params`) or the built-in ``--family``
    config, whose context holds the prefix, the pooled prefix, the prompt,
    its continuation and ``headroom``.  A checkpoint's context must hold
    the prefix, the prompt and its continuation."""
    needed = prefix_len + args.seq_len + args.generate_tokens
    if args.hf_checkpoint:
        from .hf_convert import load_hf_llama

        config, params = load_hf_llama(args.hf_checkpoint, device="cpu")
        log.info(
            "Imported HF llama checkpoint %s (d_model=%d layers=%d "
            "heads=%d/%d, %s readout)",
            args.hf_checkpoint, config.d_model, config.n_layers,
            config.n_heads, config.n_kv_heads,
            "untied" if "lm_head" in params else "tied",
        )
        if config.max_seq_len < needed:
            raise SystemExit(
                f"HF model has max_seq_len={config.max_seq_len} < "
                f"seq_len + generate_tokens = {needed}; lower "
                "--seq-len/--generate-tokens"
            )
        return config, None, params
    if args.checkpoint_dir:
        from .checkpoint import load_model_layout, load_model_manifest

        family, config = load_model_manifest(args.checkpoint_dir)
        if family != args.family:
            log.info("Checkpoint manifest says family=%s (overriding CLI)",
                     family)
        if config.max_seq_len < needed:
            raise SystemExit(
                f"checkpointed model has max_seq_len={config.max_seq_len} "
                f"< seq_len + generate_tokens = {needed}; lower "
                "--seq-len/--generate-tokens"
            )
        return config, load_model_layout(args.checkpoint_dir), None
    return BUILTIN_CONFIGS[args.family](args.seq_len, args.generate_tokens,
                                        prefix_len + pool_prefix,
                                        headroom), None, None


def served_params(args, config, layout, params, device: torch.device) -> dict:
    """The weights of :func:`served_model`'s model on ``device``: the HF
    directory's, the latest checkpoint's (a ``moe`` layout is refused with
    the reference's error) or the built-in seeded ones."""
    if params is not None:
        from .checkpoint import _to_device

        return _to_device(params, device)
    if args.checkpoint_dir:
        from .checkpoint import OrbaxCheckpointError, TrainCheckpointer, \
            exit_refused

        checkpointer = TrainCheckpointer(args.checkpoint_dir)
        try:
            params = checkpointer.restore_params(
                family_of(config).name, config, layout=layout, device=device)
        except OrbaxCheckpointError as err:
            exit_refused(err)
        log.info("Restored weights from %s step %s", args.checkpoint_dir,
                 checkpointer.latest_step())
        return params
    return family_of(config).init_params(
        config, torch.Generator().manual_seed(0), device)


def load_tokenizer(args, model_config, service_config: ServiceConfig):
    """``--tokenizer``'s ``transformers`` tokenizer (``None`` without the
    flag), loaded from a local directory only; the reference's vocabulary
    check, and ``eos_id`` from the tokenizer when ``--eos-id`` is unset."""
    if not args.tokenizer:
        return None
    try:
        from transformers import AutoTokenizer
    except ImportError as err:
        raise SystemExit(f"--tokenizer needs transformers ({err})")
    tokenizer = AutoTokenizer.from_pretrained(args.tokenizer,
                                              local_files_only=True)
    tok_vocab = len(tokenizer)  # incl. added special tokens
    if tok_vocab > model_config.vocab_size:
        # an out-of-range id would be clamped by the embedding gather and
        # silently serve garbage
        raise SystemExit(
            f"tokenizer vocab ({tok_vocab}) exceeds the model's "
            f"vocab_size ({model_config.vocab_size})"
        )
    if service_config.eos_id is None and tokenizer.eos_token_id is not None:
        service_config.eos_id = int(tokenizer.eos_token_id)
        log.info("eos_id %d from the tokenizer", service_config.eos_id)
    log.info("Tokenizer: %s (vocab %d)", args.tokenizer, tok_vocab)
    return tokenizer


def mesh_usage(args) -> str | None:
    """The usage error of ``--model-parallel``, or ``None``: a mesh that
    does not divide the ranks of this launch (``WORLD_SIZE``; 1 in a lone
    process), as the trainer's mesh flags refuse it."""
    if not args.model_parallel:
        return None
    import os

    from .distributed import mesh_shape

    if args.model_parallel < 1:
        return f"--model-parallel {args.model_parallel} must be >= 1"
    world = int(os.environ.get("WORLD_SIZE", "").strip() or 1)
    try:
        mesh_shape(world, args.model_parallel, 1)
    except ValueError as err:
        return (f"--model-parallel {args.model_parallel} over {world} "
                f"rank(s): {err} (launch the ranks with python -m "
                "torch.distributed.run --nproc-per-node N)")
    return None


def open_serving_mesh(args, device: torch.device):
    """The ``(data, model)`` serving mesh of ``--model-parallel`` over this
    launch's ranks (``None`` without the flag), with the reference's
    check of ``--batch-size`` against its data axis.  Joins the process
    group when launched over ranks; ranks other than 0 log only
    warnings."""
    if not args.model_parallel:
        return None
    import os

    from .distributed import initialize_from_env, make_mesh

    if int(os.environ.get("RANK", "").strip() or 0) != 0:
        logging.getLogger().setLevel(logging.WARNING)
    initialize_from_env(device=device)
    mesh = make_mesh(model_parallel=args.model_parallel, device=device)
    if args.batch_size % mesh.shape["data"]:
        raise SystemExit(
            f"--batch-size {args.batch_size} must be divisible by the "
            f"mesh's data axis ({mesh.shape['data']})"
        )
    log.info("Serving mesh: %s over %d devices", dict(mesh.shape), mesh.size)
    return mesh


def check_checkpoint_flags(args) -> None:
    """The checks of the checkpoint and tokenizer flags, before any model
    is built."""
    if args.hf_checkpoint and args.checkpoint_dir:
        raise SystemExit(
            "--hf-checkpoint and --checkpoint-dir are mutually exclusive"
        )
    if args.tokenizer and not Path(args.tokenizer).is_dir():
        raise SystemExit(
            f"--tokenizer {args.tokenizer} is not a directory (tokenizers "
            "load from a local directory, never from a hub)"
        )


def check_orchestration(args, spec_on_plane: bool) -> tuple:
    """The reference binary's args-only checks of ``--journal-path``,
    ``--scheduler`` and ``--knobs``; returns the armed knob names."""
    if args.journal_path and not args.fleet_max_replicas:
        raise SystemExit(
            "--journal-path records the fleet control loop "
            "(requires --fleet-max-replicas)"
        )
    if args.scheduler and not args.fleet_max_replicas:
        raise SystemExit(
            "--scheduler drives the fleet demo's loop + cycles "
            "(requires --fleet-max-replicas)"
        )
    if not args.knobs:
        return ()
    from ..sched.knobs import KnobError, parse_knob_names

    try:
        knob_names = parse_knob_names(args.knobs)
    except KnobError as err:
        raise SystemExit(str(err))
    if not args.continuous:
        raise SystemExit("--knobs requires --continuous")
    if not args.scheduler:
        raise SystemExit(
            "--knobs actuates through the scheduler's between-cycle "
            "safe point (requires --scheduler)"
        )
    if "speculative" in knob_names:
        if args.beams > 1:
            raise SystemExit(
                "the speculative knob does not combine with --beams "
                "(beam search is deterministic; there is no "
                "draft-and-verify round to toggle)"
            )
        if not args.speculative_draft_layers:
            raise SystemExit(
                "the speculative knob requires --speculative-draft-layers "
                "(there is no draft-and-verify engine to toggle)"
            )
    if "decode_block" in knob_names and (
            (args.decode_block < 2 and args.shards < 2)
            or args.beams > 1
            or (args.speculative_draft_layers and not spec_on_plane)):
        raise SystemExit(
            "the decode-block knob needs the block/gang decode engine: set "
            "--decode-block >= 2 or --shards >= 2 (plain continuous path "
            "only — not with --beams / --speculative-draft-layers)"
        )
    if "shards" in knob_names and args.shards < 2:
        raise SystemExit(
            "the shards knob needs the sharded plane (--shards >= 2)"
        )
    if "prefix_pool" in knob_names and not args.prefix_pool:
        raise SystemExit("the prefix-pool knob requires --prefix-pool")
    return knob_names


def check_tenancy(args):
    """The reference binary's args-only checks of the tenancy flags;
    returns the :class:`~.tenancy.TenancyConfig` (``None`` without
    ``--tenants``).  A usage error exits before any model is built."""
    from .tenancy import TenancyConfig

    if not args.tenants:
        for flag, given in (
                ("--tenant-weights", args.tenant_weights),
                ("--tenant-slos", args.tenant_slos),
                ("--urgency-window", args.urgency_window),
                ("--shed-tiers", args.shed_tiers),
                ("--admission-shards", args.admission_shards != 1),
                ("--decode-slo-budget", args.decode_slo_budget),
                ("--prefix-pool", args.prefix_pool)):
            if given:
                raise SystemExit(f"{flag} requires --tenants")
        return None
    if not args.continuous:
        raise SystemExit("--tenants requires --continuous")
    if args.beams > 1:
        raise SystemExit(
            "--tenants applies to the plain continuous decode path "
            "(not --beams)"
        )
    names = tuple(s.strip() for s in args.tenants.split(",") if s.strip())
    if not names:
        raise SystemExit("--tenants is empty")
    weights = floats_flag("--tenant-weights", args.tenant_weights)
    slos = floats_flag("--tenant-slos", args.tenant_slos)
    if args.urgency_window < 0:
        raise SystemExit(
            f"--urgency-window {args.urgency_window} must be >= 0 (0 = off)"
        )
    if args.urgency_window > 0 and not any(s > 0 for s in slos):
        raise SystemExit(
            "--urgency-window needs at least one positive --tenant-slos "
            "entry (without a deadline nothing can jump the quantum)"
        )
    if not 0 <= args.shed_tiers <= 3:
        raise SystemExit(
            f"--shed-tiers {args.shed_tiers} must be in [0, 3] (0 = off)"
        )
    if args.admission_shards < 1:
        raise SystemExit(
            f"--admission-shards {args.admission_shards} must be >= 1 "
            "(1 = the single staging plane)"
        )
    if args.decode_slo_budget < 0:
        raise SystemExit(
            f"--decode-slo-budget {args.decode_slo_budget} must be >= 0 "
            "(0 = off)"
        )
    if args.prefix_pool < 0:
        raise SystemExit(
            f"--prefix-pool {args.prefix_pool} must be >= 0 (0 = off)"
        )
    if args.prefix_pool:
        if args.prefix_ids:
            raise SystemExit(
                "--prefix-pool and --prefix-ids are mutually exclusive (the "
                "pool generalizes the single broadcast prefix)"
            )
        if args.prefix_pool < args.batch_size:
            raise SystemExit(
                f"--prefix-pool {args.prefix_pool} must be >= --batch-size "
                f"{args.batch_size} (one refill can admit that many "
                "distinct prefixes per shard; a smaller pool could LRU-evict "
                "an entry the same admission batch still references)"
            )
    try:
        return TenancyConfig(
            tenants=names, weights=weights, prefix_pool=args.prefix_pool,
            prefix_len=args.seq_len if args.prefix_pool else 0,
            ttft_slo_s=slos, urgency_window_s=args.urgency_window,
            shed_tiers=args.shed_tiers,
            admission_shards=args.admission_shards,
            decode_slo_s=args.decode_slo_budget,
        )
    except ValueError as err:
        # count mismatches, tiny weights, bad knobs: usage errors at
        # start-up, never tracebacks mid-cycle
        raise SystemExit(str(err))


def floats_flag(flag: str, text: str) -> tuple[float, ...]:
    """A comma-separated float flag (empty: ``()``)."""
    if not text:
        return ()
    try:
        return tuple(float(s) for s in text.split(",") if s.strip())
    except ValueError as err:
        raise SystemExit(f"{flag} must be floats ({err})")


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


def leave_process_group() -> None:
    """Leave the process group a ``--model-parallel`` launch joined, once
    every rank is through (gloo's threads otherwise race the exit)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
    leave_process_group()
