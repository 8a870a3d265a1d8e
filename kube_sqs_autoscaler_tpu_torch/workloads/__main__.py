"""Worker binary: ``python -m kube_sqs_autoscaler_tpu_torch.workloads``.

Counterpart of ``python -m kube_sqs_autoscaler_tpu.workloads``: one
queue-draining GPT inference worker, the process a scaled Deployment
replica runs.  ``--demo N`` self-feeds an in-memory queue with N random
messages (the same bodies as the reference binary's demo), drains it
through :class:`~.service.QueueWorker` and exits.

The worker runs on the card (``--device cuda``, the default) and exits
with an error when there is none; ``--device cpu`` runs it on the CPU.
Weights are the built-in GPT config's, drawn from a seeded generator.

Flags of the reference binary whose paths are not ported yet are not
accepted; without ``--demo`` there is no queue client yet.
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
from .model import ModelConfig, init_params
from .service import QueueWorker, ServiceConfig, collect_replies

DEMO_QUEUE = "demo://queue"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="kube-sqs-autoscaler-torch-worker")
    parser.add_argument("--batch-size", type=int, default=8)
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
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the model runs (default cuda; no card is an error, "
             "never a quiet CPU run)",
    )
    parser.add_argument(
        "--demo", type=int, default=0, metavar="N",
        help="process N random messages from a local in-memory queue and exit",
    )
    return parser


def builtin_config(seq_len: int, generate_tokens: int) -> ModelConfig:
    """The built-in GPT, with a context that holds the prompt and its
    continuation (at least 64 positions)."""
    return ModelConfig(
        vocab_size=8192, d_model=512, n_heads=8, n_layers=4, d_ff=2048,
        max_seq_len=max(64, seq_len + generate_tokens),
    )


def run_demo(
    demo: int,
    params: dict,
    model_config: ModelConfig,
    service_config: ServiceConfig,
    device: torch.device,
) -> dict:
    """Feed ``demo`` random bodies through a :class:`QueueWorker` and
    drain the replies; returns the run's counts and rates."""
    log = logging.getLogger("worker")
    queue = FakeMessageQueue()
    rng = np.random.default_rng(0)
    for _ in range(demo):
        ids = rng.integers(0, model_config.vocab_size,
                           service_config.seq_len).tolist()
        queue.send_message(DEMO_QUEUE, json.dumps(ids))
    service_config.queue_url = DEMO_QUEUE
    result_queue = FakeMessageQueue() if service_config.result_queue_url else None
    worker = QueueWorker(queue, params, model_config, service_config,
                         result_queue=result_queue, device=device)
    start = time.perf_counter()
    while worker.processed < demo:
        with worker.timer.span("cycle"):
            worker.run_once()
    elapsed = time.perf_counter() - start
    log.info(
        "Processed %d messages in %.2fs (%.1f msg/s) on %s",
        worker.processed, elapsed, worker.processed / elapsed, device,
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
        "generated_tokens": worker.generated_tokens,
        "tokens_per_s": worker.generated_tokens / elapsed,
        "replies": replies,
        "duplicate_replies": duplicates,
        "queue_attributes": queue.get_queue_attributes(DEMO_QUEUE, ()),
        "cycle": worker.timer.summary().get("cycle"),
    }


def main(argv=None) -> dict:
    configure_logging()
    args = build_parser().parse_args(argv)
    if args.generate_tokens < 0:
        raise SystemExit(f"--generate-tokens {args.generate_tokens} must be >= 0")
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"error: {err}") from None
    if not args.demo:
        raise SystemExit(
            "error: only --demo N is ported so far (the PyTorch worker has "
            "no SQS client yet)"
        )
    model_config = builtin_config(args.seq_len, args.generate_tokens)
    params = init_params(model_config, torch.Generator().manual_seed(0), device)
    service_config = ServiceConfig(
        queue_url="", batch_size=args.batch_size, seq_len=args.seq_len,
        generate_tokens=args.generate_tokens, temperature=args.temperature,
        top_k=args.top_k, top_p=args.top_p,
        result_queue_url=args.result_queue_url,
        eos_id=None if args.eos_id < 0 else args.eos_id,
    )
    return run_demo(args.demo, params, model_config, service_config, device)


if __name__ == "__main__":
    main()
