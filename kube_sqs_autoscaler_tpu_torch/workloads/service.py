"""The queue-draining inference worker in PyTorch.

Counterpart of ``kube_sqs_autoscaler_tpu/workloads/service.py``: a worker
receives message bodies (JSON arrays of token ids) from an SQS-compatible
queue, pads each batch to a power-of-two length bucket, runs the model on
its device, replies (when a result queue is set) and then deletes the
inputs.  Two modes:

- **classify** (default): one forward, the greedy next token at each
  row's last real position;
- **generate** (``ServiceConfig.generate_tokens > 0``): KV-cache decoding
  of that many continuation tokens per body (:mod:`.decode`).

On the card both modes run their prompt pass through the CUDA flash
kernel (the family's pick, :mod:`.family`).  The model calls are the
reference's seams: ``forward_fn`` and ``generate_fn`` (by default those
of the config's family, the GPT or the llama).  The rolling-slot
generate worker is :class:`.continuous.ContinuousWorker`, which reads
``decode_block`` and ``request_ttl_s`` here.  Reply bytes match the
reference worker's for the same traffic and weights (greedy).

``ServiceConfig.quantized_kv`` decodes through the int8 KV cache, and a
worker given a ``prefix_cache`` continues every body from that shared,
once-prefilled prompt prefix (its suffix prefill runs the family's chunk
decoder).  ``ServiceConfig.profile_dir`` traces the batch worker's first
``profile_cycles`` serve cycles with ``torch.profiler``
(:func:`..utils.profiling.maybe_trace`).
"""

from __future__ import annotations

import itertools
import json
import logging
import threading
from dataclasses import dataclass
from typing import Any, Protocol

import numpy as np
import torch

from ..device import resolve_device
from ..utils.profiling import SpanTimer, maybe_trace
from .decode import prefix_len_of
from .family import family_of
from .model import ModelConfig

log = logging.getLogger(__name__)


def sampling_keys(seed: int, device: str | torch.device = "cuda"):
    """Endless per-batch generators seeded ``seed, seed + 1, ...`` on
    ``device``: reproducible runs, non-identical batches."""
    for i in itertools.count():
        generator = torch.Generator(device=device)
        generator.manual_seed(seed + i)
        yield generator


def parse_request_body(body: str) -> np.ndarray | None:
    """One message body (a JSON array of token ids) -> int32 ids, or
    ``None`` for a malformed body, which is dropped."""
    try:
        return np.asarray(json.loads(body), np.int32).reshape(-1)
    except Exception:
        # the body comes off the queue unchecked and may fail to parse or
        # convert in any way; a malformed body is consumed (deleted) with
        # an error reply, never redelivered forever and never answered
        # with a fabricated result
        log.error("Dropping malformed message body: %.64r", body)
        return None


def build_token_reply(tokens, eos_id: int | None) -> dict:
    """One generate-mode reply payload: ``{"tokens": [...]}`` trimmed at
    ``eos_id``."""
    ids = [int(t) for t in tokens]
    if eos_id is not None and eos_id in ids:
        ids = ids[: ids.index(eos_id)]
    return {"tokens": ids}


def request_id(message: dict) -> str:
    """The correlation id a reply carries: the request's MessageId (the
    receipt handle for queues that assign none)."""
    return message.get("MessageId", message["ReceiptHandle"])


def sent_epoch(message: dict) -> "float | None":
    """The message's queue-stamped arrival in epoch seconds
    (``SentTimestamp`` is epoch milliseconds); None when unstamped."""
    sent = message.get("Attributes", {}).get("SentTimestamp")
    if sent is None:
        return None
    try:
        return float(sent) / 1000.0
    except (TypeError, ValueError):
        return None


def collect_replies(
    queue, queue_url: str, *, max_messages: int = 16
) -> tuple[dict[str, dict], int]:
    """Drain every visible reply from ``queue_url``, deleting each as it
    is read and de-duplicating by ``request_id``.  Returns ``(replies,
    duplicates)``; a reply body that is not JSON with a ``request_id`` is
    dropped."""
    replies: dict[str, dict] = {}
    duplicates = 0
    while True:
        batch = queue.receive_messages(queue_url, max_messages=max_messages)
        if not batch:
            return replies, duplicates
        for message in batch:
            queue.delete_message(queue_url, message["ReceiptHandle"])
            try:
                payload = json.loads(message["Body"])
                rid = payload["request_id"]
            except Exception:
                log.error("Dropping malformed reply body: %.64r",
                          message["Body"])
                continue
            if rid in replies:
                duplicates += 1
                continue
            replies[rid] = payload


class MessageQueue(Protocol):
    """What a worker needs from a queue (satisfied by
    :class:`~..metrics.fake.FakeMessageQueue`)."""

    def receive_messages(
        self, queue_url: str, max_messages: int = 1, wait_time_s: int = 0
    ) -> list[dict]:
        ...

    def delete_message(self, queue_url: str, receipt_handle: str) -> None:
        ...


@dataclass
class ServiceConfig:
    queue_url: str
    batch_size: int = 8  # messages pulled (and padded) per model call
    seq_len: int = 64  # longest body kept; longer bodies are truncated
    pad_token: int = 0
    idle_sleep_s: float = 0.05  # backoff when the queue is empty
    receive_wait_s: int = 20  # SQS long polling (fakes ignore it)
    error_backoff_s: float = 1.0  # pause after a failed cycle
    # > 0: decode this many continuation tokens per message
    generate_tokens: int = 0
    # generate-mode sampling: 0 = greedy; > 0 samples with a generator
    # seeded sample_seed + batch counter; top_k / top_p truncate
    temperature: float = 0.0
    sample_seed: int = 0
    top_k: int = 0
    top_p: float = 1.0
    eos_id: int | None = None
    # generate mode decodes through the int8 KV cache (int8 weights are a
    # separate choice, workloads/quantize.py)
    quantized_kv: bool = False
    # continuous serving only: tokens the engine advances per decode
    # dispatch (decode.block_decode); 1 = the single-step engine
    decode_block: int = 1
    # continuous serving only: > 0 answers a request already older than
    # this many seconds on arrival (its SentTimestamp) with an "expired"
    # error reply instead of decoding it; 0 = off
    request_ttl_s: float = 0.0
    # continuous serving only: > 1 stacks this many engine shards of
    # batch_size slots each behind one admission plane, gang-stepped in one
    # decode dispatch a cycle (workloads/shard_plane.py)
    shards: int = 1
    # publish one JSON result per input message to this queue (after
    # compute, before deleting the input: at-least-once)
    result_queue_url: str = ""
    # set to a directory to write a torch.profiler trace of the first
    # profile_cycles serve cycles (utils/profiling.maybe_trace), flushed
    # as soon as the window closes; empty = no tracing, no overhead
    profile_dir: str = ""
    profile_cycles: int = 20

    def __post_init__(self) -> None:
        if self.top_k < 0:
            raise ValueError(f"top_k={self.top_k} must be >= 0 (0 = off)")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(
                f"top_p={self.top_p} must be in (0, 1] (1.0 = off)"
            )
        if self.decode_block < 1:
            raise ValueError(
                f"decode_block={self.decode_block} must be >= 1"
            )
        if self.shards < 1:
            raise ValueError(f"shards={self.shards} must be >= 1")
        if self.request_ttl_s < 0:
            raise ValueError(
                f"request_ttl_s={self.request_ttl_s} must be >= 0 "
                "(0 = off)"
            )


class QueueWorker:
    """One worker: receive → batch → forward or generate → (reply) →
    delete, until stopped.  The model runs on ``device`` (``"cuda"`` by
    default; a missing card raises).

    ``forward_fn(params, tokens) -> logits [B, S, vocab]`` and
    ``generate_fn(params, tokens, num_tokens, lengths) -> [B, num_tokens]``
    are the model seams.  The defaults run the forward and generate of
    the config's family (:func:`.family.family_of`: the GPT or the llama)
    with the prompt attention picked by the batch's bucket length, and the
    generate default samples with the seed-per-batch generators of
    :func:`sampling_keys`.  The generate default decodes through the int8
    cache under ``ServiceConfig.quantized_kv`` and, given a
    ``prefix_cache`` (the family's ``prefill_prefix`` in that layout),
    continues each body from the shared prefix."""

    def __init__(
        self,
        queue: MessageQueue,
        params: Any,
        model_config: ModelConfig,
        service_config: ServiceConfig,
        forward_fn=None,
        generate_fn=None,
        result_queue: MessageQueue | None = None,
        device: str | torch.device = "cuda",
        prefix_cache: dict | None = None,
    ) -> None:
        self.queue = queue
        self.params = params
        self.model_config = model_config
        self.config = service_config
        self.device = resolve_device(device)
        if service_config.result_queue_url and result_queue is None:
            # in-memory queues ignore urls, so defaulting replies onto the
            # input queue object would self-feed
            raise ValueError(
                "result_queue_url is set but no result_queue client was "
                "given"
            )
        self.result_queue = result_queue
        if service_config.generate_tokens > 0:
            budget = (prefix_len_of(prefix_cache) + service_config.seq_len
                      + service_config.generate_tokens)
            if budget > model_config.max_seq_len:
                raise ValueError(
                    f"prefix + seq_len + generate_tokens = {budget} exceeds "
                    f"the model's max_seq_len={model_config.max_seq_len}"
                )
        self._sample_keys = sampling_keys(service_config.sample_seed,
                                          self.device)
        family = family_of(model_config)

        def attention(tokens):
            return family.attention_fn_for(model_config, tokens.shape[1],
                                           self.device)

        def default_forward(params, tokens):
            return family.forward(params, tokens, model_config,
                                  attention(tokens))

        def default_generate(params, tokens, num_tokens, lengths):
            config = self.config
            generator = None
            if config.temperature > 0.0:
                generator = next(self._sample_keys)
            # under a prefix the suffix prefill runs the chunk decoder,
            # which takes no prompt-pass attention
            return family.generate(
                params, tokens, num_tokens, model_config,
                None if prefix_cache is not None else attention(tokens),
                temperature=config.temperature, generator=generator,
                lengths=lengths, top_k=config.top_k, top_p=config.top_p,
                eos_id=config.eos_id, quantized_cache=config.quantized_kv,
                prefix_cache=prefix_cache,
            )

        self._forward = forward_fn or default_forward
        self._generate = generate_fn or default_generate
        self._stop = threading.Event()
        self.processed = 0
        self.generated_tokens = 0
        self.timer = SpanTimer()

    def stop(self) -> None:
        self._stop.set()

    MIN_BUCKET = 16  # smallest padded length

    def _bucket_len(self, longest: int) -> int:
        """Smallest power-of-two >= ``longest``, in
        ``[MIN_BUCKET, seq_len]`` — the batch's padded length."""
        bucket = self.MIN_BUCKET
        while bucket < min(longest, self.config.seq_len):
            bucket *= 2
        return min(bucket, self.config.seq_len)

    def _batch_tokens(
        self, bodies: list[str]
    ) -> tuple[torch.Tensor, torch.Tensor, list[bool]]:
        """(tokens ``[batch, bucket]``, lengths ``[batch]``, per-body
        validity) on the worker's device; dropped bodies occupy a
        one-pad-token row, flagged invalid."""
        raw = [parse_request_body(body) for body in bodies]
        valid = [ids is not None for ids in raw]
        parsed: list[np.ndarray] = [
            (ids if ids is not None else np.zeros((0,), np.int32))
            [: self.config.seq_len]
            for ids in raw
        ]
        bucket = self._bucket_len(max((p.size for p in parsed), default=1))
        rows = np.full(
            (self.config.batch_size, bucket), self.config.pad_token, np.int32
        )
        lengths = np.ones((self.config.batch_size,), np.int32)
        for i, ids in enumerate(parsed):
            rows[i, : ids.size] = ids
            lengths[i] = max(1, ids.size)
        return (
            torch.from_numpy(rows).to(self.device),
            torch.from_numpy(lengths).to(self.device),
            valid,
        )

    def run_once(self) -> int:
        """One receive/process/delete cycle. Returns messages processed."""
        messages = self.queue.receive_messages(
            self.config.queue_url,
            max_messages=self.config.batch_size,
            wait_time_s=self.config.receive_wait_s,
        )
        if not messages:
            return 0
        tokens, lengths, valid = self._batch_tokens(
            [m["Body"] for m in messages]
        )
        config = self.config
        # the host copy below waits for the device, so deletion happens
        # strictly after compute succeeds (at-least-once processing)
        with torch.inference_mode():
            if config.generate_tokens > 0:
                produced = self._generate(
                    self.params, tokens, config.generate_tokens, lengths,
                ).cpu().numpy()
                self.generated_tokens += produced[: len(messages)].size
                results = [
                    build_token_reply(row, config.eos_id)
                    for row in produced[: len(messages)]
                ]
            else:
                logits = self._forward(self.params, tokens)
                rows = torch.arange(logits.shape[0], device=logits.device)
                picks = torch.argmax(logits[rows, lengths - 1], dim=-1)
                results = [
                    {"next_token": int(t)}
                    for t in picks.cpu().numpy()[: len(messages)]
                ]
        if config.result_queue_url:
            # reply BEFORE deleting the input: a crash between the two
            # redelivers the input (duplicates possible, losses not)
            for i, (message, payload) in enumerate(zip(messages, results)):
                if not valid[i]:
                    payload = {"error": "malformed body"}
                payload["request_id"] = request_id(message)
                self.result_queue.send_message(
                    config.result_queue_url, json.dumps(payload)
                )
        for message in messages:
            self.queue.delete_message(
                self.config.queue_url, message["ReceiptHandle"]
            )
        self.processed += len(messages)
        return len(messages)

    def run_forever(self) -> None:
        """Serve until stopped; a failed cycle logs, backs off and
        retries (its messages reappear after the visibility timeout).
        With ``profile_dir`` set, the first ``profile_cycles`` cycles run
        under :func:`..utils.profiling.maybe_trace`; a profiler failure is
        logged and the worker serves on unprofiled."""
        if self.config.profile_dir:
            try:
                with maybe_trace(self.config.profile_dir, self.device):
                    self._serve(max_cycles=self.config.profile_cycles)
            except Exception as err:
                log.error("Profiling failed (continuing unprofiled): %s", err)
        self._serve()

    def _serve(self, max_cycles: int | None = None) -> None:
        """The serve loop body; ``max_cycles`` bounds it (None = forever)."""
        cycles = 0
        while not self._stop.is_set():
            if max_cycles is not None and cycles >= max_cycles:
                return
            cycles += 1
            try:
                with self.timer.span("cycle"):
                    idle = self.run_once() == 0
            except Exception:
                log.exception("Worker cycle failed")
                self._stop.wait(self.config.error_backoff_s)
                continue
            if idle:
                self._stop.wait(self.config.idle_sleep_s)


class ElasticWorkerPool:
    """Keeps the worker-thread count equal to a Deployment's replica
    count: poll the Deployment API and start/stop worker threads to match
    ``spec.replicas`` (the surface the autoscaler actuates)."""

    def __init__(self, deployment_api, deployment: str, worker_factory) -> None:
        self.api = deployment_api
        self.deployment = deployment
        self.worker_factory = worker_factory
        self._members: list[tuple[QueueWorker, threading.Thread]] = []
        self._retiring: list[tuple[QueueWorker, threading.Thread]] = []
        self._retired_processed = 0

    @property
    def workers(self) -> list[QueueWorker]:
        return [worker for worker, _ in self._members]

    def _prune(self) -> None:
        still_retiring = []
        for worker, thread in self._retiring:
            if thread.is_alive():
                still_retiring.append((worker, thread))
            else:
                self._retired_processed += worker.processed
        self._retiring = still_retiring
        live = []
        for worker, thread in self._members:
            if thread.is_alive():
                live.append((worker, thread))
            else:
                log.error("Worker thread died; replacing on this reconcile")
                self._retired_processed += worker.processed
        self._members = live

    def reconcile(self) -> int:
        """Match live worker count to the Deployment's replicas; returns
        the count."""
        self._prune()
        want = self.api.get(self.deployment).replicas
        while len(self._members) < want:
            worker = self.worker_factory()
            thread = threading.Thread(target=worker.run_forever, daemon=True)
            thread.start()
            self._members.append((worker, thread))
        while len(self._members) > want:
            worker, thread = self._members.pop()
            worker.stop()
            self._retiring.append((worker, thread))
        return len(self._members)

    @property
    def processed(self) -> int:
        """Messages processed over the pool's lifetime (scaled-down and
        crashed workers included)."""
        return (
            self._retired_processed
            + sum(w.processed for w, _ in self._members)
            + sum(w.processed for w, _ in self._retiring)
        )

    def stop_all(self) -> None:
        for worker, _ in self._members + self._retiring:
            worker.stop()
        self._retiring += self._members
        self._members = []
        for _, thread in self._retiring:
            thread.join(timeout=30)
        self._prune()
        if self._retiring:
            log.error(
                "%d worker thread(s) still alive after stop_all join timeout",
                len(self._retiring),
            )
