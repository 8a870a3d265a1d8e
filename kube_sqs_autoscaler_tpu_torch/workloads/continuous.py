"""Continuous batching: rolling decode slots that refill independently.

Counterpart of ``kube_sqs_autoscaler_tpu/workloads/continuous.py``, plain
GPT path.  The batch worker (:class:`.service.QueueWorker` in generate
mode) decodes a whole batch before it takes another message; here every
row of the KV cache is a slot of its own.  Each engine step advances every
busy slot, a finished slot replies at once, and new requests are
prefilled into free slots while the others keep decoding.  Greedy outputs
equal :func:`.decode.generate` for each prompt alone, eos padding
included: the batcher changes scheduling, never results.

- **Admission** (:meth:`ContinuousBatcher.submit_many`): one refill's
  prompts, each padded to the ``prompt_len`` bucket, prefill as one
  ``[M, P]`` batch (through the CUDA flash forward on the card) and are
  copied into their slot rows, with each row's length, pending token and
  liveness folded into the batcher's state: one insert, no host wait.
- **Decode**: at ``decode_block == 1`` one :func:`.decode.decode_step`
  over every slot, busy or not, and one host wait per token (the
  reference's baseline).  At ``decode_block > 1`` a
  :func:`.decode.block_decode` with the liveness on the device, and block
  N+1 is dispatched before block N is read, so the host's settle, reply
  and refill for block N overlap the device's work on block N+1.

Where the reference donates its state to jitted programs, the port
mutates the slot cache and the per-row state (``current``, ``done``,
``remaining``) in place, and one CUDA stream keeps every insert ahead of
the next decode.  Host operands go up from fresh pinned buffers without a
wait.  Every device result the host reads is copied into pinned host
memory as soon as it is produced, with an event behind the copy
(:class:`_HostCopy`): the host waits for that event, never for the whole
stream, which would also wait for the block dispatched after it.

Not ported yet (the batcher raises ``ValueError``): the llama family, a
mesh, the int8 KV cache, the shared prefix cache, speculative and beam
slots, and tenancy.
"""

from __future__ import annotations

import itertools
import json
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..utils.profiling import SpanTimer
from .decode import _pick, block_decode, decode_step, init_cache, prefill
from .flash import attention_fn_for
from .model import ModelConfig
from .service import (
    ServiceConfig, build_token_reply, parse_request_body, request_id,
    sampling_keys, sent_epoch,
)

log = logging.getLogger(__name__)


def _to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A fresh host operand on ``device``.  On the card it goes up from a
    pinned buffer of its own without waiting; the caching host allocator
    keeps that buffer until the copy has read it."""
    host = torch.from_numpy(array)
    if device.type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


class _HostCopy:
    """Device results on their way to the host.  On the card each tensor
    is copied into pinned host memory when it is produced, and an event is
    recorded behind the copies; :meth:`wait` waits for that event alone.
    CPU tensors are copied plainly."""

    def __init__(self, *tensors: torch.Tensor) -> None:
        device = tensors[0].device
        self.event = None
        if device.type != "cuda":
            self.host = [t.clone() for t in tensors]
            return
        self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for t in tensors]
        for host, tensor in zip(self.host, tensors):
            host.copy_(tensor, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(device))

    def ready(self) -> bool:
        """Whether the copies have landed; never waits."""
        return self.event is None or self.event.query()

    def wait(self) -> list[np.ndarray]:
        """The host values, once the copies have landed."""
        if self.event is not None:
            self.event.synchronize()
        return [host.numpy() for host in self.host]


def _rows_prefill(params, prompts, lengths, config, attention_fn):
    """``M`` prompts' prefill as one ``[M, P]`` batch; returns ``(logits
    [M, V], rows_cache)``.  Rows never interact across the batch, so each
    row's result is what its own ``[1, P]`` prefill gives."""
    return prefill(params, prompts, config, attention_fn, lengths=lengths)


def _splice_rows_layers(cache, rows_cache, rows, prompt_len) -> None:
    """Copy each prefilled row's prompt positions into its slot row of the
    batch cache, in place: one indexed copy per layer entry for all the
    rows."""
    for layer_cache, rows_layer in zip(cache["layers"], rows_cache["layers"]):
        for name, buf in layer_cache.items():
            buf[rows, :, :prompt_len] = rows_layer[name][:, :, :prompt_len]


def _insert_rows_impl(
    params: dict,
    cache: dict,
    current: torch.Tensor,
    done: torch.Tensor,
    remaining: torch.Tensor,
    rows: torch.Tensor,
    prompts: torch.Tensor,
    lengths: torch.Tensor,
    key: torch.Generator | None,
    config: ModelConfig,
    budget: int,
    attention_fn,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    eos_id: int | None = None,
) -> torch.Tensor:
    """Batched admission: prefill ``prompts`` (``[M, P]``, right-padded,
    real lengths ``lengths``) as one batch, copy them into slot ``rows``
    of ``cache``, and fold each row's length, pending token (``current``),
    ``done`` (set where the first token is ``eos_id``) and ``remaining``
    (``budget - 1``: the first token spends one) into the state, all in
    place.  Returns the first tokens ``[M]``, still on the device."""
    logits, rows_cache = _rows_prefill(params, prompts, lengths, config,
                                       attention_fn)
    _splice_rows_layers(cache, rows_cache, rows, prompts.shape[1])
    cache["length"][rows] = lengths
    firsts = _pick(logits, key, temperature, top_k, top_p)
    current[rows] = firsts
    done[rows] = firsts == eos_id if eos_id is not None else False
    remaining[rows] = budget - 1
    return firsts


@dataclass
class _Slot:
    busy: bool = False
    produced: list = field(default_factory=list)
    budget: int = 0
    done: bool = False  # emitted eos before the budget (frees this step)
    payload: Any = None  # the caller's per-request context (the message)
    submitted_at: float = 0.0  # admission time, for time to first token
    ttft_done: bool = False  # time to first token already recorded


class ContinuousBatcher:
    """The slot machine: submit prompts, step the batch, collect results.

    Synchronous and queue-agnostic: drive it from anything that produces
    ``(token_ids, payload)`` requests.  Greedy or sampled
    (``temperature``/``top_k``/``top_p`` through :func:`.decode._pick`,
    one generator per engine step), ``eos_id`` ends a slot early.  The
    model runs on ``device`` (``"cuda"`` by default; a missing card
    raises).  Counters: ``insert_dispatches`` and ``decode_dispatches``
    (device work launched), ``host_transfers`` (host waits for a device
    result), ``tokens_emitted``, ``block_tokens`` / ``block_capacity``
    (kept tokens / dispatched block positions of busy slots), and
    ``overlapped_settles`` / ``block_settles`` (settles at which the block
    dispatched that cycle was still running).
    """

    def __init__(
        self,
        params: dict,
        config: ModelConfig,
        batch_size: int,
        prompt_len: int,
        generate_tokens: int,
        *,
        family: str = "gpt",
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        eos_id: int | None = None,
        sample_seed: int = 0,
        mesh=None,
        quantized_kv: bool = False,
        prefix_cache: dict | None = None,
        draft_layers: int = 0,
        beams: int = 1,
        decode_block: int = 1,
        tenancy=None,
        device: str | torch.device = "cuda",
    ) -> None:
        if beams < 1:
            raise ValueError(f"beams={beams} must be >= 1")
        if family not in ("gpt", "llama"):
            raise ValueError(f"unknown family {family!r}")
        unported = {
            "family='llama'": family == "llama",
            "mesh": mesh is not None,
            "quantized_kv": quantized_kv,
            "prefix_cache": prefix_cache is not None,
            "draft_layers": draft_layers > 0,
            "beams > 1": beams > 1,
            "tenancy": tenancy is not None,
        }
        for knob, asked in unported.items():
            if asked:
                raise ValueError(
                    f"{knob} is not yet ported to the PyTorch continuous "
                    "batcher (plain GPT path only)"
                )
        if decode_block < 1:
            raise ValueError(f"decode_block={decode_block} must be >= 1")
        budget = prompt_len + generate_tokens
        if budget > config.max_seq_len:
            raise ValueError(
                f"prompt_len + generate_tokens = {budget} exceeds "
                f"max_seq_len={config.max_seq_len}"
            )
        if top_k < 0:
            raise ValueError(f"top_k={top_k} must be >= 0")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p={top_p} must be in (0, 1]")
        self.device = resolve_device(device)
        self.params = params
        self.config = config
        self.prompt_len = prompt_len
        self.generate_tokens = generate_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.eos_id = eos_id
        self.decode_block = decode_block
        self._attention_fn = attention_fn_for(prompt_len, self.device)
        # serving stats
        self.tokens_emitted = 0
        self.ttft_sum = 0.0
        self.ttft_count = 0
        self.last_ttft_s: float | None = None
        self.ttft_samples: deque[float] = deque(maxlen=4096)
        self.block_tokens = 0
        self.block_capacity = 0
        self.block_settles = 0
        self.overlapped_settles = 0
        # the serving contract these pin: a refill costs one insert
        # dispatch and no host wait however many requests it admits; a
        # block cycle one decode dispatch and at most one host wait
        self.decode_dispatches = 0
        self.insert_dispatches = 0
        self.host_transfers = 0
        # deferred first tokens: (host copy, slot rows), read at the next
        # step()
        self._pending_firsts: list[tuple[_HostCopy, list[int]]] = []
        # the block in flight: (host copy of tokens and counts, busy slots
        # when it was dispatched)
        self._pending_block: tuple[_HostCopy, int] | None = None
        self.slots = [_Slot() for _ in range(batch_size)]
        with torch.inference_mode():
            self.cache = init_cache(config, batch_size, self.device)
            # each slot's next input token, and its liveness on the
            # device: done marks a free or finished row (admission clears
            # it), remaining its unspent budget
            self._current = torch.zeros(batch_size, dtype=torch.long,
                                        device=self.device)
            self._done = torch.ones(batch_size, dtype=torch.bool,
                                    device=self.device)
            self._remaining = torch.zeros(batch_size, dtype=torch.long,
                                          device=self.device)
        # one generator per engine step and insert; greedy needs none
        self._keys = (
            sampling_keys(sample_seed, self.device) if temperature > 0.0
            else itertools.repeat(None)
        )

    @property
    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if not s.busy]

    def _free_slot_count(self) -> int:
        """Admission capacity as a bare count (what a refill sizes its
        receive by)."""
        return len(self.free_slots)

    @property
    def active(self) -> int:
        return sum(s.busy for s in self.slots)

    def _pad_prompt(self, token_ids) -> tuple[np.ndarray, int]:
        """Truncate/right-pad one prompt to the ``prompt_len`` bucket
        (an empty prompt counts one pad token)."""
        ids = np.zeros((self.prompt_len,), np.int64)
        real = np.asarray(token_ids, np.int64).reshape(-1)[: self.prompt_len]
        ids[: real.size] = real
        return ids, max(1, real.size)

    def submit(self, token_ids, payload: Any = None) -> int:
        """Prefill one request into a free slot; returns the slot index
        (the single-request case of :meth:`submit_many`)."""
        return self.submit_many([(token_ids, payload)])[0]

    def submit_many(self, requests: list[tuple[Any, Any]]) -> list[int]:
        """Admit ``(token_ids, payload)`` requests into free slots as one
        insert; returns their slot indices in order.  The first tokens
        stay on the device until the next :meth:`step`."""
        if not requests:
            return []
        free = self.free_slots
        if len(requests) > len(free):
            raise RuntimeError(
                f"no free slot for {len(requests)} request(s) "
                f"({len(free)} free); call step() until slots open"
            )
        rows = free[: len(requests)]
        now = time.perf_counter()
        padded = [self._pad_prompt(ids) for ids, _ in requests]
        prompts = np.stack([ids for ids, _ in padded])
        lengths = np.asarray([n for _, n in padded], np.int64)
        with torch.inference_mode():
            firsts = _insert_rows_impl(
                self.params, self.cache, self._current, self._done,
                self._remaining, _to_device(np.asarray(rows), self.device),
                _to_device(prompts, self.device),
                _to_device(lengths, self.device), next(self._keys),
                self.config, self.generate_tokens, self._attention_fn,
                self.temperature, self.top_k, self.top_p, self.eos_id,
            )
            self._pending_firsts.append((_HostCopy(firsts), list(rows)))
        self.insert_dispatches += 1
        for row, (_, payload) in zip(rows, requests):
            self.slots[row] = _Slot(
                busy=True, budget=self.generate_tokens, payload=payload,
                submitted_at=now,
            )
        return rows

    def _emit(self, slot: _Slot, token: int) -> None:
        """Append one kept token to a slot: the one place the eos check
        and the emitted-token count live."""
        slot.produced.append(token)
        self.tokens_emitted += 1
        if self.eos_id is not None and token == self.eos_id:
            slot.done = True

    def _settle_pending_firsts(self) -> int:
        """Emit the deferred first tokens and record time to first token;
        returns the number of host copies waited for."""
        if not self._pending_firsts:
            return 0
        pending, self._pending_firsts = self._pending_firsts, []
        self._record_firsts([(copy.wait()[0], rows) for copy, rows in pending])
        return len(pending)

    def _record_firsts(self, pending_host: list) -> None:
        now = time.perf_counter()
        for values, rows in pending_host:
            for token, row in zip(values.reshape(-1), rows):
                slot = self.slots[row]
                self._emit(slot, int(token))
                if slot.ttft_done:
                    continue
                slot.ttft_done = True
                ttft = now - slot.submitted_at
                self.ttft_sum += ttft
                self.ttft_count += 1
                self.last_ttft_s = ttft
                self.ttft_samples.append(ttft)

    def _needs_decode(self, slot: _Slot) -> bool:
        return slot.busy and not slot.done and len(slot.produced) < slot.budget

    def _finish_ready(self) -> list[tuple[Any, np.ndarray]]:
        """Free every slot whose request completed; returns the finished
        ``(payload, tokens)`` pairs, eos-padded to the budget like
        ``generate``."""
        finished = []
        for row, slot in enumerate(self.slots):
            if slot.busy and (slot.done or len(slot.produced) >= slot.budget):
                tokens = slot.produced
                if len(tokens) < slot.budget:
                    tokens = tokens + [self.eos_id] * (
                        slot.budget - len(tokens)
                    )
                finished.append((slot.payload, np.asarray(tokens, np.int32)))
                self.slots[row] = _Slot()
        return finished

    def step(self) -> list[tuple[Any, np.ndarray]]:
        """Advance every busy slot (one token, or up to ``decode_block``
        per dispatch); returns the finished requests as ``(payload,
        continuation_tokens)`` pairs, whose slots are free again.  A no-op
        when nothing is busy."""
        if self.active == 0:
            return []
        if self.decode_block > 1:
            return self._step_block()
        return self._step_single()

    def _step_single(self) -> list[tuple[Any, np.ndarray]]:
        """One token per dispatch, read by the host at once: the
        reference's baseline engine."""
        self.host_transfers += self._settle_pending_firsts()
        # rows whose budget is one token (or that hit eos) need no step
        needs = [self._needs_decode(s) for s in self.slots]
        if any(needs):
            with torch.inference_mode():
                logits, self.cache = decode_step(
                    self.params, self.cache, self._current, self.config
                )
                nxt = _pick(logits, next(self._keys), self.temperature,
                            self.top_k, self.top_p)
                copy = _HostCopy(nxt)
            self.decode_dispatches += 1
            nxt_host = copy.wait()[0]
            self.host_transfers += 1
            for row, slot in enumerate(self.slots):
                if needs[row]:
                    self._emit(slot, int(nxt_host[row]))
            self._current = nxt
        return self._finish_ready()

    def _block_keys(self) -> list:
        return [next(self._keys) for _ in range(self.decode_block)]

    def _step_block(self) -> list[tuple[Any, np.ndarray]]:
        """Dispatch block N+1, then read block N.

        The on-device ``done``/``remaining`` make the dispatch independent
        of block N's outcome: rows that finished in it stay frozen, and
        rows admitted since were folded in by the insert ahead of it on
        the stream.  The host waits once a cycle: the pending first tokens
        were copied after block N, so their wait covers it."""
        new_block = None
        busy = self.active
        with torch.inference_mode():
            (self.cache, self._current, self._done, self._remaining,
             tokens, counts) = block_decode(
                self.params, self.cache, self._current, self._done,
                self._remaining, self._block_keys(), self.config,
                temperature=self.temperature, top_k=self.top_k,
                top_p=self.top_p, eos_id=self.eos_id,
            )
            new_block = (_HostCopy(tokens, counts), busy)
        self.decode_dispatches += 1
        pending, self._pending_block = self._pending_block, new_block
        waited = self._settle_pending_firsts()
        if waited or pending is not None:
            self.host_transfers += 1
        if pending is not None:
            copy, dispatched_busy = pending
            toks_host, counts_host = copy.wait()
            self.block_capacity += self.decode_block * dispatched_busy
            self.block_tokens += int(counts_host.sum())
            for row, slot in enumerate(self.slots):
                if not slot.busy:
                    continue
                # rows admitted after this block was dispatched sat in it
                # frozen (count 0); the host keeps the counted prefix
                for token in toks_host[: int(counts_host[row]), row]:
                    if slot.done or len(slot.produced) >= slot.budget:
                        break
                    self._emit(slot, int(token))
            self.block_settles += 1
            if not new_block[0].ready():
                self.overlapped_settles += 1
        return self._finish_ready()


class ContinuousWorker:
    """A queue-draining worker on :class:`ContinuousBatcher`.

    Same at-least-once contract as :class:`.service.QueueWorker`: a
    message is deleted only after its continuation is generated and its
    reply (when ``ServiceConfig.result_queue_url`` is set) is sent.  A long
    request never blocks fresh messages: slots refill as they finish.
    ``now_fn`` is the request-TTL clock and must share a time base with
    the queue's ``SentTimestamp`` (epoch seconds by default)."""

    # after an empty receive while slots are still decoding, skip this
    # many cycles before polling again (one billed receive per generated
    # token would be absurd on SQS)
    POLL_BACKOFF_CYCLES = 16

    def __init__(
        self,
        queue,
        params: dict,
        model_config: ModelConfig,
        service_config: ServiceConfig,
        *,
        result_queue=None,
        now_fn=None,
        device: str | torch.device = "cuda",
    ) -> None:
        if service_config.generate_tokens < 1:
            raise ValueError(
                "ContinuousWorker is generate-mode serving; set "
                "ServiceConfig.generate_tokens >= 1"
            )
        if service_config.result_queue_url and result_queue is None:
            # in-memory queues ignore urls, so defaulting replies onto the
            # input queue object would self-feed
            raise ValueError(
                "result_queue_url is set but no result_queue client was "
                "given"
            )
        self.queue = queue
        self.config = service_config
        self.result_queue = result_queue
        self.batcher = ContinuousBatcher(
            params, model_config,
            batch_size=service_config.batch_size,
            prompt_len=service_config.seq_len,
            generate_tokens=service_config.generate_tokens,
            temperature=service_config.temperature,
            top_k=service_config.top_k,
            top_p=service_config.top_p,
            eos_id=service_config.eos_id,
            sample_seed=service_config.sample_seed,
            decode_block=service_config.decode_block,
            device=device,
        )
        self.processed = 0
        self.refill_cycles = 0  # liveness: bumped by every refill pass
        self._now = now_fn or time.time
        self.shed_by_reason = {"ttl": 0}
        self.timer = SpanTimer()
        # created eagerly, so a stop() before run_forever() still holds
        self._stop = threading.Event()
        self._running = False
        self._poll_backoff = 0

    def _settle(self, message: dict, tokens: np.ndarray | None, *,
                error: str | None = None) -> None:
        """Reply (when configured), then delete one finished message.
        ``tokens=None`` answers with ``error`` (default "malformed body")
        instead of a result."""
        if self.config.result_queue_url:
            if tokens is None:
                payload = {"error": error or "malformed body"}
            else:
                payload = build_token_reply(tokens, self.config.eos_id)
            payload["request_id"] = request_id(message)
            # reply BEFORE deleting the input: a crash between the two
            # redelivers the input (duplicates possible, losses not)
            self.result_queue.send_message(
                self.config.result_queue_url, json.dumps(payload)
            )
        self.queue.delete_message(
            self.config.queue_url, message["ReceiptHandle"]
        )

    def _refill(self) -> int:
        """Receive up to the free-slot count and prefill the messages in;
        returns the number received."""
        self.refill_cycles += 1
        free = self.batcher._free_slot_count()
        if not free:
            return 0
        if self._poll_backoff > 0:
            self._poll_backoff -= 1
            return 0
        messages = self.queue.receive_messages(
            self.config.queue_url, max_messages=free,
            wait_time_s=0 if self.batcher.active else
            self.config.receive_wait_s,
        )
        if not messages and self.batcher.active:
            self._poll_backoff = self.POLL_BACKOFF_CYCLES
        self._admit(messages)
        return len(messages)

    def _parse_for_admit(self, message: dict) -> np.ndarray | None:
        """One message's token ids; ``None`` for a malformed body."""
        return parse_request_body(message["Body"])

    def _submit_parsed(self, parsed: list[tuple[np.ndarray, dict]]) -> int:
        """Prefill ``(ids, message)`` records as one insert."""
        self.batcher.submit_many(parsed)
        return len(parsed)

    def _admit(self, messages: list[dict]) -> int:
        """Parse and prefill received ``messages`` (at most the free-slot
        count); returns the number admitted.  Expired messages are shed
        and malformed bodies answered with an error reply and deleted:
        never redelivered forever, never counted as processed."""
        admit = []
        for message in messages:
            if self._shed_if_expired(message):
                continue
            ids = self._parse_for_admit(message)
            if ids is None:
                self._settle(message, None)
                continue
            admit.append((ids, message))
        if admit:
            self._submit_parsed(admit)
        return len(admit)

    def _shed_if_expired(self, message: dict) -> bool:
        """Answer ``message`` with an ``"expired"`` error and delete it if
        it is already older than ``request_ttl_s``; returns whether it
        was shed."""
        if not self._expired(message):
            return False
        self._settle(message, None, error="expired")
        self.shed_by_reason["ttl"] += 1
        return True

    def _expired(self, message: dict) -> bool:
        """The message's queue ``SentTimestamp`` is older than
        ``request_ttl_s``; a message without one never expires."""
        ttl = self.config.request_ttl_s
        if ttl <= 0:
            return False
        sent = sent_epoch(message)
        if sent is None:
            return False
        return self._now() - sent > ttl

    def run_once(self) -> int:
        """One engine cycle: refill free slots, advance the batch, settle
        finished requests.  Returns the messages completed."""
        self._refill()
        done = self.batcher.step()
        for message, tokens in done:
            self._settle(message, tokens)
        if done:
            self._poll_backoff = 0  # a slot just freed: poll right away
        self.processed += len(done)
        return len(done)

    def stop(self) -> None:
        """Ask the serve loop to exit after its current cycle (sticky even
        before :meth:`run_forever` starts)."""
        self._stop.set()

    def run_forever(self) -> None:
        """Serve until :meth:`stop`.  A failed cycle logs, backs off and
        retries.  A second concurrent start raises ``RuntimeError``."""
        if self._running:
            raise RuntimeError(
                "ContinuousWorker is already running; one serve loop per "
                "worker (spawn another replica to add capacity)"
            )
        self._running = True
        try:
            while not self._stop.is_set():
                try:
                    with self.timer.span("cycle"):
                        idle = (self.run_once() == 0
                                and self.batcher.active == 0)
                except Exception:
                    log.exception("Continuous worker cycle failed")
                    self._stop.wait(self.config.error_backoff_s)
                    continue
                if idle:
                    self._stop.wait(self.config.idle_sleep_s)
        finally:
            self._running = False

    def drain(self, total: int, max_cycles: int | None = None,
              timeout_s: float | None = None) -> int:
        """Run cycles until ``total`` messages complete, the queue runs
        dry with nothing in flight, or the cycle or wall-clock budget runs
        out; returns the number completed.  Unfinished messages stay in
        flight on the queue and reappear after its visibility timeout."""
        cycles = 0
        deadline = (
            time.monotonic() + timeout_s if timeout_s is not None else None
        )
        while self.processed < total:
            if max_cycles is not None and cycles >= max_cycles:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            cycles += 1
            with self.timer.span("cycle"):
                done = self.run_once()
            if done == 0 and self.batcher.active == 0:
                break
        return self.processed
