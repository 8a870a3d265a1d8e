"""Continuous batching: rolling decode slots that refill independently.

Counterpart of ``kube_sqs_autoscaler_tpu/workloads/continuous.py``, plain
path, for both model families (``family="gpt"`` or ``"llama"``, whose
slots hold the compact GQA cache).  The batch worker
(:class:`.service.QueueWorker` in generate mode) decodes a whole batch
before it takes another message; here every
row of the KV cache is a slot of its own.  Each engine step advances every
busy slot, a finished slot replies at once, and new requests are
prefilled into free slots while the others keep decoding.  Greedy outputs
equal :func:`.decode.generate` for each prompt alone, eos padding
included: the batcher changes scheduling, never results.

- **Admission** (:meth:`ContinuousBatcher.submit_many`): one refill's
  prompts, each padded to the ``prompt_len`` bucket, prefill as one
  ``[M, P]`` batch (through the CUDA flash forward on the card, in its
  GQA mode with the sliding window for the llama family) and are
  copied into their slot rows, with each row's length, pending token and
  liveness folded into the batcher's state: one insert, no host wait.
- **Decode**: at ``decode_block == 1`` one decode step of the family
  (:func:`.decode.decode_step` or :func:`.llama.llama_decode_step`) over
  every slot, busy or not, and one host wait per token (the
  reference's baseline).  At ``decode_block > 1`` a
  :func:`.decode.block_decode` with the liveness on the device, and block
  N+1 is dispatched before block N is read, so the host's settle, reply
  and refill for block N overlap the device's work on block N+1.
- **Fleet seams**: :meth:`ContinuousBatcher.adopt_engine` lets a new fleet
  replica share a donor's params and engine, and the worker's settle
  reports whether it answered (the fleet's reply dedup overrides it).
- **Sharded-plane seams**: :meth:`ContinuousBatcher.submit_resume`
  re-admits evacuated requests mid-flight (one ``[M, prompt_len +
  generate_tokens]`` insert with per-row budgets),
  :meth:`ContinuousBatcher.request_decode_block` and
  :meth:`ContinuousBatcher.set_slot_limit` are the live engine knobs, and
  :class:`ContinuousWorker` builds a :class:`~.shard_plane.ShardedBatcher`
  when ``ServiceConfig.shards > 1`` (or ``sharded=True``) and moves a
  quarantined shard's rows off it (:meth:`ContinuousWorker.evacuate_shard`).

Where the reference donates its state to jitted programs, the port
mutates the slot cache and the per-row state (``current``, ``done``,
``remaining``) in place, and one CUDA stream keeps every insert ahead of
the next decode.  Host operands go up from fresh pinned buffers without a
wait.  Every device result the host reads is copied into pinned host
memory as soon as it is produced, with an event behind the copy
(:class:`_HostCopy`): the host waits for that event, never for the whole
stream, which would also wait for the block dispatched after it.

The worker reports its serving gauges and TTFT histogram to a
:class:`~..obs.prometheus.WorkloadMetrics` registry
(:meth:`ContinuousWorker.attach_metrics`), from host counters only.

The slots hold either cache layout (``quantized_kv``: int8 codes with
per-position scales) and may start past a shared prompt prefix
(``prefix_cache``, from the family's ``prefill_prefix`` in the same
layout): every slot row holds a copy of the prefix, an insert runs the
suffixes through the family's chunk decoder (no kernel launch, as in the
reference) and splices only the suffix positions, so decode never writes
the prefix region.  The layout's entry points come from
:meth:`.family.ModelFamily.layout`.

Speculative slots (``draft_layers``: an early-exit self-draft of the
target's first layers, ``draft_tokens`` proposals a round) run one
draft-and-verify round a step over every slot, with a second round
dispatched before the first is read where every row in it is certain to
need one; one target prefill seeds both caches.  Beam slots (``beams``)
each own ``beams`` cache rows and a search state on the device, and a step
is one beam expansion over every slot with the parent gather of the cache.
Both admit one request an insert, as in the reference, and their results
equal :func:`.speculative.speculative_generate` and
:func:`.beam.beam_search` for each prompt alone.

Not ported yet (the batcher raises ``ValueError``): a mesh and tenancy
(with the overload ladder's ``_quiesce_rows``).
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
from .beam import RowGather, beam_step, rank_beams, seed_beams
from .decode import (
    _check_prefix_layout, _pick, block_decode, broadcast_prefix,
    prefix_len_of,
)
from .family import CacheLayout, family_of
from .speculative import (
    draft_prefix_from_target, self_draft, speculative_round,
)
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


def _rows_prefill(params, prompts, lengths, config, attention_fn,
                  layout: CacheLayout, prefix_cache=None):
    """``M`` prompts' prefill as one ``[M, P]`` batch in the family's cache
    ``layout``; returns ``(logits [M, V], rows_cache)``.  With a
    ``prefix_cache`` the prompts are suffixes continued from it through
    the layout's chunk decoder (``attention_fn`` does not apply), else the
    layout's prefill runs them with ``attention_fn``.  Rows never interact
    across the batch, so each row's result is what its own ``[1, P]``
    prefill gives."""
    if prefix_cache is not None:
        return layout.prefill_with_prefix(params, prefix_cache, prompts,
                                          config, lengths=lengths)
    return layout.prefill(params, prompts, config, attention_fn,
                          lengths=lengths)


def _splice_rows_layers(cache, rows_cache, rows, prefix_len,
                        prompt_len, beams: int = 1) -> None:
    """Copy each prefilled row's prompt positions (under a prefix, the
    suffix positions ``[prefix_len, prefix_len + prompt_len)`` only) into
    its slot row of the batch cache, in place: one indexed copy per layer
    entry for all the rows.  Every entry has the position on axis 2, the
    ``[B, H, S, D]`` k/v or codes and the ``[B, H, S]`` scales alike.
    ``beams > 1``: slot ``row`` owns cache rows ``[row * beams, (row + 1) *
    beams)``, and its one prefilled row is repeated over them (every beam
    of a fresh slot starts from the same prompt cache).  Only as many
    layers as ``cache`` holds are copied: a draft cache takes the first
    layers of the target's prefill."""
    span = slice(prefix_len, prefix_len + prompt_len)
    if beams > 1:
        rows = (rows[:, None] * beams
                + torch.arange(beams, device=rows.device)).reshape(-1)
    for layer_cache, rows_layer in zip(cache["layers"], rows_cache["layers"]):
        for name, buf in layer_cache.items():
            piece = rows_layer[name][:, :, span]
            if beams > 1:
                piece = piece.repeat_interleave(beams, dim=0)
            buf[rows, :, span] = piece


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
    budgets: torch.Tensor | None = None,
    *,
    layout: CacheLayout,
    prefix_cache: dict | None = None,
    prefix_len: int = 0,
) -> torch.Tensor:
    """Batched admission: prefill ``prompts`` (``[M, P]``, right-padded,
    real lengths ``lengths``) as one batch in the cache ``layout``, copy
    them into slot ``rows`` of ``cache``, and fold each row's length (past
    the ``prefix_len`` shared prefix tokens), pending token (``current``),
    ``done`` (set where the first token is ``eos_id``) and ``remaining``
    (``budget - 1``: the first token spends one) into the state, all in
    place.  ``budgets`` (``[M]``) replaces ``budget - 1`` with each row's
    own remaining budget: the resume insert's rows are mid-request.
    Returns the first tokens ``[M]``, still on the device."""
    logits, rows_cache = _rows_prefill(params, prompts, lengths, config,
                                       attention_fn, layout, prefix_cache)
    _splice_rows_layers(cache, rows_cache, rows, prefix_len,
                        prompts.shape[1])
    cache["length"][rows] = prefix_len + lengths
    firsts = _pick(logits, key, temperature, top_k, top_p)
    current[rows] = firsts
    done[rows] = firsts == eos_id if eos_id is not None else False
    remaining[rows] = budgets if budgets is not None else budget - 1
    return firsts


def _spec_insert_row_impl(
    params: dict,
    cache: dict,
    draft_cache: dict,
    current: torch.Tensor,
    row: torch.Tensor,
    prompt: torch.Tensor,
    length: torch.Tensor,
    key: torch.Generator | None,
    config,
    attention_fn,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    *,
    layout: CacheLayout,
    prefix_cache: dict | None = None,
    prefix_len: int = 0,
) -> torch.Tensor:
    """Admission of one speculative slot: ONE target prefill of ``prompt``
    (``[1, P]``) fills both caches.  The early-exit self-draft is the
    target's first layers, and layer ``i``'s k/v depend only on layers
    below it, so the draft's row is the first layers of the target's
    (:func:`_splice_rows_layers` copies as many layers as a cache holds).
    Folds the row's lengths and pending token in place; returns the first
    token ``[1]``, still on the device."""
    logits, row_cache = _rows_prefill(params, prompt, length, config,
                                      attention_fn, layout, prefix_cache)
    for target in (cache, draft_cache):
        _splice_rows_layers(target, row_cache, row, prefix_len,
                            prompt.shape[1])
        target["length"][row] = prefix_len + length
    first = _pick(logits, key, temperature, top_k, top_p)
    current[row] = first
    return first


def _beam_insert_row_impl(
    params: dict,
    cache: dict,
    state: dict,
    current: torch.Tensor,
    row: int,
    prompt: torch.Tensor,
    length: torch.Tensor,
    config,
    attention_fn,
    *,
    layout: CacheLayout,
    beams: int,
    eos_id: int | None = None,
    prefix_cache: dict | None = None,
    prefix_len: int = 0,
) -> None:
    """Admission of one beam slot: one prefill of ``prompt`` (``[1, P]``)
    seeds slot ``row``'s ``beams`` cache rows and its search state in
    place: the first expansion's top ``beams`` tokens become the beams'
    seeds (``scores``, the first ``out`` column, ``alive``, ``emitted`` of
    ``state``, and the rows' pending tokens), :func:`.beam.beam_search`'s
    seeding for one slot."""
    logits, row_cache = _rows_prefill(params, prompt, length, config,
                                      attention_fn, layout, prefix_cache)
    slot = torch.full((1,), row, dtype=torch.long, device=current.device)
    _splice_rows_layers(cache, row_cache, slot, prefix_len, prompt.shape[1],
                        beams=beams)
    beam_rows = slice(row * beams, (row + 1) * beams)
    cache["length"][beam_rows] = prefix_len + length
    first_tokens, seeded = seed_beams(logits, beams,
                                      state["out"].shape[-1], eos_id)
    for name, value in seeded.items():
        state[name][row] = value[0]
    current[beam_rows] = first_tokens


@dataclass
class _Slot:
    busy: bool = False
    produced: list = field(default_factory=list)
    budget: int = 0
    done: bool = False  # emitted eos before the budget (frees this step)
    payload: Any = None  # the caller's per-request context (the message)
    # speculative slots: verify rounds and accepted drafts; beam slots:
    # beam steps taken
    rounds: int = 0
    accepted: int = 0
    submitted_at: float = 0.0  # admission time, for time to first token
    ttft_done: bool = False  # time to first token already recorded


class ContinuousBatcher:
    """The slot machine: submit prompts, step the batch, collect results.

    Synchronous and queue-agnostic: drive it from anything that produces
    ``(token_ids, payload)`` requests.  ``quantized_kv`` keeps the slots
    in the int8 layout; ``prefix_cache`` (the family's ``prefill_prefix``
    in the same layout) starts every slot past a shared prefix.  The
    config's class picks the model
    family (:func:`.family.family_of`): a :class:`.model.ModelConfig` is
    served as the GPT, a :class:`.llama.LlamaConfig` as the llama (the
    compact GQA cache, the llama prefill with the sliding window,
    :func:`.llama.llama_decode_step`); ``family``, where given, must name
    the same family.  Greedy or
    sampled (``temperature``/``top_k``/``top_p`` through
    :func:`.decode._pick`, one generator per engine step), ``eos_id`` ends a
    slot early.  The
    model runs on ``device`` (``"cuda"`` by default; a missing card
    raises).  Counters: ``insert_dispatches`` and ``decode_dispatches``
    (device work launched), ``host_transfers`` (host waits for a device
    result), ``tokens_emitted``, ``block_tokens`` / ``block_capacity``
    (kept tokens / dispatched block positions of busy slots), and
    ``overlapped_settles`` / ``block_settles`` (settles at which the block
    dispatched that cycle was still running).

    ``draft_layers`` > 0 makes the slots speculative (the first
    ``draft_layers`` layers draft ``draft_tokens`` proposals a round;
    counters ``spec_rounds``, ``spec_accepted``, ``spec_second_rounds``
    and ``spec_overlapped``, the second rounds still running when the
    first was read; :meth:`set_speculative`), ``beams`` > 1 makes each
    slot a beam search (``length_penalty`` ranks the finished beams).

    ``host_transfers`` is the reference's odometer: one per insert whose
    first tokens a settle reads, one per decode step read at
    ``decode_block == 1`` and one per settled block.  At ``decode_block >
    1`` the port waits fewer times than it counts: a cycle's first tokens
    were copied after the pending block on the one stream, so the host
    waits once for both.  ``free_slot_scans`` counts the admission-order
    scans (:attr:`free_slots`).
    """

    def __init__(
        self,
        params: dict,
        config: ModelConfig,
        batch_size: int,
        prompt_len: int,
        generate_tokens: int,
        *,
        family: str | None = None,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        eos_id: int | None = None,
        sample_seed: int = 0,
        mesh=None,
        quantized_kv: bool = False,
        prefix_cache: dict | None = None,
        draft_layers: int = 0,
        draft_tokens: int = 4,
        beams: int = 1,
        length_penalty: float = 0.0,
        decode_block: int = 1,
        tenancy=None,
        device: str | torch.device = "cuda",
    ) -> None:
        if beams < 1:
            raise ValueError(f"beams={beams} must be >= 1")
        model_family = family_of(config, family)
        unported = {"mesh": mesh is not None, "tenancy": tenancy is not None}
        for knob, asked in unported.items():
            if asked:
                raise ValueError(
                    f"{knob} is not yet ported to the PyTorch continuous "
                    "batcher"
                )
        if decode_block < 1:
            raise ValueError(f"decode_block={decode_block} must be >= 1")
        if decode_block > 1 and (beams > 1 or draft_layers):
            raise ValueError(
                "decode_block > 1 applies to the plain decode path (beam "
                "steps and speculative rounds already amortize their own "
                "device calls)"
            )
        if beams > 1:
            # each beam slot owns `beams` contiguous cache rows and a
            # device-side search state; deterministic by construction
            if draft_layers:
                raise ValueError(
                    "beams do not combine with draft_layers (beam "
                    "search is deterministic; speculative rounds are "
                    "per-row)"
                )
            if temperature > 0.0:
                raise ValueError(
                    "beams are deterministic; temperature must be 0"
                )
        self._prefix_cache = prefix_cache
        if prefix_cache is not None:
            # slots start past a shared, once-prefilled prefix in the
            # decode path's layout
            _check_prefix_layout(prefix_cache, quantized_kv)
        self.prefix_len = prefix_len_of(prefix_cache)
        if draft_layers:
            # speculative slots: an early-exit self-draft inside the slot
            # machine, one draft-and-verify round a step
            if not 0 < draft_layers < config.n_layers:
                raise ValueError(
                    f"draft_layers={draft_layers} must be in "
                    f"[1, n_layers-1] (model has n_layers="
                    f"{config.n_layers})"
                )
            if draft_tokens < 1:
                raise ValueError(
                    f"draft_tokens={draft_tokens} must be >= 1"
                )
        # a speculative round can overshoot a slot's budget by k and still
        # write k + 1 masked positions past its frozen length: the 2k
        # slack speculative_generate reserves
        spec_slack = 2 * draft_tokens if draft_layers else 0
        budget = self.prefix_len + prompt_len + generate_tokens + spec_slack
        if budget > config.max_seq_len:
            slack = f" + 2*draft_tokens ({spec_slack})" if spec_slack else ""
            raise ValueError(
                f"prefix + prompt_len + generate_tokens{slack} = "
                f"{budget} exceeds max_seq_len={config.max_seq_len}"
            )
        if top_k < 0:
            raise ValueError(f"top_k={top_k} must be >= 0")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p={top_p} must be in (0, 1]")
        self.device = resolve_device(device)
        self.params = params
        self.config = config
        self.family = model_family.name
        self.quantized_kv = quantized_kv
        self.prompt_len = prompt_len
        self.generate_tokens = generate_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.eos_id = eos_id
        self.draft_layers = draft_layers
        self.draft_tokens = draft_tokens
        self.beams = beams
        self.length_penalty = length_penalty
        # speculative slots: dispatch a round that is certain to be needed
        # before reading the one in flight (set_speculative toggles it)
        self.spec_overlap = True
        self.decode_block = decode_block
        # the engine that was built: the live decode_block knob
        # (request_decode_block) moves only a block engine, which takes any
        # block >= 1 (the sharded plane's always does)
        self._block_engine = decode_block > 1
        # a staged decode_block change, landed at the re-dispatch boundary
        self._pending_decode_block: int | None = None
        # admission cap (per shard on the sharded plane): free_slots offers
        # at most slot_limit - busy rows; None = unlimited
        self.slot_limit: int | None = None
        self.free_slot_scans = 0
        # the engine a fleet replica adopts from its donor (adopt_engine):
        # the prompt-pass attention (the llama pick carries the sliding
        # window), the insert, the family's cache layout (its prefill,
        # prefix continuation and decode step) and the engine that runs it
        self._attention_fn = model_family.attention_fn_for(
            config, prompt_len, self.device)
        self._insert_many = _insert_rows_impl
        self._layout = model_family.layout(quantized_kv)
        self._step_fn = self._layout.decode_step
        if decode_block > 1:
            self._block_fn = block_decode
        else:
            self._decode = self._step_fn
        # speculative stats: verify rounds and accepted drafts over all
        # slots (each slot keeps its own), second rounds dispatched ahead
        # of the first's read and how many were still running at that read
        self.spec_rounds = 0
        self.spec_accepted = 0
        self.spec_second_rounds = 0
        self.spec_overlapped = 0
        # serving stats
        self.tokens_emitted = 0
        self.ttft_sum = 0.0
        self.ttft_count = 0
        self.last_ttft_s: float | None = None
        self.ttft_samples: deque[float] = deque(maxlen=4096)
        # (label, seconds) TTFT samples not yet in a metrics registry's
        # histogram (drain_ttft_histograms); label None is engine-wide
        self._pending_ttft_obs: deque[tuple[str | None, float]] = deque()
        self.block_tokens = 0
        self.block_capacity = 0
        self.block_settles = 0
        self.overlapped_settles = 0
        # the serving contract these pin: a refill costs one insert
        # dispatch and no host wait however many requests it admits; a
        # block cycle one decode dispatch
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
        # a beam slot owns `beams` contiguous cache rows
        cache_rows = batch_size * beams
        with torch.inference_mode():
            if prefix_cache is not None:
                # every slot row starts as a copy of the shared prefix
                self.cache = broadcast_prefix(prefix_cache, cache_rows)
            else:
                self.cache = self._layout.init_cache(config, cache_rows,
                                                     self.device)
            # each cache row's next input token
            self._current = torch.zeros(cache_rows, dtype=torch.long,
                                        device=self.device)
            if beams == 1 and not draft_layers:
                # plain slots keep their liveness on the device: done
                # marks a free or finished row (admission clears it),
                # remaining its unspent budget
                self._done = torch.ones(batch_size, dtype=torch.bool,
                                        device=self.device)
                self._remaining = torch.zeros(batch_size, dtype=torch.long,
                                              device=self.device)
            if draft_layers:
                # the draft is the target's first layers: its params a
                # layer slice, its cache the same layout with fewer layers
                self.draft_params, self.draft_config = self_draft(
                    params, config, draft_layers)
                if prefix_cache is not None:
                    self.draft_cache = broadcast_prefix(
                        draft_prefix_from_target(prefix_cache, draft_layers),
                        batch_size)
                else:
                    self.draft_cache = self._layout.init_cache(
                        self.draft_config, batch_size, self.device)
            if beams > 1:
                # each slot's search state (beam_search's loop state)
                pad = eos_id if eos_id is not None else 0
                self._beam = {
                    "scores": torch.zeros((batch_size, beams),
                                          dtype=torch.float32,
                                          device=self.device),
                    "out": torch.full((batch_size, beams, generate_tokens),
                                      pad, dtype=torch.long,
                                      device=self.device),
                    "alive": torch.zeros((batch_size, beams),
                                         dtype=torch.bool, device=self.device),
                    "emitted": torch.zeros((batch_size, beams),
                                           dtype=torch.long,
                                           device=self.device),
                }
                self._beam_gather = RowGather(self.cache)
        # one generator per engine step and insert; greedy needs none
        self._keys = (
            sampling_keys(sample_seed, self.device) if temperature > 0.0
            else itertools.repeat(None)
        )

    def adopt_engine(self, source: "ContinuousBatcher") -> None:
        """Share ``source``'s engine: its prompt-pass attention and its
        insert and decode steps (of one family: the family is part of the
        engine key).  They close over the serving knobs only,
        never over a batcher's rolling state, so a fleet replica built
        with the donor's knobs, params and config runs the donor's engine
        and pays only for its own KV cache.  Raises ``ValueError`` when a
        knob differs or ``params`` / ``config`` are not the donor's very
        objects (and the donor's prefix cache).  Plain decode slots only,
        as in the reference: beam and speculative engines raise."""
        if (self.beams > 1 or self.draft_layers or source.beams > 1
                or source.draft_layers):
            raise ValueError(
                "adopt_engine supports the plain decode path only"
            )
        mine, theirs = self._engine_key(), source._engine_key()
        if mine != theirs:
            raise ValueError(
                f"engine mismatch: {mine} != {theirs} (a replica must be "
                "constructed with the donor's exact serving knobs)"
            )
        if (self.config is not source.config
                or self.params is not source.params
                or self._prefix_cache is not source._prefix_cache):
            raise ValueError(
                "adopt_engine requires the donor's exact params/config/"
                "prefix objects (the engine runs over them)"
            )
        self._attention_fn = source._attention_fn
        self._insert_many = source._insert_many
        self._layout = source._layout
        self._step_fn = source._step_fn
        # whichever decode step both sides built (a live decode_block
        # change can leave a block engine at block 1)
        if hasattr(source, "_block_fn") and hasattr(self, "_block_fn"):
            self._block_fn = source._block_fn
        elif hasattr(source, "_decode") and hasattr(self, "_decode"):
            self._decode = source._decode
        else:
            raise ValueError(
                "engine mismatch: donor and replica were built on different "
                "decode paths (block vs single-step)"
            )

    def _engine_key(self) -> tuple:
        """The serving knobs the engine depends on."""
        return (
            len(self.slots), self.prompt_len, self.generate_tokens,
            self.family, self.temperature, self.top_k, self.top_p,
            self.eos_id, self.quantized_kv, self.prefix_len,
            self.decode_block, self.draft_layers, self.draft_tokens,
            self.beams, self.length_penalty, str(self.device),
        )

    def request_decode_block(self, block: int) -> bool:
        """Stage a live decode-block change.  It lands inside a later
        :meth:`step` at the re-dispatch boundary: that step dispatches
        nothing, so the block in flight settles at the old size, and the
        next step dispatches at the new one.  An idle engine swaps at once.
        Block engines only (built with ``decode_block > 1``, or the sharded
        plane).  Returns False when ``block`` is already the live or staged
        size."""
        if not self._block_engine:
            raise ValueError(
                "decode_block is a live knob only on the block/gang decode "
                "engine (construct with decode_block > 1, or the sharded "
                "plane)"
            )
        block = int(block)
        if block < 1:
            raise ValueError(f"decode_block={block} must be >= 1")
        current = (self._pending_decode_block
                   if self._pending_decode_block is not None
                   else self.decode_block)
        if block == current:
            return False
        if self._pending_block is None and self.active == 0:
            self.decode_block = block
            self._pending_decode_block = None
            return True
        self._pending_decode_block = block
        return True

    def _apply_pending_decode_block(self) -> None:
        """Land a staged block change; the step bodies call it once nothing
        is in flight."""
        if self._pending_decode_block is None:
            return
        self.decode_block = self._pending_decode_block
        self._pending_decode_block = None

    def set_speculative(self, enabled: bool) -> None:
        """Toggle the speculative engine's second-round overlap (the
        dispatch, before the first round's read, of a round every row in
        it is certain to need).  Read once a :meth:`step`.  Speculative
        engines only."""
        if not self.draft_layers:
            raise ValueError(
                "the speculative knob needs the draft-and-verify "
                "engine (draft_layers > 0)"
            )
        self.spec_overlap = bool(enabled)

    def set_slot_limit(self, limit: int | None) -> None:
        """Cap admission at ``limit`` busy rows (per shard on the sharded
        plane); ``None`` = unlimited.  Rows above a lowered limit decode to
        completion; a raised limit offers the parked rows at the next
        refill."""
        if limit is not None:
            limit = int(limit)
            per_shard = getattr(self, "shard_slots", len(self.slots))
            if not 1 <= limit <= per_shard:
                raise ValueError(
                    f"slot_limit={limit} must be in [1, {per_shard}] "
                    "(or None = unlimited)"
                )
        self.slot_limit = limit
        self._invalidate_admission_cache()

    def _invalidate_admission_cache(self) -> None:
        """Called at every change of which rows may be admitted (slot
        assignment and release, mask and probe flips, the slot limit): the
        sharded plane memoizes its availability scan; a no-op here, where
        ``free_slots`` is an uncached scan."""

    @property
    def free_slots(self) -> list[int]:
        self.free_slot_scans += 1
        rows = [i for i, s in enumerate(self.slots) if not s.busy]
        if self.slot_limit is not None:
            busy = len(self.slots) - len(rows)
            rows = rows[: max(0, self.slot_limit - busy)]
        return rows

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
        stay on the device until the next :meth:`step`.  Beam and
        speculative slots admit one request an insert (each seeds its
        slot's search or draft state), as in the reference."""
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
        if self.beams > 1 or self.draft_layers:
            for row, (token_ids, payload) in zip(rows, requests):
                self._submit_one(row, token_ids, payload, now)
            return rows
        padded = [self._pad_prompt(ids) for ids, _ in requests]
        prompts = np.stack([ids for ids, _ in padded])
        lengths = np.asarray([n for _, n in padded], np.int64)
        with torch.inference_mode():
            firsts = self._insert_many(
                self.params, self.cache, self._current, self._done,
                self._remaining, _to_device(np.asarray(rows), self.device),
                _to_device(prompts, self.device),
                _to_device(lengths, self.device), next(self._keys),
                self.config, self.generate_tokens, self._attention_fn,
                self.temperature, self.top_k, self.top_p, self.eos_id,
                **self._insert_layout(),
            )
            self._defer_firsts(firsts, rows)
        self.insert_dispatches += 1
        for row, (_, payload) in zip(rows, requests):
            self.slots[row] = _Slot(
                busy=True, budget=self.generate_tokens, payload=payload,
                submitted_at=now,
            )
        self._invalidate_admission_cache()
        return rows

    def _submit_one(self, row: int, token_ids, payload, now: float) -> None:
        """Admission of one request into a beam or speculative slot: one
        prefill (the CUDA flash forward on the card, or the chunk decoder
        behind a prefix) that seeds the slot's state in place."""
        ids, length = self._pad_prompt(token_ids)
        prompt = _to_device(ids[None, :], self.device)
        lengths = _to_device(np.asarray([length], np.int64), self.device)
        with torch.inference_mode():
            if self.beams > 1:
                _beam_insert_row_impl(
                    self.params, self.cache, self._beam, self._current, row,
                    prompt, lengths, self.config, self._attention_fn,
                    beams=self.beams, eos_id=self.eos_id,
                    **self._insert_layout(),
                )
            else:
                first = _spec_insert_row_impl(
                    self.params, self.cache, self.draft_cache, self._current,
                    _to_device(np.asarray([row]), self.device), prompt,
                    lengths, next(self._keys), self.config,
                    self._attention_fn, self.temperature, self.top_k,
                    self.top_p, **self._insert_layout(),
                )
                self._defer_firsts(first, [row])
        self.insert_dispatches += 1
        self.slots[row] = _Slot(busy=True, budget=self.generate_tokens,
                                payload=payload, submitted_at=now)
        self._invalidate_admission_cache()

    def _insert_layout(self) -> dict:
        """The insert's cache-layout keywords: the layout and the shared
        prefix the slots start past."""
        return dict(layout=self._layout, prefix_cache=self._prefix_cache,
                    prefix_len=self.prefix_len)

    def _defer_firsts(self, firsts: torch.Tensor, rows: list[int]) -> None:
        """Hold an insert's first tokens until the next :meth:`step`: here
        each insert's are copied to the host at once, behind their own
        event (the sharded plane copies a cycle's together)."""
        self._pending_firsts.append((_HostCopy(firsts), list(rows)))

    @property
    def resume_len(self) -> int:
        """The resume insert's prompt bucket: a resumed row prefills its
        prompt and what it had produced, at most ``prompt_len +
        generate_tokens`` tokens (past the shared prefix, if any: the
        resume runs through the same insert)."""
        return self.prompt_len + self.generate_tokens

    def submit_resume(self, resumes: list[tuple]) -> list[int]:
        """Re-admit evacuated mid-flight requests into free slots; returns
        their slot rows.

        Each resume is ``(token_ids, payload, produced, budget,
        submitted_at)``: the original prompt, the payload, the tokens
        already produced (the reply keeps them), the original budget and
        admission time.  The batch prefills prompt + produced as one
        ``[M, resume_len]`` insert through the same insert and attention
        as :meth:`submit_many` (the CUDA flash forward on the card), with
        each row's unspent budget, so a greedy row continues as if never
        interrupted.  Its time to first token is not recorded again."""
        if self.beams > 1 or self.draft_layers:
            raise ValueError(
                "submit_resume supports the plain decode path only"
            )
        if not resumes:
            return []
        free = self.free_slots
        if len(resumes) > len(free):
            raise RuntimeError(
                f"no free slot for {len(resumes)} resumed request(s) "
                f"({len(free)} free); release the rest to the queue"
            )
        rows = free[: len(resumes)]
        prompts = np.zeros((len(resumes), self.resume_len), np.int64)
        lengths = np.zeros((len(resumes),), np.int64)
        budgets = np.zeros((len(resumes),), np.int64)
        for i, (ids, _, produced, budget, _) in enumerate(resumes):
            prior = np.asarray(ids, np.int64).reshape(-1)[: self.prompt_len]
            full = np.concatenate([prior, np.asarray(produced, np.int64)])
            if not 0 <= len(produced) < budget:
                raise ValueError(
                    f"resumed row produced {len(produced)} of budget "
                    f"{budget} tokens: a complete request settles, it does "
                    "not resume"
                )
            if full.size > self.resume_len:
                raise ValueError(
                    f"resume prompt of {full.size} tokens exceeds the "
                    f"resume bucket ({self.resume_len})"
                )
            prompts[i, : full.size] = full
            lengths[i] = max(1, full.size)
            # the insert's first token spends one of the remaining budget
            budgets[i] = budget - len(produced) - 1
        with torch.inference_mode():
            firsts = self._insert_many(
                self.params, self.cache, self._current, self._done,
                self._remaining, _to_device(np.asarray(rows), self.device),
                _to_device(prompts, self.device),
                _to_device(lengths, self.device), next(self._keys),
                self.config, self.generate_tokens, self._attention_fn,
                self.temperature, self.top_k, self.top_p, self.eos_id,
                budgets=_to_device(budgets, self.device),
                **self._insert_layout(),
            )
            self._defer_firsts(firsts, rows)
        self.insert_dispatches += 1
        for row, (_, payload, produced, budget, submitted_at) in zip(
                rows, resumes):
            self.slots[row] = _Slot(
                busy=True, budget=budget, payload=payload,
                produced=list(produced), submitted_at=submitted_at,
                ttft_done=bool(produced),
            )
        self._invalidate_admission_cache()
        return rows

    def _emit(self, slot: _Slot, token: int) -> None:
        """Append one kept token to a slot: the one place the eos check
        and the emitted-token count live."""
        slot.produced.append(token)
        self.tokens_emitted += 1
        if self.eos_id is not None and token == self.eos_id:
            slot.done = True

    def _settle_pending_firsts(self) -> None:
        """Emit the deferred first tokens and record time to first token;
        counts one host transfer per insert read, as the reference does."""
        if not self._pending_firsts:
            return
        pending, self._pending_firsts = self._pending_firsts, []
        self.host_transfers += len(pending)
        self._record_firsts([(copy.wait()[0], rows) for copy, rows in pending])

    def _record_firsts(self, pending_host: list) -> None:
        now = time.perf_counter()
        for values, rows in pending_host:
            for token, row in zip(values.reshape(-1), rows):
                slot = self.slots[row]
                self._emit(slot, int(token))
                if slot.ttft_done:
                    # a resumed row: its first life recorded the TTFT
                    continue
                self._record_ttft(row, slot, now)

    def _record_ttft(self, row: int, slot: _Slot, now: float) -> None:
        """Record a slot's time to first token, once."""
        slot.ttft_done = True
        ttft = now - slot.submitted_at
        self.ttft_sum += ttft
        self.ttft_count += 1
        self.last_ttft_s = ttft
        self.ttft_samples.append(ttft)
        self._pending_ttft_obs.append((None, ttft))
        self._note_ttft(row, ttft)

    def _note_ttft(self, row: int, ttft: float) -> None:
        """Per-row TTFT hook: the sharded plane files it by shard."""

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
        if finished:
            self._invalidate_admission_cache()
        return finished

    def step(self) -> list[tuple[Any, np.ndarray]]:
        """Advance every busy slot (one token, or up to ``decode_block``
        per dispatch); returns the finished requests as ``(payload,
        continuation_tokens)`` pairs, whose slots are free again.  A no-op
        when nothing is busy."""
        if self.active == 0:
            return []
        if self.beams > 1:
            return self._step_beam()
        if self.draft_layers:
            return self._step_spec()
        if self._block_engine:
            # the built engine, not the live size: the decode_block knob
            # can take a block engine to 1
            return self._step_block()
        return self._step_single()

    def _step_single(self) -> list[tuple[Any, np.ndarray]]:
        """One token per dispatch, read by the host at once: the
        reference's baseline engine."""
        self._settle_pending_firsts()
        # rows whose budget is one token (or that hit eos) need no step
        needs = [self._needs_decode(s) for s in self.slots]
        if any(needs):
            with torch.inference_mode():
                logits, self.cache = self._decode(
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
        the stream.  The counter adds one per insert settled and one for
        block N, as the reference's does; the host waits once a cycle,
        because the pending first tokens were copied after block N and
        their wait covers it.  A staged decode-block change skips the
        dispatch: the block in flight settles at the old size and the
        change lands."""
        new_block = None
        busy = self.active
        if self._pending_decode_block is None:
            with torch.inference_mode():
                (self.cache, self._current, self._done, self._remaining,
                 tokens, counts) = self._block_fn(
                    self.params, self.cache, self._current, self._done,
                    self._remaining, self._block_keys(), self.config,
                    self._step_fn, temperature=self.temperature,
                    top_k=self.top_k, top_p=self.top_p, eos_id=self.eos_id,
                )
                new_block = (_HostCopy(tokens, counts), busy)
            self.decode_dispatches += 1
        self._settle_pending_firsts()
        pending, self._pending_block = self._pending_block, new_block
        if pending is not None:
            copy, dispatched_busy = pending
            toks_host, counts_host = copy.wait()
            self.host_transfers += 1
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
            if new_block is not None and not new_block[0].ready():
                self.overlapped_settles += 1
        if self._pending_block is None:
            self._apply_pending_decode_block()
        return self._finish_ready()


    def _dispatch_spec_round(self, mask: list[bool]) -> _HostCopy:
        """Launch one draft-and-verify round over the masked rows; returns
        the host copy of its ``(round_tokens, n)`` on its way."""
        with torch.inference_mode():
            active = _to_device(np.asarray(mask), self.device)
            self._current, round_tokens, n = speculative_round(
                self._layout, self._layout, self.params, self.draft_params,
                self.config, self.draft_config, self.cache, self.draft_cache,
                self._current, active, self.draft_tokens, next(self._keys),
                self.temperature, self.top_k, self.top_p,
            )
            copy = _HostCopy(round_tokens, n)
        self.decode_dispatches += 1
        return copy

    def _consume_spec_round(self, mask: list[bool], copy: _HostCopy) -> None:
        """Emit a round's accepted drafts and bonus for the masked rows."""
        toks_host, n_host = copy.wait()
        self.host_transfers += 1
        for row, slot in enumerate(self.slots):
            if not mask[row]:
                continue
            accepted = int(n_host[row])
            slot.rounds += 1
            slot.accepted += accepted
            self.spec_rounds += 1
            self.spec_accepted += accepted
            for token in toks_host[row, : accepted + 1]:
                if slot.done or len(slot.produced) >= slot.budget:
                    break
                self._emit(slot, int(token))

    def _step_spec(self) -> list[tuple[Any, np.ndarray]]:
        """One, or two pipelined, draft-and-verify rounds.

        A row that needs another round even if the one in flight accepts
        every draft (``produced + k + 1 < budget``) is known now, so its
        next round is dispatched before the host reads this one's
        ``(round_tokens, n)``: the read then overlaps the second round's
        device time.  An ``eos_id`` makes completion unknowable ahead, so
        the overlap needs eos-free serving; rows left out keep their
        pending token for the next step, within the budget's 2k slack."""
        self._settle_pending_firsts()
        needs = [self._needs_decode(s) for s in self.slots]
        if any(needs):
            first_round = self._dispatch_spec_round(needs)
            ahead = self.draft_tokens + 1
            certain = [
                needs[row] and self.eos_id is None
                and len(slot.produced) + ahead < slot.budget
                for row, slot in enumerate(self.slots)
            ]
            second_round = (
                self._dispatch_spec_round(certain)
                if any(certain) and self.spec_overlap else None
            )
            self._consume_spec_round(needs, first_round)
            if second_round is not None:
                self.spec_second_rounds += 1
                if not second_round.ready():
                    self.spec_overlapped += 1
                self._consume_spec_round(certain, second_round)
        return self._finish_ready()

    def _beam_best(self, row: int, scores, out, emitted) -> np.ndarray:
        """A finished slot's best beam from the host state, ranked as
        :func:`.beam.beam_search` ranks (ties to the lowest beam)."""
        _, order = rank_beams(torch.from_numpy(scores[row]),
                              torch.from_numpy(emitted[row]),
                              self.length_penalty)
        return out[row, int(order[0])].astype(np.int32)

    def _step_beam(self) -> list[tuple[Any, np.ndarray]]:
        """One beam step over the slots that still search, read by the
        host at once (with the state, so a finishing slot's best beam
        needs no second read); then the finished slots' best beams.  A
        beam slot has no incremental first token: its time to first token
        is the time to its answer."""
        needs = [
            s.busy and not s.done and s.rounds < s.budget - 1
            for s in self.slots
        ]
        host = None
        if any(needs):
            with torch.inference_mode():
                active = _to_device(np.asarray(needs), self.device)
                self.cache, self._current, self._beam = beam_step(
                    self.params, self.cache, self._current, self._beam,
                    active, self.config, self._beam_gather,
                    step_fn=self._step_fn, beams=self.beams,
                    eos_id=self.eos_id,
                )
                copy = _HostCopy(self._beam["alive"].any(dim=1),
                                 self._beam["scores"], self._beam["out"],
                                 self._beam["emitted"])
            self.decode_dispatches += 1
            alive_host, *host = copy.wait()
            self.host_transfers += 1
            for row, slot in enumerate(self.slots):
                if needs[row]:
                    slot.rounds += 1
                    if not alive_host[row]:
                        # every beam frozen: the result is already final
                        slot.done = True
        finished = []
        now = time.perf_counter()
        for row, slot in enumerate(self.slots):
            if not (slot.busy
                    and (slot.done or slot.rounds >= slot.budget - 1)):
                continue
            if host is None:
                # a one-token budget finishes without a step
                with torch.inference_mode():
                    host = _HostCopy(self._beam["scores"], self._beam["out"],
                                     self._beam["emitted"]).wait()
            best = self._beam_best(row, *host)
            # kept tokens as _emit counts them: up to and including the
            # first eos, never the padding after it
            kept = int(best.size)
            if self.eos_id is not None:
                hits = np.flatnonzero(best == self.eos_id)
                if hits.size:
                    kept = int(hits[0]) + 1
            self.tokens_emitted += kept
            self._record_ttft(row, slot, now)
            finished.append((slot.payload, best))
            self.slots[row] = _Slot()
        if finished:
            self._invalidate_admission_cache()
        return finished


def drain_ttft_histograms(batcher, metrics) -> None:
    """Move a batcher's pending TTFT samples into the cumulative
    ``ttft_seconds`` histogram of ``metrics``.  A module function because
    two consumers drain on their own cadence: the worker's own
    :meth:`ContinuousWorker._update_metrics` and the fleet pool's, which
    drains every replica into one family (cumulative histograms merge
    across replicas, unlabeled gauges would not)."""
    pending = getattr(batcher, "_pending_ttft_obs", None)
    while pending:
        _, seconds = pending.popleft()
        metrics.observe_histogram(
            "ttft_seconds", seconds,
            "Seconds from request admission to its first generated token "
            "being host-visible (cumulative histogram over the worker's "
            "lifetime).",
        )


class ContinuousWorker:
    """A queue-draining worker on :class:`ContinuousBatcher`.

    Same at-least-once contract as :class:`.service.QueueWorker`: a
    message is deleted only after its continuation is generated and its
    reply (when ``ServiceConfig.result_queue_url`` is set) is sent.  A long
    request never blocks fresh messages: slots refill as they finish.
    ``now_fn`` is the request-TTL clock and must share a time base with
    the queue's ``SentTimestamp`` (epoch seconds by default).  ``family``
    (``"gpt"`` or ``"llama"``; by default the config's) and
    ``prefix_cache`` (a shared prefix the slots start past, in the layout
    ``ServiceConfig.quantized_kv`` picks) go to the batcher or the
    plane; ``draft_layers`` / ``draft_tokens`` (speculative slots) and
    ``beams`` / ``length_penalty`` (beam slots) to the batcher, never the
    plane."""

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
        sharded: bool | None = None,
        family: str | None = None,
        prefix_cache: dict | None = None,
        draft_layers: int = 0,
        draft_tokens: int = 4,
        beams: int = 1,
        length_penalty: float = 0.0,
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
        knobs = dict(
            prompt_len=service_config.seq_len,
            generate_tokens=service_config.generate_tokens,
            temperature=service_config.temperature,
            top_k=service_config.top_k,
            top_p=service_config.top_p,
            eos_id=service_config.eos_id,
            sample_seed=service_config.sample_seed,
            decode_block=service_config.decode_block,
            quantized_kv=service_config.quantized_kv,
            prefix_cache=prefix_cache,
            family=family,
            draft_layers=draft_layers,
            draft_tokens=draft_tokens,
            beams=beams,
            length_penalty=length_penalty,
            device=device,
        )
        if sharded is None:
            sharded = service_config.shards > 1
        if draft_layers > 0 and sharded:
            # the reference runs speculative shards on its decode plane
            # (planes/engine.py), which the port does not have yet
            raise ValueError(
                "speculative decoding on the sharded plane runs on the "
                "decode-plane engine, not yet ported (ROADMAP Queue 1 "
                "item 7)"
            )
        if sharded:
            # the sharded plane: `shards` gang-stepped engine shards of
            # batch_size slots each behind this worker's admission, one
            # decode dispatch a cycle.  sharded=True builds it even at one
            # shard (a ShardedWorkerPool pinned to one shard).
            from .shard_plane import ShardedBatcher

            self.batcher: ContinuousBatcher = ShardedBatcher(
                params, model_config, shards=service_config.shards,
                shard_slots=service_config.batch_size, **knobs,
            )
        else:
            self.batcher = ContinuousBatcher(
                params, model_config, batch_size=service_config.batch_size,
                **knobs,
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
        # optional WorkloadMetrics registry (attach_metrics); the gauges
        # refresh once per engine cycle
        self.metrics = None
        self._served_since: float | None = None

    @property
    def shed(self) -> int:
        """Requests shed over the worker's lifetime, all reasons summed."""
        return sum(self.shed_by_reason.values())

    def _settle(self, message: dict, tokens: np.ndarray | None, *,
                error: str | None = None, counted: bool = True) -> bool:
        """Reply (when configured), then delete one finished message.
        ``tokens=None`` answers with ``error`` (default "malformed body")
        instead of a result.  ``counted=False`` marks a settle that does
        not ride :meth:`run_once`'s completion count (TTL sheds and
        malformed drops); the fleet's override keys its duplicate
        accounting on it.  Returns whether this call answered the request
        (the fleet's override returns False for a duplicate it consumed)."""
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
        return True

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
                self._settle(message, None, counted=False)
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
        if self._settle(message, None, error="expired", counted=False):
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

    def evacuate_shard(self, shard: int) -> tuple[int, int]:
        """Move a quarantined shard's unfinished rows off it: re-admit
        prompt + produced onto healthy shards as one resume insert, and
        hand back to the queue (``change_message_visibility(0)``) what
        finds no healthy free slot or no longer parses.  Returns
        ``(evacuated, released)``.  The caller masks the shard out of
        admission first, so no resumed row routes back onto it.  Sharded
        plane only."""
        taken = self.batcher.take_shard_inflight(shard)
        capacity = len(self.batcher.free_slots)
        resumes, handback = [], []
        for payload, produced, budget, submitted_at in taken:
            ids = parse_request_body(payload["Body"])
            fits = (
                ids is not None
                and len(resumes) < capacity
                and min(ids.size, self.batcher.prompt_len) + len(produced)
                <= self.batcher.resume_len
            )
            if fits:
                resumes.append((ids, payload, produced, budget,
                                submitted_at))
            else:
                handback.append(payload)
        if resumes:
            self.batcher.submit_resume(resumes)
        nack = getattr(self.queue, "change_message_visibility", None)
        if handback and nack is None:
            log.warning(
                "Queue has no change_message_visibility; %d released "
                "request(s) will redeliver only after the visibility "
                "timeout", len(handback),
            )
        for payload in handback:
            # back through the queue: a survivor decodes it from the
            # prompt; the reply registry still dedups a racing redelivery
            if nack is not None:
                nack(self.config.queue_url, payload["ReceiptHandle"], 0)
        return len(resumes), len(handback)

    def attach_metrics(self, metrics) -> None:
        """Report the serving gauges (tokens/s, time to first token,
        active slots, block utilization), the shed counters and the TTFT
        histogram to a :class:`~..obs.prometheus.WorkloadMetrics`
        registry, refreshed every engine cycle."""
        self.metrics = metrics
        self._update_metrics()

    def _update_metrics(self) -> None:
        """Write this cycle's numbers into the registry.  Host counters
        only: the registry renders on a server thread, which must never
        touch a device tensor."""
        if self.metrics is None:
            return
        batcher = self.batcher
        elapsed = (
            time.perf_counter() - self._served_since
            if self._served_since is not None else 0.0
        )
        self.metrics.set_serving_gauges(
            tokens_per_second=(
                batcher.tokens_emitted / elapsed if elapsed > 0 else 0.0
            ),
            time_to_first_token_seconds=(
                batcher.ttft_sum / batcher.ttft_count
                if batcher.ttft_count else 0.0
            ),
            active_slots=batcher.active,
            decode_block_utilization=(
                batcher.block_tokens / batcher.block_capacity
                if batcher.block_capacity else 0.0
            ),
        )
        shed_help = (
            "Requests shed at admission, by reason: ttl = older than "
            "--request-ttl on arrival (explicit expired reply).  The "
            "unlabeled series is their sum."
        )
        self.metrics.set_gauge(
            "requests_shed_total", self.shed, shed_help, kind="counter",
        )
        for reason, count in sorted(self.shed_by_reason.items()):
            self.metrics.set_gauge(
                "requests_shed_total", count, shed_help,
                labels=(("reason", reason),), kind="counter",
            )
        drain_ttft_histograms(batcher, self.metrics)

    def run_once(self) -> int:
        """One engine cycle: refill free slots, advance the batch, settle
        finished requests.  Returns the messages completed."""
        if self._served_since is None:
            self._served_since = time.perf_counter()
        self._refill()
        done = self.batcher.step()
        for message, tokens in done:
            self._settle(message, tokens)
        if done:
            self._poll_backoff = 0  # a slot just freed: poll right away
        self.processed += len(done)
        self._update_metrics()
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
