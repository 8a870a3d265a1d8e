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
(:meth:`ContinuousWorker.attach_metrics`), from host counters only.  With
:meth:`ContinuousWorker.attach_spans` the worker and its engine record
each cycle's phases (``cycle``, ``receive``, ``insert``, ``step``,
``reply`` and the plain engines' launches, waits and emits inside them)
into a :class:`~..utils.profiling.SpanTimer`, on the clock device traces
use; off, each site costs one attribute test.

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

Multi-tenant serving (``tenancy``, a :class:`.tenancy.TenancyConfig`):
the worker stages received messages in per-tenant sub-queues and picks
each refill's admission batch by deficit round robin
(:class:`.tenancy.FairAdmission`), with the overload ladder's degrade,
evict and shed tiers and the decode-phase deadline.  With a prefix pool
(``tenancy.prefix_pool > 0``) each tenant's prompt prefix is prefilled
once into a :class:`.tenancy.PrefixPool` row, and a refill's pooled insert
(:func:`_insert_rows_pooled_impl`) gathers every row's prefix from the
pool on the device and runs the suffixes through the chunk decoder: one
dispatch, no host wait.  A degraded row that finishes before its device
budget is quiesced (:meth:`ContinuousBatcher._quiesce_rows`) and kept out
of admission until the block in flight has settled.  With
``tenancy.admission_shards > 1`` the staging is the sharded admission
plane (:class:`.admission_shards.ShardedAdmission`), each shard with its
own ladder; tenancy on ``shards > 1`` rides the sharded plane's sticky
tenant homes and per-shard pools; speculative slots with ``shards > 1``
or with tenancy run on the decode plane
(:class:`~..planes.engine.DecodePlaneBatcher`), the S = 1 end of it
without ``shards``.

On a ``(data, model)`` serving mesh (``mesh``, a rank's
:class:`.distributed.Mesh`; the reference's mesh-sharded slots) every rank
runs the same host bookkeeping over every slot, and the device work splits:
each admission's prompt pass runs on every data rank at the rank's heads
over ``model`` (the reference's insert prefill replicates over ``data``
too), and each decode step, block or speculative round computes the rank's
rows over ``data`` (:func:`.family.split_rows`), whose logits are gathered
over ``model`` and ``data``, so every rank picks every row's token, sampled
ones included, as one process would.  A rank's cache holds its own slots'
rows at its heads (the reference's ``cache_shardings``: rows over
``data``, heads over ``model``), and its lengths every slot's; an
admission writes only the rows its rank holds.
:class:`ContinuousWorker` takes the ``mesh`` too: world rank 0 owns the
queue (it receives, replies and deletes, and broadcasts what it received)
and the clock the host's decisions read
(:class:`.distributed.RankQueue`, :func:`.distributed.rank_clock`).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import logging
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..obs.lifecycle import request_key as _trace_key
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
    ServiceConfig, bounded_tenant_key, build_token_reply,
    parse_request_body, parse_tenant_request, request_id, sampling_keys,
    sent_epoch,
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
    CPU tensors are copied plainly.  ``span`` is the id of the phase span
    that launched the copy, when the engine records spans."""

    span: int | None = None

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
                        prompt_len, beams: int = 1, held=None) -> None:
    """Copy each prefilled row's prompt positions (under a prefix, the
    suffix positions ``[prefix_len, prefix_len + prompt_len)`` only) into
    its slot row of the batch cache, in place: one indexed copy per layer
    entry for all the rows.  Every entry has the position on axis 2, the
    ``[B, H, S, D]`` k/v or codes and the ``[B, H, S]`` scales alike.
    ``beams > 1``: slot ``row`` owns cache rows ``[row * beams, (row + 1) *
    beams)``, and its one prefilled row is repeated over them (every beam
    of a fresh slot starts from the same prompt cache).  Only as many
    layers as ``cache`` holds are copied: a draft cache takes the first
    layers of the target's prefill.  ``held`` (``(positions, rows)``, on
    a serving mesh's data rank): ``cache`` holds only the rank's slots, so
    just the prefilled rows at ``positions`` are copied, into its own
    slot rows ``rows`` (:meth:`ContinuousBatcher._held`)."""
    span = slice(prefix_len, prefix_len + prompt_len)
    if held is not None:
        positions, rows = held
        rows_cache = {"layers": [
            {name: buf[positions] for name, buf in layer.items()}
            for layer in rows_cache["layers"]]}
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
    held=None,
) -> torch.Tensor:
    """Batched admission: prefill ``prompts`` (``[M, P]``, right-padded,
    real lengths ``lengths``) as one batch in the cache ``layout``, copy
    them into slot ``rows`` of ``cache``, and fold each row's length (past
    the ``prefix_len`` shared prefix tokens), pending token (``current``),
    ``done`` (set where the first token is ``eos_id``) and ``remaining``
    (``budget - 1``: the first token spends one) into the state, all in
    place.  ``budgets`` (``[M]``) replaces ``budget - 1`` with each row's
    own remaining budget: the resume insert's rows are mid-request.
    ``held``: the rows a mesh's data rank holds
    (:func:`_splice_rows_layers`).  Returns the first tokens ``[M]``,
    still on the device."""
    logits, rows_cache = _rows_prefill(params, prompts, lengths, config,
                                       attention_fn, layout, prefix_cache)
    _splice_rows_layers(cache, rows_cache, rows, prefix_len,
                        prompts.shape[1], held=held)
    cache["length"][rows] = prefix_len + lengths
    firsts = _pick(logits, key, temperature, top_k, top_p)
    current[rows] = firsts
    done[rows] = firsts == eos_id if eos_id is not None else False
    remaining[rows] = budgets if budgets is not None else budget - 1
    return firsts


def _insert_rows_pooled_impl(
    params: dict,
    cache: dict,
    current: torch.Tensor,
    done: torch.Tensor,
    remaining: torch.Tensor,
    rows: torch.Tensor,
    prompts: torch.Tensor,
    lengths: torch.Tensor,
    key: torch.Generator | None,
    entry_idx: torch.Tensor,
    pool_layers: list,
    config,
    budget: int,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    eos_id: int | None = None,
    *,
    layout: CacheLayout,
    pool_prefix_len: int,
    held=None,
) -> torch.Tensor:
    """:func:`_insert_rows_impl` for the per-tenant prefix pool: each row's
    prefix is gathered from the pool's stacked rows by ``entry_idx``
    (``[M]``) instead of prefilled again (the prefix's forward was paid
    once, at the pool's install), the suffix ``prompts`` run one chunk
    decode continuing from the gathered prefixes (no kernel launch, as in
    the reference), and prefix and suffix positions ``[0, pool_prefix_len
    + P)`` are copied into the slot rows.  Lengths, pending tokens and
    liveness fold in as the plain insert folds them, in place, with
    scalars filled on the device: one dispatch, no host wait.  Returns
    the first tokens ``[M]``, still on the device."""
    n_rows = rows.shape[0]
    prefix_rows = {
        "layers": [{name: buf[entry_idx] for name, buf in layer.items()}
                   for layer in pool_layers],
        "length": torch.full((n_rows,), pool_prefix_len, dtype=torch.long,
                             device=prompts.device),
    }
    logits_all, rows_cache = layout.chunk_decode(params, prefix_rows,
                                                 prompts, config)
    logits = logits_all[torch.arange(n_rows, device=prompts.device),
                        lengths - 1]
    _splice_rows_layers(cache, rows_cache, rows, 0,
                        pool_prefix_len + prompts.shape[1], held=held)
    cache["length"].index_copy_(0, rows, pool_prefix_len + lengths)
    firsts = _pick(logits, key, temperature, top_k, top_p)
    current.index_copy_(0, rows, firsts)
    if eos_id is not None:
        done.index_copy_(0, rows, firsts == eos_id)
    else:
        done.index_fill_(0, rows, False)
    remaining.index_fill_(0, rows, budget - 1)
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
    held=None,
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
                            prompt.shape[1], held=held)
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
    held=None,
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
                        beams=beams, held=held)
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
    # multi-tenant serving: the admitting tenant ("" = tenancy off, no
    # per-tenant attribution) and the request's queue arrival (epoch
    # seconds from its SentTimestamp): per-tenant TTFT counts from
    # arrival, because the queue and staging wait is where a flooding
    # tenant starves the others
    tenant: str = ""
    arrived_at: float | None = None
    # overload tier 1 cut the budget below generate_tokens: the device row
    # outlives the host's completion, so _finish_ready quiesces it
    degraded: bool = False
    # decode-phase deadline (tenancy.decode_slo_s > 0), armed at the first
    # produced token; None = unarmed
    decode_deadline_at: float | None = None


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
    (kept tokens / dispatched block positions of busy slots; a single
    step adds its tokens and no capacity), and
    ``overlapped_settles`` / ``block_settles`` (settles at which the block
    dispatched that cycle was still running).

    ``draft_layers`` > 0 makes the slots speculative (the first
    ``draft_layers`` layers draft ``draft_tokens`` proposals a round;
    counters ``spec_rounds``, ``spec_accepted``, ``spec_second_rounds``
    and ``spec_overlapped``, the second rounds still running when the
    first was read; :meth:`set_speculative`), ``beams`` > 1 makes each
    slot a beam search (``length_penalty`` ranks the finished beams).

    ``tenancy`` (plain decode path only) turns on per-tenant attribution
    (``tenant_tokens``, ``tenant_ttft`` and its sums and counts) and, with
    ``tenancy.prefix_pool > 0``, the per-tenant :attr:`prefix_pool` and its
    pooled insert (:meth:`submit_many_prefixed`); the pool and a global
    ``prefix_cache`` are mutually exclusive.

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
        if tenancy is not None and (beams > 1 or draft_layers):
            raise ValueError(
                "tenancy applies to the plain continuous decode path "
                "(not beams / speculative slots)"
            )
        model_family = family_of(config, family)
        if mesh is not None:
            # mesh-sharded slots: the cache rows over "data", heads over
            # "model" (the reference's cache_shardings); the insert prefill
            # runs on every data rank, as the reference's replicates over
            # data, and each rank writes the rows it holds
            from .decode import prefix_cache_shardings, require_serving_mesh

            require_serving_mesh(mesh)
            if batch_size % mesh.shape["data"]:
                raise ValueError(
                    f"batch_size {batch_size} not divisible by the "
                    f"mesh's data axis ({mesh.shape['data']})"
                )
            if prefix_cache is not None:
                _check_prefix_layout(prefix_cache, quantized_kv)
                prefix_cache = prefix_cache_shardings(mesh, prefix_cache)
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
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(
            device)
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
        # the layout of the steps over every slot row (decode steps,
        # blocks, speculative rounds); on a mesh the admissions' layout
        # runs the rank's heads on every data rank, the steps' its rows
        self._round_layout = self._layout
        if mesh is not None:
            from .family import rank_layout, split_rows_layout
            from .train import tensor_parallel

            self._layout = rank_layout(self._layout, tensor_parallel(mesh))
            self._round_layout = split_rows_layout(self._layout, mesh)
        self._step_fn = self._round_layout.decode_step
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
        # (tenant or None, seconds) TTFT samples not yet in a metrics
        # registry's histograms (drain_ttft_histograms); None is
        # engine-wide.  Bounded, so a batcher nobody drains cannot grow
        self._pending_ttft_obs: deque[tuple[str | None, float]] = deque(
            maxlen=16384)
        # multi-tenant attribution (tenancy only): kept tokens, recent
        # TTFT samples and cumulative TTFT sums and counts per tenant,
        # label-bounded by bounded_tenant_key
        self.tenancy = tenancy
        self.tenant_tokens: dict[str, int] = {}
        self.tenant_ttft: dict[str, deque] = {}
        self.tenant_ttft_sum: dict[str, float] = {}
        self.tenant_ttft_count: dict[str, int] = {}
        # the epoch clock of arrival-based per-tenant TTFT; the worker
        # rebinds it to its request-TTL clock, so a FakeClock episode and
        # the queue's SentTimestamps share one time base
        self._epoch_now = time.time
        # tenant -> home shard (the sticky router's map on the sharded
        # plane; carried as admission state here)
        self._tenant_home: OrderedDict = OrderedDict()
        # rows quiesced mid-budget (a degraded slot finished before its
        # device budget ran out): kept out of admission until the block in
        # flight at the quiesce settles, since that block still computed
        # them live.  Empty unless the overload ladder degrades.
        self._tainted: set[int] = set()
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
        # the plain slots' work: rows admitted by batched inserts, their
        # real prompt tokens and the tokens of the bucket they padded to;
        # decode steps dispatched (decode_block a block, 1 a single step)
        # and the slot rows stepped, busy or not, counted when the step
        # settles as block_tokens is (a single step adds its tokens there)
        self.insert_rows = 0
        self.insert_prompt_tokens = 0
        self.insert_padded_tokens = 0
        self.decode_steps = 0
        self.decode_row_steps = 0
        # phase spans (a utils.profiling.SpanTimer): None = off = one
        # attribute test a site; the worker's attach_spans wires it
        self.spans = None
        # request-lifecycle tracing (obs/lifecycle.py): None = off = the
        # engine path byte for byte; the worker's attach_lifecycle wires it
        self.lifecycle = None
        # scheduled collectives (comms.CollectiveScheduler): None = off =
        # the engine byte for byte, odometers included; attach_comms wires
        # it.  With comms on, the settle pulls are scheduled inside the
        # dispatch-ahead window, and a settle that consumes a pull started
        # there is not counted as a blocking host transfer
        self.comms = None
        # the settle-pull ops covering deferred first tokens, keyed by
        # id() of the entry (alive in _pending_firsts until the settle
        # pops both), and the op covering the block in flight
        self._first_ops: dict[int, Any] = {}
        self._block_op = None
        # deferred first tokens: (host copy, slot rows), read at the next
        # step()
        self._pending_firsts: list[tuple[_HostCopy, list[int]]] = []
        # the block in flight: (host copy of tokens and counts, busy slots
        # when it was dispatched)
        self._pending_block: tuple[_HostCopy, int] | None = None
        self.slots = [_Slot() for _ in range(batch_size)]
        # a beam slot owns `beams` contiguous cache rows
        cache_rows = batch_size * beams
        # the slots whose cache rows this rank holds: on a mesh's data
        # axis its own (whole beam slots, as batch_size % data == 0); None
        # = every slot
        self._held_slots = None
        if mesh is not None and mesh.shape["data"] > 1:
            from .decode import rank_rows

            self._held_slots = rank_rows(mesh, batch_size)
        with torch.inference_mode():
            if prefix_cache is not None:
                # every slot row starts as a copy of the shared prefix
                self.cache = self._held_cache(
                    lambda n: broadcast_prefix(prefix_cache, n), cache_rows)
            else:
                self.cache = self._held_cache(
                    lambda n: self._layout.init_cache(config, n,
                                                      self.device),
                    cache_rows)
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
                    draft_prefix = draft_prefix_from_target(prefix_cache,
                                                            draft_layers)
                    self.draft_cache = self._held_cache(
                        lambda n: broadcast_prefix(draft_prefix, n),
                        batch_size)
                else:
                    self.draft_cache = self._held_cache(
                        lambda n: self._layout.init_cache(
                            self.draft_config, n, self.device),
                        batch_size)
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
                self._beam_gather = RowGather(
                    self.cache, held=self._held_cache_rows(beams))
        # one generator per engine step and insert; greedy needs none
        self._keys = (
            sampling_keys(sample_seed, self.device) if temperature > 0.0
            else itertools.repeat(None)
        )
        self._prefix_pool = None
        self._pool_prefix_len = 0
        if tenancy is not None and tenancy.prefix_pool > 0:
            self._build_prefix_pool(tenancy, prefix_cache, prompt_len,
                                    generate_tokens, batch_size)

    def _build_prefix_pool(self, tenancy, prefix_cache, prompt_len: int,
                           generate_tokens: int, batch_size: int) -> None:
        """The per-tenant prefix pool, with the reference's checks."""
        from .tenancy import PrefixPool

        if prefix_cache is not None:
            raise ValueError(
                "the per-tenant prefix pool and the single global "
                "prefix_cache are mutually exclusive (the pool IS "
                "the generalization of the broadcast prefix)"
            )
        if self.mesh is not None:
            # the pool's rows hold the rank's heads over "model"
            kv_heads = (self.config.n_kv_heads if self.family == "llama"
                        else self.config.n_heads)
            model_axis = self.mesh.shape["model"]
            if kv_heads % model_axis:
                raise ValueError(
                    f"prefix pool KV heads ({kv_heads}) not "
                    f"divisible by the mesh's model axis "
                    f"({model_axis}) — the pooled gather shards "
                    "heads over 'model'"
                )
        if tenancy.prefix_len < 1:
            raise ValueError(
                "tenancy.prefix_len must be >= 1 when prefix_pool "
                "is enabled (the pool's static prefix bucket)"
            )
        pooled_budget = tenancy.prefix_len + prompt_len + generate_tokens
        if pooled_budget > self.config.max_seq_len:
            raise ValueError(
                f"pool prefix_len + prompt_len + generate_tokens = "
                f"{pooled_budget} exceeds max_seq_len="
                f"{self.config.max_seq_len}"
            )
        shard_slots = getattr(self, "shard_slots", batch_size)
        if tenancy.prefix_pool < shard_slots:
            # one refill can admit shard_slots distinct prefixes; with
            # entries >= shard_slots every entry of the same batch sits at
            # the LRU's recent end when the next install picks a victim, so
            # an install never overwrites a row that an earlier request of
            # the same insert is about to gather
            raise ValueError(
                f"prefix_pool={tenancy.prefix_pool} must be >= the "
                f"per-shard slot count ({shard_slots}) so a single "
                "admission batch can never LRU-evict an entry "
                "another row of the same batch still references"
            )
        self._pool_prefix_len = tenancy.prefix_len
        self._prefix_pool = PrefixPool(
            self.params, self.config, entries=tenancy.prefix_pool,
            prefix_len=tenancy.prefix_len,
            shards=getattr(self, "shards", 1), family=self.family,
            quantized_kv=self.quantized_kv, device=self.device,
            mesh=self.mesh,
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
        # each replica keeps its own prefix pool rows and LRU
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
        self._round_layout = source._round_layout
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
            self._pool_prefix_len, self.decode_block, self.draft_layers,
            self.draft_tokens, self.beams, self.length_penalty,
            str(self.device),
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

    # -- scheduled collectives (comms/): the engine's transfer seam --------

    def attach_comms(self, comms) -> None:
        """Wire a :class:`~..comms.CollectiveScheduler` (None detaches).
        With one attached, the block and gang steps flush the queued
        settle pulls inside their dispatch-ahead window and the prefix
        pool records its installs; detached, every path is the engine as
        it was, odometers included."""
        self.comms = comms
        if self._prefix_pool is not None:
            self._prefix_pool.comms = comms

    def _comms_flush(self, firsts: list, block, *, overlapped: bool) -> None:
        """Submit every deferred first-token entry of ``firsts`` not yet
        scheduled, and the ``block`` in flight, as settle-pull ops, then
        flush the comms queue.  Called right after the next block's
        dispatch (``overlapped``: a block is on the device to hide
        behind).  The pulls start nothing new on the card: each result's
        host copy was issued when it was produced, and the op's finish
        waits on it.  No synchronizing call."""
        comms = self.comms
        if comms is None or not comms.enabled:
            return
        for entry, rows in firsts:
            if id(entry) in self._first_ops:
                continue
            payload, wait = self._first_pull(entry)
            rids = [_trace_key(self.slots[row].payload) for row in rows]
            op = comms.settle_pull(
                payload, wait=wait, destination="host",
                source=self._comms_source(rows),
                rids=[r for r in rids if r is not None],
                args={"rows": list(rows)},
            )
            if op is not None:
                self._first_ops[id(entry)] = op
        if self._block_op is None and block is not None:
            payload, wait = self._block_pull(block)
            rids = [_trace_key(slot.payload)
                    for slot in self.slots if slot.busy]
            self._block_op = comms.settle_pull(
                payload, wait=wait, destination="host",
                source=self._comms_source(None),
                rids=[r for r in rids if r is not None],
                args={"block": True},
            )
        comms.flush(overlapped=overlapped)

    def _first_pull(self, entry) -> tuple:
        """A deferred first-token entry as ``(payload, wait)`` for its
        settle pull: here the entry is its host copy."""
        return entry.host, entry.wait

    def _block_pull(self, block) -> tuple:
        """The block in flight as ``(payload, wait)``: its tokens and
        counts, on their way to the host in one copy."""
        copy, _ = block
        return copy.host, copy.wait

    def _comms_source(self, rows) -> str:
        """The routing endpoint a settle pull leaves from: one device
        here (the sharded plane names a single shard's rows)."""
        return "device"

    def _row_kv_nbytes(self) -> int:
        """One cache row's KV bytes across every layer: the size of a
        per-row KV move (evacuation, handoff) for the comms accounting.
        Metadata only."""
        total = 0
        for layer in self.cache["layers"]:
            for buf in layer.values():
                total += (buf.numel() * buf.element_size()
                          // max(1, buf.shape[0]))
        return total

    def _invalidate_admission_cache(self) -> None:
        """Called at every change of which rows may be admitted (slot
        assignment and release, mask and probe flips, the slot limit): the
        sharded plane memoizes its availability scan; a no-op here, where
        ``free_slots`` is an uncached scan."""

    @property
    def free_slots(self) -> list[int]:
        self.free_slot_scans += 1
        rows = [i for i, s in enumerate(self.slots)
                if not s.busy and i not in self._tainted]
        if self.slot_limit is not None:
            busy = len(self.slots) - len(rows)
            rows = rows[: max(0, self.slot_limit - busy)]
        return rows

    def _free_slot_count(self) -> int:
        """Admission capacity as a bare count (what a refill sizes its
        receive by)."""
        return len(self.free_slots)

    def _quiesce_rows(self, rows: list[int]) -> None:
        """Freeze the device state of host-finished rows whose device
        budget has not run out (a degraded completion): mark them done
        with no budget left, so the next dispatched block skips them, and
        keep them out of admission until the block already in flight
        settles (its tokens for these rows were computed live and must
        land on free slots, never in a new request).  One small fill on
        the stream, on cycles where a degraded slot finished."""
        if not rows:
            return
        self._invalidate_admission_cache()
        with torch.inference_mode():
            idx = _to_device(np.asarray(rows), self.device)
            self._done.index_fill_(0, idx, True)
            self._remaining.index_fill_(0, idx, 0)
        if self._pending_block is not None:
            # the single-step engine reads every token in the cycle it
            # dispatches it, so its quiesced rows are free at once
            self._tainted.update(rows)

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
        slot's search or draft state), as in the reference.  Recorded as
        the ``insert`` span, with ``insert.stage`` (padding, stacking,
        uploads) and ``insert.launch`` inside it on the plain path."""
        if not requests:
            return []
        spans = self.spans
        if spans is None:
            return self._submit_many(requests)
        with spans.span("insert"):
            return self._submit_many(requests)

    def _submit_many(self, requests: list[tuple[Any, Any]]) -> list[int]:
        free = self.free_slots
        if len(requests) > len(free):
            raise RuntimeError(
                f"no free slot for {len(requests)} request(s) "
                f"({len(free)} free); call step() until slots open"
            )
        rows = free[: len(requests)]
        now = time.perf_counter()
        if self.lifecycle is not None:
            for _, payload in requests:
                self.lifecycle.stamp(_trace_key(payload), "prefill")
        if self.beams > 1 or self.draft_layers:
            for row, (token_ids, payload) in zip(rows, requests):
                self._submit_one(row, token_ids, payload, now)
            return rows
        spans = self.spans
        stage = spans.begin("insert.stage") if spans is not None else None
        padded = [self._pad_prompt(ids) for ids, _ in requests]
        prompts = np.stack([ids for ids, _ in padded])
        lengths = np.asarray([n for _, n in padded], np.int64)
        with torch.inference_mode():
            rows_dev = _to_device(np.asarray(rows), self.device)
            prompts_dev = _to_device(prompts, self.device)
            lengths_dev = _to_device(lengths, self.device)
            if spans is not None:
                spans.end(stage)
                launch = spans.begin("insert.launch")
            firsts = self._insert_many(
                self.params, self.cache, self._current, self._done,
                self._remaining, rows_dev, prompts_dev, lengths_dev,
                next(self._keys), self.config, self.generate_tokens,
                self._attention_fn, self.temperature, self.top_k,
                self.top_p, self.eos_id, held=self._held(rows),
                **self._insert_layout(),
            )
            self._defer_firsts(firsts, rows)
            if spans is not None:
                spans.end(launch)
        self.insert_dispatches += 1
        self.insert_rows += len(rows)
        self.insert_prompt_tokens += int(lengths.sum())
        self.insert_padded_tokens += len(rows) * self.prompt_len
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
                    held=self._held([row]), **self._insert_layout(),
                )
            else:
                first = _spec_insert_row_impl(
                    self.params, self.cache, self.draft_cache, self._current,
                    _to_device(np.asarray([row]), self.device), prompt,
                    lengths, next(self._keys), self.config,
                    self._attention_fn, self.temperature, self.top_k,
                    self.top_p, held=self._held([row]),
                    **self._insert_layout(),
                )
                self._defer_firsts(first, [row])
        self.insert_dispatches += 1
        self.slots[row] = _Slot(busy=True, budget=self.generate_tokens,
                                payload=payload, submitted_at=now)
        self._invalidate_admission_cache()

    @property
    def prefix_pool(self):
        """The per-tenant :class:`~.tenancy.PrefixPool` (None when tenancy
        is off or ``prefix_pool == 0``)."""
        return self._prefix_pool

    def export_tenant_homes(self) -> dict:
        """Sticky-home assignments as durable state; see
        :func:`~.tenancy.export_tenant_homes`."""
        from .tenancy import export_tenant_homes

        return export_tenant_homes(self._tenant_home)

    def import_tenant_homes(self, state: dict) -> int:
        from .tenancy import import_tenant_homes

        return import_tenant_homes(
            self._tenant_home, state, shards=getattr(self, "shards", 1)
        )

    def _route_prefixed(self, keys: list) -> list[int]:
        """Rows for a prefixed admission batch, one per pool key: the
        single plane admits in :attr:`free_slots` order, as
        :meth:`submit_many` does."""
        return self.free_slots[: len(keys)]

    def _pool_shard_of(self, row: int) -> int:
        """The pool partition a slot row draws prefix entries from."""
        return 0

    def submit_many_prefixed(
        self, requests: list[tuple[str, np.ndarray, np.ndarray, Any]]
    ) -> list[int]:
        """Admit ``(tenant, prefix_ids, token_ids, payload)`` requests
        through the per-tenant prefix pool; returns their slot rows.

        Each row's prefix entry is acquired first (an LRU hit, or a
        one-time install prefill on a miss), then the whole batch admits
        as one pooled insert (:func:`_insert_rows_pooled_impl`): the rows'
        prefixes gathered from the pool on the device and one suffix
        chunk forward, so a hit never prefills its prefix again.  No host
        wait; the first tokens settle with the next :meth:`step`."""
        from .tenancy import prefix_pool_key

        if self._prefix_pool is None:
            raise ValueError(
                "submit_many_prefixed needs tenancy with prefix_pool > 0"
            )
        if not requests:
            return []
        free = self._free_slot_count()
        if len(requests) > free:
            raise RuntimeError(
                f"no free slot for {len(requests)} request(s) "
                f"({free} free); call step() until slots open"
            )
        keys = [prefix_pool_key(tenant, prefix_ids)
                for tenant, prefix_ids, _, _ in requests]
        rows = self._route_prefixed(keys)
        entry_idx = [
            self._prefix_pool.acquire(self._pool_shard_of(row), key,
                                      prefix_ids)
            for row, key, (_, prefix_ids, _, _) in zip(rows, keys, requests)
        ]
        now = time.perf_counter()
        if self.lifecycle is not None:
            for tenant, _, _, payload in requests:
                self.lifecycle.stamp(_trace_key(payload), "prefill",
                                     tenant=tenant)
        padded = [self._pad_prompt(ids) for _, _, ids, _ in requests]
        prompts = np.stack([ids for ids, _ in padded])
        lengths = np.asarray([n for _, n in padded], np.int64)
        with torch.inference_mode():
            firsts = _insert_rows_pooled_impl(
                self.params, self.cache, self._current, self._done,
                self._remaining, _to_device(np.asarray(rows), self.device),
                _to_device(prompts, self.device),
                _to_device(lengths, self.device), next(self._keys),
                _to_device(np.asarray(entry_idx, np.int64), self.device),
                self._prefix_pool.layers, self.config, self.generate_tokens,
                self.temperature, self.top_k, self.top_p, self.eos_id,
                layout=self._layout, pool_prefix_len=self._pool_prefix_len,
                held=self._held(rows),
            )
            self._defer_firsts(firsts, rows)
        self.insert_dispatches += 1
        for row, (tenant, _, _, payload) in zip(rows, requests):
            self.slots[row] = _Slot(
                busy=True, budget=self.generate_tokens, payload=payload,
                submitted_at=now, tenant=tenant,
            )
        self._invalidate_admission_cache()
        return rows

    def tag_tenant(self, rows: list[int], tenants: list[str]) -> None:
        """Label freshly admitted slots with their tenants (the pool-less
        tenancy path: plain :meth:`submit_many` admission, per-tenant
        attribution still on)."""
        for row, tenant in zip(rows, tenants):
            self.slots[row].tenant = tenant

    def _insert_layout(self) -> dict:
        """The insert's cache-layout keywords: the layout and the shared
        prefix the slots start past."""
        return dict(layout=self._layout, prefix_cache=self._prefix_cache,
                    prefix_len=self.prefix_len)

    def _held_cache_rows(self, width: int) -> slice | None:
        """The cache rows this rank holds, of slots ``width`` rows wide
        (None: every row)."""
        held = self._held_slots
        if held is None:
            return None
        return slice(held.start * width, held.stop * width)

    def _held_cache(self, make, rows: int) -> dict:
        """A cache of ``rows`` slot rows from ``make(n)`` (a cache of
        ``n`` rows): on a mesh's data rank its layers hold the rank's rows
        alone, its lengths every row's (the steps advance the rank's and
        gather them, :func:`.family.split_rows`)."""
        held = self._held_cache_rows(rows // len(self.slots))
        if held is None:
            return make(rows)
        cache = make(held.stop - held.start)
        cache["length"] = cache["length"][0].expand(rows).clone()
        return cache

    def _held(self, rows: list[int]):
        """An admission's ``held`` (:func:`_splice_rows_layers`) for slot
        ``rows``: the positions of the rows this rank holds and their
        rows in its cache, on the device; None when it holds every
        row."""
        held = self._held_slots
        if held is None:
            return None
        positions = [i for i, row in enumerate(rows)
                     if held.start <= row < held.stop]
        local = [rows[i] - held.start for i in positions]
        return (_to_device(np.asarray(positions, np.int64), self.device),
                _to_device(np.asarray(local, np.int64), self.device))

    def _defer_firsts(self, firsts: torch.Tensor, rows: list[int]) -> None:
        """Hold an insert's first tokens until the next :meth:`step`: here
        each insert's are copied to the host at once, behind their own
        event (the sharded plane copies a cycle's together), tagged with
        the launch span open around it when spans are recorded."""
        copy = _HostCopy(firsts)
        if self.spans is not None:
            copy.span = self.spans.current()
        self._pending_firsts.append((copy, list(rows)))

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
                held=self._held(rows), **self._insert_layout(),
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
            if self.lifecycle is not None:
                # the evacuation -> resume seam: the trace keeps its first
                # life's stamps, a resume only annotates
                self.lifecycle.note(_trace_key(payload), "resumed")
        self._invalidate_admission_cache()
        return rows

    def _emit(self, slot: _Slot, token: int) -> None:
        """Append one kept token to a slot: the one place the eos check
        and the emitted-token count live."""
        slot.produced.append(token)
        self.tokens_emitted += 1
        if slot.tenant:
            tenant = bounded_tenant_key(slot.tenant, self.tenant_tokens)
            self.tenant_tokens[tenant] = self.tenant_tokens.get(tenant, 0) + 1
        if self.lifecycle is not None:
            # the host time of a token already in hand: no device read
            self.lifecycle.token(_trace_key(slot.payload))
        if self.eos_id is not None and token == self.eos_id:
            slot.done = True

    def _settle_pending_firsts(self) -> None:
        """Emit the deferred first tokens and record time to first token;
        counts one host transfer per insert read, as the reference does.
        With comms attached, an insert whose settle pull was already
        scheduled in the dispatch-ahead window is not a blocking
        transfer: its finish waits on the copy and closes the op."""
        if not self._pending_firsts:
            return
        pending, self._pending_firsts = self._pending_firsts, []
        comms = self.comms
        blocking = 0
        for copy, _ in pending:
            op = self._first_ops.pop(id(copy), None)
            if comms is not None and op is not None and op.dispatched:
                comms.finish(op)
            else:
                blocking += 1
        self.host_transfers += blocking
        spans = self.spans
        host = []
        for copy, rows in pending:
            wait = (spans.begin("wait.first", copy.span)
                    if spans is not None else None)
            host.append((copy.wait()[0], rows))
            if wait is not None:
                spans.end(wait)
        self._record_firsts(host)

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
        if self.lifecycle is not None:
            # the token is host-resident here: the stamp reads no device
            self.lifecycle.stamp(_trace_key(slot.payload), "first_token",
                                 tenant=slot.tenant or None)
        self.ttft_sum += ttft
        self.ttft_count += 1
        self._pending_ttft_obs.append((None, ttft))
        if slot.tenant:
            self._record_tenant_ttft(slot, ttft)
        self._note_ttft(row, ttft)

    def _record_tenant_ttft(self, slot: _Slot, ttft: float) -> None:
        """A tenant slot's TTFT sample: from its queue arrival where the
        queue stamped one, else from admission."""
        tenant = bounded_tenant_key(slot.tenant, self.tenant_ttft)
        samples = self.tenant_ttft.get(tenant)
        if samples is None:
            samples = self.tenant_ttft[tenant] = deque(maxlen=1024)
        sample = (max(0.0, self._epoch_now() - slot.arrived_at)
                  if slot.arrived_at is not None else ttft)
        samples.append(sample)
        self.tenant_ttft_sum[tenant] = (
            self.tenant_ttft_sum.get(tenant, 0.0) + sample)
        self.tenant_ttft_count[tenant] = (
            self.tenant_ttft_count.get(tenant, 0) + 1)
        self._pending_ttft_obs.append((tenant, sample))

    def _note_ttft(self, row: int, ttft: float) -> None:
        """Per-row TTFT hook: the sharded plane files it by shard."""

    def _needs_decode(self, slot: _Slot) -> bool:
        return slot.busy and not slot.done and len(slot.produced) < slot.budget

    def _finish_ready(self) -> list[tuple[Any, np.ndarray]]:
        """Free every slot whose request completed; returns the finished
        ``(payload, tokens)`` pairs, eos-padded to the budget like
        ``generate``."""
        finished, quiesce = [], []
        for row, slot in enumerate(self.slots):
            if slot.busy and (slot.done or len(slot.produced) >= slot.budget):
                tokens = slot.produced
                if len(tokens) < slot.budget:
                    tokens = tokens + [self.eos_id] * (
                        slot.budget - len(tokens)
                    )
                if slot.degraded and not slot.done:
                    # finished at a degraded budget, not at eos: the
                    # device row still has budget left
                    quiesce.append(row)
                if self.lifecycle is not None:
                    self.lifecycle.stamp(_trace_key(slot.payload),
                                         "completed")
                finished.append((slot.payload, np.asarray(tokens, np.int32)))
                self.slots[row] = _Slot()
        if finished:
            self._invalidate_admission_cache()
        if quiesce:
            self._quiesce_rows(quiesce)
        return finished

    def step(self) -> list[tuple[Any, np.ndarray]]:
        """Advance every busy slot (one token, or up to ``decode_block``
        per dispatch); returns the finished requests as ``(payload,
        continuation_tokens)`` pairs, whose slots are free again.  A no-op
        when nothing is busy and no quiesced row waits for its block.
        Recorded as the ``step`` span; the plain engines record
        ``block.launch``, ``wait.first`` / ``wait.block`` and ``emit``
        inside it (a single step is a block of one)."""
        if self.active == 0 and not self._tainted:
            return []
        spans = self.spans
        if spans is None:
            return self._step()
        with spans.span("step"):
            return self._step()

    def _step(self) -> list[tuple[Any, np.ndarray]]:
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
        spans = self.spans
        # rows whose budget is one token (or that hit eos) need no step
        needs = [self._needs_decode(s) for s in self.slots]
        nxt_host = None
        if any(needs):
            launch = spans.begin("block.launch") if spans is not None \
                else None
            with torch.inference_mode():
                logits, self.cache = self._decode(
                    self.params, self.cache, self._current, self.config
                )
                nxt = _pick(logits, next(self._keys), self.temperature,
                            self.top_k, self.top_p)
                copy = _HostCopy(nxt)
            self.decode_dispatches += 1
            self.decode_steps += 1
            self.decode_row_steps += len(self.slots)
            self.block_tokens += sum(needs)
            if launch is not None:
                copy.span = launch[0]
                spans.end(launch)
            wait = (spans.begin("wait.block", copy.span)
                    if spans is not None else None)
            nxt_host = copy.wait()[0]
            if wait is not None:
                spans.end(wait)
            self.host_transfers += 1
        emit = spans.begin("emit") if spans is not None else None
        if nxt_host is not None:
            for row, slot in enumerate(self.slots):
                if needs[row]:
                    self._emit(slot, int(nxt_host[row]))
            self._current = nxt
        finished = self._finish_ready()
        if emit is not None:
            spans.end(emit)
        return finished

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
        spans = self.spans
        new_block = None
        busy = self.active
        if busy and self._pending_decode_block is None:
            launch = spans.begin("block.launch") if spans is not None \
                else None
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
            self.decode_steps += self.decode_block
            if launch is not None:
                new_block[0].span = launch[0]
                spans.end(launch)
        if self.comms is not None:
            # the dispatch-ahead window: the block dispatched above (or
            # the one in flight) occupies the card while the pulls run
            self._comms_flush(
                self._pending_firsts, self._pending_block,
                overlapped=(new_block is not None
                            or self._pending_block is not None),
            )
        self._settle_pending_firsts()
        pending, self._pending_block = self._pending_block, new_block
        host = None
        if pending is not None:
            copy, dispatched_busy = pending
            block_op, self._block_op = self._block_op, None
            if (self.comms is not None and block_op is not None
                    and block_op.dispatched):
                # pulled inside the last window: not a blocking read
                self.comms.finish(block_op)
            else:
                self.host_transfers += 1
            wait = (spans.begin("wait.block", copy.span)
                    if spans is not None else None)
            host = copy.wait()
            if wait is not None:
                spans.end(wait)
        emit = spans.begin("emit") if spans is not None else None
        if host is not None:
            toks_host, counts_host = host
            self.block_capacity += self.decode_block * dispatched_busy
            self.block_tokens += int(counts_host.sum())
            # counted as it settles, beside the tokens it kept
            self.decode_row_steps += len(toks_host) * len(self.slots)
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
        # the one block that was in flight at the last quiesce has settled:
        # its quiesced rows may take requests again
        if self._tainted:
            self._invalidate_admission_cache()
            self._tainted.clear()
        if self._pending_block is None:
            self._apply_pending_decode_block()
        finished = self._finish_ready()
        if emit is not None:
            spans.end(emit)
        return finished


    def _dispatch_spec_round(self, mask: list[bool]) -> _HostCopy:
        """Launch one draft-and-verify round over the masked rows; returns
        the host copy of its ``(round_tokens, n)`` on its way."""
        with torch.inference_mode():
            active = _to_device(np.asarray(mask), self.device)
            self._current, round_tokens, n = speculative_round(
                self._round_layout, self._round_layout, self.params,
                self.draft_params, self.config, self.draft_config,
                self.cache, self.draft_cache,
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
    histograms of ``metrics``: the engine-wide ``ttft_seconds`` and the
    per-tenant ``tenant_time_to_first_token_seconds``.  A module function
    because two consumers drain on their own cadence: the worker's own
    :meth:`ContinuousWorker._update_metrics` and the fleet pool's, which
    drains every replica into one family (cumulative histograms merge
    across replicas, unlabeled gauges would not)."""
    pending = getattr(batcher, "_pending_ttft_obs", None)
    while pending:
        tenant, seconds = pending.popleft()
        if tenant is None:
            metrics.observe_histogram(
                "ttft_seconds", seconds,
                "Seconds from request admission to its first generated "
                "token being host-visible (cumulative histogram over the "
                "worker's lifetime).",
            )
        else:
            metrics.observe_histogram(
                "tenant_time_to_first_token_seconds", seconds,
                "Seconds from queue arrival (SentTimestamp when the queue "
                "stamps it, else admission) to the first generated token, "
                "per tenant: the cumulative-histogram form of the "
                "tenant_ttft_seconds gauge.",
                labels=(("tenant", tenant),),
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
    plane.

    ``tenancy`` (a :class:`~.tenancy.TenancyConfig`) stages received
    messages per tenant (:class:`~.tenancy.FairAdmission`, at most one
    engine-full a tenant and two in all unless the config says otherwise;
    overflow goes back to the queue at visibility 0) and picks each
    refill's admission batch by deficit round robin.  Bodies may carry the
    ``{"tenant", "prefix", "ids"}`` envelope: a prefix of the pool's
    length goes through the pool's insert, any other prefix is prepended
    to the prompt (or, if that no longer fits the prompt bucket, answered
    with an error).  Replies carry their tenant; ``completed_by_tenant``
    counts the answered ones.  ``shed_tiers`` arms the overload ladder
    (:meth:`_run_ladder`) and ``decode_slo_s`` the decode deadline
    (:meth:`_enforce_decode_deadlines`); ``shed_by_reason`` counts
    ``ttl``, ``degraded``, ``pressure`` and ``decode_deadline`` sheds.  A
    tenancy with one tenant and no prefixes serves as the plain path
    does.  A ``tokenizer`` (HF-shaped ``encode`` / ``decode``) encodes
    text bodies and adds the decoded ``text`` to each reply, as the batch
    worker's does."""

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
        tenancy=None,
        device: str | torch.device = "cuda",
        tokenizer=None,
        mesh=None,
    ) -> None:
        if service_config.generate_tokens < 1:
            raise ValueError(
                "ContinuousWorker is generate-mode serving; set "
                "ServiceConfig.generate_tokens >= 1"
            )
        if tenancy is not None and tenancy.prefix_pool > 0 \
                and tenancy.prefix_len < 1:
            # the pool's prefix bucket defaults to the prompt bucket
            tenancy = dataclasses.replace(
                tenancy, prefix_len=service_config.seq_len)
        self.tenancy = tenancy
        if service_config.result_queue_url and result_queue is None:
            # in-memory queues ignore urls, so defaulting replies onto the
            # input queue object would self-feed
            raise ValueError(
                "result_queue_url is set but no result_queue client was "
                "given"
            )
        now_fn = now_fn or time.time
        if mesh is not None:
            # every rank runs this worker: rank 0 owns the queue and the
            # clock the host's decisions read, and broadcasts both
            from .distributed import RankQueue, rank_clock

            queue = RankQueue(queue)
            if result_queue is not None:
                result_queue = RankQueue(result_queue)
            now_fn = rank_clock(now_fn)
        self.mesh = mesh
        self.queue = queue
        self.config = service_config
        self.result_queue = result_queue
        self.tokenizer = tokenizer
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
            tenancy=tenancy,
            device=device,
            mesh=mesh,
        )
        if sharded is None:
            sharded = service_config.shards > 1
        if draft_layers > 0 and (sharded or tenancy is not None):
            # speculative shards, and speculative slots behind tenant
            # staging, run on the decode plane: draft-and-verify rounds
            # over the whole [S*B] row axis, S = 1 for tenancy without
            # shards (the plain speculative engine has no tenant staging)
            from ..planes.engine import DecodePlaneBatcher

            plane_knobs = dict(knobs)
            plane_knobs.pop("draft_layers")
            plane_knobs.pop("draft_tokens")
            self.batcher = DecodePlaneBatcher(
                params, model_config, shards=service_config.shards,
                shard_slots=service_config.batch_size,
                spec_layers=draft_layers, spec_tokens=draft_tokens,
                **plane_knobs,
            )
        elif sharded:
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
        self._now = now_fn
        # per-tenant TTFT shares the TTL clock's epoch base
        self.batcher._epoch_now = self._now
        # requests shed by reason: ttl (older than request_ttl_s on
        # arrival or at its pick), degraded (overload tier 1 cut its
        # budget; answered short), pressure (tier 3 shed it from staging
        # with an error reply), decode_deadline (its decode phase blew the
        # per-token budget; shed mid-decode with an error reply)
        self.shed_by_reason = {
            "ttl": 0, "degraded": 0, "pressure": 0, "decode_deadline": 0,
        }
        # the fair-admission staging (tenancy only; None keeps _refill on
        # the plain path)
        self._fair = None
        self.ladder = None
        self._degrade_tenants: frozenset = frozenset()
        self._degraded_tokens = max(1, service_config.generate_tokens // 2)
        # answered completions per tenant (the fleet's duplicate path never
        # reaches the count; error replies are answered, not counted)
        self.completed_by_tenant: dict[str, int] = {}
        # every tenant label exported as a gauge series, bounded by
        # bounded_tenant_key and re-exported every cycle
        self._gauge_tenants: dict[str, bool] = {}
        if tenancy is not None:
            from .tenancy import FairAdmission, OverloadLadder

            total_slots = len(self.batcher.slots)
            fair_limits = dict(
                per_tenant_limit=(tenancy.staging_per_tenant
                                  or max(1, total_slots)),
                total_limit=(tenancy.staging_total
                             or max(2, 2 * total_slots)),
            )
            if tenancy.admission_shards > 1:
                # the sharded admission plane, each shard with its own
                # ladder (admission_shards=1 never imports the module)
                from .admission_shards import ShardedAdmission

                self._fair = ShardedAdmission(tenancy, **fair_limits)
            else:
                self._fair = FairAdmission(tenancy, **fair_limits)
                if tenancy.shed_tiers > 0:
                    self.ladder = OverloadLadder(tenancy.shed_tiers)
        self.timer = SpanTimer()
        # created eagerly, so a stop() before run_forever() still holds
        self._stop = threading.Event()
        self._running = False
        self._poll_backoff = 0
        # optional WorkloadMetrics registry (attach_metrics); the gauges
        # refresh once per engine cycle
        self.metrics = None
        self._served_since: float | None = None
        # optional request-lifecycle registry (attach_lifecycle); None =
        # tracing off = the serving path byte for byte
        self.lifecycle = None
        # optional phase-span recorder (attach_spans); None = off
        self.spans = None

    @property
    def shed(self) -> int:
        """Requests shed over the worker's lifetime, all reasons summed."""
        return sum(self.shed_by_reason.values())

    @property
    def staged(self) -> int:
        """Requests in fair-admission staging (0 with tenancy off):
        received, their receipt handles live, not yet admitted.  Idleness
        and drain decisions count them as in flight."""
        return self._fair.staged if self._fair is not None else 0

    def export_admission_state(self) -> dict:
        """The admission plane's accounting as durable state: the DRR and
        EDF accounting and flood classification, the overload ladder and
        the tenant-home map.  Staged messages are not saved: their receipt
        handles die with the process and the queue redelivers them."""
        state: dict = {"records": 0}
        if self._fair is not None:
            state["fair"] = self._fair.export_state()
            state["records"] += state["fair"].get("records", 0)
        if self.ladder is not None:
            state["ladder"] = self.ladder.export_state()
            state["records"] += state["ladder"].get("records", 0)
        homes = self.batcher.export_tenant_homes()
        if homes.get("records"):
            state["homes"] = homes
            state["records"] += homes["records"]
        return state

    def import_admission_state(
        self, state: dict, *, rebase: float = 0.0,
        now: "float | None" = None, max_age_s: float = 0.0,
    ) -> int:
        """Restore :meth:`export_admission_state`'s accounting; returns
        the records recovered."""
        recovered = 0
        fair = state.get("fair")
        if self._fair is not None and isinstance(fair, dict):
            recovered += self._fair.import_state(
                fair, rebase=rebase, now=now, max_age_s=max_age_s
            )
        ladder = state.get("ladder")
        if self.ladder is not None and isinstance(ladder, dict):
            recovered += self.ladder.import_state(ladder)
        homes = state.get("homes")
        if isinstance(homes, dict):
            recovered += self.batcher.import_tenant_homes(homes)
        return recovered

    def _settle(self, message: dict, tokens: np.ndarray | None, *,
                error: str | None = None, counted: bool = True) -> bool:
        """Reply (when configured), then delete one finished message.
        ``tokens=None`` answers with ``error`` (default "malformed body")
        instead of a result.  ``counted=False`` marks a settle that does
        not ride :meth:`run_once`'s completion count (TTL sheds and
        malformed drops); the fleet's override keys its duplicate
        accounting on it.  Returns whether this call answered the request
        (the fleet's override returns False for a duplicate it consumed).
        A tenant request's reply carries its tenant, and an answered one
        counts in ``completed_by_tenant``."""
        tenant = message.get("_tenant", "")
        if self.config.result_queue_url:
            if tokens is None:
                payload = {"error": error or "malformed body"}
            else:
                payload = build_token_reply(tokens, self.config.eos_id,
                                            self.tokenizer)
            payload["request_id"] = request_id(message)
            if tenant:
                payload["tenant"] = tenant
            # reply BEFORE deleting the input: a crash between the two
            # redelivers the input (duplicates possible, losses not)
            self.result_queue.send_message(
                self.config.result_queue_url, json.dumps(payload)
            )
        self.queue.delete_message(
            self.config.queue_url, message["ReceiptHandle"]
        )
        if tenant and tokens is not None:
            tenant = bounded_tenant_key(tenant, self.completed_by_tenant)
            self.completed_by_tenant[tenant] = (
                self.completed_by_tenant.get(tenant, 0) + 1)
        lc = self.lifecycle
        if lc is not None:
            # THE reply stamp: this call answered the request.  An error
            # settle may never have been admitted, so its arrival is
            # stamped here too (idempotent); the fleet's duplicate path
            # never reaches this line
            rid = request_id(message)
            lc.arrival(rid, sent=sent_epoch(message),
                       tenant=message.get("_tenant") or None)
            lc.settle(rid, error=((error or "malformed body")
                                  if tokens is None else None))
        return True

    def _note_shed(self, reason: str) -> None:
        self.shed_by_reason[reason] += 1

    def _refill(self) -> int:
        """Receive up to the free-slot count and prefill the messages in;
        returns the number received.  With tenancy the receive goes
        through the fair-admission staging instead (:meth:`_refill_tenant`)."""
        if self.tenancy is not None:
            return self._refill_tenant()
        self.refill_cycles += 1
        free = self.batcher._free_slot_count()
        if not free:
            return 0
        if self._poll_backoff > 0:
            self._poll_backoff -= 1
            return 0
        spans = self.spans
        receive = spans.begin("receive") if spans is not None else None
        messages = self.queue.receive_messages(
            self.config.queue_url, max_messages=free,
            wait_time_s=0 if self.batcher.active else
            self.config.receive_wait_s,
        )
        if receive is not None:
            spans.end(receive)
        if not messages and self.batcher.active:
            self._poll_backoff = self.POLL_BACKOFF_CYCLES
        self._admit(messages)
        return len(messages)

    def _refill_tenant(self) -> int:
        """The fair-admission refill: receive into bounded per-tenant
        staging, then pick this cycle's admission batch by deficit round
        robin (with the EDF jump) instead of arrival order.  The picked
        batch still admits as one insert a class (:meth:`_submit_parsed`):
        fairness is host bookkeeping.  Overflow past a tenant's staging
        cap goes back to the queue at visibility 0: backpressure, never
        loss."""
        self.refill_cycles += 1
        self._fair.note_cycle()  # decay the arrival-rate classifier
        free = self.batcher._free_slot_count()
        messages = []
        if self._poll_backoff > 0:
            self._poll_backoff -= 1
        elif self._fair.room > 0:
            messages = self.queue.receive_messages(
                self.config.queue_url, max_messages=self._fair.room,
                wait_time_s=0 if (self.batcher.active or self._fair.staged)
                else self.config.receive_wait_s,
            )
            if not messages and self.batcher.active:
                self._poll_backoff = self.POLL_BACKOFF_CYCLES
        nack = getattr(self.queue, "change_message_visibility", None)
        for message in messages:
            if self._shed_if_expired(message):
                continue
            parsed = self._parse_for_admit(message)
            if parsed is None:
                self._settle(message, None, counted=False)
                continue
            tenant = parsed[0]
            if self.lifecycle is not None:
                # arrival precedes the staged stamp, even where the queue
                # stamps no SentTimestamp (then it is the receive time)
                self.lifecycle.arrival(request_id(message),
                                       sent=sent_epoch(message),
                                       tenant=tenant)
            # the arrival-based TTFT deadline rides into staging for the
            # EDF jump (None: no SLO or no queue stamp, never jumps)
            deadline = self.tenancy.deadline_of(tenant, sent_epoch(message))
            if not self._fair.stage(tenant, parsed + (message,),
                                    deadline=deadline,
                                    message_id=request_id(message)):
                # the tenant's staging cap is the fairness backstop: hand
                # the message back now so other tenants' traffic is
                # received next cycle (a queue without visibility changes
                # stages it anyway)
                if nack is not None:
                    nack(self.config.queue_url, message["ReceiptHandle"], 0)
                    self._fair.overflow_total += 1
                else:
                    self._fair.drr.push(tenant, parsed + (message,),
                                        deadline=deadline)
            self._poll_backoff = 0  # staged work: keep the loop hot
        if self.ladder is not None:
            self._run_ladder()
        elif self.tenancy.shed_tiers > 0 and hasattr(self._fair, "shards"):
            self._run_shard_ladders()
        now = self._now()
        admit: list = []
        while len(admit) < free:
            picked = self._fair.pick(free - len(admit), now=now)
            if not picked:
                break
            shed_any = False
            for tenant, item in picked:
                # expired while staged: answered as an arrival-time shed
                # is, the pick's charge refunded (the request takes no
                # slot), and the freed room picked again
                if self._shed_if_expired(item[3]):
                    self._fair.drr.refund(tenant, item)
                    shed_any = True
                else:
                    if self.lifecycle is not None:
                        self.lifecycle.stamp(request_id(item[3]), "picked",
                                             tenant=tenant)
                    admit.append(item)
            if not shed_any:
                break
        if admit:
            self._submit_parsed(admit)
        return len(admit)

    def _overload_pressure(self) -> float:
        """The ladder's scalar pressure: the staged-backlog fraction gated
        by slot occupancy after the coming admission (free slots this
        cycle's pick is about to fill count as occupied).  A full staging
        area behind idle slots is a transient and a full engine with
        empty staging is steady load; overload is both at once."""
        slots = len(self.batcher.slots)
        if not slots:
            return 0.0
        staged = self._fair.staged
        free = slots - self.batcher.active
        occupancy = min(
            1.0, (self.batcher.active + min(staged, free)) / slots
        )
        staged_frac = min(1.0, staged / self._fair.total_limit)
        return staged_frac * occupancy

    def _run_ladder(self) -> None:
        """Measure pressure, advance the ladder and apply the active
        tier's actions: tier 1 marks the over-share tenants for degraded
        budgets at admission, tier 2 also evicts cold pool entries, tier 3
        also sheds their staged requests with error replies.  Once a
        tenant refill cycle, before the pick."""
        tier = self.ladder.update(self._overload_pressure())
        self._degrade_tenants = (
            self._fair.over_share() if tier >= 1 else frozenset()
        )
        pool = self.batcher.prefix_pool
        if tier >= 2 and pool is not None:
            pool.evict_cold(max(1, pool.entries // 2))
        if tier >= 3:
            target = int(
                self.ladder.exit_threshold(3) * self._fair.total_limit
            )
            self._shed_pressure(target, self._degrade_tenants)

    def _run_shard_ladders(self) -> None:
        """The sharded admission plane's ladder pass: each alive shard
        measures its own pressure (its staged fraction, gated by the
        engine's occupancy) and advances its own ladder, so one shard's
        flood engages tier actions for its tenants only.  The degrade set
        is the union over the shards, tier 3 sheds from the shard's own
        staging, and gossip then shares every flood classification."""
        fair = self._fair
        slots = len(self.batcher.slots)
        if not slots:
            return
        free = slots - self.batcher.active
        occupancy = min(
            1.0, (self.batcher.active + min(fair.staged, free)) / slots)
        degrade: set = set()
        pool = self.batcher.prefix_pool
        for shard in fair.shards:
            if not shard.alive or shard.ladder is None:
                continue
            staged_frac = min(1.0, shard.fair.staged / shard.fair.total_limit)
            tier = shard.ladder.update(staged_frac * occupancy)
            if tier < 1:
                continue
            flood = shard.fair.over_share()
            degrade |= set(flood)
            if tier >= 2 and pool is not None:
                pool.evict_cold(max(1, pool.entries // 2))
            if tier >= 3:
                target = int(shard.ladder.exit_threshold(3)
                             * shard.fair.total_limit)
                self._shed_pressure(target, flood, fair=shard.fair)
        fair.gossip()
        self._degrade_tenants = frozenset(degrade)

    def _shed_pressure(self, target: int, over_share, fair=None) -> None:
        """Tier 3: shed staged requests down to ``target``, only from
        tenants over their weight share (by sustained offered rate; a
        compliant tenant's requests are served late, never dropped).
        Best-effort (no-SLO) flooders lose their newest arrivals, the
        most over-share (staged depth / weight) first; an SLO tenant loses
        requests only in an unambiguous flood (``PREMIUM_FLOOD_FACTOR`` x
        the rate floor), and then only those already past deadline.  Every
        shed is an error reply through the normal settle.  ``fair`` scopes
        the shed to one admission shard's staging (default: the worker's
        whole staging)."""
        fair = fair if fair is not None else self._fair
        drr = fair.drr
        now = self._now()
        over = {t for t in over_share if drr.depth(t) > 0}
        best_effort = {t for t in over if self.tenancy.slo_of(t) <= 0}
        premium_bar = fair.PREMIUM_FLOOD_FACTOR * fair.OVER_SHARE_MIN_RATE
        premium_flood = {
            t for t in over - best_effort
            if fair.arrival_rate.get(t, 0.0) >= premium_bar
        }
        if not best_effort and not premium_flood:
            return  # uniform overload: everyone is compliant
        # one staged count and one depths snapshot, decremented as the
        # loops pop (no rescan a shed on an already overloaded cycle)
        staged = fair.staged
        while premium_flood and staged > target:
            popped = drr.pop_over_deadline(now, eligible=premium_flood)
            if popped is None:
                break
            staged -= 1
            self._shed_item(popped[1])
        depths = {
            t: d for t, d in drr.depths().items()
            if d > 0 and t in best_effort
        }
        while depths and staged > target:
            victim = max(
                depths,
                key=lambda t: (depths[t] / self.tenancy.weight_of(t), t),
            )
            item = drr.pop_tail(victim)
            if item is None:
                depths.pop(victim)
                continue
            staged -= 1
            depths[victim] -= 1
            if depths[victim] <= 0:
                depths.pop(victim)
            self._shed_item(item)

    def _shed_item(self, item) -> None:
        if self._settle(item[3], None,
                        error="shed under overload pressure",
                        counted=False):
            self._note_shed("pressure")

    def _parse_for_admit(self, message: dict):
        """One message -> ``(tenant, prefix_ids, ids)``: with tenancy its
        envelope (a plain body lands on the first configured tenant, with
        no prefix), else ``("", None, ids)``; ``None`` for a malformed
        body."""
        if self.tenancy is None:
            ids = parse_request_body(message["Body"], self.tokenizer)
            return None if ids is None else ("", None, ids)
        tenant, prefix_ids, ids = parse_tenant_request(
            message["Body"], default_tenant=self.tenancy.tenants[0],
            tokenizer=self.tokenizer,
        )
        if ids is None:
            return None
        message["_tenant"] = tenant
        return (tenant, prefix_ids, ids)

    def _submit_parsed(self, parsed: list[tuple]) -> int:
        """Admit ``(tenant, prefix_ids, ids, message)`` records: prefixes
        of the pool's length through the pooled insert, everything else
        through the plain insert, an off-bucket prefix prepended to its
        prompt (the same result, uncached).  At most one insert a class a
        cycle."""
        lc = self.lifecycle
        if lc is not None:
            # one seam for every admission path (refill, tenant refill,
            # the fleet's re-dispatch): arrival, backdated to the queue's
            # SentTimestamp and idempotent, and the admitted stamp that
            # closes the queue wait
            for tenant, _, _, message in parsed:
                rid = request_id(message)
                lc.arrival(rid, sent=sent_epoch(message),
                           tenant=tenant or None)
                lc.stamp(rid, "admitted")
        pool = self.batcher.prefix_pool
        plain, plain_tenants, prefixed = [], [], []
        for tenant, prefix_ids, ids, message in parsed:
            if (pool is not None and prefix_ids is not None
                    and prefix_ids.size == pool.prefix_len):
                prefixed.append((tenant, prefix_ids, ids, message))
                continue
            if prefix_ids is not None and prefix_ids.size:
                ids = np.concatenate([prefix_ids.reshape(-1),
                                      np.asarray(ids, np.int32).reshape(-1)])
                if ids.size > self.batcher.prompt_len:
                    # the prepended request no longer fits the prompt
                    # bucket, and padding would cut the user's prompt
                    # away: answer it with an error instead
                    self._settle(
                        message, None,
                        error="prefix + prompt exceeds the prompt "
                              "bucket (shrink the prefix or size "
                              "--seq-len / the prefix pool for it)",
                        counted=False,
                    )
                    continue
            plain.append((ids, message))
            plain_tenants.append(tenant)
        admitted = []
        if prefixed:
            rows = self.batcher.submit_many_prefixed(prefixed)
            admitted += [(row, t, m)
                         for row, (t, _, _, m) in zip(rows, prefixed)]
        if plain:
            rows = self.batcher.submit_many(plain)
            if self.tenancy is not None:
                self.batcher.tag_tenant(rows, plain_tenants)
                admitted += [(row, t, m) for row, t, (_, m)
                             in zip(rows, plain_tenants, plain)]
        if self.tenancy is not None:
            # arrival stamps for per-tenant TTFT, and the ladder's tier-1
            # action: an over-share tenant's fresh admissions get a
            # degraded budget (answered short, never dropped)
            degrade = self._degrade_tenants
            for row, tenant, message in admitted:
                slot = self.batcher.slots[row]
                slot.arrived_at = sent_epoch(message)
                if (degrade and tenant in degrade
                        and self._degraded_tokens < slot.budget):
                    slot.budget = self._degraded_tokens
                    slot.degraded = True
                    self._note_shed("degraded")
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
            parsed = self._parse_for_admit(message)
            if parsed is None:
                self._settle(message, None, counted=False)
                continue
            admit.append(parsed + (message,))
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
            self._note_shed("ttl")
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
            ids = parse_request_body(payload["Body"], self.tokenizer)
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

    def kill_admission_shard(self, shard: int) -> int:
        """Chaos seam (``FleetFaultPlan.admission_kills``): kill one
        admission shard.  Its staged requests go back to the queue through
        ``change_message_visibility(0)`` (redelivered, and the reply
        registry dedups), its accounting is tombstoned, and the next refill
        rehydrates it.  Sharded admission only; returns the hand-back
        count."""
        fair = self._fair
        if fair is None or not hasattr(fair, "kill_shard"):
            raise ValueError(
                "no sharded admission plane to kill a shard of "
                "(tenancy.admission_shards must be >= 2)"
            )
        nack = getattr(self.queue, "change_message_visibility", None)
        if nack is None:
            log.warning(
                "Queue has no change_message_visibility; the killed "
                "admission shard's staged requests will redeliver only "
                "after the visibility timeout"
            )

        def handback(message) -> None:
            if nack is not None:
                nack(self.config.queue_url, message["ReceiptHandle"], 0)

        return fair.kill_shard(shard, handback)

    def partition_admission_shard(self, shard: int,
                                  partitioned: bool = True) -> None:
        """Chaos seam (``FleetFaultPlan.admission_partitions``): flip one
        admission shard's gossip partition; it keeps admitting its
        tenants."""
        fair = self._fair
        if fair is None or not hasattr(fair, "partition_shard"):
            raise ValueError(
                "no sharded admission plane to partition a shard of "
                "(tenancy.admission_shards must be >= 2)"
            )
        fair.partition_shard(shard, partitioned)

    def attach_metrics(self, metrics) -> None:
        """Report the serving gauges (tokens/s, time to first token,
        active slots, block utilization), the shed counters and the TTFT
        histogram to a :class:`~..obs.prometheus.WorkloadMetrics`
        registry, refreshed every engine cycle."""
        self.metrics = metrics
        self._update_metrics()

    def attach_lifecycle(self, registry) -> None:
        """Wire a :class:`~..obs.lifecycle.LifecycleRegistry` through
        every stamp site this worker owns (the batcher's admission, emit
        and settle funnels and the fair-admission staging), and rebind the
        registry's clock to the worker's epoch clock, so stamps,
        ``SentTimestamp`` arrivals and FakeClock episodes share one time
        base.  ``None`` detaches."""
        self.lifecycle = registry
        if registry is not None:
            registry.now_fn = self._now
        self.batcher.lifecycle = registry
        if self._fair is not None:
            self._fair.lifecycle = registry

    def attach_spans(self, timer) -> None:
        """Record every cycle's phase spans into ``timer``, a
        :class:`~..utils.profiling.SpanTimer` of its own: ``cycle`` (each
        :meth:`run_once`) around ``receive``, the batcher's ``insert`` and
        ``step`` and ``reply``, on the epoch clock device traces use.
        The worker's ``timer`` keeps :meth:`run_forever`'s ``cycle`` for
        ``--metrics-port``, and cannot take the phases too (its ``cycle``
        would count twice).  ``None`` detaches."""
        if timer is not None and timer is self.timer:
            raise ValueError(
                "attach_spans needs a SpanTimer of its own: the worker's "
                "timer already records run_forever's cycle")
        self.spans = timer
        self.batcher.spans = timer

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
        export = getattr(getattr(batcher, "comms", None), "export_gauges",
                         None)
        if export is not None:
            # per-link routing gauges (topology-attached comms only), on
            # the serving gauges' cadence
            export(self.metrics)
        shed_help = (
            "Requests shed or degraded at admission, by reason: ttl = "
            "older than --request-ttl on arrival (explicit expired "
            "reply), degraded = overload tier 1 cut the token budget "
            "(answered short), pressure = overload tier 3 shed it from "
            "staging (explicit error reply), decode_deadline = the "
            "decode phase blew its per-token SLO budget (shed "
            "mid-decode with an explicit error reply).  The unlabeled "
            "series is their sum."
        )
        self.metrics.set_gauge(
            "requests_shed_total", self.shed, shed_help, kind="counter",
        )
        for reason, count in sorted(self.shed_by_reason.items()):
            self.metrics.set_gauge(
                "requests_shed_total", count, shed_help,
                labels=(("reason", reason),), kind="counter",
            )
        if self.ladder is not None:
            self.metrics.set_gauge(
                "overload_tier", self.ladder.tier,
                "Active overload-ladder tier (0 = serving normally, "
                "1 = degrading over-share tenants, 2 = + evicting cold "
                "prefix entries, 3 = + shedding staged requests).",
            )
            self.metrics.set_gauge(
                "overload_pressure", self.ladder.last_pressure,
                "Measured overload pressure (staged-backlog fraction "
                "gated by slot occupancy) the ladder last acted on.",
            )
            self.metrics.set_gauge(
                "overload_tier_transitions_total", self.ladder.transitions,
                "Ladder tier transitions (enter + exit) over the "
                "worker's lifetime.",
                kind="counter",
            )
        elif self._fair is not None and hasattr(self._fair, "shards"):
            self.metrics.set_admission_shard_gauges(self._fair.shards)
        if self.tenancy is not None:
            self._update_tenant_metrics(elapsed)
        if getattr(batcher, "kv_transfers", None) is not None:
            # the decode plane: accept rates and the handoff counter
            self.metrics.set_plane_engine_gauges(batcher)
        drain_ttft_histograms(batcher, self.metrics)
        if self.lifecycle is not None:
            # the lifecycle histograms refresh on the same cadence
            self.lifecycle.export_metrics(self.metrics)

    def _update_tenant_metrics(self, elapsed: float) -> None:
        """The per-tenant gauges and the pool's hit and miss counters.
        Staged labels fold through bounded_tenant_key before they can mint
        a series, and every registered label is written each cycle, so a
        drained tenant's depth reads 0 instead of its last value."""
        batcher = self.batcher
        depths: dict[str, int] = {}
        for tenant, depth in self._fair.depths().items():
            label = bounded_tenant_key(tenant, self._gauge_tenants)
            self._gauge_tenants[label] = True
            depths[label] = depths.get(label, 0) + depth
        for tenant in set(batcher.tenant_tokens) | set(batcher.tenant_ttft):
            self._gauge_tenants.setdefault(tenant, True)
        for tenant in sorted(self._gauge_tenants):
            count = batcher.tenant_ttft_count.get(tenant, 0)
            self.metrics.set_tenant_gauges(
                tenant,
                queue_depth=depths.get(tenant, 0),
                ttft_seconds=(batcher.tenant_ttft_sum.get(tenant, 0.0)
                              / count if count else 0.0),
                tokens_per_second=(
                    batcher.tenant_tokens.get(tenant, 0) / elapsed
                    if elapsed > 0 else 0.0),
            )
        pool = batcher.prefix_pool
        if pool is not None:
            self.metrics.set_gauge(
                "prefix_cache_hits_total", pool.hits,
                "Prefix-pool admissions that reused a resident prefix "
                "entry (the shared-prefix prefill skipped entirely).",
                kind="counter",
            )
            self.metrics.set_gauge(
                "prefix_cache_misses_total", pool.misses,
                "Prefix-pool admissions that had to install (prefill "
                "once + LRU-evict) their prefix entry.",
                kind="counter",
            )

    def _enforce_decode_deadlines(self) -> None:
        """The decode-phase deadline (``tenancy.decode_slo_s`` > 0): once
        a slot has its first token it must finish its remaining budget at
        ``decode_slo_s`` seconds a token, or it is shed mid-decode with an
        error reply.  The shed settles the reply here, then cuts the
        slot's budget to what it produced, so the engine frees (and
        quiesces) the row at its next step; :meth:`run_once` skips the
        resulting pair with no payload."""
        slo = self.tenancy.decode_slo_s
        now = self._now()
        for slot in self.batcher.slots:
            if not slot.busy or slot.done or slot.payload is None:
                continue
            produced = len(slot.produced)
            if produced < 1:
                continue  # before the first token the TTFT SLO applies
            if slot.decode_deadline_at is None:
                slot.decode_deadline_at = now + slo * max(
                    1, slot.budget - produced)
                continue
            if now <= slot.decode_deadline_at:
                continue
            message = slot.payload
            slot.payload = None
            slot.budget = produced  # finishes (and quiesces) next step
            slot.degraded = True
            if self._settle(
                message, None,
                error=("decode deadline exceeded (the decode phase blew "
                       "its per-token SLO budget)"),
                counted=False,
            ):
                self._note_shed("decode_deadline")

    def run_once(self) -> int:
        """One engine cycle: refill free slots, advance the batch, settle
        finished requests.  Returns the messages completed.  Recorded as
        the ``cycle`` span when spans are attached."""
        spans = self.spans
        if spans is None:
            return self._run_cycle()
        with spans.span("cycle"):
            return self._run_cycle()

    def _run_cycle(self) -> int:
        if self._served_since is None:
            self._served_since = time.perf_counter()
        self._refill()
        if self.tenancy is not None and self.tenancy.decode_slo_s > 0:
            self._enforce_decode_deadlines()
        done = self.batcher.step()
        spans = self.spans
        reply = spans.begin("reply") if spans is not None else None
        completed = 0
        for message, tokens in done:
            if message is None:
                # a decode-deadline shed, answered when it was shed
                continue
            self._settle(message, tokens)
            completed += 1
        if reply is not None:
            spans.end(reply)
        if done:
            self._poll_backoff = 0  # a slot just freed: poll right away
        self.processed += completed
        self._update_metrics()
        return completed

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
