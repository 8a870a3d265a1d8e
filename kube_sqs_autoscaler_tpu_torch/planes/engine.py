"""The decode plane: gang-stepped shards with speculative rows and the KV
handoff.

Counterpart of ``kube_sqs_autoscaler_tpu/planes/engine.py`` (without the
comms and lifecycle hooks), held against it by ``tests/test_torch_planes.py``.
:class:`DecodePlaneBatcher` extends
:class:`~..workloads.shard_plane.ShardedBatcher`:

- **speculative rows on the plane**: one draft-and-verify round
  (:func:`~..workloads.speculative.speculative_round`, through the
  batcher's :meth:`~..workloads.continuous.ContinuousBatcher._dispatch_spec_round`)
  runs over the whole flat ``[S*B]`` row axis, its ``active`` mask
  selecting the speculative rows.  Those rows are frozen on the device
  (``done``, no budget, as :meth:`~..workloads.shard_plane.ShardedBatcher.kill_rows`
  freezes them), so the gang block skips them; a cycle runs at most one
  round plus one gang block, and plain rows pay no extra dispatch when
  drafting is off;
- **drain-to-plain**: :meth:`DecodePlaneBatcher.set_speculative` changes
  the mode of new admissions only; a row keeps the mode it was admitted
  in, and greedy draft-and-verify emits the plain greedy continuation, so
  per-request parity holds across a flip either way;
- **the KV handoff** (:meth:`DecodePlaneBatcher.submit_handoff`): finished
  prefill rows of a prefill-plane batcher are adopted by copying their
  cache rows whole, every cache entry alike (bf16 k/v, int8 codes and
  scales), and the draft cache takes the first ``spec_layers`` layers of
  the same donor rows.  No forward runs and no kernel launches.  The copy
  is enqueued on the one CUDA stream before the donor's next insert, so
  it reads the donor rows before anything overwrites them.

A drafted admission seeds the draft cache with its own ``[M, P]`` prefill
through the layer-sliced params (:func:`_draft_rows_impl`), which runs the
CUDA flash forward once a draft layer on the card.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from ..workloads.continuous import (
    _Slot, _rows_prefill, _splice_rows_layers, _to_device,
)
from ..workloads.service import bounded_tenant_key
from ..workloads.shard_plane import ShardedBatcher
from ..workloads.speculative import self_draft


def _draft_rows_impl(dparams: dict, dcache: dict, rows: torch.Tensor,
                     prompts: torch.Tensor, lengths: torch.Tensor,
                     config, attention_fn, *, layout) -> None:
    """Seed the draft cache for a speculative admission batch: the same
    ``[M, P]`` batched prefill as the target insert, through the draft's
    layer-sliced params, spliced into ``rows`` of ``dcache`` in place with
    their lengths.  The logits are not used."""
    _, rows_cache = _rows_prefill(dparams, prompts, lengths, config,
                                  attention_fn, layout)
    _splice_rows_layers(dcache, rows_cache, rows, 0, prompts.shape[1])
    dcache["length"][rows] = lengths


def _copy_rows(cache: dict, src_cache: dict, rows: torch.Tensor,
               src_idx: torch.Tensor, n_layers: int | None = None) -> None:
    """Copy donor rows ``src_idx`` of ``src_cache`` into ``rows`` of
    ``cache`` in place, whole, for every entry of the first ``n_layers``
    layers (all by default) and the lengths."""
    for layer, src_layer in zip(cache["layers"],
                                src_cache["layers"][:n_layers]):
        for name, buf in layer.items():
            buf.index_copy_(0, rows, src_layer[name].index_select(0, src_idx))
    cache["length"].index_copy_(
        0, rows, src_cache["length"].index_select(0, src_idx))


def _handoff_rows_impl(cache: dict, dcache: dict | None,
                       current: torch.Tensor, done: torch.Tensor,
                       remaining: torch.Tensor, src_cache: dict,
                       rows: torch.Tensor, src_idx: torch.Tensor,
                       lasts: torch.Tensor, budgets: torch.Tensor, *,
                       spec: bool = False, spec_layers: int = 0) -> None:
    """The KV handoff: adopt donor rows ``src_idx`` of ``src_cache`` into
    slot ``rows`` by a device copy, no forward.  Every entry keys the row on
    axis 0, so the whole row moves for any layout; positions past a row's
    length are garbage on both sides, as after a native insert.  The row
    state arms as the resume insert's would: the donor's length, the last
    produced token pending, and the gang liveness live (plain rows, with
    ``budgets`` left) or frozen (speculative rows, stepped by rounds; their
    draft rows take the donor's first ``spec_layers`` layers)."""
    _copy_rows(cache, src_cache, rows, src_idx)
    current.index_copy_(0, rows, lasts)
    if spec:
        _copy_rows(dcache, src_cache, rows, src_idx, spec_layers)
        done.index_fill_(0, rows, True)
        remaining.index_fill_(0, rows, 0)
    else:
        done.index_fill_(0, rows, False)
        remaining.index_copy_(0, rows, budgets)


class DecodePlaneBatcher(ShardedBatcher):
    """The sharded gang engine with speculative rows and KV adoption.

    Built as :class:`~..workloads.shard_plane.ShardedBatcher` plus
    ``spec_layers`` / ``spec_tokens`` (the early-exit self-draft's depth
    and proposals a round) and ``draft_enabled`` (the mode new admissions
    take; default on when drafted).  ``spec_layers=0`` builds a pure
    handoff target.  The base engine is the plain one (``draft_layers``
    stays 0), so the inherited insert, resume insert, gang block, engine
    adoption and evacuation are unchanged; rows turn speculative through
    this class's admissions.  Counters beyond the plane's: ``kv_transfers``
    (rows adopted by handoff), ``draft_inserts`` (draft-cache prefills, one
    a drafted admission batch), ``spec_flips``, and per-tenant
    ``tenant_spec_rounds`` / ``tenant_spec_accepted``."""

    def __init__(self, params: dict, config, *, shards: int,
                 shard_slots: int, prompt_len: int, generate_tokens: int,
                 spec_layers: int = 0, spec_tokens: int = 4,
                 draft_enabled: bool | None = None, **kwargs) -> None:
        if kwargs.get("mesh") is not None and spec_layers:
            raise ValueError(
                "the speculative decode plane is single-chip for now "
                "(the spec round and handoff copy are not mesh-sharded)"
            )
        if spec_layers:
            if not 0 < spec_layers < config.n_layers:
                raise ValueError(
                    f"spec_layers={spec_layers} must be in [1, n_layers-1] "
                    f"(model has n_layers={config.n_layers})"
                )
            if spec_tokens < 1:
                raise ValueError(f"spec_tokens={spec_tokens} must be >= 1")
            if kwargs.get("prefix_cache") is not None:
                raise ValueError(
                    "spec_layers does not combine with a global prefix_cache "
                    "(the draft cache has no prefix rows)"
                )
            # a round can overshoot the budget by k and write k + 1 masked
            # positions past a frozen length: the fused engine's 2k slack
            budget = prompt_len + generate_tokens + 2 * spec_tokens
            if budget > config.max_seq_len:
                raise ValueError(
                    f"prompt_len + generate_tokens + 2*spec_tokens = "
                    f"{budget} exceeds max_seq_len={config.max_seq_len}"
                )
        super().__init__(params, config, shards=shards,
                         shard_slots=shard_slots, prompt_len=prompt_len,
                         generate_tokens=generate_tokens, **kwargs)
        rows = shards * shard_slots
        self.spec_layers = spec_layers
        self.spec_tokens = spec_tokens
        # each slot's admission mode (True: draft-and-verify rounds, frozen
        # for the gang); fixed at admission
        self._slot_spec = [False] * rows
        self.kv_transfers = 0
        self.draft_inserts = 0
        self.tenant_spec_rounds: dict[str, int] = {}
        self.tenant_spec_accepted: dict[str, int] = {}
        # accepted counts of the last rounds (recent_accept_rate)
        self._accept_window: deque[int] = deque(maxlen=256)
        self.spec_flips = 0
        self.draft_cache = None
        self.draft_enabled = False
        if spec_layers:
            self.draft_params, self.draft_config = self_draft(
                params, config, spec_layers)
            with torch.inference_mode():
                self.draft_cache = self._layout.init_cache(
                    self.draft_config, rows, self.device)
            # the round reads draft_tokens; draft_layers stays 0, so every
            # inherited plain-path check treats this as the plain plane
            self.draft_tokens = spec_tokens
            self.draft_enabled = (True if draft_enabled is None
                                  else bool(draft_enabled))

    # -- engine identity ---------------------------------------------------

    def _engine_key(self) -> tuple:
        return super()._engine_key() + (self.spec_layers, self.spec_tokens)

    def adopt_engine(self, source) -> None:
        if not isinstance(source, DecodePlaneBatcher):
            raise ValueError(
                "a decode plane adopts from a decode-plane donor only")
        super().adopt_engine(source)  # checks the whole engine key

    # -- admission: every path marks its rows' mode -------------------------

    def submit_many(self, requests):
        rows = super().submit_many(requests)
        if not (self.draft_enabled and rows):
            for row in rows:
                self._slot_spec[row] = False
            return rows
        # drafted: the plain insert seeded the target rows, their first
        # tokens and slots; add the draft prefill and freeze the rows out
        # of the gang
        padded = [self._pad_prompt(ids) for ids, _ in requests]
        prompts = np.stack([ids for ids, _ in padded])
        lengths = np.asarray([n for _, n in padded], np.int64)
        with torch.inference_mode():
            _draft_rows_impl(
                self.draft_params, self.draft_cache,
                _to_device(np.asarray(rows), self.device),
                _to_device(prompts, self.device),
                _to_device(lengths, self.device), self.draft_config,
                self._attention_fn, layout=self._layout,
            )
        self.insert_dispatches += 1
        self.draft_inserts += 1
        self.kill_rows(rows)
        for row in rows:
            self._slot_spec[row] = True
        return rows

    def submit_resume(self, resumes):
        # resumed rows decode plain: greedy draft-and-verify emits the
        # plain greedy continuation, and the resume insert is the plain one
        rows = super().submit_resume(resumes)
        for row in rows:
            self._slot_spec[row] = False
        return rows

    def submit_many_prefixed(self, requests):
        # pooled admissions stay plain: the draft cache has no pool rows
        rows = super().submit_many_prefixed(requests)
        for row in rows:
            self._slot_spec[row] = False
        return rows

    def submit_handoff(self, donor, handoffs: list[tuple]) -> list[int]:
        """Adopt started prefill rows of ``donor`` (the plain
        :class:`~..workloads.continuous.ContinuousBatcher` of a prefill
        replica) into free slots; returns their rows.

        Each handoff is ``(src_row, payload, produced, budget,
        submitted_at, tenant)``.  One device copy moves the batch's cache
        rows (and draft rows when drafting) and arms the row state; no
        forward runs.  Rows route freest first through the plane's
        admission order.  The time to first token was recorded on the
        prefill plane and is not recorded again."""
        if not handoffs:
            return []
        if (donor.config is not self.config or donor.family != self.family
                or donor.quantized_kv != self.quantized_kv):
            raise ValueError(
                "a KV handoff needs the donor's exact config/family/layout "
                "(the cache rows must be layout-identical)"
            )
        if donor.mesh is not None or self.mesh is not None:
            raise ValueError("the KV handoff transport is single-chip")
        free = self.free_slots
        if len(handoffs) > len(free):
            raise RuntimeError(
                f"no free slot for {len(handoffs)} handoff(s) ({len(free)} "
                "free); the pool must cap handoffs by free_slots"
            )
        rows = free[: len(handoffs)]
        src_idx, lasts, budgets = [], [], []
        for src_row, _, produced, budget, _, _ in handoffs:
            if not 0 < len(produced) < budget:
                raise ValueError(
                    f"handoff row produced {len(produced)} of budget "
                    f"{budget} tokens: a handoff carries a started, "
                    "unfinished request"
                )
            if self.eos_id is not None and produced[-1] == self.eos_id:
                raise ValueError(
                    "a completed (eos) request settles on the prefill plane, "
                    "it does not hand off"
                )
            src_idx.append(src_row)
            lasts.append(produced[-1])
            budgets.append(budget - len(produced))
        spec = bool(self.spec_layers) and self.draft_enabled
        lc = self.lifecycle
        handoff_t0 = lc.now_fn() if lc is not None else None
        with torch.inference_mode():
            _handoff_rows_impl(
                self.cache, self.draft_cache, self._current, self._done,
                self._remaining, donor.cache,
                _to_device(np.asarray(rows, np.int64), self.device),
                _to_device(np.asarray(src_idx, np.int64), self.device),
                _to_device(np.asarray(lasts, np.int64), self.device),
                _to_device(np.asarray(budgets, np.int64), self.device),
                spec=spec, spec_layers=self.spec_layers,
            )
        self.insert_dispatches += 1
        self.kv_transfers += len(rows)
        if self.comms is not None and self.comms.enabled:
            from ..comms.ops import HANDOFF_KV

            self.comms.record(
                HANDOFF_KV, "decode-plane", source="prefill",
                nbytes=self._row_kv_nbytes() * len(rows),
                args={"rows": len(rows)},
            )
        for row, (_, payload, produced, budget, submitted_at,
                  tenant) in zip(rows, handoffs):
            self.slots[row] = _Slot(
                busy=True, budget=budget, payload=payload,
                produced=list(produced), submitted_at=submitted_at,
                tenant=tenant or "", ttft_done=True,
            )
            self._slot_spec[row] = spec
            if lc is not None:
                from ..obs.lifecycle import request_key

                # the KV landed in a decode slot: the handoff phase closes,
                # and the copy is a paired transfer window on the trace
                rid = request_key(payload)
                lc.stamp(rid, "handoff", tenant=tenant or None)
                lc.stamp(rid, "transfer", t=handoff_t0)
                lc.stamp(rid, "transfer_done")
                lc.note(rid, "transfer_handoff_kv")
        self._invalidate_admission_cache()
        return rows

    def row_kv_nbytes(self) -> int:
        """Bytes of one slot row's cache (target and draft): what a
        handoff moves a row."""
        total = 0
        for cache in (self.cache, self.draft_cache):
            if cache is None:
                continue
            for layer in cache["layers"]:
                for buf in layer.values():
                    total += buf[0].numel() * buf.element_size()
        return total

    # -- the cycle: one spec round, then one gang block --------------------

    def _step_gang(self):
        spec_shards = None
        if self.spec_layers:
            mask = [self._slot_spec[row] and self._needs_decode(slot)
                    for row, slot in enumerate(self.slots)]
            if any(mask):
                copy = self._dispatch_spec_round(mask)
                # first tokens land in slot.produced before round tokens
                self._settle_pending_firsts()
                spec_shards = self._consume_plane_spec_round(mask, copy)
        finished = super()._step_gang()
        # a shard whose busy rows are all speculative shows no gang
        # progress; its round tokens are progress for the stall sentinel
        for s in spec_shards or ():
            self.shard_stall_cycles[s] = 0
        return finished

    def _consume_plane_spec_round(self, mask, copy) -> set[int]:
        """Emit a round's tokens, with the plane's attribution: tokens per
        shard (the shard gauges and the stall sentinel) and the bounded
        per-tenant accept counts.  Returns the shards that progressed."""
        toks_host, n_host = copy.wait()
        self.host_transfers += 1
        progressed: set[int] = set()
        for row, slot in enumerate(self.slots):
            if not mask[row]:
                continue
            n = int(n_host[row])
            slot.rounds += 1
            slot.accepted += n
            self.spec_rounds += 1
            self.spec_accepted += n
            self._accept_window.append(n)
            if slot.tenant:
                tenant = bounded_tenant_key(slot.tenant,
                                            self.tenant_spec_rounds)
                self.tenant_spec_rounds[tenant] = (
                    self.tenant_spec_rounds.get(tenant, 0) + 1)
                self.tenant_spec_accepted[tenant] = (
                    self.tenant_spec_accepted.get(tenant, 0) + n)
            shard = row // self.shard_slots
            emitted = 0
            for token in toks_host[row, : n + 1]:
                if slot.done or len(slot.produced) >= slot.budget:
                    break
                self._emit(slot, int(token))
                emitted += 1
            self.shard_tokens[shard] += emitted
            if emitted:
                progressed.add(shard)
        return progressed

    # -- the speculative knob: drain-to-plain ------------------------------

    def set_speculative(self, enabled: bool) -> None:
        """Switch draft-and-verify for new admissions, live: rows already
        admitted finish in their mode, so greedy parity per request holds
        across the flip."""
        if not self.spec_layers:
            raise ValueError(
                "the speculative knob needs a drafted decode plane "
                "(spec_layers > 0)"
            )
        enabled = bool(enabled)
        if enabled != self.draft_enabled:
            self.spec_flips += 1
        self.draft_enabled = enabled

    # -- measured economics -------------------------------------------------

    def accept_rate(self, tenant: str | None = None) -> float | None:
        """Accepted drafts over proposed drafts in ``[0, 1]``, plane-wide
        or for one (bounded) tenant label; ``None`` before any round."""
        if tenant is None:
            rounds, accepted = self.spec_rounds, self.spec_accepted
        else:
            key = bounded_tenant_key(tenant, self.tenant_spec_rounds)
            rounds = self.tenant_spec_rounds.get(key, 0)
            accepted = self.tenant_spec_accepted.get(key, 0)
        if not rounds:
            return None
        return accepted / (rounds * self.spec_tokens)

    def recent_accept_rate(self) -> float | None:
        """The accept rate over the last rounds (up to 256)."""
        if not self._accept_window:
            return None
        return (sum(self._accept_window)
                / (len(self._accept_window) * self.spec_tokens))
