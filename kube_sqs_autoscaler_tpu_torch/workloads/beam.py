"""Beam search over the KV caches, both model families.

Counterpart of ``kube_sqs_autoscaler_tpu/workloads/beam.py``'s
``beam_search`` (its mesh function waits for ROADMAP Queue 1 item 9), held
against it by ``tests/test_torch_beam.py``.  The batch axis carries the
beams: the prompt prefills once a row (the CUDA flash forward on the card),
the cache is row-repeated to ``B * W``, and each step is one decode step
of the family over every beam.  After each expansion the cache follows
the beams' parents by a row gather of every layer's k and v (the codes
and scales under int8), written into a second set of buffers that swaps
with the first (:class:`RowGather`), so the steps allocate no cache.

Scoring is the joint log-probability in fp32, with GNMT length
normalization ``score / ((5 + len) / 6) ** length_penalty`` when
``length_penalty > 0``; ``eos_id`` freezes a finished beam (its score
stops, it pads with the id).

Ties resolve as ``jax.lax.top_k`` and the stable ``jnp.argsort`` do, to
the lowest index (:func:`top_k_lowest_first`): ``torch.topk`` promises no
order among equal values, and exact ties among fp32 sums of bf16-derived
logits do occur.
"""

from __future__ import annotations

import torch

from .decode import _check_prefix_budget, _check_prefix_layout
from .family import family_of


def top_k_lowest_first(
    x: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values along the last axis and their indices,
    equal values lowest index first (``jax.lax.top_k``'s order): a stable
    descending sort, cut to ``k``."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def rank_beams(
    scores: torch.Tensor, emitted: torch.Tensor, length_penalty: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(ranked scores, order)`` of ``[..., W]`` beams, best first: the
    scores, GNMT-normalized by the emitted lengths in fp32 when
    ``length_penalty > 0``, sorted descending with ties to the lowest
    beam (the reference's stable ``argsort(-ranked)``)."""
    ranked = scores
    if length_penalty > 0:
        norm = ((5.0 + emitted.float()) / 6.0) ** length_penalty
        ranked = scores / norm
    order = torch.sort(-ranked, dim=-1, stable=True).indices
    return ranked.gather(-1, order), order


class RowGather:
    """``cache[index]`` along the row axis of every cache tensor, written
    into a spare set of buffers shaped like the cache, which then swaps
    with it: two allocations for a whole search, where a fresh gather
    would allocate a full cache copy a step."""

    def __init__(self, cache: dict) -> None:
        self.spare = _map_rows(cache, torch.empty_like)

    def __call__(self, cache: dict, index: torch.Tensor) -> dict:
        out = self.spare
        for src_layer, dst_layer in zip(cache["layers"], out["layers"]):
            for name, src in src_layer.items():
                torch.index_select(src, 0, index, out=dst_layer[name])
        out["length"] = cache["length"][index]
        self.spare = cache
        return out


def _map_rows(cache: dict, fn) -> dict:
    """``fn`` applied to every tensor of a cache (each layer's entries and
    ``length``)."""
    return {
        "layers": [{name: fn(t) for name, t in layer.items()}
                   for layer in cache["layers"]],
        "length": fn(cache["length"]),
    }


def repeat_rows(cache: dict, width: int) -> dict:
    """Each row of a cache repeated ``width`` times in place of one (row
    ``b`` becomes rows ``[b * width, (b + 1) * width)``)."""
    return _map_rows(cache, lambda t: t.repeat_interleave(width, dim=0))


def expand_beams(
    logp: torch.Tensor, scores: torch.Tensor, alive: torch.Tensor,
    eos_id: int | None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One beam expansion of ``[S, W]`` beams from their next-token
    log-probabilities ``logp`` ``[S, W, V]``: ``(new scores [S, W], parent
    beams [S, W], tokens [S, W])``, the best ``W`` of the ``W * V``
    continuations.  A frozen beam (not ``alive``) has exactly one, itself
    emitting ``eos_id`` at no cost, so it competes without multiplying
    into ``V`` children."""
    slots, width, vocab = logp.shape
    if eos_id is not None:
        frozen = torch.full_like(logp, float("-inf"))
        frozen[..., eos_id] = 0.0
        logp = torch.where(alive[..., None], logp, frozen)
    total = scores[..., None] + logp
    flat_scores, flat_idx = top_k_lowest_first(
        total.reshape(slots, width * vocab), width)
    parent = torch.div(flat_idx, vocab, rounding_mode="floor")
    return flat_scores, parent, flat_idx - parent * vocab


def seed_beams(
    logits: torch.Tensor, width: int, num_tokens: int, eos_id: int | None,
) -> tuple[torch.Tensor, dict]:
    """The first expansion of ``[S]`` rows' prompt logits ``[S, V]``: the
    top ``width`` first tokens seed the beams.  Returns ``(tokens [S * W],
    state)``, the search state ``{"scores": [S, W] fp32, "out": [S, W,
    num_tokens] (eos-padded), "alive": [S, W], "emitted": [S, W]}``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    scores, tokens = top_k_lowest_first(logp, width)
    out = torch.full((*tokens.shape, num_tokens),
                     eos_id if eos_id is not None else 0, dtype=torch.long,
                     device=tokens.device)
    out[..., 0] = tokens
    alive = (tokens != eos_id if eos_id is not None
             else torch.ones_like(tokens, dtype=torch.bool))
    return tokens.reshape(-1), {"scores": scores, "out": out, "alive": alive,
                                "emitted": torch.ones_like(tokens)}


def beam_step(
    params: dict, cache: dict, current: torch.Tensor, state: dict,
    active: torch.Tensor, config, gather: "RowGather", *, step_fn,
    beams: int, eos_id: int | None = None,
) -> tuple[dict, torch.Tensor, dict]:
    """One beam step over ``S`` slots of ``beams`` cache rows each: a
    decode step (``step_fn``, the layout's) of every row from ``current``,
    each slot's best ``beams`` of its ``beams * V`` continuations
    (:func:`expand_beams`), and the parent gather of the cache
    (:class:`RowGather`) and of the state.  A slot not ``active`` keeps its
    beams: identity parents, no write, no advance, its lengths put back.
    Returns ``(cache, current, state)``."""
    lengths_in = cache["length"]
    logits, cache = step_fn(params, cache, current, config)
    slots = active.shape[0]
    logp = torch.log_softmax(logits.float(), dim=-1).view(slots, beams, -1)
    alive, emitted, out = state["alive"], state["emitted"], state["out"]
    scores, parent, token = expand_beams(logp, state["scores"], alive,
                                         eos_id)
    act = active[:, None]
    parent = torch.where(
        act, parent, torch.arange(beams, device=active.device)[None, :])
    rows = torch.arange(slots, device=active.device)[:, None]
    cache = gather(cache, (rows * beams + parent).reshape(-1))
    cache["length"] = torch.where(active.repeat_interleave(beams),
                                  cache["length"], lengths_in)
    alive_g = alive.gather(1, parent)
    emitted_g = emitted.gather(1, parent)
    # a frozen beam's continuation is eos (already the pad value)
    write = (torch.where(alive_g, token, eos_id) if eos_id is not None
             else token)
    out_w = out[rows, parent].scatter(
        2, emitted_g.clamp(max=out.shape[-1] - 1)[..., None],
        write[..., None])
    new_alive = alive_g & (token != eos_id) if eos_id is not None else alive_g
    state = {
        "out": torch.where(act[..., None], out_w, out),
        "emitted": torch.where(act, emitted_g + alive_g.long(), emitted),
        "alive": torch.where(act, new_alive, alive),
        "scores": torch.where(act, scores, state["scores"]),
    }
    current = torch.where(act, token, current.view(slots, beams)).reshape(-1)
    return cache, current, state


def beam_search(
    params: dict,
    config,
    prompt: torch.Tensor,
    num_tokens: int,
    *,
    beams: int = 4,
    length_penalty: float = 0.0,
    eos_id: int | None = None,
    attention_fn=None,
    lengths: torch.Tensor | None = None,
    return_all: bool = False,
    prefix_cache: dict | None = None,
    quantized_cache: bool = False,
):
    """The best continuation of each prompt under beam search: int64
    ``[batch, num_tokens]``, or with ``return_all=True`` ``(sequences [B,
    W, T], scores [B, W])`` best first.  ``beams=1`` is greedy decoding.
    ``eos_id`` ends a beam when it emits the id (its score freezes, it
    pads with the id); ``length_penalty > 0`` ranks by each beam's
    finished length.  ``attention_fn`` is the prompt pass's (the CUDA
    flash forward on the card); ``lengths`` marks ragged right-padded
    prompts; ``prefix_cache`` continues the prompts as suffixes of a
    shared prefix (and rules ``attention_fn`` out: the suffix prefill runs
    the chunk decoder); ``quantized_cache`` searches through the int8
    cache."""
    batch, prompt_len = prompt.shape
    if num_tokens < 1:
        raise ValueError(f"num_tokens must be >= 1, got {num_tokens}")
    if beams < 1:
        raise ValueError(f"beams must be >= 1, got {beams}")
    _check_prefix_budget(prefix_cache, prompt_len, num_tokens, config)
    if prefix_cache is not None:
        if attention_fn is not None:
            raise ValueError(
                "attention_fn does not apply with prefix_cache (the "
                "suffix prefill runs the chunk decoder); drop one"
            )
        _check_prefix_layout(prefix_cache, quantized_cache)
    layout = family_of(config).layout(quantized_cache)
    width = beams
    if prefix_cache is not None:
        logits, cache = layout.prefill_with_prefix(
            params, prefix_cache, prompt, config, lengths=lengths)
    else:
        logits, cache = layout.prefill(params, prompt, config, attention_fn,
                                       lengths=lengths)
    last, state = seed_beams(logits, width, num_tokens, eos_id)
    cache = repeat_rows(cache, width)
    gather = RowGather(cache)
    every = torch.ones(batch, dtype=torch.bool, device=prompt.device)
    for _ in range(num_tokens - 1):
        cache, last, state = beam_step(
            params, cache, last, state, every, config, gather,
            step_fn=layout.decode_step, beams=width, eos_id=eos_id)
    out, scores, emitted = state["out"], state["scores"], state["emitted"]
    ranked, order = rank_beams(scores, emitted, length_penalty)
    out = out.gather(1, order[..., None].expand_as(out))
    if return_all:
        return out, ranked
    return out[:, 0]
