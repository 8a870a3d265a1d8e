"""Speculative decoding: draft-and-verify generation, greedy or sampled.

Counterpart of ``kube_sqs_autoscaler_tpu/workloads/speculative.py``, its
mesh function :func:`make_speculative_serving_fn` included, held against it
by ``tests/test_torch_speculative.py`` and ``tests/test_torch_serve_mesh.py``.  A small *draft* model proposes ``k``
tokens one decode step at a time, then the *target* scores all ``k + 1``
positions in one chunk-wide forward (the family's chunk decoder).  Per
round, with pending token ``p`` and proposals ``d_1..d_k``:

- the target chunk-decodes ``[p, d_1..d_k]`` into picks ``g_0..g_k``;
- ``d_j`` is accepted while every earlier draft matched, so ``n`` drafts
  are accepted, and ``d_1..d_n`` plus the bonus ``g_n`` are emitted (a
  round emits between 1 and ``k + 1`` tokens);
- both caches roll back by *length*: the entries past the accepted prefix
  stay written but are masked by each row's ``length``.

Greedy output equals :func:`.decode.generate`'s up to argmax ties in the
verify logits (the chunk sums in another order than the decode step).
With ``temperature > 0`` the Leviathan/Chen rejection rule
(:func:`_accept_and_fixup`) makes every emitted token an exact sample of
the warped target distribution; draws come from a ``torch.Generator``, so
a seed gives a reproducible run, not the reference's draws.

The draft runs one extra consume step a round (input ``d_k``) so its cache
holds every accepted input even on full acceptance.  Rows that reach
``num_tokens`` (or their eos) freeze: they advance by 0 and their writes
land in positions their length keeps masked, within the budget's ``2k``
slack.  The reference's ``lax.while_loop`` is a host loop of rounds here,
whose condition is one device-to-host read a round.

Both models' entry points come from :meth:`.family.ModelFamily.layout`,
for the target and the draft independently (a llama target may take a
GPT draft; they share only the vocabulary).  A windowed llama runs the
full cache with the window mask, never the rolling cache.
"""

from __future__ import annotations

import torch

from .decode import (
    _check_prefix_budget, _check_prefix_layout, _pick, _rank_kw, sample_rows,
    uniform_rows, warp_logits,
)
from .family import family_of


def draft_prefix_from_target(prefix_cache: dict, n_layers: int) -> dict:
    """The early-exit self-draft's prefix cache: the draft is the target's
    first ``n_layers``, so its prefix k/v are the target prefix cache's
    first layers (the same tensors, shared, never copied)."""
    return {
        "layers": prefix_cache["layers"][:n_layers],
        "length": prefix_cache["length"],
    }


def self_draft(params: dict, config, n_layers: int) -> tuple[dict, object]:
    """``(params, config)`` of the early-exit self-draft: the target's
    first ``n_layers`` layers, sharing every other tensor (the final norm
    and readout, the llama's untied ``lm_head``, int8 leaves) by
    reference."""
    from dataclasses import replace

    return (dict(params, layers=params["layers"][:n_layers]),
            replace(config, n_layers=n_layers))


def _warp(logits, temperature: float, top_k: int, top_p: float):
    """The warped sampling distribution: :func:`.decode.warp_logits`, the
    one definition ``_pick`` uses too."""
    return warp_logits(logits, temperature, top_k, top_p)


def _sample(warped: torch.Tensor, generator, draw=None) -> torch.Tensor:
    """One draw a row from the softmax of warped logits ``[B, V]`` (a mesh
    rank's share of the batch's draw with ``draw``,
    :func:`.decode._pick`)."""
    return sample_rows(torch.softmax(warped, dim=-1), generator, draw)


def _accept_and_fixup(
    generator, drafts: torch.Tensor, draft_warped: torch.Tensor,
    target_warped: torch.Tensor, draw=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One round of the speculative-sampling rule: accept draft ``d_i ~
    p_i`` with probability ``min(1, q_{i-1}(d_i) / p_i(d_i))`` while every
    earlier draft was accepted; on the first rejection emit a token from
    the residual ``(q - p)+`` (renormalized), on full acceptance from
    ``q_k``.  ``drafts`` ``[B, k]``, ``draft_warped`` ``[B, k, V]``,
    ``target_warped`` ``[B, k + 1, V]``.  Returns ``(n, fixup)``, the
    accepted count ``[B]`` and the replacement or bonus token ``[B]``.

    The fixup is drawn from the distribution itself, never from its log:
    ``torch.multinomial`` takes any non-negative weights, and a residual
    that underflowed to no mass falls back to ``q_n`` (the reference's
    ``z > 1e-9`` rule), so no NaN or negative weight reaches it."""
    batch, k = drafts.shape
    p_d = torch.softmax(draft_warped, dim=-1)  # [B, k, V]
    q = torch.softmax(target_warped, dim=-1)  # [B, k + 1, V]
    vocab = q.shape[-1]
    p_chosen = p_d.gather(-1, drafts[..., None])[..., 0]  # [B, k]
    q_chosen = q[:, :k].gather(-1, drafts[..., None])[..., 0]
    u = uniform_rows((batch, k), generator, q.device, draw)
    # accept iff u < q / p, i.e. u * p < q (p > 0: d was drawn from p)
    accept = (u * p_chosen < q_chosen).long()
    n = torch.cumprod(accept, dim=1).sum(dim=1)  # [B] in [0, k]

    def at(dist, index):
        return dist.gather(1, index.view(-1, 1, 1).expand(-1, 1, vocab))[:, 0]

    q_n = at(q, n)
    p_n = at(p_d, n.clamp(max=k - 1))
    residual = (q_n - p_n).clamp(min=0.0)
    z = residual.sum(dim=-1, keepdim=True)
    resid_dist = torch.where(z > 1e-9, residual / z.clamp(min=1e-9), q_n)
    dist = torch.where((n < k)[:, None], resid_dist, q_n)
    fixup = sample_rows(dist, generator, draw)
    return n, fixup


def speculative_round(
    target, draft, params_target, params_draft, config_target, config_draft,
    t_cache: dict, d_cache: dict, pending: torch.Tensor,
    active: torch.Tensor, draft_tokens: int, generator=None,
    temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
    tp=None, draw=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One draft-and-verify round over every row: ``draft_tokens`` (k)
    draft steps from ``pending``, the extra draft consume of ``d_k``, one
    ``(k + 1)``-wide target chunk, and the acceptance (greedy: drafts kept
    while they equal the target's picks; sampled: :func:`_accept_and_fixup`).
    ``target`` / ``draft`` are the two models' cache layouts
    (:class:`.family.CacheLayout`).  Rows not ``active`` advance by 0: their
    writes this round land in positions their unchanged lengths keep
    masked.  Sets both caches' lengths in place and returns ``(pending
    [B], round_tokens [B, k + 1], n [B])``: position ``j`` of
    ``round_tokens`` is draft ``j`` while ``j < n`` and the bonus from
    ``j == n`` on; ``n`` is 0 on inactive rows.  ``tp`` and ``draw`` are a
    mesh rank's (its heads, its rows' place in the batch's draws)."""
    k = draft_tokens
    kw = _rank_kw(tp)
    sampled = temperature > 0.0
    t_len, d_len = t_cache["length"], d_cache["length"]
    proposals, warped_all = [], []
    token = pending
    for _ in range(k):
        logits, d_cache = draft.decode_step(params_draft, d_cache, token,
                                            config_draft, **kw)
        if sampled:
            warped = _warp(logits, temperature, top_k, top_p)
            warped_all.append(warped)
            token = _sample(warped, generator, draw)
        else:
            token = torch.argmax(logits, dim=-1)
        proposals.append(token)
    drafts = torch.stack(proposals, dim=1)  # [B, k]
    # the extra consume of d_k: the draft cache holds every accepted input
    # even when all k are accepted (masked by length otherwise)
    _, d_cache = draft.decode_step(params_draft, d_cache, drafts[:, -1],
                                   config_draft, **kw)
    chunk = torch.cat([pending[:, None], drafts], dim=1)
    logits, t_cache = target.chunk_decode(params_target, t_cache, chunk,
                                          config_target, **kw)
    if sampled:
        n, bonus = _accept_and_fixup(
            generator, drafts, torch.stack(warped_all, dim=1),
            _warp(logits, temperature, top_k, top_p), draw)
    else:
        greedy = torch.argmax(logits, dim=-1)  # [B, k + 1]
        matches = (drafts == greedy[:, :k]).long()
        n = torch.cumprod(matches, dim=1).sum(dim=1)  # [B] in [0, k]
        bonus = greedy.gather(1, n[:, None])[:, 0]
    j = torch.arange(k + 1, device=drafts.device)[None, :]
    round_tokens = torch.where(j < n[:, None],
                               torch.nn.functional.pad(drafts, (0, 1)),
                               bonus[:, None])
    n = torch.where(active, n, 0)
    advance = torch.where(active, n + 1, 0)
    t_cache["length"] = t_len + advance
    d_cache["length"] = d_len + advance
    return torch.where(active, bonus, pending), round_tokens, n


def speculative_generate(
    params_target: dict,
    config_target,
    params_draft: dict,
    config_draft,
    prompt: torch.Tensor,
    num_tokens: int,
    *,
    draft_tokens: int = 4,
    attention_fn=None,
    lengths: torch.Tensor | None = None,
    return_stats: bool = False,
    temperature: float = 0.0,
    generator: torch.Generator | None = None,
    top_k: int = 0,
    top_p: float = 1.0,
    eos_id: int | None = None,
    quantized_cache: bool = False,
    prefix_cache: dict | None = None,
    draft_prefix_cache: dict | None = None,
    tp=None,
    draw=None,
    all_done=None,
):
    """``num_tokens`` tokens a prompt (int64 ``[batch, num_tokens]``)
    through draft-and-verify rounds of ``draft_tokens`` (k) proposals.

    Greedy at ``temperature=0`` (:func:`.decode.generate`'s tokens up to
    argmax ties), else speculative sampling with ``generator``.
    ``attention_fn`` is both prompt passes' (the CUDA flash forward on the
    card); ``lengths`` marks ragged right-padded prompts.  Once a row emits
    ``eos_id`` it freezes and every later position is ``eos_id``.
    ``quantized_cache`` runs both models over the int8 cache;
    ``prefix_cache`` / ``draft_prefix_cache`` (both or neither; a
    self-draft's from :func:`draft_prefix_from_target`) continue the
    prompts as suffixes of a shared prefix.  ``return_stats=True`` also
    returns ``{"rounds": [B], "acceptance_rate": [B]}``, each row's target
    passes and mean fraction of drafts accepted.

    On a mesh rank (:func:`make_speculative_serving_fn`) ``tp`` runs its
    heads, ``draw`` places its rows in the batch's draws and
    ``all_done(done)`` says whether every row of the whole batch is done,
    so every rank runs the same rounds and draws what one process
    would."""
    if config_target.vocab_size != config_draft.vocab_size:
        raise ValueError(
            f"target vocab {config_target.vocab_size} != draft vocab "
            f"{config_draft.vocab_size}"
        )
    if draft_tokens < 1:
        raise ValueError(f"draft_tokens must be >= 1, got {draft_tokens}")
    batch, prompt_len = prompt.shape
    if num_tokens < 1:
        raise ValueError(f"num_tokens must be >= 1, got {num_tokens}")
    if (prefix_cache is None) != (draft_prefix_cache is None):
        raise ValueError(
            "prefix_cache and draft_prefix_cache come together (the "
            "draft model needs its own prefix KV — "
            "draft_prefix_from_target slices it for a self-draft)"
        )
    if prefix_cache is not None:
        # the suffix prefills run the chunk decoder: attention_fn serves
        # only prompt passes, so it goes unused here, as in the reference
        _check_prefix_layout(prefix_cache, quantized_cache)
        _check_prefix_layout(draft_prefix_cache, quantized_cache)
    # a frozen row's length reaches prompt + num_tokens + k - 1, and each
    # later round still writes k masked positions past it: both caches
    # need prefix + prompt + num_tokens + 2k positions
    for name, config in (("target", config_target), ("draft", config_draft)):
        _check_prefix_budget(
            prefix_cache, prompt_len, num_tokens, config,
            slack=2 * draft_tokens, slack_label="2x draft window",
            model_name=name,
        )
    sampled = temperature > 0.0
    if sampled and generator is None:
        raise ValueError("temperature sampling requires a generator")
    if top_k < 0:
        raise ValueError(f"top_k={top_k} must be >= 0 (0 = off)")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p={top_p} must be in (0, 1] (1.0 = off)")

    k = draft_tokens
    device = prompt.device
    target = family_of(config_target).layout(quantized_cache)
    draft = family_of(config_draft).layout(quantized_cache)
    kw = _rank_kw(tp)
    if prefix_cache is not None:
        t_logits, t_cache = target.prefill_with_prefix(
            params_target, prefix_cache, prompt, config_target,
            lengths=lengths, **kw)
        _, d_cache = draft.prefill_with_prefix(
            params_draft, draft_prefix_cache, prompt, config_draft,
            lengths=lengths, **kw)
    else:
        t_logits, t_cache = target.prefill(
            params_target, prompt, config_target, attention_fn,
            lengths=lengths, **kw)
        _, d_cache = draft.prefill(
            params_draft, prompt, config_draft, attention_fn,
            lengths=lengths, **kw)
    pending = _pick(t_logits, generator, temperature, top_k, top_p, draw)

    # one full round past num_tokens, so the fixed-width write never clips
    out = torch.zeros((batch, num_tokens + k + 1), dtype=torch.long,
                      device=device)
    out[:, 0] = pending
    count = torch.ones(batch, dtype=torch.long, device=device)
    rounds = torch.zeros(batch, dtype=torch.long, device=device)
    accepted_total = torch.zeros(batch, dtype=torch.long, device=device)
    eos_seen = (pending == eos_id if eos_id is not None
                else torch.zeros(batch, dtype=torch.bool, device=device))
    j = torch.arange(k + 1, device=device)[None, :]
    while True:
        # rows at num_tokens or past their eos freeze: no emission, no
        # cache or count advance
        done = (count >= num_tokens) | eos_seen
        finished = done.all() if all_done is None else all_done(done)
        if bool(finished):  # the round's one device-to-host read
            break
        pending, round_tokens, n = speculative_round(
            target, draft, params_target, params_draft, config_target,
            config_draft, t_cache, d_cache, pending, ~done, k, generator,
            temperature, top_k, top_p, tp, draw)
        idx = (count[:, None] + j).clamp(max=out.shape[1] - 1)
        keep = (j <= n[:, None]) & ~done[:, None]
        out.scatter_(1, idx, torch.where(keep, round_tokens,
                                         out.gather(1, idx)))
        count = count + torch.where(done, 0, n + 1)
        rounds = rounds + (~done).long()
        accepted_total = accepted_total + n
        if eos_id is not None:
            eos_seen = eos_seen | (((round_tokens == eos_id) & keep)
                                   .any(dim=1))
    result = out[:, :num_tokens]
    if eos_id is not None:
        # everything from the first eos on is the id (a frozen eos row's
        # unwritten tail holds zeros): generate's post-eos padding
        hit = torch.cumsum((result == eos_id).long(), dim=1) > 0
        result = torch.where(hit, eos_id, result)
    if return_stats:
        proposed = (rounds * k).clamp(min=1)
        return result, {
            "rounds": rounds,
            "acceptance_rate": accepted_total.float() / proposed.float(),
        }
    return result


def make_speculative_serving_fn(
    mesh,
    config_target,
    params_target: dict,
    config_draft,
    *,
    draft_tokens: int = 4,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    eos_id: int | None = None,
    prefix_cache: dict | None = None,
    quantized_cache: bool = False,
):
    """The draft-and-verify loop over a ``(data, model)`` serving mesh:
    batch rows over ``data``, both models' weights and caches at the
    rank's heads over ``model`` (verify, draft steps and the per-row
    rollback are row-local).  Every rank runs a round while any row of
    the whole batch is live (one all-reduce of the done flags over
    ``data`` a round), so sampled rounds draw what one process would.
    ``prefix_cache`` (a full batch-1 cache) is placed once as the rank's
    heads, the self-draft's prefix derived by
    :func:`draft_prefix_from_target`; ``quantized_cache`` runs both
    caches as int8.  Returns ``run(params_target, params_draft, prompt,
    lengths, rng, num_tokens) -> [B, num_tokens]`` on the global batch
    (``rng`` a :class:`torch.Generator`, ignored under greedy)."""
    import torch.distributed as dist

    from .decode import (
        gather_rows, prefix_cache_shardings, rank_rows, require_serving_mesh,
    )
    from .train import _check_divisible, tensor_parallel

    require_serving_mesh(mesh)
    _check_divisible(mesh, config_target)
    placed_t = placed_d = None
    if prefix_cache is not None:
        _check_prefix_layout(prefix_cache, quantized_cache)
        placed_t = prefix_cache_shardings(mesh, prefix_cache)
        placed_d = draft_prefix_from_target(placed_t, config_draft.n_layers)
    tp = tensor_parallel(mesh)
    data = mesh.axis("data")
    family = family_of(config_target)

    def all_done(done):
        flag = done.all().to(torch.int32).reshape(1)
        return mesh.transport.all_reduce(flag, data.group,
                                         dist.ReduceOp.MIN)[0]

    def run(params_t, params_d, prompt, lengths, rng, num_tokens):
        prompt = torch.as_tensor(prompt, device=mesh.device)
        batch = prompt.shape[0]
        rows = rank_rows(mesh, batch)
        if lengths is not None:
            lengths = torch.as_tensor(lengths, device=mesh.device)[rows]
        attention = (None if placed_t is not None else family.attention_fn_for(
            config_target, prompt.shape[1], mesh.device))
        out = speculative_generate(
            params_t, config_target, params_d, config_draft, prompt[rows],
            num_tokens, draft_tokens=draft_tokens, attention_fn=attention,
            lengths=lengths, temperature=temperature,
            generator=rng if temperature > 0.0 else None, top_k=top_k,
            top_p=top_p, eos_id=eos_id, quantized_cache=quantized_cache,
            prefix_cache=placed_t, draft_prefix_cache=placed_d, tp=tp,
            draw=(rows.start, batch), all_done=all_done,
        )
        return gather_rows(mesh, out)

    return run
