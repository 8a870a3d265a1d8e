"""Autoregressive decoding with a KV cache.

Counterpart of ``kube_sqs_autoscaler_tpu/workloads/decode.py`` (the
full-precision GPT path): the prompt runs through one causal forward that
fills a cache pre-allocated at ``max_seq_len`` (:func:`prefill`; its
attention is the seam, the flash kernel on the card), then each generated
token runs the single-position path against the cache
(:func:`decode_step`), and :func:`generate` loops the two.
:func:`block_decode` advances the continuous batcher's slots a block of
tokens at a time with their liveness on the device, and
:func:`gang_block_decode` does it for the sharded plane's ``S`` engine
shards in one call; both take the model family's decode step as
``step_fn`` (the llama family's is ``llama.llama_decode_step``, which
reuses the masked cache attention here, its sliding window and grouped
queries included).

Unlike the reference's pure functions, the port writes the cache **in
place**: :func:`prefill` fills a fresh cache and :func:`decode_step`
writes each row's new k/v into the cache it is given and returns that
same cache object with its ``length`` advanced.  A caller that needs the
old cache must clone it first.  This saves a copy of every layer's cache
per generated token.

The cached decode attention is plain PyTorch, as it is plain ``jnp`` in
the reference (not a Pallas kernel).  Sampling draws from a
``torch.Generator`` where the reference splits ``jax.random`` keys: the
same seed gives a reproducible run, not the reference's draws.
"""

from __future__ import annotations

import torch

from .model import (
    ModelConfig, _block, _dense_attention, _layer_norm, embed_tokens,
)


def init_cache(
    config: ModelConfig, batch: int, device: str | torch.device = "cuda"
) -> dict:
    """Empty KV cache: per layer ``[B, H, max_seq_len, head_dim]`` in the
    model dtype, plus per-row ``length`` (int64 ``[batch]``)."""
    shape = (batch, config.n_heads, config.max_seq_len, config.head_dim)
    return {
        "layers": [
            {
                "k": torch.zeros(shape, dtype=config.dtype, device=device),
                "v": torch.zeros(shape, dtype=config.dtype, device=device),
            }
            for _ in range(config.n_layers)
        ],
        "length": torch.zeros(batch, dtype=torch.long, device=device),
    }


def _final_logits(
    params: dict, x: torch.Tensor, last_pos: torch.Tensor | None = None
) -> torch.Tensor:
    """Readout logits ``[batch, vocab]`` (fp32) at each row's ``last_pos``
    (``None``: position -1): final LN and the tied-embedding readout,
    computed only at the rows' readout positions."""
    if last_pos is None:
        x = x[:, -1]
    else:
        x = x[torch.arange(x.shape[0], device=x.device), last_pos]
    x = _layer_norm(x, params["final_ln_scale"], params["final_ln_bias"])
    return torch.matmul(x.float(), params["embed"].float().t())


def prefill(
    params: dict,
    tokens: torch.Tensor,
    config: ModelConfig,
    attention_fn=None,
    lengths: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict]:
    """Run the prompt, filling a fresh cache.

    ``tokens``: int ``[batch, prompt_len]`` → (logits ``[batch, vocab]``
    fp32 at each row's last real position, cache with ``length`` =
    ``lengths`` or ``prompt_len``).  ``lengths`` marks right-padded ragged
    prompts; causality keeps real positions from attending the pads."""
    batch, prompt_len = tokens.shape
    if prompt_len > config.max_seq_len:
        raise ValueError(
            f"prompt length {prompt_len} exceeds max_seq_len={config.max_seq_len}"
        )
    device = tokens.device
    cache = init_cache(config, batch, device)
    inner = attention_fn or _dense_attention
    x = embed_tokens(params["embed"], tokens) + params["pos_embed"][:prompt_len]
    for layer, layer_cache in zip(params["layers"], cache["layers"]):

        def attend(q, k, v, _lc=layer_cache):
            _lc["k"][:, :, :prompt_len] = k
            _lc["v"][:, :, :prompt_len] = v
            return inner(q, k, v)

        x = _block(x, layer, config, attend)
    if lengths is None:
        cache["length"].fill_(prompt_len)
        logits = _final_logits(params, x)
    else:
        cache["length"].copy_(lengths)
        logits = _final_logits(params, x, last_pos=cache["length"] - 1)
    return logits, cache


def _masked_cache_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    valid: torch.Tensor,
) -> torch.Tensor:
    """``q`` (``[B, H, T, D]``) against a cache of ``H_kv`` heads (``H_kv``
    divides ``H``): fp32 scores, ``-inf`` where ``valid`` (broadcast to
    ``[B, H, T, S]``) is False, an fp32 softmax cast to ``q``'s dtype.  Query
    head ``h`` reads kv head ``h // (H / H_kv)``: the queries are grouped
    as ``[B, H_kv, G * T, D]`` against the compact cache, the dot products
    of the reference's repeated cache without a repeated (and upcast)
    copy; at ``H_kv = H`` the grouping is no reshape at all."""
    batch, heads, chunk, head_dim = q.shape
    kv_heads, keys = k_cache.shape[1], k_cache.shape[2]
    grouped = q.reshape(batch, kv_heads, heads // kv_heads * chunk, head_dim)
    scores = torch.matmul(
        grouped.float(), k_cache.float().transpose(-1, -2)
    ).view(batch, heads, chunk, keys) / (head_dim ** 0.5)
    scores = scores.masked_fill(~valid, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.matmul(probs.view(batch, kv_heads, -1, keys), v_cache)
    return out.view(batch, heads, chunk, head_dim)


def _chunk_cached_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    start: torch.Tensor,
    window: int | None = None,
) -> torch.Tensor:
    """``T`` query positions per row (``[B, H, T, D]`` at global positions
    ``start[b] + t``) against the padded cache: query ``t`` attends
    entries ``<= start[b] + t``, and with ``window`` only those ``> start[b]
    + t - window`` (sliding-window models)."""
    chunk = q.shape[2]
    key_pos = torch.arange(k_cache.shape[2], device=q.device)
    q_pos = start[:, None, None, None] + torch.arange(
        chunk, device=q.device
    )[None, None, :, None]
    valid = key_pos <= q_pos
    if window is not None:
        # the window's lower edge stops at the cache's last key: an idle
        # slot stepping on past the end keeps its last `window` keys and a
        # finite softmax (an empty one is NaN, which the sampler rejects)
        last = k_cache.shape[2] - 1
        valid = valid & (key_pos > q_pos.clamp(max=last) - window)
    return _masked_cache_attention(q, k_cache, v_cache, valid)


def _cached_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    length: torch.Tensor,
    window: int | None = None,
) -> torch.Tensor:
    """One query position per row (``[B, H, 1, D]``) against the cache:
    the ``T = 1`` case of :func:`_chunk_cached_attention`."""
    return _chunk_cached_attention(q, k_cache, v_cache, length, window)


def _decode_impl(
    params: dict,
    cache: dict,
    tokens: torch.Tensor,
    config: ModelConfig,
    write_and_attend,
) -> tuple[torch.Tensor, dict]:
    """The decode-step skeleton: embed at each row's position, per layer
    call ``write_and_attend(q, k, v, layer_cache, rows, pos) -> out``,
    final logits; advances ``cache["length"]`` in place."""
    pos = cache["length"]
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    x = (
        embed_tokens(params["embed"], tokens)
        + embed_tokens(params["pos_embed"], pos)
    )[:, None, :]
    for layer, layer_cache in zip(params["layers"], cache["layers"]):

        def attend(q, k, v, _lc=layer_cache):
            return write_and_attend(q, k, v, _lc, rows, pos)

        x = _block(x, layer, config, attend)
    logits = _final_logits(params, x)
    cache["length"] = pos + 1
    return logits, cache


def _write_rows(
    buf: torch.Tensor, rows: torch.Tensor, pos: torch.Tensor,
    new: torch.Tensor,
) -> None:
    """``buf[rows, :, pos] = new`` in place, except that a row at or past
    the end of the buffer writes nothing: the reference's scatter drops an
    out-of-range update.  The index is clamped into the buffer and such a
    row rewrites the value already there, so no index ever leaves the
    buffer (on the card one would be a device-side assert) and nothing
    waits for the device."""
    last = buf.shape[2] - 1
    at = pos.clamp(max=last)
    past_end = (pos > last)[:, None, None]
    buf[rows, :, at] = torch.where(past_end, buf[rows, :, at], new)


def decode_step(
    params: dict, cache: dict, tokens: torch.Tensor, config: ModelConfig
) -> tuple[torch.Tensor, dict]:
    """One step: feed ``tokens`` (int ``[batch]``, row ``b``'s token for
    position ``cache["length"][b]``), return (fp32 logits ``[batch,
    vocab]`` for each row's next position, the same cache updated in
    place).  A row at or past ``max_seq_len`` (an idle serving slot that
    keeps stepping) writes no k/v and reads the last position embedding,
    as in the reference."""

    def write_and_attend(q, k, v, layer_cache, rows, pos):
        _write_rows(layer_cache["k"], rows, pos, k[:, :, 0])
        _write_rows(layer_cache["v"], rows, pos, v[:, :, 0])
        return _cached_attention(q, layer_cache["k"], layer_cache["v"], pos)

    return _decode_impl(params, cache, tokens, config, write_and_attend)


def _mask_top_k(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Keep the ``top_k`` highest logits per row (ties at the k-th value
    all kept), ``-inf`` elsewhere."""
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def _mask_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filter: keep the smallest set of tokens whose cumulative
    probability reaches ``top_p`` (the top token always kept)."""
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    exclusive_cum = torch.cumsum(probs, dim=-1) - probs
    keep = exclusive_cum < top_p
    kth = torch.where(keep, sorted_desc, float("inf")).amin(
        dim=-1, keepdim=True
    )
    return logits.masked_fill(logits < kth, float("-inf"))


def warp_logits(
    logits: torch.Tensor, temperature: float, top_k: int, top_p: float
) -> torch.Tensor:
    """The warped sampling distribution: temperature, then top-k, then
    nucleus truncation."""
    logits = logits / temperature
    if top_k > 0:
        logits = _mask_top_k(logits, min(top_k, logits.shape[-1]))
    if top_p < 1.0:
        logits = _mask_top_p(logits, top_p)
    return logits


def _pick(
    logits: torch.Tensor,
    generator: torch.Generator | None,
    temperature: float,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """Greedy at ``temperature <= 0`` (the first maximum, as
    ``jnp.argmax``), else one draw per row from the warped distribution
    with ``generator`` (on the logits' device)."""
    if top_k < 0:
        raise ValueError(f"top_k={top_k} must be >= 0 (0 = off)")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p={top_p} must be in (0, 1] (1.0 = off)")
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(warp_logits(logits, temperature, top_k, top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def generate(
    params: dict,
    prompt: torch.Tensor,
    num_tokens: int,
    config: ModelConfig,
    *,
    temperature: float = 0.0,
    generator: torch.Generator | None = None,
    attention_fn=None,
    lengths: torch.Tensor | None = None,
    top_k: int = 0,
    top_p: float = 1.0,
    eos_id: int | None = None,
) -> torch.Tensor:
    """``num_tokens`` continuation tokens per prompt (int64 ``[batch,
    num_tokens]``): prefill, then a Python loop of decode steps.

    Greedy at ``temperature=0``, else sampled with ``generator``.
    ``lengths`` marks ragged right-padded prompts (each row continues from
    its own last real token).  Once a row emits ``eos_id`` every later
    position is ``eos_id``."""
    batch, prompt_len = prompt.shape
    if num_tokens < 1:
        raise ValueError(f"num_tokens must be >= 1, got {num_tokens}")
    if prompt_len + num_tokens > config.max_seq_len:
        raise ValueError(
            f"prefix (0) + prompt ({prompt_len}) + num_tokens "
            f"({num_tokens}) exceeds max_seq_len={config.max_seq_len}"
        )
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature sampling requires a generator")
    logits, cache = prefill(params, prompt, config, attention_fn,
                            lengths=lengths)
    token = _pick(logits, generator, temperature, top_k, top_p)
    done = (
        token == eos_id if eos_id is not None
        else torch.zeros_like(token, dtype=torch.bool)
    )
    produced = [token]
    for _ in range(num_tokens - 1):
        logits, cache = decode_step(params, cache, token, config)
        token = _pick(logits, generator, temperature, top_k, top_p)
        if eos_id is not None:
            token = torch.where(done, eos_id, token)
            done = done | (token == eos_id)
        produced.append(token)
    return torch.stack(produced, dim=1)


def block_decode(
    params: dict,
    cache: dict,
    current: torch.Tensor,
    done: torch.Tensor,
    remaining: torch.Tensor,
    keys: list,
    config: ModelConfig,
    step_fn=decode_step,
    *,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    eos_id: int | None = None,
    freeze: torch.Tensor | None = None,
    corrupt: torch.Tensor | None = None,
    health: bool = False,
):
    """Advance every live row up to ``block = len(keys)`` tokens: a Python
    loop of ``step_fn`` (the model family's decode step, :func:`decode_step`
    by default; ``llama.llama_decode_step`` for the llama family) with the
    per-row liveness kept on the device, so the host waits once per block,
    not per token (the reference's ``lax.scan``).

    Per-row state (``[batch]`` tensors the caller owns across calls):
    ``current`` the next input token, ``done`` the row emitted ``eos_id``
    or holds no request, ``remaining`` the tokens it may still emit.  A
    row is live at a step iff ``~done & (remaining > 0)``.  Live rows run
    exactly the single-step computation; frozen rows compute too (one
    batch shape) but neither emit nor spend budget, and their ``length``
    is put back, so their stray k/v write lands on a dead position.
    ``keys`` holds one sampling generator per step (``None`` entries when
    greedy).

    Liveness only falls, so each row's kept tokens are a prefix of the
    block: returns ``(cache, current, done, remaining, tokens [block,
    batch], counts [batch])`` where ``tokens[:counts[b], b]`` are row
    ``b``'s.  No step reads a device value on the host.

    The sharded plane's fault seams (unused, the loop is the same ops):

    - ``freeze`` (bool ``[batch]``): those rows are not live for the whole
      block, the wedged-shard fault;
    - ``corrupt`` (bool ``[batch]``): those rows' logits become NaN before
      the pick, the poisoned-logits fault.  Their pick reads zero logits
      instead, so a sampled pick never hands NaN to ``torch.multinomial``
      (on the card a device-side assert); the token is garbage either way
      and the caller discards it;
    - ``health=True``: also return ``bad [batch]``, set where a live row
      saw a non-finite logit (computed from the NaN logits, not the
      stand-in)."""
    pad = eos_id if eos_id is not None else 0
    emitted, lives = [], []
    bad = torch.zeros_like(done) if health else None
    for key in keys:
        live = ~done & (remaining > 0)
        if freeze is not None:
            live = live & ~freeze
        length = cache["length"]
        logits, cache = step_fn(params, cache, current, config)
        pick_from = logits
        if corrupt is not None:
            logits = logits.masked_fill(corrupt[:, None], float("nan"))
            pick_from = logits.masked_fill(corrupt[:, None], 0.0)
        if health:
            bad = bad | (live & ~torch.isfinite(logits).all(dim=-1))
        nxt = _pick(pick_from, key, temperature, top_k, top_p)
        emitted.append(torch.where(live, nxt, pad))
        if eos_id is not None:
            done = done | (live & (nxt == eos_id))
        remaining = torch.where(live, remaining - 1, remaining)
        current = torch.where(live, nxt, current)
        cache["length"] = torch.where(live, cache["length"], length)
        lives.append(live)
    counts = torch.stack(lives).sum(dim=0)
    if health:
        return (cache, current, done, remaining, torch.stack(emitted),
                counts, bad)
    return cache, current, done, remaining, torch.stack(emitted), counts


def gang_block_decode(
    params: dict,
    cache: dict,
    current: torch.Tensor,
    done: torch.Tensor,
    remaining: torch.Tensor,
    keys: list,
    shard_active: torch.Tensor,
    config: ModelConfig,
    step_fn=decode_step,
    *,
    shards: int,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    eos_id: int | None = None,
    poison: torch.Tensor | None = None,
    wedge: torch.Tensor | None = None,
):
    """Advance ``shards`` engine shards of ``B = rows / shards`` slots
    each with one :func:`block_decode` of ``step_fn`` over the flat
    ``[S*B]`` rows (the
    reference ``vmap``s it over ``[S, B]``; rows never interact, so the
    flat call computes what ``S`` independent engines would).

    ``shard_active`` (bool ``[S]``) is the scale mask: an inactive shard
    reports 0 free slots while its in-flight rows decode on (drain).
    ``poison`` / ``wedge`` (bool ``[S]``, ``None`` = healthy) are the
    shard-fault seams, passed to every row of the shard as
    :func:`block_decode`'s ``corrupt`` / ``freeze``.

    Keys: the reference folds the shard index into each block key so
    vmapped shards do not replay one stream.  Here one generator per step
    draws for all ``S*B`` rows, so every row, in every shard, already gets
    its own draws.

    Returns ``(cache, current, done, remaining, tokens [block, S*B],
    counts [S*B], free [S], bad [S])``: ``free[s]`` counts shard ``s``'s
    rows that are done or out of budget (0 for an inactive shard) and
    ``bad[s]`` says a live row of shard ``s`` saw non-finite logits.
    Both are reduced on the device, for the caller's one settle copy."""
    rows = current.shape[0]
    if rows % shards:
        raise ValueError(f"{rows} rows not divisible by {shards} shards")
    slots = rows // shards

    def per_row(mask):
        return None if mask is None else mask.repeat_interleave(slots)

    (cache, current, done, remaining, tokens, counts,
     bad_rows) = block_decode(
        params, cache, current, done, remaining, keys, config, step_fn,
        temperature=temperature, top_k=top_k, top_p=top_p, eos_id=eos_id,
        freeze=per_row(wedge), corrupt=per_row(poison), health=True,
    )
    spent = (done | (remaining <= 0)).view(shards, slots).sum(dim=1)
    free = torch.where(shard_active, spent, torch.zeros_like(spent))
    bad = bad_rows.view(shards, slots).any(dim=1)
    return cache, current, done, remaining, tokens, counts, free, bad
