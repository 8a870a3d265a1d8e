"""Autoregressive decoding with a KV cache.

Counterpart of ``kube_sqs_autoscaler_tpu/workloads/decode.py`` (its GPT
paths, on one device and over a ``(data, model)`` serving mesh,
:func:`make_serving_fns`): the prompt runs through one causal forward that
fills a cache pre-allocated at ``max_seq_len`` (:func:`prefill`; its
attention is the seam, the flash kernel on the card), then each generated
token runs the single-position path against the cache
(:func:`decode_step`), and :func:`generate` loops the two.  Each cache
layout, full precision or int8 codes with per-position scales
(:func:`quantized_prefill`, :func:`quantized_decode_step`), has the same
four entry points: a prefill, a decode step, a chunk decode that takes
``T`` tokens a row in one forward (:func:`chunk_decode`,
:func:`quantized_chunk_decode`), and a shared-prefix prefill whose
suffixes continue through the chunk decoder (:func:`prefill_prefix`,
:func:`prefill_with_prefix` and their int8 twins).
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
    ModelConfig, _block, _dense_attention, _embed, _layer_norm, unembed,
)
from .quantize import _INV_127


def init_cache(
    config: ModelConfig, batch: int, device: str | torch.device = "cuda",
    tp=None,
) -> dict:
    """Empty KV cache: per layer ``[B, H, max_seq_len, head_dim]`` in the
    model dtype, plus per-row ``length`` (int64 ``[batch]``).  ``tp``
    (:class:`.train.TensorParallel`) holds a tensor-parallel rank's
    ``H / tp`` heads."""
    heads = config.n_heads if tp is None else tp.heads(config.n_heads)
    shape = (batch, heads, config.max_seq_len, config.head_dim)
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
    params: dict, x32: torch.Tensor, dtype: torch.dtype,
    last_pos: torch.Tensor | None = None, tp=None,
) -> torch.Tensor:
    """Readout logits ``[batch, vocab]`` (fp32) at each row's ``last_pos``
    (``None``: position -1) of the last block's unrounded output ``x32``:
    final LN into the model ``dtype`` and the tied-embedding readout,
    computed only at the rows' readout positions (gathered over ``model``
    on a tensor-parallel rank)."""
    if last_pos is None:
        x32 = x32[:, -1]
    else:
        x32 = x32[torch.arange(x32.shape[0], device=x32.device), last_pos]
    x = _layer_norm(x32, params["final_ln_scale"], params["final_ln_bias"],
                    dtype)
    return unembed(x, params["embed"], tp)


def prefill(
    params: dict,
    tokens: torch.Tensor,
    config: ModelConfig,
    attention_fn=None,
    lengths: torch.Tensor | None = None,
    tp=None,
) -> tuple[torch.Tensor, dict]:
    """Run the prompt, filling a fresh cache.

    ``tokens``: int ``[batch, prompt_len]`` → (logits ``[batch, vocab]``
    fp32 at each row's last real position, cache with ``length`` =
    ``lengths`` or ``prompt_len``).  ``lengths`` marks right-padded ragged
    prompts; causality keeps real positions from attending the pads.
    ``tp`` (:class:`.train.TensorParallel`) runs a tensor-parallel rank's
    heads: its cache holds them, its logits are gathered over ``model``
    (every entry point of this module takes it)."""
    batch, prompt_len = tokens.shape
    if prompt_len > config.max_seq_len:
        raise ValueError(
            f"prompt length {prompt_len} exceeds max_seq_len={config.max_seq_len}"
        )
    device = tokens.device
    cache = init_cache(config, batch, device, tp)
    inner = attention_fn or _dense_attention
    x, x32 = _embed(params, tokens, slice(0, prompt_len), tp)
    for layer, layer_cache in zip(params["layers"], cache["layers"]):

        def attend(q, k, v, _lc=layer_cache):
            _lc["k"][:, :, :prompt_len] = k
            _lc["v"][:, :, :prompt_len] = v
            return inner(q, k, v)

        x, x32 = _block(x, layer, config, attend, x32, tp=tp)
    if lengths is None:
        cache["length"].fill_(prompt_len)
        logits = _final_logits(params, x32, x.dtype, tp=tp)
    else:
        cache["length"].copy_(lengths)
        logits = _final_logits(params, x32, x.dtype,
                               last_pos=cache["length"] - 1, tp=tp)
    return logits, cache


def _masked_cache_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    valid: torch.Tensor,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """``q`` (``[B, H, T, D]``) against a cache of ``H_kv`` heads (``H_kv``
    divides ``H``): fp32 scores, ``-inf`` where ``valid`` (broadcast to
    ``[B, H, T, S]``) is False, an fp32 softmax cast to ``q``'s dtype.  Query
    head ``h`` reads kv head ``h // (H / H_kv)``: the queries are grouped
    as ``[B, H_kv, G * T, D]`` against the compact cache, the dot products
    of the reference's repeated cache without a repeated (and upcast)
    copy; at ``H_kv = H`` the grouping is no reshape at all.

    The int8 cache passes its codes as ``k_cache`` / ``v_cache`` with their
    per-position scales ``[B, H_kv, S]``, which factor out of both
    products (the reference's factorized dequantize): the scores are
    scaled by ``k_scale`` before the ``1 / sqrt(D)``, the probabilities by
    ``v_scale`` before their cast, and the values stay codes."""
    batch, heads, chunk, head_dim = q.shape
    kv_heads, keys = k_cache.shape[1], k_cache.shape[2]
    grouped = q.reshape(batch, kv_heads, heads // kv_heads * chunk, head_dim)
    scores = torch.matmul(grouped.float(), k_cache.float().transpose(-1, -2))
    if k_scale is not None:
        scores = scores * k_scale[:, :, None, :]
    scores = scores.view(batch, heads, chunk, keys) / (head_dim ** 0.5)
    scores = scores.masked_fill(~valid, float("-inf"))
    probs = torch.softmax(scores, dim=-1).view(batch, kv_heads, -1, keys)
    if v_scale is not None:
        probs = probs * v_scale[:, :, None, :]
    out = torch.matmul(probs.to(q.dtype), v_cache.to(q.dtype))
    return out.view(batch, heads, chunk, head_dim)


def _chunk_valid(
    start: torch.Tensor, chunk: int, keys: int, window: int | None
) -> torch.Tensor:
    """The ``[B, 1, T, S]`` mask of ``T`` queries at ``start[b] + t``
    against ``S`` cache positions: entries ``<= start[b] + t``, and with
    ``window`` only those ``> start[b] + t - window``.  The window's lower
    edge stops at the cache's last key: an idle slot stepping on past the
    end keeps its last ``window`` keys and a finite softmax (an empty one
    is NaN, which the sampler rejects).  The reference has no such clamp;
    positions inside the cache are unchanged by it."""
    key_pos = torch.arange(keys, device=start.device)
    q_pos = start[:, None, None, None] + torch.arange(
        chunk, device=start.device
    )[None, None, :, None]
    valid = key_pos <= q_pos
    if window is not None:
        valid = valid & (key_pos > q_pos.clamp(max=keys - 1) - window)
    return valid


def _chunk_cached_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    start: torch.Tensor,
    window: int | None = None,
) -> torch.Tensor:
    """``T`` query positions per row (``[B, H, T, D]`` at global positions
    ``start[b] + t``) against the padded cache, masked by
    :func:`_chunk_valid` (the sliding window included)."""
    valid = _chunk_valid(start, q.shape[2], k_cache.shape[2], window)
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


def _quantized_chunk_cached_attention(
    q: torch.Tensor,
    layer_cache: dict,
    start: torch.Tensor,
    window: int | None = None,
) -> torch.Tensor:
    """:func:`_chunk_cached_attention` over an int8 cache entry
    (``k_codes``, ``k_scale``, ``v_codes``, ``v_scale``; compact GQA heads
    included), the scales factored out of both products."""
    valid = _chunk_valid(start, q.shape[2], layer_cache["k_codes"].shape[2],
                         window)
    return _masked_cache_attention(
        q, layer_cache["k_codes"], layer_cache["v_codes"], valid,
        k_scale=layer_cache["k_scale"], v_scale=layer_cache["v_scale"],
    )


def _decode_impl(
    params: dict,
    cache: dict,
    tokens: torch.Tensor,
    config: ModelConfig,
    write_and_attend,
    tp=None,
) -> tuple[torch.Tensor, dict]:
    """The decode-step skeleton: embed at each row's position, per layer
    call ``write_and_attend(q, k, v, layer_cache, rows, pos) -> out``,
    final logits; advances ``cache["length"]`` in place."""
    pos = cache["length"]
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    x, x32 = (t[:, None, :] for t in _embed(params, tokens, pos, tp))
    for layer, layer_cache in zip(params["layers"], cache["layers"]):

        def attend(q, k, v, _lc=layer_cache):
            return write_and_attend(q, k, v, _lc, rows, pos)

        x, x32 = _block(x, layer, config, attend, x32, tp=tp)
    logits = _final_logits(params, x32, x.dtype, tp=tp)
    cache["length"] = pos + 1
    return logits, cache


def _write_positions(
    buf: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
    new: torch.Tensor,
) -> None:
    """``buf[rows, :, cols] = new`` in place: ``buf`` is a ``[B, H, S, D]``
    cache buffer or a ``[B, H, S]`` scale buffer, ``rows`` ``[B, 1]``,
    ``cols`` ``[B, T]`` each row's consecutive positions and ``new`` ``[B,
    T, H(, D)]``.  A position past the end of the buffer writes nothing:
    the reference's scatter drops an out-of-range update.  Such a write is
    clamped to the last position and carries what that position holds
    after the call (the chunk's own entry for it, else its old value), so
    no index leaves the buffer (on the card one would be a device-side
    assert), duplicates agree, and nothing waits for the device."""
    last = buf.shape[2] - 1
    new = new.to(buf.dtype)
    past_end = cols > last  # [B, T]
    first = cols[:, :1]
    # the chunk entry that lands on the last position, where one does
    t_last = (last - first).clamp(0, cols.shape[1] - 1)
    tail = [1] * (new.dim() - 2)
    landing = new.gather(1, t_last.view(-1, 1, *tail).expand(
        -1, 1, *new.shape[2:]))
    held = buf[rows[:, 0], :, last].unsqueeze(1)
    final = torch.where((first <= last).view(-1, 1, *tail), landing, held)
    value = torch.where(past_end.view(*past_end.shape, *tail), final, new)
    buf[rows, :, cols.clamp(max=last)] = value


def _write_rows(
    buf: torch.Tensor, rows: torch.Tensor, pos: torch.Tensor,
    new: torch.Tensor,
) -> None:
    """``buf[rows, :, pos] = new`` in place for one position a row
    (``rows``, ``pos`` ``[B]``; ``new`` ``[B, H, D]`` for a cache buffer,
    ``[B, H]`` for an int8 cache's scales), except that a row at or past
    the end of the buffer writes nothing: the reference's scatter drops an
    out-of-range update.  The index is clamped into the buffer and such a
    row rewrites the value already there, so no index ever leaves the
    buffer (on the card one would be a device-side assert) and nothing
    waits for the device.  (:func:`_write_positions` is the chunk form.)"""
    last = buf.shape[2] - 1
    at = pos.clamp(max=last)
    past_end = (pos > last).view(-1, *([1] * (new.dim() - 1)))
    buf[rows, :, at] = torch.where(past_end, buf[rows, :, at], new)


def decode_step(
    params: dict, cache: dict, tokens: torch.Tensor, config: ModelConfig,
    tp=None,
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

    return _decode_impl(params, cache, tokens, config, write_and_attend, tp)


# ---------------------------------------------------------------------------
# int8 KV cache
# ---------------------------------------------------------------------------
#
# The cache as int8 codes with one fp32 scale per (row, head, position)
# vector, the reference's layout (``decode.py:211-392``).  The scales factor
# out of both attention products (:func:`_masked_cache_attention`), so the
# products run on the codes and the dequantize is an elementwise scale of
# the ``[B, H, T, S]`` scores and probabilities.


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-position symmetric int8 of a ``[..., T, D]`` k/v slice:
    (codes ``int8 [..., T, D]``, scale ``fp32 [..., T]``), bitwise the
    reference's compiled program's on the same fp32 values (the scale as
    :func:`.quantize._quantize_arrays` computes it)."""
    x32 = x.float()
    max_abs = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(max_abs * _INV_127, min=1e-12)
    codes = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return codes, scale[..., 0]


def quantize_cache(cache: dict) -> dict:
    """A filled full-precision cache -> its int8 form (codes and scales a
    layer, the same ``length``)."""
    layers = []
    for lc in cache["layers"]:
        k_codes, k_scale = quantize_kv(lc["k"])
        v_codes, v_scale = quantize_kv(lc["v"])
        layers.append({"k_codes": k_codes, "k_scale": k_scale,
                       "v_codes": v_codes, "v_scale": v_scale})
    return {"layers": layers, "length": cache["length"]}


def init_quantized_cache(
    config, batch: int, kv_heads: int | None = None,
    device: str | torch.device = "cuda", tp=None,
) -> dict:
    """An empty int8 cache: zero codes and the floor scale ``1e-12``
    (exactly :func:`quantize_kv` of zeros), ``[B, H, max_seq_len, D]`` and
    ``[B, H, max_seq_len]`` a layer; ``kv_heads`` sets the head count of
    the llama family's compact GQA layout, ``tp`` a tensor-parallel rank's
    share of it."""
    heads = kv_heads if kv_heads is not None else config.n_heads
    if tp is not None:
        heads = tp.heads(heads)
    shape = (batch, heads, config.max_seq_len, config.head_dim)
    return {
        "layers": [
            {
                "k_codes": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.full(shape[:3], 1e-12, dtype=torch.float32,
                                      device=device),
                "v_codes": torch.zeros(shape, dtype=torch.int8, device=device),
                "v_scale": torch.full(shape[:3], 1e-12, dtype=torch.float32,
                                      device=device),
            }
            for _ in range(config.n_layers)
        ],
        "length": torch.zeros(batch, dtype=torch.long, device=device),
    }


def quantized_prefill(
    params: dict,
    tokens: torch.Tensor,
    config: ModelConfig,
    attention_fn=None,
    lengths: torch.Tensor | None = None,
    tp=None,
) -> tuple[torch.Tensor, dict]:
    """:func:`prefill` with the filled cache quantized to int8: the prompt
    pass runs in full precision (through the flash forward on the card),
    the decode steps that follow read int8."""
    logits, cache = prefill(params, tokens, config, attention_fn, lengths,
                            tp)
    return logits, quantize_cache(cache)


def _quantized_write_and_attend(window: int | None = None):
    """The int8 write-and-attend both families' decode skeletons take:
    quantize each row's new k/v vector, write codes and scales at its
    position (a row past the end writes nothing), attend with the scales
    factored out.  The compact GQA cache needs no expansion: the grouped
    attention reads it as it is."""

    def write_and_attend(q, k, v, layer_cache, rows, pos):
        kc, ks = quantize_kv(k[:, :, 0])  # [B, H, D] -> codes, [B, H]
        vc, vs = quantize_kv(v[:, :, 0])
        _write_rows(layer_cache["k_codes"], rows, pos, kc)
        _write_rows(layer_cache["k_scale"], rows, pos, ks)
        _write_rows(layer_cache["v_codes"], rows, pos, vc)
        _write_rows(layer_cache["v_scale"], rows, pos, vs)
        return _quantized_chunk_cached_attention(q, layer_cache, pos, window)

    return write_and_attend


def quantized_decode_step(
    params: dict, cache: dict, tokens: torch.Tensor, config: ModelConfig,
    tp=None,
) -> tuple[torch.Tensor, dict]:
    """:func:`decode_step` against the int8 cache (the same skeleton and
    the same ragged per-row contract)."""
    return _decode_impl(params, cache, tokens, config,
                        _quantized_write_and_attend(), tp)


# ---------------------------------------------------------------------------
# Chunk decode: T tokens a row in one forward
# ---------------------------------------------------------------------------


def _full_chunk_write_and_attend(window: int | None = None):
    """The full-precision chunk write-and-attend of both families' chunk
    decoders: write the ``[B, H, T, D]`` chunk's k/v at each row's
    ``cols`` in place (positions past the end drop), attend."""

    def write_and_attend(q, k, v, layer_cache, rows, cols, start):
        _write_positions(layer_cache["k"], rows, cols, k.transpose(1, 2))
        _write_positions(layer_cache["v"], rows, cols, v.transpose(1, 2))
        return _chunk_cached_attention(q, layer_cache["k"], layer_cache["v"],
                                       start, window)

    return write_and_attend


def _quantized_chunk_write_and_attend(window: int | None = None):
    """The int8 chunk write-and-attend of both families: quantize the
    chunk's k/v per position (the codes ``T`` :func:`quantized_decode_step`
    calls would write), write codes and scales at each row's ``cols``,
    attend with the scales factored out."""

    def write_and_attend(q, k, v, layer_cache, rows, cols, start):
        for name, x in (("k", k), ("v", v)):
            codes, scale = quantize_kv(x)  # [B, H, T, D], [B, H, T]
            _write_positions(layer_cache[f"{name}_codes"], rows, cols,
                             codes.transpose(1, 2))
            _write_positions(layer_cache[f"{name}_scale"], rows, cols,
                             scale.transpose(1, 2))
        return _quantized_chunk_cached_attention(q, layer_cache, start,
                                                 window)

    return write_and_attend


def _chunk_positions(cache: dict, tokens: torch.Tensor):
    """``(start [B], rows [B, 1], cols [B, T])`` of a chunk appended at
    each row's cache length."""
    start = cache["length"]
    rows = torch.arange(tokens.shape[0], device=tokens.device)[:, None]
    cols = start[:, None] + torch.arange(tokens.shape[1],
                                         device=tokens.device)[None, :]
    return start, rows, cols


def _chunk_decode_impl(
    params: dict,
    cache: dict,
    tokens: torch.Tensor,
    config: ModelConfig,
    write_and_attend,
    tp=None,
) -> tuple[torch.Tensor, dict]:
    """The GPT chunk-decode skeleton both cache layouts share: embed at
    each row's chunk positions, per layer ``write_and_attend(q, k, v,
    layer_cache, rows, cols, start) -> out``, logits at every position;
    advances ``cache["length"]`` by ``T``."""
    start, rows, cols = _chunk_positions(cache, tokens)
    x, x32 = _embed(params, tokens, cols, tp)
    for layer, layer_cache in zip(params["layers"], cache["layers"]):

        def attend(q, k, v, _lc=layer_cache):
            return write_and_attend(q, k, v, _lc, rows, cols, start)

        x, x32 = _block(x, layer, config, attend, x32, tp=tp)
    x = _layer_norm(x32, params["final_ln_scale"], params["final_ln_bias"],
                    x.dtype)
    cache["length"] = start + tokens.shape[1]
    return unembed(x, params["embed"], tp), cache


def chunk_decode(
    params: dict, cache: dict, tokens: torch.Tensor, config: ModelConfig,
    tp=None,
) -> tuple[torch.Tensor, dict]:
    """Decode a ``T``-token chunk a row in one forward: ``tokens`` (int
    ``[B, T]``) are row ``b``'s inputs at positions ``cache["length"][b]``
    onward.  Returns (fp32 logits ``[B, T, vocab]``, entry ``t`` the
    next-token distribution after input ``t``; the same cache, written in
    place and advanced by ``T``): what ``T`` :func:`decode_step` calls
    compute, the keys in the same slots and the mask causal."""
    return _chunk_decode_impl(params, cache, tokens, config,
                              _full_chunk_write_and_attend(), tp)


def quantized_chunk_decode(
    params: dict, cache: dict, tokens: torch.Tensor, config: ModelConfig,
    tp=None,
) -> tuple[torch.Tensor, dict]:
    """:func:`chunk_decode` against the int8 cache: the chunk's k/v
    quantized per position (the codes ``T`` :func:`quantized_decode_step`
    calls would write), attended with the scales factored out."""
    return _chunk_decode_impl(params, cache, tokens, config,
                              _quantized_chunk_write_and_attend(), tp)


# ---------------------------------------------------------------------------
# Prefix caching: one prompt prefix's KV shared across requests
# ---------------------------------------------------------------------------


def _prefill_prefix_impl(prefill_fn, params, prefix, config,
                         attention_fn=None, tp=None) -> dict:
    """The prefix build all four family and layout variants share: the
    prefix as a batch-1 prompt on the params' device, prefilled with
    ``prefill_fn``; returns the cache."""
    device = params["embed"].device
    prefix = torch.as_tensor(prefix, dtype=torch.long, device=device)
    if prefix.dim() == 1:
        prefix = prefix[None, :]
    _, cache = prefill_fn(params, prefix, config, attention_fn, tp=tp)
    return cache


def prefill_prefix(
    params: dict, prefix, config: ModelConfig, attention_fn=None, tp=None
) -> dict:
    """The KV cache of a shared prompt prefix, computed once: ``prefix``
    (int ``[P]`` or ``[1, P]``) -> a batch-1 cache at ``length == P`` for
    :func:`prefill_with_prefix`.  ``attention_fn`` is the prompt pass's
    (the flash forward on the card, whose ragged edge takes any ``P``)."""
    return _prefill_prefix_impl(prefill, params, prefix, config,
                                attention_fn, tp)


def quantized_prefill_prefix(
    params: dict, prefix, config: ModelConfig, attention_fn=None, tp=None
) -> dict:
    """:func:`prefill_prefix` in the int8 layout.  Per-position
    quantization is position-local, so these codes are what
    :func:`quantized_prefill` of any prompt that starts with the prefix
    writes at the same positions."""
    return _prefill_prefix_impl(quantized_prefill, params, prefix, config,
                                attention_fn, tp)


def broadcast_prefix(prefix_cache: dict, batch: int) -> dict:
    """A batch-1 prefix cache -> a batch-``B`` cache, one copy a row (each
    row decodes into its own slots past the prefix, in place, so the
    shared prefix is never written)."""

    def rows(leaf):
        return leaf.expand(batch, *leaf.shape[1:]).clone()

    return {
        "layers": [{name: rows(leaf) for name, leaf in layer.items()}
                   for layer in prefix_cache["layers"]],
        "length": rows(prefix_cache["length"]),
    }


def _prefill_with_prefix_impl(
    chunk_decode_fn,
    params: dict,
    prefix_cache: dict,
    tokens: torch.Tensor,
    config,
    lengths: torch.Tensor | None = None,
    tp=None,
) -> tuple[torch.Tensor, dict]:
    """The suffix continuation both families share (``chunk_decode_fn``
    is the family's and layout's chunk decoder): broadcast the prefix, run
    the suffix chunk, read out each row's last real position, and set the
    ragged rows' lengths."""
    batch = tokens.shape[0]
    cache = broadcast_prefix(prefix_cache, batch)
    start = cache["length"]
    logits_all, cache = chunk_decode_fn(params, cache, tokens, config, tp=tp)
    if lengths is None:
        return logits_all[:, -1], cache
    lengths = lengths.long()
    logits = logits_all[torch.arange(batch, device=tokens.device),
                        lengths - 1]
    cache["length"] = start + lengths
    return logits, cache


def prefill_with_prefix(
    params: dict,
    prefix_cache: dict,
    tokens: torch.Tensor,
    config: ModelConfig,
    lengths: torch.Tensor | None = None,
    tp=None,
) -> tuple[torch.Tensor, dict]:
    """Per-request suffixes (int ``[B, T]``, at positions ``[P, P + T)``)
    continued from a shared prefix's cache in one :func:`chunk_decode`:
    the attention :func:`prefill` of the concatenated prompts computes, up
    to summation order (the chunk path's softmax runs over the masked
    cache axis).  ``lengths`` marks ragged right-padded suffixes.  Returns
    (readout logits ``[B, vocab]``, a cache at ``P + T`` or ``P +
    lengths[b]`` a row).  The suffix launches no kernel, as in the
    reference."""
    return _prefill_with_prefix_impl(chunk_decode, params, prefix_cache,
                                     tokens, config, lengths, tp)


def quantized_prefill_with_prefix(
    params: dict,
    prefix_cache: dict,
    tokens: torch.Tensor,
    config: ModelConfig,
    lengths: torch.Tensor | None = None,
    tp=None,
) -> tuple[torch.Tensor, dict]:
    """:func:`prefill_with_prefix` over the int8 layout (the prefix from
    :func:`quantized_prefill_prefix`; the suffix quantizes its own
    positions as it writes them)."""
    return _prefill_with_prefix_impl(quantized_chunk_decode, params,
                                     prefix_cache, tokens, config, lengths,
                                     tp)


def prefix_len_of(prefix_cache: dict | None) -> int:
    """The number of positions a prefix cache holds (0 for none), read on
    the host."""
    return 0 if prefix_cache is None else int(prefix_cache["length"][0])


def _check_prefix_layout(prefix_cache: dict, quantized: bool) -> None:
    """A prefix cache must be in the decode path's layout: int8 codes and
    scales for an int8 decode, full-precision k/v otherwise."""
    is_quantized = "k_codes" in prefix_cache["layers"][0]
    if is_quantized != quantized:
        want = "quantized (int8)" if quantized else "full-precision"
        got = "quantized (int8)" if is_quantized else "full-precision"
        raise ValueError(
            f"prefix cache layout mismatch: this decode path needs a "
            f"{want} prefix cache but was given a {got} one (build it "
            f"with the matching prefill_prefix variant)"
        )


def _check_prefix_budget(
    prefix_cache: dict | None, prompt_len: int, num_tokens: int, config,
    slack: int = 0, slack_label: str = "", model_name: str = "",
) -> None:
    """The generate entry's bound: prefix + prompt + num_tokens (+
    ``slack``, labeled ``slack_label``: the speculative entry's 2k draft
    window) within ``max_seq_len``; ``model_name`` names whose bound it
    is."""
    prefix_len = prefix_len_of(prefix_cache)
    if prefix_len + prompt_len + num_tokens + slack > config.max_seq_len:
        extra = f" + {slack_label} ({slack})" if slack else ""
        owner = f"the {model_name} model's " if model_name else ""
        raise ValueError(
            f"prefix ({prefix_len}) + prompt ({prompt_len}) + num_tokens "
            f"({num_tokens}){extra} exceeds "
            f"{owner}max_seq_len={config.max_seq_len}"
        )


def _rank_kw(tp) -> dict:
    """The ``tp=`` keyword of a family entry point, only on a
    tensor-parallel rank (the single-device callers' step functions take
    none)."""
    return {} if tp is None else {"tp": tp}


def _generate_loop(
    step_fn, params, cache, logits, num_tokens, config, generator,
    temperature, top_k, top_p, eos_id, tp=None, draw=None,
) -> torch.Tensor:
    """The decode loop both families' generate run after their prefill:
    pick, then ``num_tokens - 1`` steps; rows that emitted ``eos_id`` pad
    with it.  ``tp`` and ``draw`` are a mesh rank's (:func:`_pick`)."""
    token = _pick(logits, generator, temperature, top_k, top_p, draw)
    done = (
        token == eos_id if eos_id is not None
        else torch.zeros_like(token, dtype=torch.bool)
    )
    produced = [token]
    for _ in range(num_tokens - 1):
        logits, cache = step_fn(params, cache, token, config, **_rank_kw(tp))
        token = _pick(logits, generator, temperature, top_k, top_p, draw)
        if eos_id is not None:
            token = torch.where(done, eos_id, token)
            done = done | (token == eos_id)
        produced.append(token)
    return torch.stack(produced, dim=1)


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
    draw: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Greedy at ``temperature <= 0`` (the first maximum, as
    ``jnp.argmax``), else one draw per row from the warped distribution
    with ``generator`` (on the logits' device).

    ``draw = (start, total)`` says the rows are ``[start, start + B)`` of
    a batch of ``total`` rows split over a mesh's ``data`` axis: the rank
    draws the whole batch's noise from ``generator`` and keeps its rows.
    ``torch.multinomial`` draws one sample as the argmax of ``probs / q``
    with ``q`` exponential noise of the batch's shape, so every rank's
    rows get the tokens one process sampling the whole batch with the
    same generator would."""
    if top_k < 0:
        raise ValueError(f"top_k={top_k} must be >= 0 (0 = off)")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p={top_p} must be in (0, 1] (1.0 = off)")
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(warp_logits(logits, temperature, top_k, top_p), dim=-1)
    return sample_rows(probs, generator, draw)


def sample_rows(probs: torch.Tensor, generator,
                draw: tuple[int, int] | None = None) -> torch.Tensor:
    """One draw a row from ``probs`` ``[B, V]`` (any non-negative
    weights): ``torch.multinomial``, or with ``draw = (start, total)`` the
    rows' share of one multinomial draw over a ``total``-row batch
    (:func:`_pick`)."""
    if draw is None:
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    start, total = draw
    noise = torch.empty((total, probs.shape[-1]), dtype=probs.dtype,
                        device=probs.device).exponential_(1,
                                                          generator=generator)
    return torch.argmax(probs / noise[start:start + probs.shape[0]], dim=-1)


def uniform_rows(shape: tuple[int, ...], generator, device,
                 draw: tuple[int, int] | None = None) -> torch.Tensor:
    """``torch.rand(shape)`` of ``shape[0]`` rows, or with ``draw = (start,
    total)`` those rows of one draw over a ``total``-row batch."""
    if draw is None:
        return torch.rand(shape, generator=generator, device=device)
    start, total = draw
    return torch.rand((total, *shape[1:]), generator=generator,
                      device=device)[start:start + shape[0]]


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
    quantized_cache: bool = False,
    prefix_cache: dict | None = None,
    tp=None,
    draw: tuple[int, int] | None = None,
) -> torch.Tensor:
    """``num_tokens`` continuation tokens per prompt (int64 ``[batch,
    num_tokens]``): prefill, then a Python loop of decode steps.

    Greedy at ``temperature=0``, else sampled with ``generator``.
    ``lengths`` marks ragged right-padded prompts (each row continues from
    its own last real token).  Once a row emits ``eos_id`` every later
    position is ``eos_id``.  ``quantized_cache=True`` decodes through the
    int8 cache; ``prefix_cache`` (from :func:`prefill_prefix`, or
    :func:`quantized_prefill_prefix` with ``quantized_cache``) prepends a
    shared prefix, the ``prompt`` rows being the per-request suffixes.
    On a mesh rank (:func:`make_serving_fns`) ``tp`` runs its heads and
    ``draw`` places its rows in the batch (:func:`_pick`)."""
    batch, prompt_len = prompt.shape
    if num_tokens < 1:
        raise ValueError(f"num_tokens must be >= 1, got {num_tokens}")
    _check_prefix_budget(prefix_cache, prompt_len, num_tokens, config)
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature sampling requires a generator")
    if prefix_cache is not None:
        if attention_fn is not None:
            raise ValueError(
                "attention_fn does not apply with prefix_cache (the "
                "suffix prefill runs the chunk decoder); drop one"
            )
        _check_prefix_layout(prefix_cache, quantized_cache)
        pf = (quantized_prefill_with_prefix if quantized_cache
              else prefill_with_prefix)
        logits, cache = pf(params, prefix_cache, prompt, config,
                           lengths=lengths, tp=tp)
    else:
        prefill_fn = quantized_prefill if quantized_cache else prefill
        logits, cache = prefill_fn(params, prompt, config, attention_fn,
                                   lengths=lengths, tp=tp)
    step_fn = quantized_decode_step if quantized_cache else decode_step
    return _generate_loop(step_fn, params, cache, logits, num_tokens, config,
                          generator, temperature, top_k, top_p, eos_id, tp,
                          draw)


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
    tp=None,
    draw: tuple[int, int] | None = None,
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
      stand-in).

    ``tp`` and ``draw`` are a mesh rank's (its heads, its rows' place in
    the batch; :func:`_pick`)."""
    pad = eos_id if eos_id is not None else 0
    emitted, lives = [], []
    bad = torch.zeros_like(done) if health else None
    for key in keys:
        live = ~done & (remaining > 0)
        if freeze is not None:
            live = live & ~freeze
        length = cache["length"]
        logits, cache = step_fn(params, cache, current, config,
                                **_rank_kw(tp))
        pick_from = logits
        if corrupt is not None:
            logits = logits.masked_fill(corrupt[:, None], float("nan"))
            pick_from = logits.masked_fill(corrupt[:, None], 0.0)
        if health:
            bad = bad | (live & ~torch.isfinite(logits).all(dim=-1))
        nxt = _pick(pick_from, key, temperature, top_k, top_p, draw)
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
    tp=None,
    draw: tuple[int, int] | None = None,
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
    Both are reduced on the device, for the caller's one settle copy.
    ``tp`` and ``draw`` pass to :func:`block_decode`."""
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
        tp=tp, draw=draw,
    )
    spent = (done | (remaining <= 0)).view(shards, slots).sum(dim=1)
    free = torch.where(shard_active, spent, torch.zeros_like(spent))
    bad = bad_rows.view(shards, slots).any(dim=1)
    return cache, current, done, remaining, tokens, counts, free, bad


# ---------------------------------------------------------------------------
# Serving over a (data, model) mesh
# ---------------------------------------------------------------------------
#
# The reference compiles its serving functions over a GSPMD mesh.  Here each
# rank is a process (:mod:`.distributed`) that holds its slices of the
# weights (:func:`.train.shard_params`), its batch rows over ``data`` and its
# heads over ``model``, in the reference's layout (``decode.py:1159``):
# positions whole, the vocabulary over ``model``.  A rank runs the family's
# entry points with ``tp`` (the Megatron collectives around each block, the
# vocabulary-parallel lookup, the readout's logits all-gathered over
# ``model``), so every rank of a model group picks the same token.  What
# the caller sees is global, as the reference's arrays are: every rank gets
# the whole batch in and the whole batch back (an all-gather over ``data``).


def require_serving_mesh(mesh) -> None:
    """The one serving-mesh contract check: decode needs a ``(data,
    model)`` mesh — ring/sequence parallelism applies to training and
    prefill, not token-by-token decode.  Shared by every sharded serving
    factory (generate, beams, continuous slots)."""
    if mesh.shape.get("seq", 1) != 1:
        raise ValueError(
            "serving uses a (data, model) mesh; got seq="
            f"{mesh.shape['seq']} (ring/sequence parallelism applies to "
            "training and prefill, not token-by-token decode)"
        )


def rank_rows(mesh, batch: int) -> slice:
    """This rank's rows of a ``batch``-row global batch over ``data``."""
    ax = mesh.axis("data")
    if batch % ax.size:
        raise ValueError(
            f"batch {batch} not divisible by the mesh's data axis "
            f"({ax.size})"
        )
    rows = batch // ax.size
    return slice(ax.index * rows, (ax.index + 1) * rows)


def _rank_heads(mesh, heads: int) -> slice:
    ax = mesh.axis("model")
    if heads % ax.size:
        raise ValueError(
            f"{heads} cache heads not divisible by the mesh's model axis "
            f"({ax.size})"
        )
    per = heads // ax.size
    return slice(ax.index * per, (ax.index + 1) * per)


def gather_rows(mesh, x: torch.Tensor) -> torch.Tensor:
    """The global batch from every data rank's rows (all-gather over
    ``data``, concatenated on dim 0 in rank order)."""
    ax = mesh.axis("data")
    if ax.size == 1:
        return x
    return torch.cat(mesh.transport.all_gather(x, ax.group, ax.size), dim=0)


def prefix_cache_shardings(mesh, prefix_cache: dict) -> dict:
    """A rank's shard of a batch-1 prefix cache: its heads over ``model``
    (both layouts: bf16 ``k``/``v`` ``[1, H, S, D]``, int8 codes with
    scales ``[1, H, S]``), the batch whole: the one shared row that
    :func:`broadcast_prefix` expands to the rank's rows.  (The reference's
    ``cache_shardings`` has no counterpart: a rank's own cache is built at
    its rows and heads, :func:`init_cache` and
    :func:`init_quantized_cache` with ``tp``.)"""

    def shard(leaf):
        return leaf[:, _rank_heads(mesh, leaf.shape[1])].to(
            mesh.device).contiguous()

    return {
        "layers": [{name: shard(leaf) for name, leaf in layer.items()}
                   for layer in prefix_cache["layers"]],
        "length": prefix_cache["length"].to(mesh.device).clone(),
    }


def compile_serving_fns(
    mesh,
    prefill_fn,
    decode_fn,
    generate_fn,
    prefix_cache: dict | None = None,
):
    """The family-agnostic serving wiring over a mesh (one implementation
    for the gpt and llama families; only the family ops differ).

    Requires a serving mesh (:func:`require_serving_mesh`).  Family ops
    (config bound) take the rank's rows and ``tp``:
    ``prefill_fn(params, tokens, tp)``, ``decode_fn(params, cache, token,
    tp)`` and ``generate_fn(params, prompt, num_tokens, temperature,
    generator, lengths, top_k, top_p, eos_id, prefix_cache, tp, draw)``.
    ``prefix_cache`` (a full batch-1 cache from the family's
    ``prefill_prefix``, in the decode layout) is placed once as the rank's
    heads (:func:`prefix_cache_shardings`) and every prompt row continues
    from it.

    Returns ``(prefill, decode_step, generate)``, the reference's
    contract on global inputs: ``prefill(params, tokens)`` -> (logits
    ``[B, V]``, the rank's cache), ``decode_step(params, cache, tokens)``
    -> (logits ``[B, V]``, the cache advanced), and ``generate(params,
    prompt, rng, lengths, num_tokens, temperature=0.0, top_k=0, top_p=1.0,
    eos_id=None)`` -> tokens ``[B, num_tokens]``, all positional as in the
    reference (``rng`` a :class:`torch.Generator`, ignored under greedy;
    ``lengths`` each row's real prompt length).  Every rank calls each
    with the same arguments; each computes its rows and heads, and the
    results are all-gathered over ``data``.  Sampled tokens equal one
    process's for the same generator seed (:func:`_pick`'s ``draw``)."""
    from .train import tensor_parallel

    require_serving_mesh(mesh)
    tp = tensor_parallel(mesh)
    placed = (None if prefix_cache is None
              else prefix_cache_shardings(mesh, prefix_cache))
    device = mesh.device

    def prefill_mesh(params, tokens):
        tokens = torch.as_tensor(tokens, device=device)
        rows = rank_rows(mesh, tokens.shape[0])
        logits, cache = prefill_fn(params, tokens[rows], tp)
        return gather_rows(mesh, logits), cache

    def decode_mesh(params, cache, tokens):
        tokens = torch.as_tensor(tokens, device=device)
        rows = rank_rows(mesh, tokens.shape[0])
        logits, cache = decode_fn(params, cache, tokens[rows], tp)
        return gather_rows(mesh, logits), cache

    def generate_mesh(params, prompt, rng, lengths, num_tokens,
                      temperature=0.0, top_k=0, top_p=1.0, eos_id=None):
        prompt = torch.as_tensor(prompt, device=device)
        batch = prompt.shape[0]
        rows = rank_rows(mesh, batch)
        if lengths is not None:
            lengths = torch.as_tensor(lengths, device=device)[rows]
        out = generate_fn(params, prompt[rows], num_tokens, temperature,
                          rng if temperature > 0.0 else None, lengths,
                          top_k, top_p, eos_id, placed, tp,
                          (rows.start, batch))
        return gather_rows(mesh, out)

    return prefill_mesh, decode_mesh, generate_mesh


def make_serving_fns(
    mesh,
    config: ModelConfig,
    params: dict,
    *,
    quantized_cache: bool = False,
    prefix_cache: dict | None = None,
):
    """``(prefill, decode_step, generate)`` over the mesh for the gpt
    family (:func:`compile_serving_fns`'s contract; the llama counterpart
    is ``llama.make_llama_serving_fns``); the config's heads, vocabulary
    and ``d_ff`` must divide by the mesh's ``model`` axis.  ``params``
    stays in the reference's signature; each call takes the rank's
    weights (:func:`.train.shard_params`).  The prompt pass runs the flash
    forward on the card at the rank's heads.  ``quantized_cache=True`` serves through the int8 KV
    cache, whose codes and scales split by head like the bf16 cache;
    ``prefix_cache`` (from :func:`prefill_prefix` /
    :func:`quantized_prefill_prefix`, layout matching) pins a shared
    prompt prefix; both compose."""
    from .flash import attention_fn_for
    from .train import _check_divisible

    require_serving_mesh(mesh)
    _check_divisible(mesh, config)
    if prefix_cache is not None:
        _check_prefix_layout(prefix_cache, quantized_cache)
    pf = quantized_prefill if quantized_cache else prefill
    step = quantized_decode_step if quantized_cache else decode_step
    device = mesh.device

    def attention(tokens):
        return attention_fn_for(tokens.shape[1], device, config.head_dim)

    def prefill_fn(params, tokens, tp):
        return pf(params, tokens, config, attention(tokens), tp=tp)

    def decode_fn(params, cache, tokens, tp):
        return step(params, cache, tokens, config, tp=tp)

    def generate_fn(params, prompt, num_tokens, temperature, generator,
                    lengths, top_k, top_p, eos_id, prefix, tp, draw):
        return generate(
            params, prompt, num_tokens, config, temperature=temperature,
            generator=generator,
            attention_fn=None if prefix is not None else attention(prompt),
            lengths=lengths, top_k=top_k, top_p=top_p, eos_id=eos_id,
            quantized_cache=quantized_cache, prefix_cache=prefix, tp=tp,
            draw=draw,
        )

    return compile_serving_fns(mesh, prefill_fn, decode_fn, generate_fn,
                               prefix_cache=prefix_cache)
