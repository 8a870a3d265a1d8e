"""The llama model family: RoPE, grouped-query attention, RMSNorm, SwiGLU.

Counterpart of ``kube_sqs_autoscaler_tpu/workloads/llama.py``'s serving
path (its ``llama.py:45-786`` and ``llama_generate``), held against it by
``tests/test_torch_llama.py``.  Parameters keep the reference's names and
``[in, out]`` layout (``embed``, ``final_norm``, an optional untied
``lm_head``; per layer ``attn_norm``, ``wq``, ``wkv`` or ``wk``/``wv``,
``wo``, ``mlp_norm``, ``w_gate_up`` or ``w_gate``/``w_up``, ``w_down``).

- **GQA**: the cache holds ``n_kv_heads`` heads; query head ``h`` reads kv
  head ``h // (n_heads / n_kv_heads)``.  The prompt pass hands the compact
  k/v to the CUDA flash forward, which takes GQA natively (the dense path
  gets them repeated, :func:`.flash.gqa_adapt`).  The cached decode
  attention groups the queries against the compact cache
  (:func:`.decode._chunk_cached_attention`): the reference's ``repeat_kv``
  dot products, without a repeated copy of the cache.
- **RoPE** rotates interleaved pairs ``(x[2i], x[2i+1])`` (not the
  rotate-half layout) in fp32 and casts back to the model dtype; prefill
  positions are ``[S]``, decode positions ``[B, 1, 1]`` per row.
- **RMSNorm**: fp32 statistics, no mean and no bias, the scale multiplied
  in fp32 before the cast; ``eps`` is always ``config.rms_eps``.  A norm
  that reads a residual sum reads it unrounded, in fp32: the reference's
  compiled program fuses the add into the norm's fp32 upcast (XLA's
  default excess precision), while the residual stream itself is rounded
  to the model dtype.
- **SwiGLU**: ``silu(gate) * up`` in the model dtype, gate the first half
  of ``w_gate_up``'s output; in ``wkv`` k comes first.  ``silu`` is
  ``gate * (1 / (1 + exp(-gate)))`` rounded at each step, as XLA lowers the
  reference's ``jax.nn.silu`` for bf16.
- **Sliding window** (``config.sliding_window``) reaches the prompt pass
  through :func:`llama_attention_fn_for` and every decode step through the
  masked cache attention; the rolling-buffer cache holds only the window.

As the port's GPT cache, the cache is written in place: a decode step
writes each row's new k/v into the cache it is given and returns it.

The int8 cache (:func:`llama_quantized_prefill`,
:func:`llama_quantized_decode_step`) keeps the compact ``n_kv_heads``
heads, its codes and per-position scales read by the grouped attention as
they are (the reference expands both to full heads, ``expand_gqa``; the
products are the same).  Each layout has a chunk decoder
(:func:`llama_chunk_decode`, :func:`llama_quantized_chunk_decode`) and a
shared-prefix prefill whose suffixes continue through it
(:func:`llama_prefill_prefix`, :func:`llama_prefill_with_prefix` and
their int8 twins).

The trainer branch (:func:`llama_loss_fn`, :func:`make_llama_train_step`)
runs through :func:`.train.make_train_step`'s seams; its attention is the
GQA-native flash forward and backward on the card; on a mesh its
objective is :func:`llama_mesh_loss`'s (RoPE at the rank's positions, the
ring over compact k/v).  Over a serving mesh every cached entry point
takes ``tp`` (a rank's ``n_kv_heads / tp`` kv heads, its logits gathered
over ``model``), wired by :func:`make_llama_serving_fns`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from .decode import (
    _cached_attention, _check_prefix_budget, _check_prefix_layout,
    _chunk_positions, _full_chunk_write_and_attend, _generate_loop,
    _masked_cache_attention, _prefill_prefix_impl, _prefill_with_prefix_impl,
    _quantized_chunk_write_and_attend, _quantized_write_and_attend,
    _write_rows, init_quantized_cache, quantize_cache,
)
from .flash import attention_fn_for, gqa_adapt, windowed
from .model import _dense_attention, _residual, embed_tokens, unembed


@dataclass(frozen=True)
class LlamaConfig:
    """Llama-family dimensions (the defaults are the worker's built-in
    llama)."""

    vocab_size: int = 8192
    d_model: int = 512
    n_heads: int = 8
    n_kv_heads: int = 2  # GQA: n_heads // n_kv_heads query heads a kv head
    n_layers: int = 4
    d_ff: int = 1408
    max_seq_len: int = 1024
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-6
    # each position attends only its last sliding_window keys (None = full
    # causal), in the prompt pass and in decode alike
    sliding_window: int | None = None
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def __post_init__(self) -> None:
        if self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"n_heads={self.n_heads} must be divisible by "
                f"n_kv_heads={self.n_kv_heads}"
            )
        if self.d_model % self.n_heads:
            raise ValueError(
                f"d_model={self.d_model} must be divisible by "
                f"n_heads={self.n_heads}"
            )


def init_llama_params(
    config: LlamaConfig,
    generator: torch.Generator,
    device: str | torch.device = "cuda",
    dense_mlp: bool = True,
) -> dict:
    """Scaled-normal initialization in the reference's layout (std 0.02,
    ``0.02 / sqrt(2 * n_layers)`` on ``wo`` and ``w_down``, norms at one).
    ``generator`` is a CPU :class:`torch.Generator`: the weights are drawn
    in fp32 on the host, then cast and moved.  ``dense_mlp=False`` leaves
    out the SwiGLU weights (the reference's flag for routed experts)."""
    dtype = config.dtype
    d = config.d_model
    kv_dim = config.n_kv_heads * config.head_dim

    def normal(shape, scale):
        draw = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (draw * scale).to(device=device, dtype=dtype)

    def ones():
        return torch.ones(d, dtype=dtype, device=device)

    params = {
        "embed": normal((config.vocab_size, d), 0.02),
        "final_norm": ones(),
        "layers": [],
    }
    out_scale = 0.02 / (2 * config.n_layers) ** 0.5
    for _ in range(config.n_layers):
        layer = {
            "attn_norm": ones(),
            "wq": normal((d, d), 0.02),
            "wkv": normal((d, 2 * kv_dim), 0.02),
            "wo": normal((d, d), out_scale),
            "mlp_norm": ones(),
        }
        if dense_mlp:
            layer["w_gate_up"] = normal((d, 2 * config.d_ff), 0.02)
            layer["w_down"] = normal((config.d_ff, d), out_scale)
        params["layers"].append(layer)
    return params


def _rms_norm(
    x: torch.Tensor, scale: torch.Tensor, eps: float,
    dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """fp32 statistics, output in ``dtype`` (default ``x``'s; no mean, no
    bias)."""
    x32 = x.float()
    normed = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return (normed * scale.float()).to(dtype or x.dtype)


def readout_weights(params: dict) -> torch.Tensor:
    """The unembedding ``[vocab, d_model]``: ``lm_head`` when the params
    carry one (untied), else the tied input embedding."""
    head = params.get("lm_head")
    return head if head is not None else params["embed"]


def rope_angles(
    positions: torch.Tensor, head_dim: int, theta: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``(cos, sin)`` of shape ``[*positions.shape, head_dim / 2]``:
    position ``p``, pair ``i`` turns by ``p * theta^(-2i / head_dim)``."""
    exponents = -torch.arange(0, head_dim, 2, dtype=torch.float32,
                              device=positions.device) / head_dim
    # a Python base: a device tensor made from it would be a pageable copy,
    # which waits for the stream (a host sync every layer of every step)
    freqs = torch.pow(theta, exponents)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(
    x: torch.Tensor, positions: torch.Tensor, theta: float
) -> torch.Tensor:
    """Rotate ``[B, H, S, D]`` by per-position angles in fp32: the pairs
    ``(x[2i], x[2i+1])``.  ``positions`` is ``[S]`` (the prompt pass) or
    ``[B, 1, 1]`` (each row's decode position)."""
    return _rotate(x, rope_angles(positions, x.shape[-1], theta))


def _rotate(
    x: torch.Tensor, rope: tuple[torch.Tensor, torch.Tensor]
) -> torch.Tensor:
    """:func:`apply_rope` with the angles ``rope = (cos, sin)`` already
    built: a forward or a decode step builds them once for all its
    layers."""
    cos, sin = rope
    x32 = x.float()
    x1, x2 = x32[..., 0::2], x32[..., 1::2]
    rotated = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.reshape(x.shape).to(x.dtype)


def _split_heads(t: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    """``[B, S, n_heads * head_dim] -> [B, n_heads, S, head_dim]`` (a
    view)."""
    batch, seq, _ = t.shape
    return t.reshape(batch, seq, n_heads, head_dim).transpose(1, 2)


def _project_qkv(
    h: torch.Tensor, layer: dict, config: LlamaConfig,
    rope: tuple[torch.Tensor, torch.Tensor],
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (``n_heads``, rotated by ``rope``), k (``n_kv_heads``, rotated),
    v (``n_kv_heads``), from the fused ``wkv`` or the split ``wk``/``wv``
    layout (identical values)."""
    head_dim = config.head_dim
    q = _split_heads(h @ layer["wq"], -1, head_dim)
    if "wkv" in layer:
        k, v = torch.chunk(h @ layer["wkv"], 2, dim=-1)
    else:
        k, v = h @ layer["wk"], h @ layer["wv"]
    k = _split_heads(k, -1, head_dim)
    v = _split_heads(v, -1, head_dim)
    return _rotate(q, rope), _rotate(k, rope), v


def _swiglu(x: torch.Tensor, layer: dict) -> torch.Tensor:
    """SwiGLU from the fused ``w_gate_up`` or the split ``w_gate``/``w_up``."""
    if "w_gate_up" in layer:
        gate, up = torch.chunk(x @ layer["w_gate_up"], 2, dim=-1)
    else:
        gate, up = x @ layer["w_gate"], x @ layer["w_up"]
    silu = gate * torch.reciprocal(1 + torch.exp(-gate))
    return (silu * up) @ layer["w_down"]


def _llama_block(
    x: torch.Tensor, layer: dict, config: LlamaConfig,
    rope: tuple[torch.Tensor, torch.Tensor], attend,
    x32: torch.Tensor | None = None, mlp=None, tp=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pre-RMSNorm attention and pre-RMSNorm SwiGLU, residual around both.
    ``rope`` is the ``(cos, sin)`` of :func:`rope_angles` at the block's
    positions.  ``attend(q, k, v) -> [B, H, S, D]`` gets compact
    ``n_kv_heads`` k/v:
    the prompt pass's kernel, or a cache-writing closure in decode.
    ``x32`` is ``x`` unrounded when ``x`` is a residual sum (``None`` for
    the embeddings).  ``mlp(h, layer)`` replaces the SwiGLU (the routed
    experts of :mod:`.moe`).  ``tp`` (:class:`.train.TensorParallel`)
    runs the block on a tensor-parallel rank's slices.  Returns the
    block's output and its fp32 value."""
    dtype = x.dtype
    h = _rms_norm(x if x32 is None else x32, layer["attn_norm"],
                  config.rms_eps, dtype)
    if tp is not None:
        h = tp.copy(h)
    q, k, v = _project_qkv(h, layer, config, rope)
    out = attend(q, k, v)
    batch, _, seq, _ = out.shape
    out = out.transpose(1, 2).reshape(batch, seq, -1) @ layer["wo"]
    x, x32 = _residual(x, out if tp is None else tp.reduce(out))
    h2 = _rms_norm(x32, layer["mlp_norm"], config.rms_eps, dtype)
    if tp is None or getattr(mlp, "tp_native", False):
        return _residual(x, (mlp or _swiglu)(h2, layer))
    return _residual(x, tp.reduce((mlp or _swiglu)(tp.copy(h2), layer)))


def _gqa_dense_attention(config: LlamaConfig):
    """The window-aware dense prompt attention over compact k/v."""
    return gqa_adapt(windowed(_dense_attention, config.sliding_window))


def _prompt_attention(config: LlamaConfig, attention_fn):
    """The prompt pass's attention over compact k/v: ``attention_fn``
    adapted (:func:`.flash.gqa_adapt`: the GQA-native kernel takes them as
    they are, others get them repeated), window-aware dense when it is
    ``None``.  The one place a prompt pass adapts to GQA."""
    if attention_fn is None:
        return _gqa_dense_attention(config)
    return gqa_adapt(attention_fn)


def llama_attention_fn_for(
    config: LlamaConfig, seq_len: int, device: str | torch.device
):
    """The prompt-pass attention for ``device``: :func:`.flash.
    attention_fn_for`'s pick (the CUDA flash forward on the card, which
    takes the compact k/v as they are; dense on the CPU, which the prompt
    pass hands repeated k/v) with ``config.sliding_window`` bound in.  A
    bare ``attention_fn_for`` would prefill a windowed model
    full-causal."""
    return windowed(attention_fn_for(seq_len, device, config.head_dim),
                    config.sliding_window)


def llama_forward_hidden(
    params: dict,
    tokens: torch.Tensor,
    config: LlamaConfig,
    attention_fn=None,
    mlp=None,
    remat: bool = False,
    positions: torch.Tensor | None = None,
    tp=None,
) -> torch.Tensor:
    """Final RMS-normed hidden states ``[B, S, d_model]``.
    ``attention_fn(q, k, v)`` is the prompt-pass pick
    (:func:`llama_attention_fn_for`; window-aware dense by default),
    adapted to the compact k/v; ``mlp(h, layer)`` replaces the SwiGLU.
    ``remat=True`` recomputes each block in the backward
    (:func:`torch.utils.checkpoint.checkpoint`, the reference's
    ``jax.checkpoint``): the same values at a lower peak memory.
    ``positions`` overrides the RoPE positions (``[S]``: a
    sequence-parallel rank's global, or zig-zag-permuted, positions);
    ``tp`` runs the blocks on a tensor-parallel rank's slices."""
    seq = tokens.shape[1]
    if seq > config.max_seq_len:
        raise ValueError(
            f"sequence length {seq} exceeds max_seq_len={config.max_seq_len}"
        )
    if positions is None:
        positions = torch.arange(seq, device=tokens.device)
    rope = rope_angles(positions, config.head_dim, config.rope_theta)
    attend = _prompt_attention(config, attention_fn)
    x = (embed_tokens(params["embed"], tokens) if tp is None
         else tp.embed(params["embed"], tokens))
    x32 = None
    for layer in params["layers"]:
        if remat:
            x, x32 = checkpoint(_llama_block, x, layer, config, rope, attend,
                                x32, mlp, tp, use_reentrant=False)
        else:
            x, x32 = _llama_block(x, layer, config, rope, attend, x32, mlp,
                                  tp)
    return _rms_norm(x32, params["final_norm"], config.rms_eps, x.dtype)


def llama_forward(
    params: dict,
    tokens: torch.Tensor,
    config: LlamaConfig,
    attention_fn=None,
    mlp=None,
    tp=None,
) -> torch.Tensor:
    """Logits ``[B, S, vocab]`` (fp32 results of model-dtype operands);
    ``tp`` runs a tensor-parallel rank's slices (the logits gathered over
    ``model``)."""
    return unembed(
        llama_forward_hidden(params, tokens, config, attention_fn, mlp=mlp,
                             tp=tp),
        readout_weights(params), tp,
    )


# ---------------------------------------------------------------------------
# Training (the reference's llama.py:400-461, single device)
# ---------------------------------------------------------------------------


def llama_loss_fn(
    params: dict,
    tokens: torch.Tensor,
    config: LlamaConfig,
    attention_fn=None,
    remat: bool = False,
) -> torch.Tensor:
    """Next-token cross-entropy in fp32 through the fused readout
    (:func:`.train.fused_next_token_nll` over :func:`readout_weights`)."""
    from .train import fused_next_token_nll

    return fused_next_token_nll(
        readout_weights(params),
        llama_forward_hidden(params, tokens, config, attention_fn,
                             remat=remat),
        tokens,
    )


def init_llama_train_state(
    generator: torch.Generator, config: LlamaConfig, train_config,
    device: str | torch.device = "cuda",
) -> dict:
    """Seeded llama weights (:func:`init_llama_params`), AdamW and the
    step count."""
    from .train import init_train_state

    return init_train_state(generator, config, train_config, device,
                            init_fn=init_llama_params)


def llama_mesh_loss(config: LlamaConfig, train_config, mesh=None):
    """The family objective in :func:`.train.make_train_step`'s loss-seam
    shape, ``loss(params, tokens, attention_fn)``: the seam's attention
    (the GQA-native flash kernels on the card, which take the compact k/v;
    dense with repeated k/v elsewhere) adapted in the prompt pass, under
    ``train_config.remat``.  One objective for the full train step, the
    LoRA step and the trainer's eval.  With a ``mesh`` it is the rank's
    share of the loss (:func:`.train.mesh_loss`): RoPE at the rank's
    global positions, the ring's compact k/v, the vocabulary-parallel
    readout of :func:`readout_weights`."""
    if mesh is not None:
        from .train import mesh_loss

        return mesh_loss(config, mesh, remat=train_config.remat,
                         forward_fn=llama_forward_hidden,
                         readout_fn=readout_weights)

    def loss(params, tokens, attention_fn=None):
        return llama_loss_fn(params, tokens, config, attention_fn,
                             remat=train_config.remat)

    return loss


def make_llama_train_step(config: LlamaConfig, train_config,
                          device: str | torch.device = "cuda", mesh=None):
    """One optimizer step of the llama through
    :func:`.train.make_train_step`'s seams: :func:`llama_mesh_loss` as the
    objective and ``config.sliding_window`` bound into the attention (the
    windowed kernels' tile skip on the card, the windowed dense mask on
    the CPU; the windowed ring on a ``seq`` mesh)."""
    from .train import make_train_step

    return make_train_step(config, train_config, device,
                           loss=llama_mesh_loss(config, train_config, mesh),
                           window=config.sliding_window, mesh=mesh)


# ---------------------------------------------------------------------------
# GQA KV-cache decoding
# ---------------------------------------------------------------------------


def _embed_ids(params: dict, tokens: torch.Tensor, tp=None) -> torch.Tensor:
    """The token embeddings (the vocabulary-parallel lookup on a
    tensor-parallel rank)."""
    if tp is None:
        return embed_tokens(params["embed"], tokens)
    return tp.embed(params["embed"], tokens)


def _kv_cache(config: LlamaConfig, batch: int, slots: int, device,
              tp=None) -> dict:
    heads = (config.n_kv_heads if tp is None
             else tp.heads(config.n_kv_heads))
    shape = (batch, heads, slots, config.head_dim)
    return {
        "layers": [
            {"k": torch.zeros(shape, dtype=config.dtype, device=device),
             "v": torch.zeros(shape, dtype=config.dtype, device=device)}
            for _ in range(config.n_layers)
        ],
        "length": torch.zeros(batch, dtype=torch.long, device=device),
    }


def init_llama_cache(
    config: LlamaConfig, batch: int, device: str | torch.device = "cuda",
    tp=None,
) -> dict:
    """Empty cache of ``n_kv_heads`` heads: per layer ``[B, H_kv,
    max_seq_len, head_dim]``, plus per-row ``length``; ``tp`` holds a
    tensor-parallel rank's ``H_kv / tp`` kv heads (every cached entry
    point of this family takes ``tp`` as :func:`.decode.prefill` does)."""
    return _kv_cache(config, batch, config.max_seq_len, device, tp)


def init_llama_rolling_cache(
    config: LlamaConfig, batch: int, device: str | torch.device = "cuda"
) -> dict:
    """Rolling-buffer cache of ``sliding_window`` slots a layer: position
    ``p`` lives in slot ``p % window``.  Exact under the window mask: a
    query at ``p`` attends ``p - window + 1 .. p``, which are the positions
    the ring keeps."""
    if config.sliding_window is None:
        raise ValueError(
            "rolling cache requires a sliding_window config (a full-"
            "attention model needs every past position; use "
            "init_llama_cache)"
        )
    return _kv_cache(config, batch, config.sliding_window, device)


def _rolling_cached_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: torch.Tensor,
    window: int,
) -> torch.Tensor:
    """One query per row (``[B, H, 1, D]`` at position ``pos[b]``) against
    the ring: slot ``s`` holds position ``pos - ((pos - s) mod window)``,
    and a slot whose occupant is negative (still warming up) is masked
    with -inf."""
    slots = torch.arange(k_cache.shape[2], device=q.device)
    p = pos[:, None, None, None]
    occupant = p - torch.remainder(p - slots, window)
    return _masked_cache_attention(q, k_cache, v_cache, occupant >= 0)


def _final_logits(
    params: dict,
    x32: torch.Tensor,
    eps: float,
    dtype: torch.dtype,
    last_pos: torch.Tensor | None = None,
    tp=None,
) -> torch.Tensor:
    """Readout logits ``[B, vocab]`` (fp32) at each row's ``last_pos``
    (``None``: position -1) of the last block's unrounded output ``x32``,
    normed into the model ``dtype``.  ``eps`` has no default: it is the
    config's ``rms_eps``."""
    if last_pos is None:
        x32 = x32[:, -1]
    else:
        x32 = x32[torch.arange(x32.shape[0], device=x32.device), last_pos]
    x = _rms_norm(x32, params["final_norm"], eps, dtype)
    return unembed(x, readout_weights(params), tp)


def _prefill_forward(
    params: dict,
    tokens: torch.Tensor,
    config: LlamaConfig,
    prompt_attention,
    lengths: torch.Tensor | None,
    tp=None,
):
    """The prompt pass both cache layouts share: the forward with each
    layer's compact k/v captured, and the ragged readout.  Returns
    ``(logits [B, vocab], row_lengths [B], captured)``."""
    batch, prompt_len = tokens.shape
    if prompt_len > config.max_seq_len:
        raise ValueError(
            f"prompt length {prompt_len} exceeds max_seq_len="
            f"{config.max_seq_len}"
        )
    inner = _prompt_attention(config, prompt_attention)
    captured: list[tuple[torch.Tensor, torch.Tensor]] = []

    def attend(q, k, v):
        captured.append((k, v))
        return inner(q, k, v)

    rope = rope_angles(torch.arange(prompt_len, device=tokens.device),
                       config.head_dim, config.rope_theta)
    x = _embed_ids(params, tokens, tp)
    x32 = None
    for layer in params["layers"]:
        x, x32 = _llama_block(x, layer, config, rope, attend, x32, tp=tp)
    if lengths is None:
        row_lengths = torch.full((batch,), prompt_len, dtype=torch.long,
                                 device=tokens.device)
        logits = _final_logits(params, x32, config.rms_eps, x.dtype, tp=tp)
    else:
        row_lengths = lengths.long()
        logits = _final_logits(params, x32, config.rms_eps, x.dtype,
                               last_pos=row_lengths - 1, tp=tp)
    return logits, row_lengths, captured


def llama_prefill(
    params: dict,
    tokens: torch.Tensor,
    config: LlamaConfig,
    prompt_attention=None,
    lengths: torch.Tensor | None = None,
    tp=None,
) -> tuple[torch.Tensor, dict]:
    """Run the prompt, filling a fresh GQA cache (the contract of
    :func:`.decode.prefill`, ragged right-padded prompts included).
    ``prompt_attention`` is :func:`llama_attention_fn_for`'s pick, which
    carries the sliding window; the default is window-aware dense."""
    batch, prompt_len = tokens.shape
    logits, row_lengths, captured = _prefill_forward(
        params, tokens, config, prompt_attention, lengths, tp
    )
    cache = init_llama_cache(config, batch, tokens.device, tp)
    for layer_cache, (k, v) in zip(cache["layers"], captured):
        layer_cache["k"][:, :, :prompt_len] = k
        layer_cache["v"][:, :, :prompt_len] = v
    cache["length"] = row_lengths
    return logits, cache


def llama_rolling_prefill(
    params: dict,
    tokens: torch.Tensor,
    config: LlamaConfig,
    prompt_attention=None,
    lengths: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict]:
    """The prompt pass for the rolling cache: the windowed forward, then
    each layer's last ``min(window, length)`` k/v gathered into their
    slots; warm-up slots hold zeros (and stay masked)."""
    window = config.sliding_window
    if window is None:
        raise ValueError("rolling prefill requires a sliding_window config")
    logits, row_lengths, captured = _prefill_forward(
        params, tokens, config, prompt_attention, lengths
    )
    # slot s <- the newest prompt position congruent to s
    slots = torch.arange(window, device=tokens.device)[None, :]
    last = (row_lengths - 1)[:, None]
    source = last - torch.remainder(last - slots, window)  # [B, W]
    batch = tokens.shape[0]
    index = source.clamp(min=0)[:, None, :, None].expand(
        batch, config.n_kv_heads, window, config.head_dim)
    keep = (source >= 0)[:, None, :, None]
    layers = []
    for k, v in captured:
        layers.append({
            name: torch.where(keep, torch.gather(t, 2, index),
                              torch.zeros((), dtype=t.dtype, device=t.device))
            for name, t in (("k", k), ("v", v))
        })
    return logits, {"layers": layers, "length": row_lengths}


def _decode_step_impl(
    params: dict,
    cache: dict,
    tokens: torch.Tensor,
    config: LlamaConfig,
    write_and_attend,
    tp=None,
) -> tuple[torch.Tensor, dict]:
    """The decode-step skeleton of both cache layouts: embed, RoPE at each
    row's position (``[B, 1, 1]`` against ``[B, H, 1, D/2]``), per layer
    ``write_and_attend(q, k, v, layer_cache, rows, pos) -> out``, final
    logits; advances ``cache["length"]``."""
    pos = cache["length"]
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    rope = rope_angles(pos[:, None, None], config.head_dim, config.rope_theta)
    x = _embed_ids(params, tokens, tp)[:, None, :]
    x32 = None
    for layer, layer_cache in zip(params["layers"], cache["layers"]):

        def attend(q, k, v, _lc=layer_cache):
            return write_and_attend(q, k, v, _lc, rows, pos)

        x, x32 = _llama_block(x, layer, config, rope, attend, x32, tp=tp)
    logits = _final_logits(params, x32, config.rms_eps, x.dtype, tp=tp)
    cache["length"] = pos + 1
    return logits, cache


def _full_cache_write_and_attend(write_slot_of, cached_attention):
    """Write each row's compact k/v at ``write_slot_of(pos)`` in place (a
    row past the end of the buffer writes nothing, :func:`.decode.
    _write_rows`), then attend through ``cached_attention(q, k_cache,
    v_cache, pos)``."""

    def write_and_attend(q, k, v, layer_cache, rows, pos):
        slot = write_slot_of(pos)
        _write_rows(layer_cache["k"], rows, slot, k[:, :, 0])
        _write_rows(layer_cache["v"], rows, slot, v[:, :, 0])
        return cached_attention(q, layer_cache["k"], layer_cache["v"], pos)

    return write_and_attend


def llama_decode_step(
    params: dict, cache: dict, tokens: torch.Tensor, config: LlamaConfig,
    tp=None,
) -> tuple[torch.Tensor, dict]:
    """One token per row (int ``[batch]``) against the GQA cache: the
    contract of :func:`.decode.decode_step`, the sliding window
    included."""

    def attend_cache(q, k_cache, v_cache, pos):
        return _cached_attention(q, k_cache, v_cache, pos,
                                 window=config.sliding_window)

    return _decode_step_impl(
        params, cache, tokens, config,
        _full_cache_write_and_attend(lambda pos: pos, attend_cache), tp,
    )


def llama_rolling_decode_step(
    params: dict, cache: dict, tokens: torch.Tensor, config: LlamaConfig
) -> tuple[torch.Tensor, dict]:
    """One token per row against the rolling cache: write at ``pos %
    window``, attend the ring."""
    window = config.sliding_window
    if window is None:
        raise ValueError("rolling decode requires a sliding_window config")
    slot_axis = cache["layers"][0]["k"].shape[2]
    if slot_axis != window:
        # a full-size cache here would write at pos % window inside a
        # max_seq_len buffer and score mostly-zero slots: wrong logits
        # and no error, so the layout is refused
        raise ValueError(
            f"rolling decode needs a window-sized cache ({window} slots), "
            f"got {slot_axis}; build it with init_llama_rolling_cache/"
            "llama_rolling_prefill"
        )

    def attend_cache(q, k_cache, v_cache, pos):
        return _rolling_cached_attention(q, k_cache, v_cache, pos, window)

    return _decode_step_impl(
        params, cache, tokens, config,
        _full_cache_write_and_attend(
            lambda pos: torch.remainder(pos, window), attend_cache),
    )


def llama_quantized_prefill(
    params: dict,
    tokens: torch.Tensor,
    config: LlamaConfig,
    prompt_attention=None,
    lengths: torch.Tensor | None = None,
    tp=None,
) -> tuple[torch.Tensor, dict]:
    """:func:`llama_prefill` with the filled GQA cache quantized to int8
    (:func:`.decode.quantize_cache`): the compact kv heads and the int8
    bytes compose."""
    logits, cache = llama_prefill(params, tokens, config, prompt_attention,
                                  lengths=lengths, tp=tp)
    return logits, quantize_cache(cache)


def init_llama_quantized_cache(
    config: LlamaConfig, batch: int, device: str | torch.device = "cuda",
    tp=None,
) -> dict:
    """An empty int8 GQA cache (``n_kv_heads`` heads, a rank's share with
    ``tp``)."""
    return init_quantized_cache(config, batch, kv_heads=config.n_kv_heads,
                                device=device, tp=tp)


def llama_quantized_decode_step(
    params: dict, cache: dict, tokens: torch.Tensor, config: LlamaConfig,
    tp=None,
) -> tuple[torch.Tensor, dict]:
    """:func:`llama_decode_step` against the int8 GQA cache: quantize the
    new compact k/v vectors, write codes and scales, attend with the
    scales factored out (the sliding window included)."""
    return _decode_step_impl(
        params, cache, tokens, config,
        _quantized_write_and_attend(window=config.sliding_window), tp,
    )


def _llama_chunk_decode_impl(
    params: dict,
    cache: dict,
    tokens: torch.Tensor,
    config: LlamaConfig,
    write_and_attend,
    tp=None,
) -> tuple[torch.Tensor, dict]:
    """The llama chunk-decode skeleton both cache layouts share: embed,
    RoPE at each row's chunk positions (``[B, 1, T]``), per layer
    ``write_and_attend(q, k, v, layer_cache, rows, cols, start) -> out``,
    logits at every position; advances ``cache["length"]`` by ``T``."""
    start, rows, cols = _chunk_positions(cache, tokens)
    rope = rope_angles(cols[:, None, :], config.head_dim, config.rope_theta)
    x = _embed_ids(params, tokens, tp)
    x32 = None
    for layer, layer_cache in zip(params["layers"], cache["layers"]):

        def attend(q, k, v, _lc=layer_cache):
            return write_and_attend(q, k, v, _lc, rows, cols, start)

        x, x32 = _llama_block(x, layer, config, rope, attend, x32, tp=tp)
    x = _rms_norm(x32, params["final_norm"], config.rms_eps, x.dtype)
    cache["length"] = start + tokens.shape[1]
    return unembed(x, readout_weights(params), tp), cache


def llama_chunk_decode(
    params: dict, cache: dict, tokens: torch.Tensor, config: LlamaConfig,
    tp=None,
) -> tuple[torch.Tensor, dict]:
    """Decode a ``T``-token chunk a row in one forward against the GQA
    cache (the contract of :func:`.decode.chunk_decode`; RoPE at each
    row's chunk positions, the sliding window included)."""
    return _llama_chunk_decode_impl(
        params, cache, tokens, config,
        _full_chunk_write_and_attend(config.sliding_window), tp)


def llama_quantized_chunk_decode(
    params: dict, cache: dict, tokens: torch.Tensor, config: LlamaConfig,
    tp=None,
) -> tuple[torch.Tensor, dict]:
    """:func:`llama_chunk_decode` against the int8 GQA cache."""
    return _llama_chunk_decode_impl(
        params, cache, tokens, config,
        _quantized_chunk_write_and_attend(config.sliding_window), tp)


def llama_prefill_prefix(
    params: dict, prefix, config: LlamaConfig, prompt_attention=None,
    tp=None,
) -> dict:
    """The GQA cache of a shared prompt prefix, computed once (RoPE is
    position-absolute, so the cached keys are rotated for their slots);
    ``prompt_attention`` is :func:`llama_attention_fn_for`'s pick."""
    return _prefill_prefix_impl(llama_prefill, params, prefix, config,
                                prompt_attention, tp)


def llama_prefill_with_prefix(
    params: dict,
    prefix_cache: dict,
    tokens: torch.Tensor,
    config: LlamaConfig,
    lengths: torch.Tensor | None = None,
    tp=None,
) -> tuple[torch.Tensor, dict]:
    """Per-request suffixes continued from a shared prefix's cache in one
    :func:`llama_chunk_decode` (the contract of
    :func:`.decode.prefill_with_prefix`)."""
    return _prefill_with_prefix_impl(llama_chunk_decode, params,
                                     prefix_cache, tokens, config, lengths,
                                     tp)


def llama_quantized_prefill_prefix(
    params: dict, prefix, config: LlamaConfig, prompt_attention=None,
    tp=None,
) -> dict:
    """:func:`llama_prefill_prefix` in the int8 GQA layout."""
    return _prefill_prefix_impl(llama_quantized_prefill, params, prefix,
                                config, prompt_attention, tp)


def llama_quantized_prefill_with_prefix(
    params: dict,
    prefix_cache: dict,
    tokens: torch.Tensor,
    config: LlamaConfig,
    lengths: torch.Tensor | None = None,
    tp=None,
) -> tuple[torch.Tensor, dict]:
    """:func:`llama_prefill_with_prefix` over the int8 GQA layout."""
    return _prefill_with_prefix_impl(llama_quantized_chunk_decode, params,
                                     prefix_cache, tokens, config, lengths,
                                     tp)


def llama_generate(
    params: dict,
    prompt: torch.Tensor,
    num_tokens: int,
    config: LlamaConfig,
    *,
    temperature: float = 0.0,
    generator: torch.Generator | None = None,
    prompt_attention=None,
    lengths: torch.Tensor | None = None,
    top_k: int = 0,
    top_p: float = 1.0,
    rolling: bool = False,
    eos_id: int | None = None,
    quantized_cache: bool = False,
    prefix_cache: dict | None = None,
    tp=None,
    draw: tuple[int, int] | None = None,
) -> torch.Tensor:
    """``num_tokens`` continuation tokens per prompt (int64 ``[batch,
    num_tokens]``), the contract of :func:`.decode.generate` (``tp`` and
    ``draw`` a mesh rank's, as there):
    ``prompt_attention`` picks the prefill's attention
    (:func:`llama_attention_fn_for`), ``lengths`` marks ragged prompts,
    rows that emit ``eos_id`` pad with it.  ``rolling=True`` decodes
    through the window-sized rolling cache (sliding-window configs only;
    the same tokens as the full cache); ``quantized_cache=True`` through
    the int8 GQA cache; ``prefix_cache`` (from
    :func:`llama_prefill_prefix` or its int8 twin) prepends a shared
    prefix, the ``prompt`` rows being the suffixes."""
    batch, prompt_len = prompt.shape
    if num_tokens < 1:
        raise ValueError(f"num_tokens must be >= 1, got {num_tokens}")
    _check_prefix_budget(prefix_cache, prompt_len, num_tokens, config)
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature sampling requires a generator")
    if rolling and quantized_cache:
        raise ValueError(
            "rolling and quantized_cache do not compose (the ring's slot "
            "arithmetic is a full-precision layout); pick one"
        )
    if prefix_cache is not None:
        if rolling:
            raise ValueError(
                "prefix_cache rides the padded cache layout; it does not "
                "combine with the rolling-buffer cache"
            )
        if prompt_attention is not None:
            raise ValueError(
                "prompt_attention does not apply with prefix_cache (the "
                "suffix prefill runs the chunk decoder); drop one"
            )
        _check_prefix_layout(prefix_cache, quantized_cache)
    if quantized_cache:
        prefill_fn = llama_quantized_prefill
        step_fn = llama_quantized_decode_step
    else:
        prefill_fn = llama_rolling_prefill if rolling else llama_prefill
        step_fn = llama_rolling_decode_step if rolling else llama_decode_step
    if prefix_cache is not None:
        pf = (llama_quantized_prefill_with_prefix if quantized_cache
              else llama_prefill_with_prefix)
        logits, cache = pf(params, prefix_cache, prompt, config,
                           lengths=lengths, tp=tp)
    else:
        prefill_kw = {} if tp is None else {"tp": tp}
        logits, cache = prefill_fn(params, prompt, config, prompt_attention,
                                   lengths=lengths, **prefill_kw)
    return _generate_loop(step_fn, params, cache, logits, num_tokens, config,
                          generator, temperature, top_k, top_p, eos_id, tp,
                          draw)


def make_llama_serving_fns(
    mesh,
    config: LlamaConfig,
    params: dict,
    *,
    quantized_cache: bool = False,
    prefix_cache: dict | None = None,
):
    """``(prefill, decode_step, generate)`` over a ``(data, model)`` mesh:
    the contract of :func:`.decode.make_serving_fns` (the shared wiring of
    :func:`.decode.compile_serving_fns`), with the compact GQA cache split
    by *kv* head over ``model`` (``n_kv_heads % model_parallel == 0``), so
    a rank's prompt pass hands the GQA kernel ``n_kv_heads / tp`` kv heads
    (one at ``tp = n_kv_heads``), the sliding window included.
    ``quantized_cache=True`` serves through the int8 GQA cache;
    ``prefix_cache`` (from :func:`llama_prefill_prefix` /
    :func:`llama_quantized_prefill_prefix`) pins a shared prompt prefix.
    Both compose."""
    from .decode import (
        _check_prefix_layout, compile_serving_fns, require_serving_mesh,
    )
    from .train import _check_divisible

    require_serving_mesh(mesh)
    _check_divisible(mesh, config)
    if prefix_cache is not None:
        _check_prefix_layout(prefix_cache, quantized_cache)
    pf = llama_quantized_prefill if quantized_cache else llama_prefill
    step = llama_quantized_decode_step if quantized_cache else llama_decode_step
    device = mesh.device

    def attention(tokens):
        return llama_attention_fn_for(config, tokens.shape[1], device)

    def prefill_fn(params, tokens, tp):
        return pf(params, tokens, config, attention(tokens), tp=tp)

    def decode_fn(params, cache, tokens, tp):
        return step(params, cache, tokens, config, tp=tp)

    def generate_fn(params, prompt, num_tokens, temperature, generator,
                    lengths, top_k, top_p, eos_id, prefix, tp, draw):
        return llama_generate(
            params, prompt, num_tokens, config, temperature=temperature,
            generator=generator,
            prompt_attention=None if prefix is not None else attention(prompt),
            lengths=lengths, top_k=top_k, top_p=top_p, eos_id=eos_id,
            quantized_cache=quantized_cache, prefix_cache=prefix, tp=tp,
            draw=draw,
        )

    return compile_serving_fns(mesh, prefill_fn, decode_fn, generate_fn,
                               prefix_cache=prefix_cache)
