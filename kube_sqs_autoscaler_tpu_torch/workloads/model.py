"""The decoder-only GPT transformer in PyTorch.

Counterpart of ``kube_sqs_autoscaler_tpu/workloads/model.py``, held
against it by ``tests/test_torch_model.py``.  Parameters are a plain dict
with the JAX package's names and structure (``{"embed", "pos_embed",
"final_ln_scale", "final_ln_bias", "layers": [{...}, ...]}``) and its
``[in, out]`` weight layout, so every projection is ``x @ w`` with no
transpose; :class:`GPT` is the ``nn.Module`` that holds them.

Numerics follow the reference where the two frameworks would otherwise
differ:

- bf16 parameters and activations; layernorm statistics in fp32 with
  population variance and ``rsqrt(var + 1e-5)``;
- the attention scores and the tied-embedding readout are fp32 results of
  the working-dtype operands (the reference's
  ``preferred_element_type=float32``): the operands are upcast, because a
  bf16 ``torch.matmul`` would round its result to bf16;
- GELU is the tanh approximation (``jax.nn.gelu``'s default), computed
  op by op in the model dtype with its constants in that dtype, rounding
  at each step, as XLA lowers ``jax.nn.gelu`` for bf16;
- a layernorm that reads a residual sum (the embedding sum included)
  reads it unrounded, in fp32: the reference's compiled program fuses the
  add into the norm's fp32 upcast (XLA's default excess precision), while
  the residual stream itself is rounded to the model dtype.  With both
  rules the bf16 logits equal the compiled reference's up to fp32 noise;
- token ids are read with JAX's gather rule: negative ids wrap once
  (``-1`` is the last row) and every other out-of-range id clamps, so an
  unchecked message body can never index past the table (on the card a
  plain index would trip a device-side assert and kill the worker).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


@dataclass(frozen=True)
class ModelConfig:
    """Transformer dimensions (the defaults are the worker's built-in
    GPT)."""

    vocab_size: int = 8192
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 2048
    max_seq_len: int = 1024
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def init_params(
    config: ModelConfig,
    generator: torch.Generator,
    device: str | torch.device = "cuda",
) -> dict:
    """Scaled-normal initialization in the reference's layout (std 0.02,
    GPT-2-style ``0.02 / sqrt(2 * n_layers)`` on the output projections).

    ``generator`` is a CPU :class:`torch.Generator`: the weights are drawn
    in fp32 on the host, so a seed gives the same weights on every device,
    then cast to ``config.dtype`` and moved to ``device``."""
    dtype = config.dtype

    def normal(shape, scale):
        draw = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (draw * scale).to(device=device, dtype=dtype)

    def ones():
        return torch.ones(config.d_model, dtype=dtype, device=device)

    def zeros():
        return torch.zeros(config.d_model, dtype=dtype, device=device)

    d = config.d_model
    params = {
        "embed": normal((config.vocab_size, d), 0.02),
        "pos_embed": normal((config.max_seq_len, d), 0.02),
        "final_ln_scale": ones(),
        "final_ln_bias": zeros(),
        "layers": [],
    }
    out_scale = 0.02 / (2 * config.n_layers) ** 0.5
    for _ in range(config.n_layers):
        params["layers"].append({
            "ln1_scale": ones(),
            "ln1_bias": zeros(),
            "wqkv": normal((d, 3 * d), 0.02),
            "wo": normal((d, d), out_scale),
            "ln2_scale": ones(),
            "ln2_bias": zeros(),
            "w_up": normal((d, config.d_ff), 0.02),
            "w_down": normal((config.d_ff, d), out_scale),
        })
    return params


def safe_ids(tokens: torch.Tensor, rows: int) -> torch.Tensor:
    """JAX's gather rule for a table of ``rows`` rows: negative ids wrap
    once, then every id clamps into ``[0, rows - 1]``."""
    tokens = tokens.long()
    return torch.where(tokens < 0, tokens + rows, tokens).clamp(0, rows - 1)


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` under :func:`safe_ids`."""
    return table[safe_ids(tokens, table.shape[0])]


def _layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
    dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """fp32 statistics (population variance), output in ``dtype`` (default
    ``x``'s)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    normed = (x32 - mean) * torch.rsqrt(var + 1e-5)
    return (normed * scale.float() + bias.float()).to(dtype or x.dtype)


def _residual(
    x: torch.Tensor, delta: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``x + delta`` in ``x``'s dtype, and the same sum unrounded in fp32,
    which is what the next norm reads (see the module docstring)."""
    total = x.float() + delta
    return total.to(x.dtype), total


def _dense_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    window: int | None = None,
) -> torch.Tensor:
    """Causal attention on ``[B, H, S, D]`` with an fp32 softmax, masked
    with -1e9 as the reference is; ``window`` keeps each row's last
    ``window`` keys."""
    head_dim = q.shape[-1]
    seq = q.shape[2]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / (
        head_dim ** 0.5
    )
    rows = torch.arange(seq, device=q.device)[:, None]
    cols = torch.arange(seq, device=q.device)[None, :]
    mask = rows >= cols
    if window is not None:
        mask = mask & (cols > rows - window)
    scores = scores.masked_fill(~mask, -1e9)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def _split_heads(t: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    """``[B, S, D] -> [B, H, S, head_dim]`` (a view)."""
    batch, seq, _ = t.shape
    return t.reshape(batch, seq, config.n_heads, config.head_dim).transpose(
        1, 2
    )


def _merge_heads(t: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    """``[B, H, S, head_dim] -> [B, S, D]``."""
    batch, _, seq, _ = t.shape
    return t.transpose(1, 2).reshape(batch, seq, config.d_model)


def _project_qkv(
    h: torch.Tensor, layer: dict, config: ModelConfig
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v split into heads, from the fused ``wqkv`` or the split
    ``wq``/``wk``/``wv`` layout (identical values)."""
    if "wqkv" in layer:
        q, k, v = torch.chunk(h @ layer["wqkv"], 3, dim=-1)
    else:
        q, k, v = h @ layer["wq"], h @ layer["wk"], h @ layer["wv"]
    return (
        _split_heads(q, config), _split_heads(k, config),
        _split_heads(v, config),
    )


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh): ``x * 0.5 * (1 + tanh(c * (x + 0.044715 *
    x**3)))``, each op rounded to ``x``'s dtype and the constants too."""
    def const(value):
        return torch.tensor(value, dtype=x.dtype, device=x.device)

    cube = x * x * x
    inner = const(math.sqrt(2 / math.pi)) * (x + const(0.044715) * cube)
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def _mlp(x: torch.Tensor, layer: dict) -> torch.Tensor:
    return _gelu(x @ layer["w_up"]) @ layer["w_down"]


def _block(
    x: torch.Tensor, layer: dict, config: ModelConfig, attend,
    x32: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One pre-LN block: attention then MLP, residual around both.
    ``attend(q, k, v) -> [B, H, S, D]`` is the attention seam (dense,
    flash, or a cache-writing closure in :mod:`.decode`).  ``x32`` is
    ``x`` unrounded (fp32), which the first norm reads.  Returns the
    block's output and its fp32 value."""
    dtype = x.dtype
    h = _layer_norm(x32, layer["ln1_scale"], layer["ln1_bias"], dtype)
    q, k, v = _project_qkv(h, layer, config)
    x, x32 = _residual(x, _merge_heads(attend(q, k, v), config) @ layer["wo"])
    h2 = _layer_norm(x32, layer["ln2_scale"], layer["ln2_bias"], dtype)
    return _residual(x, _mlp(h2, layer))


def _embed(
    params: dict, tokens: torch.Tensor, positions
) -> tuple[torch.Tensor, torch.Tensor]:
    """Token plus position embeddings: the sum in the model dtype and
    unrounded (``positions`` is a slice or a tensor of position ids)."""
    pos = params["pos_embed"]
    pos = pos[positions] if isinstance(positions, slice) else embed_tokens(
        pos, positions)
    return _residual(embed_tokens(params["embed"], tokens), pos)


def forward_hidden(
    params: dict,
    tokens: torch.Tensor,
    config: ModelConfig,
    attention_fn=None,
    remat: bool = False,
) -> torch.Tensor:
    """Final layernormed hidden states ``[batch, seq, d_model]``.

    ``remat=True`` wraps each block in
    :func:`torch.utils.checkpoint.checkpoint` (the reference's
    ``jax.checkpoint``): the backward recomputes the block's activations
    instead of keeping them, with the same values and a lower peak
    memory."""
    seq = tokens.shape[1]
    if seq > config.max_seq_len:
        raise ValueError(
            f"sequence length {seq} exceeds max_seq_len={config.max_seq_len}"
        )
    x, x32 = _embed(params, tokens, slice(0, seq))
    attend = attention_fn or _dense_attention
    for layer in params["layers"]:
        if remat:
            x, x32 = checkpoint(_block, x, layer, config, attend, x32,
                                use_reentrant=False)
        else:
            x, x32 = _block(x, layer, config, attend, x32)
    return _layer_norm(x32, params["final_ln_scale"], params["final_ln_bias"],
                       x.dtype)


def unembed(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Tied-embedding readout: fp32 logits from working-dtype operands."""
    return torch.matmul(x.float(), embed.float().t())


def forward(
    params: dict,
    tokens: torch.Tensor,
    config: ModelConfig,
    attention_fn=None,
) -> torch.Tensor:
    """Logits ``[batch, seq, vocab]`` (fp32) for int ``[batch, seq]``
    tokens.  ``attention_fn`` replaces the attention inner op
    (``[B,H,S,D]^3 -> out``; dense by default, the flash kernel on the
    card via :func:`.flash.attention_fn_for`)."""
    return unembed(
        forward_hidden(params, tokens, config, attention_fn),
        params["embed"],
    )


def param_count(params: dict) -> int:
    top = sum(t.numel() for name, t in params.items() if name != "layers")
    return top + sum(t.numel() for layer in params["layers"]
                     for t in layer.values())


class GPT(nn.Module):
    """The model as an ``nn.Module``: holds the parameter dict's tensors
    under the reference's names (``embed``, ``layers.0.wqkv``, ...) and
    runs :func:`forward` over them."""

    def __init__(self, config: ModelConfig, params: dict) -> None:
        super().__init__()
        self.config = config
        self._top = [name for name in params if name != "layers"]
        for name in self._top:
            self.register_parameter(
                name, nn.Parameter(params[name], requires_grad=False)
            )
        self.layers = nn.ModuleList(
            nn.ParameterDict({
                name: nn.Parameter(t, requires_grad=False)
                for name, t in layer.items()
            })
            for layer in params["layers"]
        )

    def params(self) -> dict:
        """The parameter dict (the same tensors, not copies)."""
        out = {name: getattr(self, name) for name in self._top}
        out["layers"] = [dict(layer.items()) for layer in self.layers]
        return out

    def forward(self, tokens: torch.Tensor, attention_fn=None) -> torch.Tensor:
        return forward(self.params(), tokens, self.config, attention_fn)
