"""Hugging Face Llama / Mistral checkpoints in and out.

Counterpart of ``kube_sqs_autoscaler_tpu/workloads/hf_convert.py``: a
``transformers`` Llama (or Mistral) checkpoint — a model instance, a state
dict or a saved directory — becomes the port's llama parameter dict, and
back.  Three conventions differ and are handled explicitly:

- **Layout**: ``nn.Linear`` stores ``[out, in]``; the port stores
  ``[in, out]`` and computes ``x @ W``, so every projection transposes.
- **Fusions**: ``k_proj``/``v_proj`` concatenate into ``wkv`` and
  ``gate_proj``/``up_proj`` into ``w_gate_up``, on the output axis.
- **RoPE pairing**: HF rotates half-split pairs ``(x[i], x[i + D/2])``;
  the port rotates interleaved pairs ``(x[2i], x[2i+1])`` with the same
  frequency for pair ``i``, so permuting each head's q/k output channels
  with ``[0, D/2, 1, D/2+1, ...]`` makes the two rotations equal.  The
  attention output is invariant to the shared permutation.

Untied checkpoints import their ``lm_head``; ``rms_norm_eps``,
``rope_theta`` and a Mistral ``sliding_window`` are carried into
:class:`.llama.LlamaConfig`.  The two state-dict functions need only torch
and numpy; ``transformers`` is imported inside :func:`save_hf_llama` and
:func:`load_hf_llama`, the two that read or write a directory, and a
machine without it gets an error naming the flag that needs it.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .llama import LlamaConfig


# the error a machine without transformers gets from the directory
# functions, naming the flags that need them
NEEDS_TRANSFORMERS = ("--hf-checkpoint / --hf-export need the transformers "
                      "package, which this machine lacks ({})")


def llama_config_from_hf(hf_config: Any, dtype: torch.dtype | None = None
                         ) -> LlamaConfig:
    """A ``transformers`` Llama or Mistral config as
    :class:`.llama.LlamaConfig`.  A ``head_dim`` override other than
    ``hidden_size // num_attention_heads`` raises."""
    head_dim = getattr(hf_config, "head_dim", None)
    if head_dim and head_dim != (hf_config.hidden_size
                                 // hf_config.num_attention_heads):
        raise ValueError(
            f"unsupported head_dim override: {head_dim} != "
            f"{hf_config.hidden_size // hf_config.num_attention_heads}"
        )
    return LlamaConfig(
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.hidden_size,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=hf_config.num_key_value_heads,
        n_layers=hf_config.num_hidden_layers,
        d_ff=hf_config.intermediate_size,
        max_seq_len=hf_config.max_position_embeddings,
        rope_theta=_rope_theta(hf_config),
        rms_eps=float(hf_config.rms_norm_eps),
        # Mistral configs carry sliding_window (None for plain Llama)
        sliding_window=getattr(hf_config, "sliding_window", None),
        dtype=dtype if dtype is not None else torch.bfloat16,
    )


def _rope_theta(hf_config: Any) -> float:
    """The RoPE base: ``rope_theta`` on the config, or in its
    ``rope_parameters`` where newer ``transformers`` releases keep it."""
    theta = getattr(hf_config, "rope_theta", None)
    if theta is None:
        theta = (getattr(hf_config, "rope_parameters", None) or {}).get(
            "rope_theta")
    if theta is None:
        raise ValueError("the HF config carries no rope_theta")
    return float(theta)


def _interleave_perm(head_dim: int) -> np.ndarray:
    """Output channel ``2i`` takes HF channel ``i``, ``2i+1`` takes
    ``i + D/2``."""
    half = head_dim // 2
    perm = np.empty(head_dim, np.int64)
    perm[0::2] = np.arange(half)
    perm[1::2] = np.arange(half) + half
    return perm


def _deinterleave_perm(head_dim: int) -> np.ndarray:
    """The inverse of :func:`_interleave_perm`."""
    perm = _interleave_perm(head_dim)
    inverse = np.empty_like(perm)
    inverse[perm] = np.arange(head_dim)
    return inverse


def _permute_heads(w_t: np.ndarray, n_heads: int, head_dim: int,
                   perm: np.ndarray) -> np.ndarray:
    """Permute the per-head output channels of ``[d_model, n_heads *
    head_dim]``."""
    d_model = w_t.shape[0]
    return (w_t.reshape(d_model, n_heads, head_dim)[:, :, perm]
            .reshape(d_model, n_heads * head_dim))


def _to_numpy(w) -> np.ndarray:
    # a torch tensor (bf16 too, which numpy lacks) or an array -> fp32
    if isinstance(w, torch.Tensor):
        return w.detach().to("cpu", torch.float32).numpy()
    return np.asarray(w, np.float32)


def llama_params_from_hf(state_dict: dict, config: LlamaConfig,
                         dtype: torch.dtype | None = None,
                         device: str | torch.device = "cuda") -> dict:
    """An HF Llama ``state_dict`` (torch tensors or numpy arrays,
    ``transformers`` naming) as the port's parameter dict on ``device``,
    in ``dtype`` (default ``config.dtype``)."""
    dtype = dtype if dtype is not None else config.dtype

    def get(name):
        return _to_numpy(state_dict[name])

    def as_param(w):
        return torch.from_numpy(np.ascontiguousarray(w)).to(device=device,
                                                            dtype=dtype)

    head_dim = config.head_dim
    perm = _interleave_perm(head_dim)
    params = {
        "embed": as_param(get("model.embed_tokens.weight")),
        "final_norm": as_param(get("model.norm.weight")),
        "layers": [],
    }
    if "lm_head.weight" in state_dict:
        params["lm_head"] = as_param(get("lm_head.weight"))
    for i in range(config.n_layers):
        prefix = f"model.layers.{i}."
        wq = _permute_heads(get(prefix + "self_attn.q_proj.weight").T,
                            config.n_heads, head_dim, perm)
        wk = _permute_heads(get(prefix + "self_attn.k_proj.weight").T,
                            config.n_kv_heads, head_dim, perm)
        wv = get(prefix + "self_attn.v_proj.weight").T
        params["layers"].append({
            "attn_norm": as_param(get(prefix + "input_layernorm.weight")),
            "wq": as_param(wq),
            "wkv": as_param(np.concatenate([wk, wv], axis=1)),
            "wo": as_param(get(prefix + "self_attn.o_proj.weight").T),
            "mlp_norm": as_param(
                get(prefix + "post_attention_layernorm.weight")),
            "w_gate_up": as_param(np.concatenate([
                get(prefix + "mlp.gate_proj.weight").T,
                get(prefix + "mlp.up_proj.weight").T,
            ], axis=1)),
            "w_down": as_param(get(prefix + "mlp.down_proj.weight").T),
        })
    return params


def hf_state_dict_from_llama(params: dict, config: LlamaConfig) -> dict:
    """The reverse: the port's llama parameters as an HF ``state_dict`` of
    fp32 numpy arrays (``transformers`` naming), the exact inverse of
    :func:`llama_params_from_hf`.  A tied model (no ``lm_head``) omits
    ``lm_head.weight``."""
    head_dim = config.head_dim
    inverse = _deinterleave_perm(head_dim)

    def t(x):
        return _to_numpy(x).T

    state = {
        "model.embed_tokens.weight": _to_numpy(params["embed"]),
        "model.norm.weight": _to_numpy(params["final_norm"]),
    }
    if "lm_head" in params:
        state["lm_head.weight"] = _to_numpy(params["lm_head"])
    kv_dim = config.n_kv_heads * head_dim
    for i, layer in enumerate(params["layers"]):
        prefix = f"model.layers.{i}."
        wkv_t = _to_numpy(layer["wkv"])
        gate_up_t = _to_numpy(layer["w_gate_up"])
        state.update({
            prefix + "input_layernorm.weight": _to_numpy(layer["attn_norm"]),
            prefix + "self_attn.q_proj.weight": _permute_heads(
                _to_numpy(layer["wq"]), config.n_heads, head_dim, inverse).T,
            prefix + "self_attn.k_proj.weight": _permute_heads(
                wkv_t[:, :kv_dim], config.n_kv_heads, head_dim, inverse).T,
            prefix + "self_attn.v_proj.weight": wkv_t[:, kv_dim:].T,
            prefix + "self_attn.o_proj.weight": t(layer["wo"]),
            prefix + "post_attention_layernorm.weight":
                _to_numpy(layer["mlp_norm"]),
            prefix + "mlp.gate_proj.weight": gate_up_t[:, :config.d_ff].T,
            prefix + "mlp.up_proj.weight": gate_up_t[:, config.d_ff:].T,
            prefix + "mlp.down_proj.weight": t(layer["w_down"]),
        })
    return state


def save_hf_llama(params: dict, config: LlamaConfig, directory: Any):
    """Export to a ``transformers``-loadable directory (Llama, or Mistral
    when the config has a ``sliding_window``); returns the HF model."""
    try:
        import transformers
    except ImportError as err:
        raise ImportError(NEEDS_TRANSFORMERS.format(err)) from err
    tie = "lm_head" not in params
    common = dict(
        vocab_size=config.vocab_size,
        hidden_size=config.d_model,
        intermediate_size=config.d_ff,
        num_hidden_layers=config.n_layers,
        num_attention_heads=config.n_heads,
        num_key_value_heads=config.n_kv_heads,
        max_position_embeddings=config.max_seq_len,
        rope_theta=config.rope_theta,
        # where newer transformers releases read the RoPE base
        rope_parameters={"rope_type": "default",
                         "rope_theta": config.rope_theta},
        rms_norm_eps=config.rms_eps,
        tie_word_embeddings=tie,
        attn_implementation="eager",
    )
    if config.sliding_window is not None:
        hf = transformers.MistralForCausalLM(transformers.MistralConfig(
            sliding_window=config.sliding_window, **common))
    else:
        hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(**common))
    state = {k: torch.from_numpy(np.array(v, copy=True))
             for k, v in hf_state_dict_from_llama(params, config).items()}
    missing, unexpected = hf.load_state_dict(state, strict=False)
    # a tied model derives lm_head from the embedding; anything else
    # missing or unexpected is a conversion fault
    allowed_missing = {"lm_head.weight"} if tie else set()
    if set(missing) - allowed_missing or unexpected:
        raise ValueError(
            f"HF export mismatch: missing={missing} unexpected={unexpected}"
        )
    if tie:
        hf.tie_weights()
    hf.eval()
    if directory is not None:
        hf.save_pretrained(directory)
    return hf


def load_hf_llama(source: Any, dtype: torch.dtype | None = None,
                  device: str | torch.device = "cuda"
                  ) -> tuple[LlamaConfig, dict]:
    """``(LlamaConfig, params)`` from an HF model instance or a local
    checkpoint directory (read on the CPU; never fetched from a hub)."""
    if isinstance(source, (str, bytes)) or hasattr(source, "__fspath__"):
        try:
            import transformers
        except ImportError as err:
            raise ImportError(NEEDS_TRANSFORMERS.format(err)) from err
        # Llama and Mistral share the state-dict layout: dispatch on the
        # saved config's model_type so both directory kinds load
        model_type = transformers.AutoConfig.from_pretrained(
            source, local_files_only=True).model_type
        model_cls = (transformers.MistralForCausalLM
                     if model_type == "mistral"
                     else transformers.LlamaForCausalLM)
        source = model_cls.from_pretrained(source, local_files_only=True)
    config = llama_config_from_hf(source.config, dtype=dtype)
    state = dict(source.state_dict())
    if getattr(source.config, "tie_word_embeddings", False):
        # a tied checkpoint may still hold lm_head.weight as a view of the
        # embedding: drop it so readout_weights uses the tie
        state.pop("lm_head.weight", None)
    return config, llama_params_from_hf(state, config, dtype=dtype,
                                        device=device)
