"""The model families the serving entry points run, one record each.

Which family a config belongs to is decided here and nowhere else: the
batch worker's default model calls, the continuous batcher (its cache,
insert, decode step and prompt-pass attention), the sharded plane and the
worker binary all read a :class:`ModelFamily` from :func:`family_of`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from .decode import decode_step, generate, init_cache, prefill
from .flash import attention_fn_for
from .llama import (
    LlamaConfig, init_llama_cache, init_llama_params, llama_attention_fn_for,
    llama_decode_step, llama_forward, llama_generate, llama_prefill,
)
from .model import ModelConfig, forward, init_params


@dataclass(frozen=True)
class ModelFamily:
    """One family's serving functions, each with the GPT path's contract:
    ``init_params(config, generator, device)``, ``init_cache(config,
    batch, device)``, ``prefill(params, tokens, config, attention_fn,
    lengths=)``, ``decode_step(params, cache, tokens, config)``,
    ``forward(params, tokens, config, attention_fn)``, ``generate(params,
    tokens, num_tokens, config, attention_fn, **sampling)`` and
    ``attention_fn_for(config, seq_len, device)``, the prompt-pass pick
    (the CUDA flash forward on the card; the llama pick carries the
    sliding window and takes the compact GQA k/v)."""

    name: str
    config_class: type
    init_params: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable
    forward: Callable
    generate: Callable
    attention_fn_for: Callable


def _gpt_generate(params, tokens, num_tokens, config, attention_fn, **kw):
    return generate(params, tokens, num_tokens, config,
                    attention_fn=attention_fn, **kw)


def _llama_generate(params, tokens, num_tokens, config, attention_fn, **kw):
    return llama_generate(params, tokens, num_tokens, config,
                          prompt_attention=attention_fn, **kw)


def _gpt_attention_fn_for(config: ModelConfig, seq_len: int,
                          device: str | torch.device):
    return attention_fn_for(seq_len, device, config.head_dim)


FAMILIES = {
    family.name: family for family in (
        ModelFamily("gpt", ModelConfig, init_params, init_cache, prefill,
                    decode_step, forward, _gpt_generate,
                    _gpt_attention_fn_for),
        ModelFamily("llama", LlamaConfig, init_llama_params,
                    init_llama_cache, llama_prefill, llama_decode_step,
                    llama_forward, _llama_generate, llama_attention_fn_for),
    )
}


def family_of(config, name: str | None = None) -> ModelFamily:
    """The family that serves ``config``.  ``name`` (``"gpt"`` or
    ``"llama"``), where a caller passes one, must be that family: a config
    of another class raises ``ValueError``."""
    if name is not None and name not in FAMILIES:
        raise ValueError(f"unknown family {name!r}")
    family = next((f for f in FAMILIES.values()
                   if isinstance(config, f.config_class)), None)
    if family is None:
        raise ValueError(f"no model family serves a {type(config).__name__}")
    if name is not None and name != family.name:
        expected = FAMILIES[name].config_class.__name__
        raise ValueError(
            f"family={name!r} serves a {expected}, got "
            f"{type(config).__name__}"
        )
    return family
