"""The model families the serving entry points run, one record each.

Which family a config belongs to, and which cache layout's entry points
serve it (full precision or int8, :meth:`ModelFamily.layout`), is decided
here and nowhere else: the batch worker's default model calls, the
continuous batcher (its cache, insert, decode step and prompt-pass
attention), the sharded plane and the worker binary all read a
:class:`ModelFamily` from :func:`family_of`.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from functools import partial
from typing import Callable

import torch

from . import decode, llama
from .flash import attention_fn_for
from .llama import LlamaConfig
from .model import ModelConfig, forward, init_params


@dataclass(frozen=True)
class CacheLayout:
    """One cache layout's entry points for one family, each with the GPT
    path's contract: ``init_cache(config, batch, device)``,
    ``prefill(params, tokens, config, attention_fn, lengths=)``,
    ``decode_step(params, cache, tokens, config)``, ``chunk_decode(params,
    cache, tokens, config)``, ``prefill_prefix(params, prefix, config,
    attention_fn)`` and ``prefill_with_prefix(params, prefix_cache, tokens,
    config, lengths=)``."""

    init_cache: Callable
    prefill: Callable
    decode_step: Callable
    chunk_decode: Callable
    prefill_prefix: Callable
    prefill_with_prefix: Callable


@dataclass(frozen=True)
class ModelFamily:
    """One family's serving functions, each with the GPT path's contract:
    ``init_params(config, generator, device)``, ``forward(params, tokens,
    config, attention_fn)``, ``generate(params, tokens, num_tokens, config,
    attention_fn, **sampling)`` and ``attention_fn_for(config, seq_len,
    device)``, the prompt-pass pick (the CUDA flash forward on the card;
    the llama pick carries the sliding window and takes the compact GQA
    k/v); and its two cache layouts, full precision and int8
    (:meth:`layout`)."""

    name: str
    config_class: type
    init_params: Callable
    forward: Callable
    generate: Callable
    attention_fn_for: Callable
    full: CacheLayout
    int8: CacheLayout

    def layout(self, quantized_kv: bool = False) -> CacheLayout:
        """The int8 layout when ``quantized_kv``, else full precision:
        the one place a serving path picks its cache's entry points."""
        return self.int8 if quantized_kv else self.full


def _gpt_generate(params, tokens, num_tokens, config, attention_fn, **kw):
    return decode.generate(params, tokens, num_tokens, config,
                           attention_fn=attention_fn, **kw)


def _llama_generate(params, tokens, num_tokens, config, attention_fn, **kw):
    return llama.llama_generate(params, tokens, num_tokens, config,
                                prompt_attention=attention_fn, **kw)


def _gpt_attention_fn_for(config: ModelConfig, seq_len: int,
                          device: str | torch.device):
    return attention_fn_for(seq_len, device, config.head_dim)


def _gpt_quantized_cache(config, batch, device="cuda", tp=None):
    return decode.init_quantized_cache(config, batch, device=device, tp=tp)


FAMILIES = {
    family.name: family for family in (
        ModelFamily(
            "gpt", ModelConfig, init_params, forward, _gpt_generate,
            _gpt_attention_fn_for,
            full=CacheLayout(
                decode.init_cache, decode.prefill, decode.decode_step,
                decode.chunk_decode, decode.prefill_prefix,
                decode.prefill_with_prefix),
            int8=CacheLayout(
                _gpt_quantized_cache, decode.quantized_prefill,
                decode.quantized_decode_step, decode.quantized_chunk_decode,
                decode.quantized_prefill_prefix,
                decode.quantized_prefill_with_prefix),
        ),
        ModelFamily(
            "llama", LlamaConfig, llama.init_llama_params,
            llama.llama_forward, _llama_generate,
            llama.llama_attention_fn_for,
            full=CacheLayout(
                llama.init_llama_cache, llama.llama_prefill,
                llama.llama_decode_step, llama.llama_chunk_decode,
                llama.llama_prefill_prefix, llama.llama_prefill_with_prefix),
            int8=CacheLayout(
                llama.init_llama_quantized_cache,
                llama.llama_quantized_prefill,
                llama.llama_quantized_decode_step,
                llama.llama_quantized_chunk_decode,
                llama.llama_quantized_prefill_prefix,
                llama.llama_quantized_prefill_with_prefix),
        ),
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


def rank_layout(layout: CacheLayout, tp) -> CacheLayout:
    """``layout``'s entry points on a tensor-parallel rank of a serving
    mesh, ``tp`` (:class:`.train.TensorParallel`) bound into each: the
    caches hold the rank's heads, the logits are gathered over ``model``.
    ``layout`` itself without a model axis (``tp`` ``None``)."""
    if tp is None:
        return layout
    return CacheLayout(*(partial(getattr(layout, f.name), tp=tp)
                         for f in fields(CacheLayout)))


def split_rows(step_fn, mesh):
    """A step over a batch of cache rows (``step_fn(params, cache, tokens,
    config)``, a decode step or a chunk decode of a :func:`rank_layout`)
    on a cache whose layers hold this rank's rows over the mesh's
    ``data`` axis and whose lengths hold every row's (the engines' cache
    on a mesh): it runs ``step_fn`` on the rank's rows of the tokens and
    lengths, writing the layers in place, then all-gathers the logits and
    the advanced lengths over ``data``, so every rank returns the whole
    batch's.  ``step_fn`` itself on a mesh without a data axis."""
    from .decode import gather_rows, rank_rows

    if mesh.shape["data"] == 1:
        return step_fn

    def step(params, cache, tokens, config):
        rows = rank_rows(mesh, tokens.shape[0])
        view = {"layers": cache["layers"], "length": cache["length"][rows]}
        logits, view = step_fn(params, view, tokens[rows], config)
        cache["layers"] = view["layers"]
        cache["length"] = gather_rows(mesh, view["length"])
        return gather_rows(mesh, logits), cache

    return step


def split_rows_layout(layout: CacheLayout, mesh) -> CacheLayout:
    """A :func:`rank_layout` whose decode step and chunk decode compute
    the rank's rows of the batch (:func:`split_rows`): the layout of the
    steps that advance every slot row (decode steps, blocks, speculative
    rounds), where admissions keep the whole-batch entry points."""
    return CacheLayout(
        layout.init_cache, layout.prefill,
        split_rows(layout.decode_step, mesh),
        split_rows(layout.chunk_decode, mesh),
        layout.prefill_prefix, layout.prefill_with_prefix)
