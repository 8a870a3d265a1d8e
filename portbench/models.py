"""Model sizes from a configuration file, and the seeded weights.

The weights are the benchmark's, not the program's: drawn on the device
from ``--seed`` in the dtype they are served in, one call for each kind of
tensor with every layer stacked, straight into the port's parameter layout
(``[in, out]`` projections, the llama family's fused ``wkv`` and
``w_gate_up``, the GPT family's fused ``wqkv``).  Each kind has a
generator of its own, seeded from ``(seed, kind)``, so the reference can
draw the same tensors again after the program's state is gone.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Sizes:
    """The sizes both sides read, in the port's names."""

    family: str  # "gpt" or "llama"
    vocab: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    n_layers: int
    d_ff: int
    max_seq_len: int
    # the seeded draw: std of every projection and embedding, and of the
    # blocks' output projections (wo, w_down)
    init_std: float
    out_std: float
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    window: int | None = None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def sizes(config_file: dict, cache_positions: int) -> Sizes:
    """The published sizes of ``config_file``; ``cache_positions`` is the
    llama family's serving cache length (the GPT family's is its position
    table, ``n_positions``)."""
    c = config_file["config"]
    init = dict(init_std=float(config_file["init"]["std"]),
                out_std=float(config_file["init"]["out_std"]))
    if config_file["family"] == "llama":
        return Sizes(**init,
            family="llama", vocab=c["vocab_size"], d_model=c["hidden_size"],
            n_heads=c["num_attention_heads"],
            n_kv_heads=c["num_key_value_heads"],
            n_layers=c["num_hidden_layers"], d_ff=c["intermediate_size"],
            max_seq_len=cache_positions, rope_theta=float(c["rope_theta"]),
            norm_eps=float(c["rms_norm_eps"]), window=c.get("sliding_window"),
        )
    if config_file["family"] == "gpt":
        d = c["n_embd"]
        return Sizes(
            **init, family="gpt", vocab=c["vocab_size"], d_model=d,
            n_heads=c["n_head"], n_kv_heads=c["n_head"],
            n_layers=c["n_layer"], d_ff=c["n_inner"] or 4 * d,
            max_seq_len=c["n_positions"],
            norm_eps=float(c["layer_norm_epsilon"]),
        )
    raise ValueError(f"unknown family {config_file['family']!r}")


def port_config(s: Sizes):
    """The port's config object for ``s`` (bf16)."""
    if s.family == "llama":
        from kube_sqs_autoscaler_tpu_torch.workloads.llama import LlamaConfig

        return LlamaConfig(
            vocab_size=s.vocab, d_model=s.d_model, n_heads=s.n_heads,
            n_kv_heads=s.n_kv_heads, n_layers=s.n_layers, d_ff=s.d_ff,
            max_seq_len=s.max_seq_len, rope_theta=s.rope_theta,
            rms_eps=s.norm_eps, sliding_window=s.window,
            dtype=torch.bfloat16)
    from kube_sqs_autoscaler_tpu_torch.workloads.model import ModelConfig

    return ModelConfig(
        vocab_size=s.vocab, d_model=s.d_model, n_heads=s.n_heads,
        n_layers=s.n_layers, d_ff=s.d_ff, max_seq_len=s.max_seq_len,
        dtype=torch.bfloat16)


def _shapes(s: Sizes) -> dict[str, tuple[tuple[int, ...], float | None]]:
    """Every kind of tensor: its shape (stacked over layers where it is a
    layer's) and its std (``None``: ones; ``0.0``: zeros)."""
    d, L = s.d_model, s.n_layers
    std, out = s.init_std, s.out_std
    if s.family == "llama":
        kv = s.n_kv_heads * s.head_dim
        return {
            "embed": ((s.vocab, d), std),
            "lm_head": ((s.vocab, d), std),
            "final_norm": ((d,), None),
            "attn_norm": ((L, d), None),
            "wq": ((L, d, d), std),
            "wkv": ((L, d, 2 * kv), std),
            "wo": ((L, d, d), out),
            "mlp_norm": ((L, d), None),
            "w_gate_up": ((L, d, 2 * s.d_ff), std),
            "w_down": ((L, s.d_ff, d), out),
        }
    return {
        "embed": ((s.vocab, d), std),
        "pos_embed": ((s.max_seq_len, d), std),
        "final_ln_scale": ((d,), None),
        "final_ln_bias": ((d,), 0.0),
        "ln1_scale": ((L, d), None),
        "ln1_bias": ((L, d), 0.0),
        "wqkv": ((L, d, 3 * d), std),
        "wo": ((L, d, d), out),
        "ln2_scale": ((L, d), None),
        "ln2_bias": ((L, d), 0.0),
        "w_up": ((L, d, s.d_ff), std),
        "w_down": ((L, s.d_ff, d), out),
    }


TOP_LEVEL = {"embed", "lm_head", "pos_embed", "final_norm", "final_ln_scale",
             "final_ln_bias"}


def kind_seed(seed: int, kind: str) -> int:
    """A 63-bit seed for one kind of tensor of one run."""
    digest = hashlib.sha256(f"{seed}:{kind}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def stacked_weights(s: Sizes, seed: int, device: torch.device,
                    dtype: torch.dtype = torch.bfloat16) -> dict:
    """``{kind: tensor}``, each kind one draw on ``device``."""
    generator = torch.Generator(device=device)
    out = {}
    for kind, (shape, std) in _shapes(s).items():
        if std is None:
            out[kind] = torch.ones(shape, dtype=dtype, device=device)
        elif std == 0.0:
            out[kind] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            generator.manual_seed(kind_seed(seed, kind))
            t = torch.randn(shape, generator=generator, dtype=dtype,
                            device=device)
            out[kind] = t.mul_(std)
    return out


def port_params(stacked: dict) -> dict:
    """The port's parameter dict over ``stacked``'s tensors (each layer's
    entries are views of the stacks, not copies)."""
    params = {k: v for k, v in stacked.items() if k in TOP_LEVEL}
    layer_kinds = [k for k in stacked if k not in TOP_LEVEL]
    n_layers = stacked[layer_kinds[0]].shape[0]
    params["layers"] = [{k: stacked[k][i] for k in layer_kinds}
                        for i in range(n_layers)]
    return params
