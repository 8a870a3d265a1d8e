"""The GPT family (GPT-2's block, without its linear biases) in plain
float32 PyTorch: pre-LayerNorm, learned positions, causal multi-head
attention, tanh GELU, the readout tied to the token embedding."""

from __future__ import annotations

import math

import torch

from .common import causal_attention, exact_float32, linear, run_layers


def _layer_norm(x, scale, bias, eps):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def _gelu_tanh(x):
    return 0.5 * x * (1 + torch.tanh(math.sqrt(2 / math.pi)
                                     * (x + 0.044715 * x ** 3)))


def logits_at(stacked: dict, sizes, seqs: list, rows: list,
              precision: str = "fp32") -> list:
    """As :func:`.llama.logits_at`, for the GPT family."""
    s = sizes
    heads, dim = s.n_heads, s.head_dim
    with exact_float32():
        embed, pos_embed = stacked["embed"], stacked["pos_embed"]
        hidden = [embed[ids].float() + pos_embed[:ids.shape[0]].float()
                  for ids in seqs]

        def block(x, w):
            n = x.shape[0]
            h = _layer_norm(x, w["ln1_scale"], w["ln1_bias"], s.norm_eps)
            q, k, v = (t.view(n, heads, dim).transpose(0, 1) for t in
                       linear(h, w["wqkv"], precision).chunk(3, dim=-1))
            attn = causal_attention(q, k, v, None)
            x = x + linear(attn.transpose(0, 1).reshape(n, -1), w["wo"],
                           precision)
            h = _layer_norm(x, w["ln2_scale"], w["ln2_bias"], s.norm_eps)
            return x + linear(_gelu_tanh(linear(h, w["w_up"], precision)),
                              w["w_down"], precision)

        hidden = run_layers(stacked, s.n_layers, hidden, block)
        scale = stacked["final_ln_scale"].float()
        bias = stacked["final_ln_bias"].float()
        head = embed.float().T
        out = []
        for x, r in zip(hidden, rows):
            h = _layer_norm(x[r], scale, bias, s.norm_eps)
            out.append(linear(h, head, precision))
        return out
