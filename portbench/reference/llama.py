"""The llama family (Mistral-7B's block) in plain float32 PyTorch:
RMSNorm, RoPE on interleaved pairs, grouped-query attention with a
sliding window, SwiGLU, an untied readout; no biases."""

from __future__ import annotations

import torch

from .common import causal_attention, exact_float32, linear, run_layers


def _rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x, positions, theta):
    """Rotate ``[H, n, D]`` by position: pair ``(x[2i], x[2i+1])`` turns
    by ``p * theta^(-2i / D)``."""
    dim = x.shape[-1]
    freqs = theta ** (-torch.arange(0, dim, 2, dtype=torch.float32,
                                    device=x.device) / dim)
    angles = positions.float()[:, None] * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       dim=-1).reshape(x.shape)


def logits_at(stacked: dict, sizes, seqs: list, rows: list,
              precision: str = "fp32") -> list:
    """For each token sequence ``seqs[i]`` (1-D ids), the float32 logits
    ``[len(rows[i]), vocab]`` at its positions ``rows[i]`` (the logits
    that predict the token after each).  ``precision="fp8"`` runs every
    linear layer with float8 operands: the control."""
    s = sizes
    heads, kv_heads, dim = s.n_heads, s.n_kv_heads, s.head_dim
    with exact_float32():
        embed = stacked["embed"]
        hidden = [embed[ids].float() for ids in seqs]

        def block(x, w):
            n = x.shape[0]
            pos = torch.arange(n, device=x.device)
            h = _rms_norm(x, w["attn_norm"], s.norm_eps)
            q = linear(h, w["wq"], precision).view(n, heads, dim)
            k, v = linear(h, w["wkv"], precision).chunk(2, dim=-1)
            q = _rope(q.transpose(0, 1), pos, s.rope_theta)
            k = _rope(k.reshape(n, kv_heads, dim).transpose(0, 1), pos,
                      s.rope_theta)
            v = v.reshape(n, kv_heads, dim).transpose(0, 1)
            attn = causal_attention(q, k, v, s.window)
            x = x + linear(attn.transpose(0, 1).reshape(n, -1), w["wo"],
                           precision)
            h = _rms_norm(x, w["mlp_norm"], s.norm_eps)
            gate, up = linear(h, w["w_gate_up"], precision).chunk(2, dim=-1)
            return x + linear(torch.nn.functional.silu(gate) * up,
                              w["w_down"], precision)

        hidden = run_layers(stacked, s.n_layers, hidden, block)
        norm = stacked["final_norm"].float()
        head = stacked["lm_head"].float().T
        out = []
        for x, r in zip(hidden, rows):
            h = _rms_norm(x[r], norm, s.norm_eps)
            out.append(linear(h, head, precision))
        return out
