"""The yardstick's arithmetic: the chip's peaks, model FLOPs, and each
kernel's operations and bytes, all from the shapes of the benchmark's own
inputs.

:func:`forward_flops` is a copy of the program's
``workloads/perf.py`` ``forward_flops`` (2 FLOPs a multiply-add, the
attention products counted over the full ``S x S``), kept here so that the
program cannot change what the benchmark counts.  A kernel's roofline
counts what its inputs need: the real prompt length, not the bucket it is
padded to, and only the causal pairs inside the window.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2


def _attention_flops(batch: int, seq: int, d_model: int, n_layers: int) -> float:
    return n_layers * batch * 4.0 * seq * seq * d_model


def matmul_flops_per_token(s) -> float:
    """FLOPs of every weight product for one token (``s``: ``models.Sizes``)."""
    d = s.d_model
    if s.family == "llama":
        kv_dim = s.n_kv_heads * s.head_dim
        per_token = (d * d + d * 2 * kv_dim + d * d + d * 2 * s.d_ff
                     + s.d_ff * d) * s.n_layers
    else:
        per_token = (d * 3 * d + d * d + d * s.d_ff + s.d_ff * d) * s.n_layers
    per_token += d * s.vocab  # the readout
    return 2.0 * per_token


def forward_flops(s, batch: int, seq: int) -> float:
    """Forward model FLOPs of one ``[batch, seq]`` pass."""
    return (batch * seq * matmul_flops_per_token(s)
            + _attention_flops(batch, seq, s.d_model, s.n_layers))


def request_flops(s, prompt_len: int, generated: int) -> float:
    """Model FLOPs of one served request: the prompt's forward, then one
    token at a time, each against every position before it."""
    steps = max(generated - 1, 0)
    contexts = steps * prompt_len + steps * (steps + 1) // 2
    decode = (steps * matmul_flops_per_token(s)
              + 4.0 * contexts * s.d_model * s.n_layers)
    return forward_flops(s, 1, prompt_len) + decode


def live_pairs(length: int, window: int | None) -> int:
    """Query-key pairs a causal pass over ``length`` positions computes,
    each query seeing at most ``window`` keys."""
    if window is None or length <= window:
        return length * (length + 1) // 2
    return window * (window + 1) // 2 + (length - window) * window


def flash_fwd_work(s, length: int) -> tuple[float, float]:
    """``(operations, bytes)`` of one layer's prompt attention over one
    row of ``length`` real positions: two products of ``head_dim`` a live
    pair and head; q, k, v read once and the output written once."""
    ops = 4.0 * s.head_dim * s.n_heads * live_pairs(length, s.window)
    elements = length * s.head_dim * (2 * s.n_heads + 2 * s.n_kv_heads)
    return ops, float(elements * BF16_BYTES)


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the chip can take: operations or bytes at peak,
    whichever bounds."""
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)
