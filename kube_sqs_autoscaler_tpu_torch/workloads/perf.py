"""Model-FLOPs accounting and MFU (model FLOPs utilization).

Counterpart of ``kube_sqs_autoscaler_tpu/workloads/perf.py``, with the
same conventions, so the two packages' numbers count the same work:

- FLOPs are *model* FLOPs — the matmul work the architecture defines —
  not hardware FLOPs: rematerialization or a recomputing backward kernel
  does not change the number.
- 2 FLOPs per multiply-accumulate.
- Attention score/value matmuls are counted *full* (no causal ½
  discount), so the flash kernels' causal tile skip shows up as higher
  MFU.
- A train step is 3x the forward (backward = 2x forward).

The peak is the card's dense bf16 rate from NVIDIA's data sheet, looked
up by ``torch.cuda.get_device_name``; an unknown card and the CPU give
``None`` (callers then print tokens/s only).  None of the reference's TPU
peaks carry over.
"""

from __future__ import annotations

from typing import Any

import torch

# dense bf16 peak FLOP/s per card, by device-name substring (NVIDIA data
# sheets, SXM parts at their full power limit)
_PEAK_FLOPS = (
    ("h100", 989e12),
)


def peak_flops(device: str | torch.device | None = None) -> float | None:
    """The bf16 dense peak of ``device`` (default: the current CUDA
    card), or ``None`` for the CPU, an unknown card, or no card."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    for marker, peak in _PEAK_FLOPS:
        if marker in name:
            return peak
    return None


def _attention_flops(batch: int, seq: int, d_model: int, n_layers: int) -> float:
    # scores (q kᵀ) + values (p v): 2 matmuls of S² x Dh MACs per head
    # per layer per example = 2 (matmuls) x 2 (FLOPs/MAC) x S² x d_model
    return n_layers * batch * 4.0 * seq * seq * d_model


def forward_flops(config: Any, batch: int, seq: int) -> float:
    """Forward-pass model FLOPs for one ``[batch, seq]`` token batch
    (duck-typed on the config: a ``n_kv_heads`` field means the llama
    family's projections)."""
    d = config.d_model
    tokens = batch * seq
    if hasattr(config, "n_kv_heads"):  # llama family
        kv_dim = config.n_kv_heads * config.head_dim
        per_token = (
            d * d  # wq
            + d * 2 * kv_dim  # wkv
            + d * d  # wo
            + d * 2 * config.d_ff  # w_gate_up
            + config.d_ff * d  # w_down
        ) * config.n_layers
    else:  # gpt family
        per_token = (
            d * 3 * d  # wqkv
            + d * d  # wo
            + d * config.d_ff  # w_up
            + config.d_ff * d  # w_down
        ) * config.n_layers
    per_token += d * config.vocab_size  # tied-embedding logits
    return 2.0 * tokens * per_token + _attention_flops(
        batch, seq, d, config.n_layers
    )


def train_step_flops(config: Any, batch: int, seq: int) -> float:
    """fwd + bwd model FLOPs for one optimizer step (bwd = 2x fwd)."""
    return 3.0 * forward_flops(config, batch, seq)


def mfu(flops: float, seconds: float,
        device: str | torch.device | None = None) -> float | None:
    """``flops / seconds`` as a fraction of the card's bf16 peak
    (``None`` when the peak is unknown, e.g. on the CPU)."""
    peak = peak_flops(device)
    if peak is None or seconds <= 0:
        return None
    return flops / seconds / peak
