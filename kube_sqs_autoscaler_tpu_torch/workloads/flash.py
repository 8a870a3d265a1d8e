"""Flash attention: the worker's prompt-pass attention as a CUDA kernel.

Counterpart of ``kube_sqs_autoscaler_tpu/workloads/flash.py``.  The JAX
package computes causal (or full) attention with an online softmax over
K/V blocks in a Pallas TPU kernel (``_fwd_kernel``); here the same function
is the hand-written Hopper kernel ``csrc/flash_fwd.cu``, built and loaded
by :mod:`.kernels`, bound through ``ctypes``.

- :func:`flash_attention` launches the kernel for CUDA tensors, or raises
  when it cannot take them; it never falls back.  For CPU tensors it runs
  :func:`flash_attention_reference`, the plain PyTorch version with the
  same masks, which the CPU tests hold against the JAX kernel and
  ``chip_smoke.py`` holds the CUDA kernel against on the card.
- :func:`attention_fn_for` picks the prompt-pass attention: the kernel on
  the card at every prompt length (the JAX package's TPU crossover
  ``FLASH_MIN_SEQ`` does not carry over), the dense path on the CPU, as
  the reference picks dense off the TPU.
- :data:`kernel_launches` counts launches, so a run can show that the
  main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .model import _dense_attention

SUPPORTED_HEAD_DIMS = (64, 128)
SUPPORTED_DTYPES = (torch.bfloat16, torch.float32)

kernel_launches = 0
"""Launches of the CUDA kernel since import (or since a caller reset it);
incremented where the kernel is launched and nowhere else."""

_bound: dict[torch.dtype, object] = {}
_count_lock = threading.Lock()  # worker pools launch from several threads


def _kernel_fn(dtype: torch.dtype):
    """The ctypes entry point for ``dtype``, building the library on
    first use."""
    fn = _bound.get(dtype)
    if fn is None:
        from .kernels import load

        lib = load("flash_fwd")
        for name in ("flash_fwd_bf16", "flash_fwd_f32"):
            entry = getattr(lib, name)
            entry.argtypes = (
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                + [ctypes.c_longlong] * 9
                + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
            )
            entry.restype = ctypes.c_int
        lib.flash_fwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_fwd_error_string.restype = ctypes.c_char_p
        _bound[torch.bfloat16] = (lib.flash_fwd_bf16, lib)
        _bound[torch.float32] = (lib.flash_fwd_f32, lib)
        fn = _bound[dtype]
    return fn


def _check(q, k, v, causal: bool, window: int | None) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, H, S, D], got {tuple(t.shape)}")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    batch, heads, seq, dim = q.shape
    if k.shape[0] != batch or k.shape[2] != seq or k.shape[3] != dim:
        raise ValueError(
            f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)} in "
            "batch, sequence or head dim"
        )
    if heads % k.shape[1]:
        raise ValueError(
            f"query heads {heads} not divisible by kv heads {k.shape[1]}"
        )
    if window is not None:
        if not causal:
            raise ValueError("window requires causal attention")
        if window < 1:
            raise ValueError(f"window={window} must be >= 1")


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int | None = None,
) -> torch.Tensor:
    """The plain PyTorch version of the kernel, on any device.

    fp32 scores (scaled after the product), the kernel's masks (-inf
    without a window; -1e30 plus the live-row guard with one), the
    unnormalized probabilities rounded to ``v``'s dtype before the PV
    product and divided by their fp32 sum after it.  GQA k/v repeat
    query head ``h``'s kv head ``h // groups``."""
    _check(q, k, v, causal, window)
    groups = q.shape[1] // k.shape[1]
    if groups > 1:
        k = repeat_kv(k, groups)
        v = repeat_kv(v, groups)
    seq = q.shape[2]
    scale = 1.0 / q.shape[-1] ** 0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        rows = torch.arange(seq, device=q.device)[:, None]
        cols = torch.arange(seq, device=q.device)[None, :]
        mask_value = float("-inf") if window is None else -1e30
        keep = rows >= cols
        if window is not None:
            keep = keep & (cols > rows - window)
        scores = scores.masked_fill(~keep, mask_value)
    row_max = scores.amax(dim=-1, keepdim=True)
    probs = torch.exp(scores - row_max)
    if window is not None:
        probs = probs * (row_max > -1e29)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return (out / probs.sum(dim=-1, keepdim=True)).to(q.dtype)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int | None = None,
) -> torch.Tensor:
    """Flash attention on ``[B, H, S, D]``; ``k``/``v`` may be compact GQA
    ``[B, H_kv, S, D]`` with ``H % H_kv == 0``.  ``window`` (requires
    ``causal``) keeps row ``r``'s keys ``r - window + 1 .. r``.

    CUDA tensors launch the kernel (bf16 or f32, ``D`` in
    :data:`SUPPORTED_HEAD_DIMS`, last dim contiguous; any other input
    raises).  CPU tensors run :func:`flash_attention_reference`."""
    global kernel_launches
    _check(q, k, v, causal, window)
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, window=window)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(
            f"q, k, v must lie on one CUDA device, got {q.device}, "
            f"{k.device}, {v.device}"
        )
    if q.dtype not in SUPPORTED_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"the kernel takes bf16 or f32 q/k/v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    batch, heads, seq, dim = q.shape
    if dim not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"head dim {dim} not supported by the kernel "
            f"(supported: {SUPPORTED_HEAD_DIMS})"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
    fn, lib = _kernel_fn(q.dtype)
    out = torch.empty((batch, heads, seq, dim), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            batch, heads, k.shape[1], seq, dim,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), -1 if window is None else int(window),
            1.0 / dim ** 0.5, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_fwd launch failed: {lib.flash_fwd_error_string(err).decode()}"
        )
    with _count_lock:
        kernel_launches += 1
    return out


# GQA marker the attention dispatchers check: the kernel takes compact
# [B, H_kv, S, D] k/v directly
flash_attention.gqa_native = True


def attention_fn_for(seq_len: int, device: str | torch.device = "cuda"):
    """The prompt-pass attention for ``device``: the kernel-backed
    :func:`flash_attention` on CUDA at every ``seq_len`` (the kernel masks
    its own ragged edge), :func:`.model._dense_attention` on the CPU.
    ``seq_len`` is kept for the reference's call shape."""
    del seq_len
    if torch.device(device).type == "cuda":
        return flash_attention
    return _dense_attention


def windowed(fn, window: int | None):
    """Bind a sliding window into an attention fn (both
    :func:`flash_attention` and ``_dense_attention`` take ``window=``),
    keeping the ``gqa_native`` marker; ``None`` returns ``fn``."""
    if window is None:
        return fn

    def attend(q, k, v):
        return fn(q, k, v, window=window)

    attend.gqa_native = getattr(fn, "gqa_native", False)
    return attend


def repeat_kv(t: torch.Tensor, groups: int) -> torch.Tensor:
    """``[B, H_kv, S, D] -> [B, H_kv * groups, S, D]`` (GQA broadcast:
    query head ``h`` reads kv head ``h // groups``)."""
    if groups == 1:
        return t
    return t.repeat_interleave(groups, dim=1)


def gqa_adapt(fn):
    """Adapt ``fn`` to compact ``[B, H_kv, S, D]`` k/v: GQA-native fns
    pass through; others get :func:`repeat_kv` just before the call."""
    if getattr(fn, "gqa_native", False):
        return fn

    def attend(q, k, v):
        if q.shape[1] != k.shape[1]:
            groups = q.shape[1] // k.shape[1]
            k = repeat_kv(k, groups)
            v = repeat_kv(v, groups)
        return fn(q, k, v)

    return attend
