"""Cached decode attention: one query position a row against the KV cache,
as a CUDA kernel.

The JAX package computes this attention in plain ``jnp``
(``kube_sqs_autoscaler_tpu/workloads/decode.py``: ``_cached_attention``),
not in Pallas, so the kernel here, ``csrc/decode_attn.cu``, replaces no TPU
kernel: it replaces the port's plain PyTorch path at ``T = 1``, which
upcast every layer's whole cache to fp32 at every step and scored all
``S`` positions of every row to mask most of them away.  The kernel reads
the compact cache in its own dtype, in place, and each row only over its
valid keys (see the note in the source).

- :func:`decode_attention` launches the kernel, or raises when it cannot
  take its tensors (those on the CPU included); it never falls back.
- :func:`takes_kernel` is the routing predicate ``decode._cached_attention``
  applies to what it can observe of its inputs; what it refuses runs the
  plain version, ``decode._chunk_cached_attention``, which
  ``chip_smoke.py`` holds the kernel against on the card.
- :data:`decode_attention_launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from .flash import SUPPORTED_DTYPES, SUPPORTED_HEAD_DIMS, check_row_alignment

decode_attention_launches = 0
"""Calls of :func:`decode_attention` that launched the kernel (one a call,
its merge pass included) since import, or since a caller reset it."""

MIN_CHUNK = 256
"""Fewest cache positions a chunk of the split covers."""
BLOCKS_PER_SM = 32
"""The split aims at this many blocks a streaming multiprocessor."""

_bound: dict = {}  # dtype -> bound entry point
_errors = None
_count_lock = threading.Lock()  # worker pools launch from several threads
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
# q, k, v, length, out, part_acc, part_ml; B, H, H_kv, S, D; strides q (b,
# h), k (b, h, s), v (b, h, s), length; window, chunk_len, chunks; scale;
# stream
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 3
             + [ctypes.c_float, ctypes.c_void_p])


def takes_kernel(device: torch.device | str, query_len: int,
                 q_dtype: torch.dtype, cache_dtype: torch.dtype,
                 head_dim: int) -> bool:
    """Whether :func:`decode_attention`'s kernel computes a cached attention
    of these observable properties: one query position a row, on a CUDA
    device, over a bf16 or fp32 cache of ``q``'s dtype, at a head dim the
    kernel takes.  Everything else (the CPU, ``T > 1``, the int8 cache,
    other head dims) stays on the plain path."""
    return (torch.device(device).type == "cuda" and query_len == 1
            and cache_dtype in SUPPORTED_DTYPES and q_dtype == cache_dtype
            and head_dim in SUPPORTED_HEAD_DIMS)


def _check(q, k_cache, v_cache, length, window) -> None:
    """Shapes and options on any device."""
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dim() != 4:
            raise ValueError(
                f"{name} must be [B, H, S, D], got {tuple(t.shape)}")
    if q.shape[2] != 1:
        raise ValueError(f"q must hold one position a row, got {q.shape[2]}")
    if k_cache.shape != v_cache.shape:
        raise ValueError(f"k_cache {tuple(k_cache.shape)} and v_cache "
                         f"{tuple(v_cache.shape)} differ")
    batch, heads, _, dim = q.shape
    if k_cache.shape[0] != batch or k_cache.shape[3] != dim:
        raise ValueError(f"the cache {tuple(k_cache.shape)} does not match "
                         f"q {tuple(q.shape)} in batch or head dim")
    if heads % k_cache.shape[1]:
        raise ValueError(f"query heads {heads} not divisible by kv heads "
                         f"{k_cache.shape[1]}")
    if length.shape != (batch,) or length.dtype != torch.int64:
        raise ValueError(f"length must be int64 [{batch}], got "
                         f"{length.dtype} {tuple(length.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be >= 1")


def _check_kernel_inputs(q, k_cache, v_cache, length) -> None:
    """The kernel's contract beyond the shapes: bf16 or fp32 of one dtype,
    a head dim it takes, last dims contiguous, 16-byte-aligned cache rows
    (its cp.async copies), and everything on one CUDA device."""
    tensors = (q, k_cache, v_cache)
    if q.dtype not in SUPPORTED_DTYPES or any(
            t.dtype != q.dtype for t in tensors):
        raise ValueError(
            "the decode kernel takes bf16 or f32 q and cache of one dtype, "
            "got " + ", ".join(str(t.dtype) for t in tensors))
    if q.shape[-1] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"head dim {q.shape[-1]} not supported by the decode kernel "
            f"(supported: {SUPPORTED_HEAD_DIMS})")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("q and the cache must be contiguous in their last "
                         "dim")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        strides = [s for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
        check_row_alignment(name, t.element_size(), 0, strides,
                            t.data_ptr())
    devices = {t.device for t in (*tensors, length)}
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(
            "q, the cache and length must lie on one CUDA device, got "
            + ", ".join(str(t.device) for t in (*tensors, length)))


def split(keys: int, pairs: int, sms: int) -> tuple[int, int]:
    """``(chunks, chunk_len)``: how the kernel cuts each row's ``keys``
    cache positions, from the shapes alone.  ``pairs`` (row, kv head)
    blocks a chunk (a query group larger than a block serves takes more,
    which the split leaves out); enough chunks that the grid reaches
    :data:`BLOCKS_PER_SM` blocks on each of ``sms`` multiprocessors, none
    shorter than :data:`MIN_CHUNK`, lengths a multiple of 64.  Which
    chunks hold live keys is known only on the device, where the others
    exit at once."""
    wanted = min(-(-keys // MIN_CHUNK), -(-BLOCKS_PER_SM * sms // pairs))
    chunks = max(1, wanted)
    chunk_len = -(-keys // chunks)
    chunk_len = -(-chunk_len // 64) * 64
    return -(-keys // chunk_len), chunk_len


def _entry(dtype: torch.dtype):
    global _errors
    found = _bound.get(dtype)
    if found is not None:
        return found
    from .kernels import load

    lib = load("decode_attn")
    errors = lib.decode_attn_error_string
    errors.argtypes = [ctypes.c_int]
    errors.restype = ctypes.c_char_p
    _errors = errors  # before any entry point is published
    for suffix_dtype, suffix in _SUFFIX.items():
        fn = getattr(lib, f"decode_attn_{suffix}")
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _bound[suffix_dtype] = fn
    return _bound[dtype]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: torch.Tensor,
                     window: int | None = None) -> torch.Tensor:
    """One query position a row (``q`` ``[B, H, 1, D]``) against the cache
    (``[B, H_kv, S, D]``, ``H_kv`` dividing ``H``; query head ``h`` reads
    kv head ``h // (H / H_kv)``): row ``b`` attends keys ``lo..hi`` with
    ``hi = min(length[b], S - 1)`` and ``lo = max(0, hi - window + 1)``
    (``0`` without a window).  Returns ``[B, H, 1, D]`` in ``q``'s dtype.

    Launches the kernel: bf16 or fp32, ``D`` in
    :data:`.flash.SUPPORTED_HEAD_DIMS`, last dims contiguous, cache rows
    16-byte aligned, everything (``length`` int64) on one CUDA device;
    anything else raises, CPU tensors too."""
    _check(q, k_cache, v_cache, length, window)
    _check_kernel_inputs(q, k_cache, v_cache, length)
    batch, heads, _, dim = q.shape
    kv_heads, keys = k_cache.shape[1], k_cache.shape[2]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    chunks, chunk_len = split(keys, batch * kv_heads, sms)
    out = torch.empty((batch, heads, 1, dim), dtype=q.dtype, device=q.device)
    part_acc = part_ml = None
    if chunks > 1:
        part_acc = torch.empty((batch, heads, chunks, dim),
                               dtype=torch.float32, device=q.device)
        part_ml = torch.empty((batch, heads, chunks, 2),
                              dtype=torch.float32, device=q.device)
    fn = _entry(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            length.data_ptr(), out.data_ptr(),
            None if part_acc is None else part_acc.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(),
            batch, heads, kv_heads, keys, dim,
            q.stride(0), q.stride(1), *k_cache.stride()[:3],
            *v_cache.stride()[:3], length.stride(0),
            -1 if window is None else int(window), chunk_len, chunks,
            1.0 / math.sqrt(dim), stream,
        )
    if err != 0:
        raise RuntimeError(f"decode_attn launch failed: "
                           f"{_errors(err).decode()}")
    global decode_attention_launches
    with _count_lock:
        decode_attention_launches += 1
    return out
