"""Flash attention: the attention of the worker and the trainer as CUDA
kernels.

Counterpart of ``kube_sqs_autoscaler_tpu/workloads/flash.py``.  The JAX
package computes causal (or full) attention with an online softmax over
K/V blocks in a Pallas TPU kernel (``_fwd_kernel``) and differentiates it
with two more (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``) under a
``custom_vjp``.  Here the same functions are the hand-written Hopper
kernels ``csrc/flash_fwd.cu`` (with and without the per-row logsumexp) and
``csrc/flash_bwd.cu`` (dq; dk with dv), built and loaded by :mod:`.kernels`,
bound through ``ctypes``, and tied together by a
:class:`torch.autograd.Function`.

- :func:`flash_attention` and :func:`flash_attention_lse` launch the
  kernels for CUDA tensors, or raise when they cannot take them; they
  never fall back.  Where a gradient is needed they run the lse forward and
  record the backward kernels; under ``torch.no_grad()`` the plain forward
  runs.  For CPU tensors the same autograd wiring runs the plain PyTorch
  versions (:func:`flash_attention_lse_reference`,
  :func:`flash_bwd_dq_reference`, :func:`flash_bwd_dkv_reference`), which
  the CPU tests hold against the JAX kernels and ``chip_smoke.py`` holds
  the CUDA kernels against on the card.
- :func:`attention_fn_for` picks the attention: the kernels on the card at
  every length (the JAX package's TPU crossover ``FLASH_MIN_SEQ`` does not
  carry over) for the head dims they take, the dense path on the CPU and
  for any other head dim, as the reference picks dense off the TPU.
- :data:`kernel_launches`, :data:`lse_launches`, :data:`dq_launches` and
  :data:`dkv_launches` count launches, so a run can show that its path
  went through each kernel.

Ragged lengths (not a multiple of the kernels' 64-row tiles) are masked
inside every kernel, forward and backward.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .model import _dense_attention

SUPPORTED_HEAD_DIMS = (64, 128)
SUPPORTED_DTYPES = (torch.bfloat16, torch.float32)

kernel_launches = 0
"""Launches of the forward kernel without the lse (the serving prompt pass
and every forward under ``torch.no_grad()``) since import, or since a
caller reset it; incremented where the kernel is launched and nowhere
else."""
lse_launches = 0
"""Launches of the forward kernel with the lse (every forward that records
a gradient, and :func:`flash_attention_lse`)."""
dq_launches = 0
"""Launches of the dq backward kernel."""
dkv_launches = 0
"""Launches of the dk/dv backward kernel."""

MERGE_NEG_INF = -1e9
"""Initial / not-covered lse value for :func:`merge_attention_partials`:
large-negative and finite, so ``-inf - -inf`` NaNs never arise in the
merge or its gradient (``exp(-1e9 - x)`` underflows to exactly 0)."""

_bound: dict[tuple[str, torch.dtype], tuple] = {}
_count_lock = threading.Lock()  # worker pools launch from several threads
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
# each entry point's leading arguments; every one ends with causal, window,
# q_shift, scale and the stream
_ARGTYPES = {
    # q, k, v, o, lse; B, H, H_kv, S_q, S_k, D; 3 strides each of q, k, v
    "flash_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
    + [ctypes.c_longlong] * 9,
    # q, k, v, dout, lse, delta, dq; sizes; strides of q, k, v, dout
    "flash_bwd_dq": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
    + [ctypes.c_longlong] * 12,
    # q, k, v, dout, lse, delta, dk, dv; sizes; strides of q, k, v, dout
    "flash_bwd_dkv": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
    + [ctypes.c_longlong] * 12,
}
_ARGTYPES_TAIL = [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]


def _count(name: str) -> None:
    with _count_lock:
        globals()[name] += 1


def _source(kernel: str) -> str:
    return "flash_fwd" if kernel == "flash_fwd" else "flash_bwd"


def _errors(lib: ctypes.CDLL, source: str):
    errors = getattr(lib, f"{source}_error_string")
    errors.argtypes = [ctypes.c_int]
    errors.restype = ctypes.c_char_p
    return errors


def _entry(kernel: str, dtype: torch.dtype):
    """``(ctypes entry point, error-string function)`` of ``kernel``
    (``flash_fwd``, ``flash_bwd_dq`` or ``flash_bwd_dkv``) for ``dtype``,
    building its library on first use.  The argtypes are exact:
    ``c_void_p`` for every pointer (a null lse included) and the stream,
    ``c_longlong`` for every stride, so ctypes never truncates one."""
    found = _bound.get((kernel, dtype))
    if found is not None:
        return found
    from .kernels import load

    source = _source(kernel)
    lib = load(source)
    errors = _errors(lib, source)
    for suffix_dtype, suffix in _SUFFIX.items():
        fn = getattr(lib, f"{kernel}_{suffix}")
        fn.argtypes = _ARGTYPES[kernel] + _ARGTYPES_TAIL
        fn.restype = ctypes.c_int
        _bound[(kernel, suffix_dtype)] = (fn, errors)
    return _bound[(kernel, dtype)]


def _launch(kernel: str, dtype: torch.dtype, device: torch.device, *args):
    fn, errors = _entry(kernel, dtype)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(
            f"{kernel} launch failed: {errors(err).decode()}"
        )


def _check(q, k, v, causal: bool, window: int | None,
           q_shift: int | None = None) -> None:
    """Shapes and options every entry point takes.  ``q_shift=None``
    requires q and k/v of one length; an int allows rectangular q against
    k/v and must be >= 0 under ``causal`` (every row sees a key)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, H, S, D], got {tuple(t.shape)}")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    batch, heads, seq, dim = q.shape
    if (k.shape[0] != batch or k.shape[3] != dim
            or (q_shift is None and k.shape[2] != seq)):
        raise ValueError(
            f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)} in "
            "batch, sequence or head dim"
        )
    if heads % k.shape[1]:
        raise ValueError(
            f"query heads {heads} not divisible by kv heads {k.shape[1]}"
        )
    if causal and q_shift is not None and q_shift < 0:
        raise ValueError(f"q_shift={q_shift} must be >= 0 under causal")
    if window is not None:
        if not causal:
            raise ValueError("window requires causal attention")
        if window < 1:
            raise ValueError(f"window={window} must be >= 1")


def _check_cuda(*tensors: torch.Tensor) -> None:
    """The kernels' contract: one CUDA device, bf16 or f32 of one dtype,
    a supported head dim, the last dim contiguous."""
    first = tensors[0]
    if not (first.is_cuda and all(t.device == first.device for t in tensors)):
        raise ValueError(
            "q, k, v must lie on one CUDA device, got "
            + ", ".join(str(t.device) for t in tensors)
        )
    if first.dtype not in SUPPORTED_DTYPES or any(
            t.dtype != first.dtype for t in tensors):
        raise ValueError(
            "the kernels take bf16 or f32 tensors of one dtype, got "
            + ", ".join(str(t.dtype) for t in tensors)
        )
    if first.shape[-1] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"head dim {first.shape[-1]} not supported by the kernels "
            f"(supported: {SUPPORTED_HEAD_DIMS})"
        )
    for t in tensors:
        if t.stride(-1) != 1:
            raise ValueError("q, k, v (and dout) must be contiguous in their "
                             "last dim")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _visible(q_len: int, k_len: int, causal: bool, window: int | None,
             q_shift: int, device) -> torch.Tensor | None:
    """``[S_q, S_k]`` bool: which keys each row sees (``None``: all)."""
    if not causal:
        return None
    rows = torch.arange(q_len, device=device)[:, None] + q_shift
    cols = torch.arange(k_len, device=device)[None, :]
    keep = rows >= cols
    if window is not None:
        keep = keep & (cols > rows - window)
    return keep


def _scores(q, k, causal, window, q_shift, mask_value) -> torch.Tensor:
    """fp32 ``[B, H, S_q, S_k]`` scores (scaled after the product), masked
    with ``mask_value``; GQA k repeats for query head ``h // groups``."""
    k = repeat_kv(k, q.shape[1] // k.shape[1])
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (
        1.0 / q.shape[-1] ** 0.5
    )
    keep = _visible(q.shape[2], k.shape[2], causal, window, q_shift, q.device)
    if keep is not None:
        scores = scores.masked_fill(~keep, mask_value)
    return scores


def flash_fwd_reference(q, k, v, *, causal=True, window=None, q_shift=0):
    """The forward kernel's plain version, on any device: ``(out, lse)``
    (see :func:`flash_attention_reference` for the arithmetic)."""
    scores = _scores(q, k, causal, window, q_shift,
                     float("-inf") if window is None else -1e30)
    row_max = scores.amax(dim=-1, keepdim=True)
    probs = torch.exp(scores - row_max)
    if window is not None:
        probs = probs * (row_max > -1e29)
    row_sum = probs.sum(dim=-1, keepdim=True)
    v = repeat_kv(v, q.shape[1] // v.shape[1])
    out = torch.matmul(probs.to(v.dtype).float(), v.float()) / row_sum
    lse = (row_max + torch.log(row_sum))[..., 0]
    return out.to(q.dtype), lse


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int | None = None,
) -> torch.Tensor:
    """The plain PyTorch version of the forward kernel, on any device.

    fp32 scores (scaled after the product), the kernel's masks (-inf
    without a window; -1e30 plus the live-row guard with one), the
    unnormalized probabilities rounded to ``v``'s dtype before the PV
    product and divided by their fp32 sum after it.  GQA k/v repeat
    query head ``h``'s kv head ``h // groups``."""
    _check(q, k, v, causal, window)
    return flash_fwd_reference(q, k, v, causal=causal, window=window)[0]


def flash_attention_lse_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, q_shift: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the lse forward: ``(out, lse)`` with the fp32
    per-row logsumexp ``max + log(sum)``; row ``i`` sees keys
    ``<= i + q_shift`` under ``causal``."""
    _check(q, k, v, causal, None, q_shift)
    return flash_fwd_reference(q, k, v, causal=causal, q_shift=q_shift)


def _probs_and_ds(q, k, v, dout, lse, delta, causal, window, q_shift):
    """The backward's recompute from the lse: fp32 ``p = exp(s - lse)``
    (0 where masked) and ``ds = p * (dp - delta) * scale``, both
    ``[B, H, S_q, S_k]``."""
    scale = 1.0 / q.shape[-1] ** 0.5
    scores = _scores(q, k, causal, window, q_shift, float("-inf"))
    probs = torch.exp(scores - lse[..., None])
    v = repeat_kv(v, q.shape[1] // v.shape[1])
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    return probs, probs * (dp - delta[..., None]) * scale


def _group_sum(t: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """``[B, H, S, D] -> [B, H_kv, S, D]``: sum each kv head's group."""
    batch, heads, seq, dim = t.shape
    return t.reshape(batch, kv_heads, heads // kv_heads, seq, dim).sum(2)


def flash_bwd_dq_reference(q, k, v, dout, lse, delta, *, causal=True,
                           window=None, q_shift=0) -> torch.Tensor:
    """The plain version of the dq kernel: ``dq = ds.to(k.dtype) @ k``,
    ``ds`` recomputed from the lse (``_bwd_dq_kernel``'s formula), the
    product in fp32, the result in q's dtype."""
    _, ds = _probs_and_ds(q, k, v, dout, lse, delta, causal, window, q_shift)
    k_full = repeat_kv(k, q.shape[1] // k.shape[1])
    dq = torch.matmul(ds.to(k.dtype).float(), k_full.float())
    return dq.to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, dout, lse, delta, *, causal=True,
                            window=None, q_shift=0):
    """The plain version of the dk/dv kernel (``_bwd_dkv_kernel``'s
    formula): ``dv = p.to(dout.dtype)^T @ dout`` and
    ``dk = ds.to(q.dtype)^T @ q``, summed over each kv head's query-head
    group in fp32, compact ``[B, H_kv, S_k, D]`` in k's and v's dtype."""
    probs, ds = _probs_and_ds(q, k, v, dout, lse, delta, causal, window,
                              q_shift)
    dv = torch.matmul(probs.to(dout.dtype).float().transpose(-1, -2),
                      dout.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    kv_heads = k.shape[1]
    return (_group_sum(dk, kv_heads).to(k.dtype),
            _group_sum(dv, kv_heads).to(v.dtype))


def _strides(*tensors: torch.Tensor) -> list[int]:
    return [s for t in tensors for s in t.stride()[:3]]


def flash_fwd(q, k, v, *, causal: bool = True, window: int | None = None,
              q_shift: int = 0, need_lse: bool = False):
    """The forward kernel's wrapper: ``(out, lse)``, ``lse`` ``None``
    unless ``need_lse``.  CUDA tensors launch the kernel (counted in
    :data:`lse_launches` or :data:`kernel_launches`): bf16 runs on the
    tensor cores and needs 16-byte-aligned rows
    (:func:`check_rows_aligned`), f32 runs the scalar fp32 kernel.  CPU
    tensors run :func:`flash_fwd_reference`.  Takes no gradient (see
    :func:`flash_attention`)."""
    _check(q, k, v, causal, window, q_shift)
    if _on_cpu(q, k, v):
        out, lse = flash_fwd_reference(q, k, v, causal=causal, window=window,
                                       q_shift=q_shift)
        return out, (lse if need_lse else None)
    _check_cuda(q, k, v)
    if q.dtype == torch.bfloat16:
        check_rows_aligned(q=q, k=k, v=v)
    batch, heads, q_len, dim = q.shape
    out = torch.empty((batch, heads, q_len, dim), dtype=q.dtype,
                      device=q.device)
    lse = torch.empty((batch, heads, q_len), dtype=torch.float32,
                      device=q.device) if need_lse else None
    _launch(
        "flash_fwd", q.dtype, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        batch, heads, k.shape[1], q_len, k.shape[2], dim,
        *_strides(q, k, v),
        int(causal), -1 if window is None else int(window), int(q_shift),
        1.0 / dim ** 0.5,
    )
    _count("lse_launches" if need_lse else "kernel_launches")
    return out, lse


def attention_delta(out: torch.Tensor, dout: torch.Tensor,
                    dlse: torch.Tensor | None = None) -> torch.Tensor:
    """The backward's row term ``Delta = rowsum(dO * O) - dlse``, fp32
    ``[B, H, S_q]``, contiguous (a plain tensor op, as on the TPU: an lse
    cotangent shifts Delta, flash.py:465-471)."""
    delta = (dout.float() * out.float()).sum(dim=-1)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


def check_row_alignment(name: str, element_size: int, storage_offset: int,
                        strides, base_address: int = 0) -> None:
    """Raise ``ValueError`` unless every row of a ``[B, H, S, D]`` tensor
    starts on a 16-byte boundary, as the bf16 kernels' 16-byte
    ``cp.async`` copies need: its first element (``storage_offset``
    elements past ``base_address``, its storage's address) and each of its
    ``strides`` (in elements) must be whole multiples of 16 bytes.  A
    misaligned input is refused, never copied."""
    bad = []
    if (base_address + storage_offset * element_size) % 16:
        bad.append(f"first element at byte offset "
                   f"{storage_offset * element_size} of a storage at "
                   f"{base_address:#x}")
    bad += [f"stride {s} ({s * element_size} bytes)" for s in strides
            if (s * element_size) % 16]
    if bad:
        raise ValueError(
            f"{name} rows must start on 16-byte boundaries for the bf16 "
            f"kernels: {', '.join(bad)}"
        )


def check_rows_aligned(**tensors: torch.Tensor) -> None:
    """:func:`check_row_alignment` for each named ``[B, H, S, D]`` tensor:
    the bf16 kernels' contract, checked before every bf16 launch, forward
    and backward."""
    for name, t in tensors.items():
        # a dim of size 1 never steps by its stride
        strides = [s for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
        check_row_alignment(name, t.element_size(), t.storage_offset(),
                            strides, t.untyped_storage().data_ptr())


def _check_bwd(q, k, v, dout, lse, delta):
    if dout.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)} != q {tuple(q.shape)}")
    _check_cuda(q, k, v, dout)
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != q.shape[:3] or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(
                f"{name} must be contiguous fp32 {tuple(q.shape[:3])} on "
                f"{q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if q.dtype == torch.bfloat16:
        check_rows_aligned(q=q, k=k, v=v, dout=dout)


def flash_bwd_dq(q, k, v, dout, lse, delta, *, causal=True, window=None,
                 q_shift=0) -> torch.Tensor:
    """dq of flash attention from the forward's lse and ``Delta``
    (:func:`attention_delta`): the dq kernel for CUDA tensors, its plain
    version for CPU tensors.  ``dq`` is contiguous, in q's dtype.  bf16
    inputs run on the tensor cores and need 16-byte-aligned rows
    (:func:`check_rows_aligned`); f32 inputs run the scalar fp32 kernel."""
    _check(q, k, v, causal, window, q_shift)
    if _on_cpu(q, k, v, dout, lse, delta):
        return flash_bwd_dq_reference(q, k, v, dout, lse, delta,
                                      causal=causal, window=window,
                                      q_shift=q_shift)
    _check_bwd(q, k, v, dout, lse, delta)
    batch, heads, q_len, dim = q.shape
    dq = torch.empty((batch, heads, q_len, dim), dtype=q.dtype,
                     device=q.device)
    _launch(
        "flash_bwd_dq", q.dtype, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        batch, heads, k.shape[1], q_len, k.shape[2], dim,
        *_strides(q, k, v, dout),
        int(causal), -1 if window is None else int(window), int(q_shift),
        1.0 / dim ** 0.5,
    )
    _count("dq_launches")
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, *, causal=True, window=None,
                  q_shift=0) -> tuple[torch.Tensor, torch.Tensor]:
    """Compact dk, dv of flash attention (each kv head's query-head group
    summed): the dk/dv kernel for CUDA tensors, its plain version for CPU
    tensors.  Both are contiguous ``[B, H_kv, S_k, D]`` in k's dtype.  The
    inputs' contract is :func:`flash_bwd_dq`'s."""
    _check(q, k, v, causal, window, q_shift)
    if _on_cpu(q, k, v, dout, lse, delta):
        return flash_bwd_dkv_reference(q, k, v, dout, lse, delta,
                                       causal=causal, window=window,
                                       q_shift=q_shift)
    _check_bwd(q, k, v, dout, lse, delta)
    batch, heads, q_len, dim = q.shape
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch(
        "flash_bwd_dkv", q.dtype, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        batch, heads, k.shape[1], q_len, k.shape[2], dim,
        *_strides(q, k, v, dout),
        int(causal), -1 if window is None else int(window), int(q_shift),
        1.0 / dim ** 0.5,
    )
    _count("dkv_launches")
    return dk, dv


def kernel_resources(source: str) -> list[dict]:
    """What the compiler gave every kernel instantiation of
    ``csrc/<source>.cu`` (``flash_fwd`` or ``flash_bwd``;
    ``cudaFuncGetAttributes``): one dict per kernel, dtype and head dim
    with ``registers`` a thread, ``local_bytes`` a thread (above 0 means
    spills), ``static_smem_bytes`` and the ``dynamic_smem_bytes`` its
    launch asks for.  Builds the library on first use; needs a card."""
    from .kernels import load

    lib = load(source)
    count = getattr(lib, f"{source}_kernel_count")
    count.argtypes = []
    count.restype = ctypes.c_int
    fn = getattr(lib, f"{source}_kernel_attributes")
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p)] \
        + [ctypes.POINTER(ctypes.c_int)] * 4
    fn.restype = ctypes.c_int
    errors = _errors(lib, source)
    out = []
    for which in range(count()):
        name = ctypes.c_char_p()
        values = [ctypes.c_int() for _ in range(4)]
        err = fn(which, ctypes.byref(name), *map(ctypes.byref, values))
        if err != 0:
            raise RuntimeError(f"cudaFuncGetAttributes failed: "
                               f"{errors(err).decode()}")
        kernel, dtype, dim = name.value.decode().split()
        out.append(dict(
            kernel=kernel, dtype=dtype, head_dim=int(dim),
            **dict(zip(("registers", "local_bytes", "static_smem_bytes",
                        "dynamic_smem_bytes"), (x.value for x in values)))))
    return out


class _FlashAttention(torch.autograd.Function):
    """The counterpart of ``_flash`` / ``_flash_lse`` and their vjps:
    forward with the lse, backward through the dq and dk/dv kernels (the
    plain versions for CPU tensors).  Returns ``(out, lse)``; both are
    differentiable, and an lse cotangent shifts ``Delta``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_shift):
        out, lse = flash_fwd(q, k, v, causal=causal, window=window,
                             q_shift=q_shift, need_lse=True)
        # q, k, v are usually head views of the fused QKV projection: saved
        # as they are, never copied
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.options = (causal, window, q_shift)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_shift = ctx.options
        if dout is None:  # only the lse was used
            dout = torch.zeros_like(out)
        elif dout.stride(-1) != 1:  # the kernels need a contiguous last dim
            dout = dout.contiguous()
        delta = attention_delta(out, dout, dlse)
        options = dict(causal=causal, window=window, q_shift=q_shift)
        dq = flash_bwd_dq(q, k, v, dout, lse, delta, **options)
        dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, **options)
        return dq, dk, dv, None, None, None


def _records_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int | None = None,
) -> torch.Tensor:
    """Flash attention on ``[B, H, S, D]``; ``k``/``v`` may be compact GQA
    ``[B, H_kv, S, D]`` with ``H % H_kv == 0``.  ``window`` (requires
    ``causal``) keeps row ``r``'s keys ``r - window + 1 .. r``.
    Differentiable: where a gradient is recorded, the lse forward runs and
    the backward launches the dq and dk/dv kernels.

    CUDA tensors launch the kernels (bf16 or f32, ``D`` in
    :data:`SUPPORTED_HEAD_DIMS`, last dim contiguous, bf16 rows 16-byte
    aligned; any other input raises).  CPU tensors run the
    plain versions."""
    _check(q, k, v, causal, window)
    if _records_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window, 0)[0]
    return flash_fwd(q, k, v, causal=causal, window=window)[0]


def flash_attention_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, q_shift: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention` that also returns the fp32 per-row
    logsumexp ``[B, H, S_q]``, differentiable in both outputs.  ``q`` may
    be shorter or longer than ``k``/``v``; ``q_shift >= 0`` places q row 0
    at that causal position (row ``i`` sees keys ``<= i + q_shift``), so
    rectangular blocks of a larger problem merge exactly with
    :func:`merge_attention_partials`."""
    _check(q, k, v, causal, None, q_shift)
    return _FlashAttention.apply(q, k, v, causal, None, q_shift)


def merge_attention_partials(acc_out, acc_lse, out, lse):
    """Fold one ``(out, lse)`` attention partial into fp32 accumulators:
    with ``L = logaddexp(acc_lse, lse)`` the merged output is
    ``acc_out * e^(acc_lse - L) + out * e^(lse - L)``.  Start from
    ``acc_out = 0``, ``acc_lse = MERGE_NEG_INF``."""
    new_lse = torch.logaddexp(acc_lse, lse)
    w_acc = torch.exp(acc_lse - new_lse)[..., None]
    w_new = torch.exp(lse - new_lse)[..., None]
    return acc_out * w_acc + out.float() * w_new, new_lse


# GQA marker the attention dispatchers check: the kernel takes compact
# [B, H_kv, S, D] k/v directly
flash_attention.gqa_native = True


def attention_fn_for(seq_len: int, device: str | torch.device,
                     head_dim: int):
    """The prompt-pass attention for ``device`` and ``head_dim``: the
    kernel-backed :func:`flash_attention` on CUDA at every ``seq_len`` (the
    kernel masks its own ragged edge) when ``head_dim`` is one the kernels
    take (:data:`SUPPORTED_HEAD_DIMS`), else :func:`.model._dense_attention`
    — on the CPU, and on CUDA outside the kernels' contract, as the
    reference picks dense whenever its kernel is not the right call.
    ``seq_len`` is kept for the reference's call shape."""
    del seq_len
    if (torch.device(device).type == "cuda"
            and head_dim in SUPPORTED_HEAD_DIMS):
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
