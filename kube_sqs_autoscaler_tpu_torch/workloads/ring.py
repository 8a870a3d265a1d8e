"""Ring attention: causal self-attention over a sequence-parallel mesh axis.

Counterpart of ``kube_sqs_autoscaler_tpu/workloads/ring.py``.  The sequence
is split over the ``seq`` axis of a :class:`.distributed.Mesh`; each rank
keeps its query block and the key/value blocks rotate around the ring one
hop a step (:func:`.distributed.ring_shift`, differentiable: its backward
rotates the cotangents the other way), while the hops' partial results
merge, so no rank ever holds the full ``[S, S]`` scores or the full K/V.
Every rank runs the same ``P - 1`` rotations in the same order, forward
and backward, whatever its hops compute (lockstep).

The per-rank body (:func:`_ring_attention_kernel_local`) makes each live
hop one call of the flash kernel with its lse
(:func:`.flash.flash_attention_lse`'s autograd function), whose
``(out, lse)`` partials merge across hops
(:func:`.flash.merge_attention_partials`); its backward runs the dq and
dk/dv kernels with the hop's own lse and the lse cotangent the merge feeds
back.  The diagonal hop is causal, earlier ranks' hops are full, later
ranks' hops are skipped but still rotate.  On CUDA tensors each hop
launches the kernels; on CPU tensors the same body runs each kernel's
plain version.  The reference also keeps an einsum body with an online
softmax; the port has the one body.

A sliding window (the Mistral band) runs on the kernel too, where the
reference keeps its einsum body: the kernel takes ``window`` with
``q_shift``, so an earlier rank's hop is one call over the rows the band
reaches (``q_shift = (d - e) * S_local``), and a hop wholly outside the
band is skipped.  That computes the same function.
"""

from __future__ import annotations

import torch

from .distributed import Mesh, ring_shift
from .flash import (
    MERGE_NEG_INF,
    _FlashAttention,
    merge_attention_partials,
)


class _Consume(torch.autograd.Function):
    """Identity on ``acc`` that also takes a skipped hop's k/v block and
    gives it a zero cotangent, so that block's rotation is differentiated
    on this rank as on every other (lockstep in the backward)."""

    @staticmethod
    def forward(ctx, acc, *blocks):
        ctx.like = [(b.shape, b.dtype, b.device) for b in blocks]
        return acc.view_as(acc)

    @staticmethod
    def backward(ctx, g, *unused):
        return (g, *(torch.zeros(shape, dtype=dtype, device=device)
                     for shape, dtype, device in ctx.like))


def _hop(q, k, v, causal, window=None, q_shift=0):
    """One kernel call with its lse, differentiable in both outputs."""
    return _FlashAttention.apply(q, k, v, causal, window, q_shift)


def merge_rows(acc, acc_lse, out, lse, lo: int, hi: int):
    """:func:`.flash.merge_attention_partials` of a partial over rows
    ``[lo, hi)`` only; the other rows keep their accumulators (a
    zero-weight partial for them)."""
    if lo == 0 and hi == acc.shape[2]:
        return merge_attention_partials(acc, acc_lse, out, lse)
    a, a_lse = merge_attention_partials(acc[:, :, lo:hi],
                                        acc_lse[:, :, lo:hi], out, lse)
    return (torch.cat([acc[:, :, :lo], a, acc[:, :, hi:]], dim=2),
            torch.cat([acc_lse[:, :, :lo], a_lse, acc_lse[:, :, hi:]],
                      dim=2))


def _ring_attention_kernel_local(q, k, v, *, mesh: Mesh, axis: str = "seq",
                                 window: int | None = None):
    """Per-rank body with the flash kernel as the hop op.  q:
    ``[B, H, S_local, D]``; k/v compact ``[B, H_kv, S_local, D]``."""
    ax = mesh.axis(axis)
    size, me = ax.size, ax.index
    seq_local = q.shape[2]
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    acc_lse = torch.full(q.shape[:3], MERGE_NEG_INF, dtype=torch.float32,
                         device=q.device)
    k_blk, v_blk = k, v
    for step in range(size):
        owner = (me - step) % size
        if owner == me:
            out, lse = _hop(q, k_blk, v_blk, True, window, 0)
            acc, acc_lse = merge_rows(acc, acc_lse, out, lse, 0, seq_local)
        elif owner < me and window is None:
            out, lse = _hop(q, k_blk, v_blk, False)
            acc, acc_lse = merge_rows(acc, acc_lse, out, lse, 0, seq_local)
        elif owner < me:
            # row i sees this block's keys j > i + shift - window: the
            # rows below seq_local + window - shift - 1 see at least one
            shift = (me - owner) * seq_local
            live = min(seq_local, seq_local + window - shift - 1)
            if live > 0:
                out, lse = _hop(q[:, :, :live], k_blk, v_blk, True, window,
                                shift)
                acc, acc_lse = merge_rows(acc, acc_lse, out, lse, 0, live)
            else:
                acc = _Consume.apply(acc, k_blk, v_blk)
        else:
            # a later rank's block is wholly masked: no FLOPs, but it is
            # rotated on like every other
            acc = _Consume.apply(acc, k_blk, v_blk)
        if step < size - 1:
            k_blk, v_blk = ring_shift(mesh, axis, k_blk, v_blk)
    return acc.to(q.dtype)


def make_ring_attention(mesh: Mesh, *, seq_axis: str = "seq",
                        window: int | None = None):
    """An attention fn ``(q, k, v) -> out`` on a rank's shards
    (``[B_local, H_local, S_local, D]``; batch over ``data``, heads over
    ``model``, sequence over ``seq``) that runs as ring attention over
    ``mesh[seq_axis]``.  GQA-native: compact k/v rotate as they are.
    ``window`` runs the sliding-window schedule."""

    def attend(q, k, v):
        return _ring_attention_kernel_local(q, k, v, mesh=mesh,
                                            axis=seq_axis, window=window)

    attend.gqa_native = True
    return attend
