"""Zig-zag ring attention: load-balanced causal sequence parallelism.

Counterpart of ``kube_sqs_autoscaler_tpu/workloads/zigzag.py``.  Plain ring
attention (:mod:`.ring`) gives rank ``d`` block ``d``, so under the causal
mask rank 0 attends almost nothing and rank ``P-1`` everything, and the
lockstep rotations make every rank wait for the slowest.  Here the
sequence is cut into ``2P`` chunks and rank ``d`` holds chunks ``d`` and
``2P-1-d``; every rank then does the same work, each hop half a block:

- its own k/v: a causal ``[c, c]`` call for the low rows and a ``[c, 2c]``
  call for the high rows with ``q_shift = c`` (full over the low chunk,
  causal within the high one);
- k/v from an earlier rank: one unmasked ``[2c, c]`` call against its low
  chunk;
- k/v from a later rank: one unmasked ``[c, 2c]`` call for the high rows,
  a zero-weight partial for the low rows.

Layout contract: q/k/v (and the output) are in zig-zag order — natural
position ``zigzag_permutation(S, P)[i]`` lives at slot ``i``, so the
contiguous shard of rank ``d`` is exactly its two chunks.  The loss is
computed in permuted order too (permuted positions and permuted shifted
targets); :func:`permute_batch` prepares a batch on the host, the
production path.
"""

from __future__ import annotations

import numpy as np
import torch

from .distributed import Mesh, ring_shift
from .flash import MERGE_NEG_INF
from .ring import _hop, merge_rows


def zigzag_permutation(seq: int, n_devices: int) -> np.ndarray:
    """``perm[i]`` = natural position stored at zig-zag slot ``i``: rank
    ``d`` gets chunks ``d`` and ``2P-1-d`` of size ``seq / (2P)``,
    concatenated, rank-major."""
    if seq % (2 * n_devices):
        raise ValueError(
            f"seq={seq} must be divisible by 2*n_devices={2 * n_devices}"
        )
    chunk = seq // (2 * n_devices)
    out = []
    for d in range(n_devices):
        out.append(np.arange(d * chunk, (d + 1) * chunk))
        hi = 2 * n_devices - 1 - d
        out.append(np.arange(hi * chunk, (hi + 1) * chunk))
    return np.concatenate(out)


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    """Inverse of a permutation."""
    return np.argsort(perm)


_on_device: dict = {}


def _device_permutation(seq: int, n_devices: int, device) -> torch.Tensor:
    """:func:`zigzag_permutation` on ``device``, copied there once (a host
    copy every step would wait for the stream)."""
    key = (seq, n_devices, str(device))
    if key not in _on_device:
        _on_device[key] = torch.as_tensor(zigzag_permutation(seq, n_devices),
                                          device=device)
    return _on_device[key]


def _zigzag_attention_kernel_local(q, k, v, *, mesh: Mesh,
                                   axis: str = "seq"):
    """Per-rank zig-zag body with the flash kernel as the hop op (three
    hop shapes, each a rectangular kernel call; partials merged by
    :func:`.flash.merge_attention_partials`)."""
    ax = mesh.axis(axis)
    size, me = ax.size, ax.index
    seq_local = q.shape[2]
    chunk = seq_local // 2
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    acc_lse = torch.full(q.shape[:3], MERGE_NEG_INF, dtype=torch.float32,
                         device=q.device)
    k_blk, v_blk = k, v
    for step in range(size):
        owner = (me - step) % size
        if owner == me:
            out_lo, lse_lo = _hop(q[:, :, :chunk], k_blk[:, :, :chunk],
                                  v_blk[:, :, :chunk], True)
            out_hi, lse_hi = _hop(q[:, :, chunk:], k_blk, v_blk, True,
                                  None, chunk)
            acc, acc_lse = merge_rows(acc, acc_lse,
                                      torch.cat([out_lo, out_hi], dim=2),
                                      torch.cat([lse_lo, lse_hi], dim=2),
                                      0, seq_local)
        elif owner < me:
            out, lse = _hop(q, k_blk[:, :, :chunk], v_blk[:, :, :chunk],
                            False)
            acc, acc_lse = merge_rows(acc, acc_lse, out, lse, 0, seq_local)
        else:
            out, lse = _hop(q[:, :, chunk:], k_blk, v_blk, False)
            acc, acc_lse = merge_rows(acc, acc_lse, out, lse, chunk,
                                      seq_local)
        if step < size - 1:
            k_blk, v_blk = ring_shift(mesh, axis, k_blk, v_blk)
    return acc.to(q.dtype)


def make_zigzag_ring_attention(mesh: Mesh, *, seq_axis: str = "seq"):
    """Attention fn over ``mesh[seq_axis]`` for zig-zag-ordered shards
    (``[B_local, H_local, 2c, D]``): the kernels on CUDA tensors, their
    plain versions on CPU tensors, as :func:`.ring.make_ring_attention`."""
    if mesh.shape[seq_axis] < 2:
        raise ValueError("zig-zag needs a nontrivial seq axis (P >= 2)")

    def fn(q, k, v):
        if q.shape[2] % 2:
            raise ValueError(
                f"zig-zag shard of {q.shape[2]} positions is not two "
                "equal chunks")
        return _zigzag_attention_kernel_local(q, k, v, mesh=mesh,
                                              axis=seq_axis)

    fn._zigzag = True  # layout marker checked by the zig-zag losses
    fn.gqa_native = True
    return fn


def permute_batch(tokens, n_devices: int):
    """Host-side zig-zag preparation of one natural-order token batch:
    ``(tokens_zz, targets_zz, valid)`` — the permuted inputs, the permuted
    shifted targets (slot ``i``'s target is the token at natural position
    ``perm[i] + 1``) and the validity mask ``[1, S]`` (the slot holding
    the last natural position has no target)."""
    tokens = np.asarray(tokens)
    seq = tokens.shape[1]
    perm = zigzag_permutation(seq, n_devices)
    next_tokens = np.concatenate(
        [tokens[:, 1:], np.zeros_like(tokens[:, :1])], axis=1
    )
    return tokens[:, perm], next_tokens[:, perm], (perm < seq - 1)[None, :]


def _require_zigzag_attention(attention_fn, mesh: Mesh):
    """The zig-zag losses need zig-zag-layout attention: a natural-order
    fn on permuted inputs would compute a wrong but finite loss."""
    if attention_fn is None:
        return make_zigzag_ring_attention(mesh)
    if not getattr(attention_fn, "_zigzag", False):
        raise ValueError(
            "zig-zag loss requires attention built by "
            "make_zigzag_ring_attention (inputs are in zig-zag order; a "
            "natural-order attention fn would apply the wrong causal mask)"
        )
    return attention_fn


def zigzag_loss_from_permuted(params, tokens_zz, targets_zz, valid, config,
                              mesh: Mesh, attention_fn=None,
                              remat: bool = False, forward_fn=None,
                              readout_fn=None, forward_factory=None):
    """This rank's share of the LM loss on a batch already in zig-zag
    order (:func:`permute_batch`): ``tokens_zz``/``targets_zz`` are the
    rank's batch rows ``[B_local, S]`` over the whole permuted sequence,
    ``valid`` ``[1, S]``; the rank runs its contiguous ``S / P`` slots
    with their permuted positions.  The shares of all ranks sum to the
    reference's mean over the ``B x (S - 1)`` targets.

    ``forward_fn(params, tokens, config, attention_fn, remat=,
    positions=, tp=)`` defaults to the gpt family's hidden-state forward
    and ``readout_fn(params)`` to its tied embedding; the llama family
    passes its own (RoPE at the permuted positions).  ``forward_factory``
    is :func:`.train.mesh_readout_loss`'s (the MoE objective)."""
    from .train import mesh_readout_loss

    seq = tokens_zz.shape[1]
    ax = mesh.axis("seq")
    attend = _require_zigzag_attention(attention_fn, mesh)
    seq_local = seq // ax.size
    lo = ax.index * seq_local
    positions = _device_permutation(seq, ax.size, tokens_zz.device)[
        lo:lo + seq_local]
    count = tokens_zz.shape[0] * mesh.shape["data"] * (seq - 1)
    if not isinstance(valid, torch.Tensor):
        valid = torch.as_tensor(valid)
    weight = valid.to(tokens_zz.device).reshape(1, -1)[
        :, lo:lo + seq_local].float() / count
    return mesh_readout_loss(
        params, tokens_zz[:, lo:lo + seq_local],
        targets_zz[:, lo:lo + seq_local], weight, config, mesh, attend,
        positions, remat=remat, forward_fn=forward_fn, readout_fn=readout_fn,
        forward_factory=forward_factory)


def zigzag_loss_fn(params, tokens, config, mesh: Mesh, attention_fn=None,
                   remat: bool = False, forward_fn=None, readout_fn=None,
                   forward_factory=None):
    """Natural-order tokens in (the rank's rows ``[B_local, S]``), permuted
    on the device with static index gathers, then
    :func:`zigzag_loss_from_permuted`."""
    seq = tokens.shape[1]
    perm = _device_permutation(seq, mesh.shape["seq"], tokens.device)
    next_tokens = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                            dim=1)
    return zigzag_loss_from_permuted(
        params, tokens[:, perm], next_tokens[:, perm],
        (perm < seq - 1)[None, :], config, mesh, attention_fn, remat=remat,
        forward_fn=forward_fn, readout_fn=readout_fn,
        forward_factory=forward_factory)


def make_zigzag_loss(mesh: Mesh, config, remat: bool = False,
                     forward_fn=None, readout_fn=None, forward_factory=None):
    """The zig-zag objective in the train step's loss-seam shape: builds
    the zig-zag attention once and returns ``loss(params, tokens,
    attention_fn=None)`` (the seam's natural-order attention is
    discarded).  Windowed configs are refused, as the reference refuses
    them: the permuted blocks have no banded form.  ``forward_factory``
    (exclusive with ``forward_fn``) serves objectives whose forward
    collects per-evaluation state (the MoE aux term)."""
    if forward_fn is not None and forward_factory is not None:
        raise ValueError("pass forward_fn or forward_factory, not both")
    if getattr(config, "sliding_window", None) is not None:
        raise ValueError(
            "sliding_window does not compose with the zig-zag schedule; "
            "use plain sequence parallelism (windowed ring attention) "
            "or a (data, model) mesh"
        )
    attend = make_zigzag_ring_attention(mesh)

    def loss(params, tokens, attention_fn=None):  # seam signature
        return zigzag_loss_fn(params, tokens, config, mesh, attend,
                              remat=remat, forward_fn=forward_fn,
                              readout_fn=readout_fn,
                              forward_factory=forward_factory)

    return loss


def make_zigzag_train_step(mesh: Mesh, config, train_config,
                           forward_fn=None, readout_fn=None):
    """A dp x sp x tp train step on the zig-zag schedule: natural-order
    token rows in, through :func:`.train.make_train_step`'s ``loss``
    seam."""
    from .train import make_train_step

    loss = make_zigzag_loss(mesh, config, remat=train_config.remat,
                            forward_fn=forward_fn, readout_fn=readout_fn)
    return make_train_step(config, train_config, mesh.device, loss=loss,
                           mesh=mesh)
