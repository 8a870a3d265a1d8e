"""Input pipeline: token streams with host-to-device prefetch.

Counterpart of ``kube_sqs_autoscaler_tpu/workloads/data.py``:

- :func:`synthetic_token_stream` — an endless deterministic stream of
  ``[batch, seq]`` int32 batches (numpy, host-side), the same bytes as the
  reference's for a seed.
- :func:`prefetch_to_device` — wraps any batch iterator and keeps
  ``depth`` batches ahead already on their way to the device: each batch
  is staged in pinned host memory and copied with ``non_blocking=True``,
  so the host-to-device copy of batch ``n+1`` overlaps the device compute
  of batch ``n`` (the counterpart of ``prefetch_to_mesh``).

- :func:`corpus_token_stream` — endless random-crop batches from an
  on-disk token corpus through the port's native mmap reader
  (:mod:`..native.tokenreader`), the same batches as the reference's for a
  (seed, step).
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator

import numpy as np
import torch


def synthetic_token_stream(
    vocab_size: int, batch: int, seq: int, seed: int = 0
) -> Iterator[np.ndarray]:
    """Endless ``[batch, seq]`` int32 batches, deterministic per seed."""
    rng = np.random.default_rng(seed)
    while True:
        yield rng.integers(0, vocab_size, (batch, seq), dtype=np.int32)


def corpus_token_stream(
    data_dir: str,
    batch: int,
    seq: int,
    seed: int = 0,
    start_step: int = 0,
) -> Iterator[np.ndarray]:
    """Endless ``[batch, seq]`` int32 random-crop batches from a token
    corpus (``write_token_shards``'s format) through the native reader,
    which builds on first use.  Every batch is a pure function of
    ``(seed, step)``: a trainer resumed at step ``N`` passes
    ``start_step=N`` and reads the stream the uninterrupted run read."""
    from ..native.tokenreader import TokenReader

    reader = TokenReader(data_dir, min_window=seq)
    step = start_step
    while True:
        yield reader.batch(batch, seq, seed, step)
        step += 1


def _to_device(batch: np.ndarray, device: torch.device) -> torch.Tensor:
    host = torch.from_numpy(np.ascontiguousarray(batch))
    if device.type != "cuda":
        return host.to(device)
    # a pinned staging copy lets the device copy run asynchronously
    return host.pin_memory().to(device, non_blocking=True)


def prefetch_to_device(
    batches: Iterable[np.ndarray],
    device: str | torch.device,
    depth: int = 2,
) -> Iterator[torch.Tensor]:
    """Yield device-resident batches, ``depth`` copies ahead.

    ``depth=0`` degenerates to a plain copy per step (no overlap);
    ``depth=2`` keeps one batch computing and one in flight, as the
    reference does."""
    if depth < 0:
        raise ValueError(f"depth={depth} must be >= 0")
    device = torch.device(device)
    it = iter(batches)
    if depth == 0:
        for batch in it:
            yield _to_device(batch, device)
        return
    queue: collections.deque[torch.Tensor] = collections.deque()
    try:
        while True:
            while len(queue) <= depth:
                queue.append(_to_device(next(it), device))
            yield queue.popleft()
    except StopIteration:
        while queue:
            yield queue.popleft()


def mesh_rows(batch: np.ndarray, mesh) -> np.ndarray:
    """A rank's rows of a global ``[B, S]`` batch: the ``data`` axis splits
    the batch; every rank of a data row keeps the whole sequence (its seq
    slice's targets reach into the next slice)."""
    data = mesh.axis("data")
    rows = batch.shape[0]
    if rows % data.size:
        raise ValueError(f"batch of {rows} rows not divisible by the data "
                         f"axis ({data.size})")
    share = rows // data.size
    return batch[data.index * share:(data.index + 1) * share]


def prefetch_to_mesh(
    batches: Iterable[np.ndarray],
    mesh,
    depth: int = 2,
) -> Iterator[torch.Tensor]:
    """:func:`prefetch_to_device` of each rank's share
    (:func:`mesh_rows`) onto the mesh's device, ``depth`` copies ahead;
    the reference's ``depth`` checks."""
    if depth < 0:
        raise ValueError(f"depth={depth} must be >= 0")
    return prefetch_to_device((mesh_rows(b, mesh) for b in batches),
                              mesh.device, depth)
