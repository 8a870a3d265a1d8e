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

The reference's ``corpus_token_stream`` reads an on-disk corpus through
its native reader and is not ported yet.
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
