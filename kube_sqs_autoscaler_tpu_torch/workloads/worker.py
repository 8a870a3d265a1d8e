"""In-process work-queue inference worker and pool.

Counterpart of ``kube_sqs_autoscaler_tpu/workloads/worker.py``: a worker
takes token batches off a ``queue.Queue``, runs the forward on its device
and reports the greedy next token per sequence with its latency; a pool
runs one thread per worker over one shared queue.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from ..device import resolve_device
from .flash import attention_fn_for
from .model import ModelConfig, forward


@dataclass
class WorkItem:
    """One inference request: an int token batch ``[batch, seq]``."""

    tokens: Any
    id: int = 0


@dataclass
class WorkResult:
    id: int
    next_tokens: Any  # int64 [batch] on the host — greedy next token
    latency_s: float


class InferenceWorker:
    """Drains a work queue through the forward pass on ``device``."""

    def __init__(
        self,
        params: Any,
        config: ModelConfig,
        device: str | torch.device = "cuda",
    ) -> None:
        self.params = params
        self.config = config
        self.device = resolve_device(device)
        self.processed = 0

    def process(self, item: WorkItem) -> WorkResult:
        start = time.perf_counter()
        tokens = torch.as_tensor(item.tokens, device=self.device)
        with torch.inference_mode():
            logits = forward(
                self.params, tokens, self.config,
                attention_fn_for(tokens.shape[1], self.device),
            )
            # the host copy waits for the device
            next_tokens = torch.argmax(logits[:, -1, :], dim=-1).cpu()
        self.processed += 1
        return WorkResult(
            id=item.id,
            next_tokens=next_tokens,
            latency_s=time.perf_counter() - start,
        )

    def serve_forever(
        self,
        work: "queue.Queue[WorkItem | None]",
        results: "queue.Queue[WorkResult]",
    ) -> None:
        """Blocking drain loop; a ``None`` item is the shutdown sentinel."""
        while True:
            item = work.get()
            if item is None:
                return
            results.put(self.process(item))


@dataclass
class WorkerPool:
    """A fixed-size pool of threads sharing one model."""

    worker_factory: Callable[[], InferenceWorker]
    size: int = 1
    work: "queue.Queue[WorkItem | None]" = field(default_factory=queue.Queue)
    results: "queue.Queue[WorkResult]" = field(default_factory=queue.Queue)

    def __post_init__(self) -> None:
        self._threads: list[threading.Thread] = []
        self.workers: list[InferenceWorker] = []

    def start(self) -> None:
        for _ in range(self.size):
            worker = self.worker_factory()
            self.workers.append(worker)
            thread = threading.Thread(
                target=worker.serve_forever, args=(self.work, self.results),
                daemon=True,
            )
            thread.start()
            self._threads.append(thread)

    def submit(self, item: WorkItem) -> None:
        self.work.put(item)

    def stop(self) -> None:
        for _ in self._threads:
            self.work.put(None)
        for thread in self._threads:
            thread.join(timeout=30)
        self._threads.clear()

    def depth(self) -> int:
        """Current backlog — the quantity the autoscaler thresholds on."""
        return self.work.qsize()
