"""The queue-fed GPT serving worker and the GPT trainer in PyTorch.

- :mod:`.model` — the decoder-only transformer (plain functions on a
  parameter dict, plus the :class:`~.model.GPT` module wrapper).
- :mod:`.convert` — the JAX package's parameters (as numpy) to the port's.
- :mod:`.flash` — flash attention, differentiable: the CUDA kernels
  (forward with or without the lse; dq; dk/dv) on card tensors, their plain
  PyTorch versions on CPU tensors, and the attention dispatcher.
- :mod:`.kernels` — builds and loads the CUDA sources under ``csrc/``.
- :mod:`.decode` — KV-cache prefill, decode step, sampling and generate,
  in the bf16 and int8 cache layouts, the chunk decoders and the shared
  prefix cache.
- :mod:`.quantize` — per-output-channel int8 weights for serving.
- :mod:`.service` — the queue worker (classify and generate modes).
- :mod:`.continuous` — continuous batching: the rolling-slot batcher and
  its queue worker.
- :mod:`.worker` — the in-process work-queue worker and pool.
- :mod:`.train` — the objective, AdamW with its schedule and clip, grad
  accumulation and the single-device train step.
- :mod:`.data` — the synthetic token stream and device prefetch.
- :mod:`.perf` — model FLOPs and MFU against the card's peak.
- :mod:`.trainer` — the trainer binary.
"""
