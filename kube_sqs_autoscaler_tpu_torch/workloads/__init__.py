"""The queue-fed GPT serving worker in PyTorch.

- :mod:`.model` — the decoder-only transformer (plain functions on a
  parameter dict, plus the :class:`~.model.GPT` module wrapper).
- :mod:`.convert` — the JAX package's parameters (as numpy) to the port's.
- :mod:`.flash` — flash attention: the CUDA kernel on card tensors, its
  plain PyTorch version on CPU tensors, and the attention dispatcher.
- :mod:`.kernels` — builds and loads the CUDA sources under ``csrc/``.
- :mod:`.decode` — KV-cache prefill, decode step, sampling and generate.
- :mod:`.service` — the queue worker (classify and generate modes).
- :mod:`.worker` — the in-process work-queue worker and pool.
"""
