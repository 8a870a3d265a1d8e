"""kube_sqs_autoscaler_tpu_torch — the queue-fed inference worker and the
GPT trainer of :mod:`kube_sqs_autoscaler_tpu` ported to PyTorch and CUDA
on an NVIDIA H100.

The JAX package stays the reference: every module here mirrors the path of
its counterpart there (``workloads/decode.py`` is the counterpart of
``kube_sqs_autoscaler_tpu/workloads/decode.py``) and is held against it by
the ``tests/test_torch_*.py`` files.  This package imports ``torch`` and
numpy only, never ``jax`` and nothing of the JAX package; what it needs
from the JAX package's JAX-free modules it keeps as its own copies.

- :mod:`.device` — device resolution: ``cuda`` unless the caller asks for
  the CPU, and a clear error (never a quiet CPU run) when no card exists.
- :mod:`.workloads` — the GPT model, KV-cache decode, the queue worker and
  its binary, the single-device trainer and its binary, and the
  hand-written CUDA flash-attention kernels: the forward
  (``csrc/flash_fwd.cu``, with and without the logsumexp) that every
  prompt pass and training forward on the card runs, and the backward
  (``csrc/flash_bwd.cu``: dq; dk with dv) of every training step.
"""
