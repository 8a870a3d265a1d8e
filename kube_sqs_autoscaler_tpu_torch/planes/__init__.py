"""Disaggregated prefill and decode planes behind one admission surface.

The port's copy of ``kube_sqs_autoscaler_tpu/planes/``.  The fused
serving plane makes prefill and decode share the same gang slots though
they scale on different axes (prefill with the admission rate, decode with
the token rate); this package splits them:

- :mod:`.prefill`: :class:`PrefillWorker` replicas run only the batched
  ``[M, P]`` admission insert (the CUDA flash forward on the card), never
  a decode step, and offer their started rows for handoff;
- :mod:`.engine`: :class:`DecodePlaneBatcher`, the sharded gang engine with
  speculative rows (draft-and-verify rounds over the flat ``[S*B]`` rows,
  accept rates per tenant, drain-to-plain) and the KV handoff, which
  adopts a prefill row's cache by a device copy, without a forward;
- :mod:`.pool`: :class:`DisaggregatedPool`, both planes as Scaler targets
  with one reply registry, so every request is answered exactly once.

Importing the package imports no torch (the pool is control plane); the
engine and the prefill worker are imported when first named.
"""

from .pool import DISAGG_SECTION, DisaggregatedPool

__all__ = ["DisaggregatedPool", "DISAGG_SECTION", "DecodePlaneBatcher",
           "PrefillWorker"]


def __getattr__(name):
    if name == "DecodePlaneBatcher":
        from .engine import DecodePlaneBatcher

        return DecodePlaneBatcher
    if name == "PrefillWorker":
        from .prefill import PrefillWorker

        return PrefillWorker
    raise AttributeError(name)
