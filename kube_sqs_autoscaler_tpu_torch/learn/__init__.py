"""The learned autoscaling policy, deployed on the real control loop.

The port's copy of ``kube_sqs_autoscaler_tpu/learn/``, its deployment
half:

- :mod:`.network` — the decision arithmetic: features over the ring
  buffer history (the forecasters' ``ewma_level`` / ``lstsq_slope``), a
  one-hidden-layer MLP, and the up/hold/down action expressed as an
  *effective queue depth* through the unchanged gates, on torch tensors;
- :mod:`.checkpoint` — the deployable artifact: versioned JSON with
  load-time validation and a content hash, the reference's own files;
- :mod:`.policy` — :class:`LearnedPolicy`, the
  :class:`~..core.types.DepthPolicy` for the real ``ControlLoop``.

The training half (the rollouts, the evolution-strategies trainers over
the compiled twins and the package's ``__main__``) is not ported yet
(ROADMAP Queue 1 item 6c).  Exports resolve lazily, as in the
reference.
"""

from __future__ import annotations

from typing import Any

_EXPORTS = {
    "LearnedPolicy": ("policy", "LearnedPolicy"),
    "PolicyCheckpoint": ("checkpoint", "PolicyCheckpoint"),
    "CheckpointError": ("checkpoint", "CheckpointError"),
    "SCHEMA_VERSION": ("checkpoint", "SCHEMA_VERSION"),
    "load_checkpoint": ("checkpoint", "load_checkpoint"),
    "save_checkpoint": ("checkpoint", "save_checkpoint"),
    "checkpoint_hash": ("checkpoint", "checkpoint_hash"),
    "checkpoint_twin": ("checkpoint", "checkpoint_twin"),
    "require_twin": ("checkpoint", "require_twin"),
    "init_params": ("network", "init_params"),
    "param_count": ("network", "param_count"),
    "params_from_numpy": ("network", "params_from_numpy"),
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str) -> Any:
    try:
        module_name, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        ) from None
    import importlib

    module = importlib.import_module(f".{module_name}", __name__)
    value = getattr(module, attr)
    globals()[name] = value  # cache: later lookups skip __getattr__
    return value


def __dir__() -> list[str]:
    return sorted(set(globals()) | set(_EXPORTS))
