"""The JAX package's parameters to the port's.

The JAX package's ``init_params`` or ``init_llama_params`` pytree, passed
as numpy arrays (for example ``jax.tree.map(np.asarray, params)``), becomes
the port's parameter dict: the same names, the same nesting and the same
``[in, out]`` weight layout, so no array is transposed.  For the llama
family that is ``embed``, ``final_norm`` and an optional ``lm_head``, and
per layer ``attn_norm``, ``wq``, ``wkv``, ``wo``, ``mlp_norm``,
``w_gate_up`` and ``w_down`` (or the split pipeline layout's ``wk`` /
``wv`` / ``w_gate`` / ``w_up``).  This module imports no JAX; the caller
does the ``np.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from .llama import LlamaConfig
from .model import ModelConfig
from .quantize import QuantizedTensor


def _tensor(array, config: ModelConfig | LlamaConfig, device) -> torch.Tensor:
    # bf16 arrays arrive as ml_dtypes' bfloat16, which torch cannot read:
    # widen to fp32 (exact) on the host, then cast to the config's dtype
    host = np.array(array)  # a writable, contiguous copy
    if host.dtype.name == "bfloat16":
        host = host.astype(np.float32)
    return torch.from_numpy(host).to(
        device=device, dtype=config.dtype
    )


def _leaf(value, config: ModelConfig | LlamaConfig, device):
    """One weight: an array cast to ``config.dtype``, or the reference's
    int8 ``QuantizedTensor`` (numpy codes and scale) as the port's, its
    codes int8 and its scales fp32 exactly."""
    if hasattr(value, "codes") and hasattr(value, "scale"):
        codes = torch.from_numpy(np.array(value.codes, np.int8))
        scale = torch.from_numpy(np.array(value.scale, np.float32))
        return QuantizedTensor(codes.to(device), scale.to(device),
                               config.dtype)
    return _tensor(value, config, device)


def params_from_jax(
    numpy_pytree: dict,
    config: ModelConfig | LlamaConfig,
    device: str | torch.device = "cuda",
) -> dict:
    """The port's parameter dict from the reference's (numpy leaves).

    Every weight is cast to ``config.dtype``; a bf16 or f32 reference
    converts exactly into the same dtype.  An int8 tree (the reference's
    ``quantize_params``, mapped to numpy leaf by leaf) keeps its codes and
    scales, as :class:`.quantize.QuantizedTensor`."""
    params = {
        name: _leaf(value, config, device)
        for name, value in numpy_pytree.items() if name != "layers"
    }
    params["layers"] = [
        {name: _leaf(value, config, device) for name, value in layer.items()}
        for layer in numpy_pytree["layers"]
    ]
    return params
