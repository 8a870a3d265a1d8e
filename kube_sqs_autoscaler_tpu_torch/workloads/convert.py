"""The JAX package's parameters to the port's.

The JAX package's ``init_params`` pytree, passed as numpy arrays (for
example ``jax.tree.map(np.asarray, params)``), becomes the port's parameter
dict: the same names, the same nesting and the same ``[in, out]`` weight
layout, so no array is transposed.  This module imports no JAX; the caller
does the ``np.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from .model import ModelConfig


def _tensor(array, config: ModelConfig, device) -> torch.Tensor:
    # bf16 arrays arrive as ml_dtypes' bfloat16, which torch cannot read:
    # widen to fp32 (exact) on the host, then cast to the config's dtype
    host = np.array(array)  # a writable, contiguous copy
    if host.dtype.name == "bfloat16":
        host = host.astype(np.float32)
    return torch.from_numpy(host).to(
        device=device, dtype=config.dtype
    )


def params_from_jax(
    numpy_pytree: dict, config: ModelConfig, device: str | torch.device = "cuda"
) -> dict:
    """The port's parameter dict from the reference's (numpy leaves).

    Every weight is cast to ``config.dtype``; a bf16 or f32 reference
    converts exactly into the same dtype."""
    params = {
        name: _tensor(value, config, device)
        for name, value in numpy_pytree.items() if name != "layers"
    }
    params["layers"] = [
        {name: _tensor(value, config, device) for name, value in layer.items()}
        for layer in numpy_pytree["layers"]
    ]
    return params
