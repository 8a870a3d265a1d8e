"""Post-training int8 weight quantization for serving.

Counterpart of ``kube_sqs_autoscaler_tpu/workloads/quantize.py``: each
per-layer matmul weight ``W [in, out]`` becomes int8 codes and one fp32
scale per output column (``W ~ codes * scale``, symmetric, no zero point).
Embeddings, the position table and the norms keep their dtype.  Only the
per-layer matmul families quantize (``wqkv/wo/w_up/w_down`` for the GPT,
``wq/wkv/wo/w_gate_up/w_down`` for the llama); the result is a drop-in for
every serving path (``forward``, prefill and decode, the worker binary's
``--quantize int8``).

A :class:`QuantizedTensor` dequantizes where it is used: ``h @ w`` falls
through ``torch.Tensor.__matmul__`` (which returns ``NotImplemented`` for an
operand that is no tensor) to :meth:`QuantizedTensor.__rmatmul__`, so the
model code runs unchanged.  XLA fuses the reference's ``int8 -> bf16 *
scale`` into the matmul's operand load; eager PyTorch does not, so each
int8 matmul here writes a bf16 copy of its weight and reads it again (about
5 bytes a parameter where the bf16 path moves 2).  The codes and scales are
bitwise the reference's compiled program's on the same fp32 input: the
scale is the max times the fp32 reciprocal of 127 (XLA's rewrite of the
reference's division by the constant), then the division by the scale and
round-half-to-even are the same IEEE operations in both.
"""

from __future__ import annotations

import torch

# per-layer weight names to quantize, by family
_GPT_WEIGHTS = ("wqkv", "wo", "w_up", "w_down")
_LLAMA_WEIGHTS = ("wq", "wkv", "wo", "w_gate_up", "w_down")
# the reference's compiled programs turn ``max_abs / 127.0`` into a product
# with the fp32 reciprocal (XLA's rewrite of a division by a constant); a
# Python float multiplies an fp32 tensor as fp32, so this is that product
_INV_127 = 1.0 / 127.0


class QuantizedTensor:
    """int8 codes and per-output-channel fp32 scales standing in for a
    ``[in, out]`` weight; ``@`` dequantizes into ``dtype`` at the use
    site.  A plain class (not an ``nn.Module``): params dicts share it by
    reference like any tensor."""

    def __init__(self, codes: torch.Tensor, scale: torch.Tensor,
                 dtype: torch.dtype) -> None:
        self.codes = codes  # int8 [in, out]
        self.scale = scale  # fp32 [out]
        self.dtype = dtype  # the activation dtype to dequantize into

    @property
    def shape(self) -> torch.Size:
        return self.codes.shape

    def numel(self) -> int:
        return self.codes.numel()

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(self.codes.to(device), self.scale.to(device),
                               self.dtype)

    def dequantize(self) -> torch.Tensor:
        return (self.codes.float() * self.scale).to(self.dtype)

    def __rmatmul__(self, other: torch.Tensor) -> torch.Tensor:
        return other @ self.dequantize()

    def __matmul__(self, other: torch.Tensor) -> torch.Tensor:
        return self.dequantize() @ other


def _quantize_arrays(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of a ``[in, out]`` weight:
    ``(codes int8 [in, out], scale fp32 [out])``."""
    w32 = w.float()
    max_abs = w32.abs().amax(dim=0)
    scale = torch.clamp(max_abs * _INV_127, min=1e-12)
    codes = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return codes, scale


def _quantize_weight(w: torch.Tensor) -> QuantizedTensor:
    codes, scale = _quantize_arrays(w)
    return QuantizedTensor(codes, scale, w.dtype)


def quantize_params(params: dict, family: str = "gpt") -> dict:
    """A params dict with the family's per-layer matmul weights as
    :class:`QuantizedTensor` (on the weights' device); the other entries
    are the same tensors, not copies."""
    names = _LLAMA_WEIGHTS if family == "llama" else _GPT_WEIGHTS
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = [
        {k: (_quantize_weight(v) if k in names else v)
         for k, v in layer.items()}
        for layer in params["layers"]
    ]
    return out


def param_leaves(params) -> list[torch.Tensor]:
    """Every tensor of a params tree (a :class:`QuantizedTensor` gives its
    codes and scale)."""
    if isinstance(params, dict):
        return [t for v in params.values() for t in param_leaves(v)]
    if isinstance(params, (list, tuple)):
        return [t for v in params for t in param_leaves(v)]
    if isinstance(params, QuantizedTensor):
        return [params.codes, params.scale]
    return [params]


def quantized_bytes(params: dict) -> int:
    """Total parameter bytes as stored (an int8 code counts one byte)."""
    return sum(t.numel() * t.element_size() for t in param_leaves(params))
