"""What both families' references share: float32 with TF32 off, the
linear layer (float32, or float8 for the control), and the run over
sequences layer by layer."""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0  # the largest finite float8 e4m3 value


@contextlib.contextmanager
def exact_float32():
    """Matrix products in true float32: TF32 off for the duration."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    precision = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.set_float32_matmul_precision(precision)


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (its largest magnitude maps to 448), back in float32."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """``x @ w`` for ``w`` ``[in, out]``: float32, or with both operands
    in float8 (per row of ``x``, per column of ``w``) for the control."""
    if precision == "fp8":
        return fp8(x, -1) @ fp8(w, 0)
    return x @ w


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: int | None) -> torch.Tensor:
    """``q`` ``[H, n, D]`` against ``k``, ``v`` ``[H_kv, n, D]`` (query
    head ``h`` reads kv head ``h // (H / H_kv)``): position ``i`` attends
    ``j <= i``, and ``j > i - window`` under a window; float32 softmax."""
    heads, n, dim = q.shape
    groups = heads // k.shape[0]
    k = k.repeat_interleave(groups, dim=0)
    v = v.repeat_interleave(groups, dim=0)
    rows = torch.arange(n, device=q.device)[:, None]
    cols = torch.arange(n, device=q.device)[None, :]
    visible = cols <= rows
    if window is not None:
        visible = visible & (cols > rows - window)
    out = torch.empty_like(q)
    for h in range(heads):
        scores = (q[h] @ k[h].T) / dim ** 0.5
        scores = scores.masked_fill(~visible, float("-inf"))
        out[h] = torch.softmax(scores, dim=-1) @ v[h]
    return out


def run_layers(stacked: dict, n_layers: int, hidden: list, block) -> list:
    """Each layer's weights upcast to float32 once, then
    ``block(x, layer)`` over every sequence's hidden state."""
    layer_kinds = [k for k, t in stacked.items()
                   if t.dim() >= 2 and t.shape[0] == n_layers
                   and k not in ("embed", "lm_head", "pos_embed")]
    for i in range(n_layers):
        layer = {k: stacked[k][i].float() for k in layer_kinds}
        hidden = [block(x, layer) for x in hidden]
        del layer
    return hidden
