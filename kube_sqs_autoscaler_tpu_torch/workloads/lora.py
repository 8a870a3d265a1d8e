"""LoRA: low-rank adapter fine-tuning for both model families.

Counterpart of ``kube_sqs_autoscaler_tpu/workloads/lora.py`` without its
pipeline functions, which wait for ROADMAP Queue 1 item 5b.  On a mesh
the adapters (and their AdamW moments) are replicated on every rank, each
rank adds its slice of ``A @ B`` to its slice of the frozen base, and the
adapters' gradients sum over every axis the base is split or replicated
over.  LoRA trains
rank-``r`` factors ``A [in, r]``, ``B [r, out]`` per targeted weight
instead of the weight: the base stays frozen (no gradient, no AdamW
moments) and only the adapters carry optimizer state.

Adapters are a tree beside ``params["layers"]``, ``{"layers": [{name:
{"a": ..., "b": ...}}]}`` in fp32, and :func:`apply_lora` builds the
effective weights ``W + (alpha / r) A @ B`` inside the step, so every
forward, loss and attention kernel is the ordinary one evaluated at the
adapted weights, with gradients reaching only the adapters.  3-D MoE
expert stacks ``[E, in, out]`` get per-expert factors; the router stays
frozen.  ``B`` starts at zero, so the adapted model starts equal to the
base.  :func:`merge_lora` folds the adapters into plain weights for
serving: a LoRA checkpoint stores the merged weights
(:func:`lora_checkpoint_state`), which the worker serves unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

# per-family default targets: the attention projections, the MLP matmuls
# and the MoE expert stacks; names a family lacks are skipped
DEFAULT_TARGETS = (
    "wq", "wkv", "wqkv", "wo", "w_up", "w_down", "w_gate_up",
    "w_up_experts", "w_down_experts", "w_gate_up_experts",
)


@dataclass(frozen=True)
class LoraConfig:
    rank: int = 8
    alpha: float = 16.0
    # weight names (within each layer dict) that receive adapters
    targets: tuple = field(default_factory=lambda: DEFAULT_TARGETS)

    def __post_init__(self) -> None:
        if self.rank < 1:
            raise ValueError(f"rank={self.rank} must be >= 1")

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def init_lora_params(generator: torch.Generator, params: dict,
                     config: LoraConfig) -> dict:
    """Adapters for every targeted weight in ``params["layers"]``, on the
    weights' device: ``a ~ N(0, 1) / rank`` (drawn in fp32 on the host
    from ``generator``, layer by layer and target by target) and ``b =
    0``, so ``apply_lora(params, adapters) == params``.  3-D expert stacks
    ``[E, in, out]`` get ``a [E, in, r]`` and ``b [E, r, out]``."""
    layers = []
    for i, layer in enumerate(params["layers"]):
        adapters = {}
        for name in config.targets:
            w = layer.get(name)
            if w is None or w.ndim not in (2, 3):
                continue
            lead = tuple(w.shape[:-2])  # () for 2-D, (E,) for expert stacks
            draw = torch.randn((*lead, w.shape[-2], config.rank),
                               generator=generator, dtype=torch.float32)
            adapters[name] = {
                "a": (draw / config.rank).to(w.device),
                "b": torch.zeros((*lead, config.rank, w.shape[-1]),
                                 dtype=torch.float32, device=w.device),
            }
        if not adapters:
            raise ValueError(
                f"no targeted weights found in layer {i}: targets="
                f"{config.targets}, layer keys={sorted(layer)}"
            )
        layers.append(adapters)
    return {"layers": layers}


def apply_lora(params: dict, adapters: dict, config: LoraConfig,
               mesh=None) -> dict:
    """Effective parameters ``W + (alpha / r) A @ B`` for the adapted
    weights, in fp32 and cast back to each weight's dtype; everything else
    passes through as the same tensor.  Gradients reach ``adapters``
    through the sum; the base gets none.  With a ``mesh``, ``params`` are
    a rank's slices (:func:`.train.shard_params`) and each ``A @ B`` is
    sliced the same way."""
    from .train import slice_for_rank

    merged_layers = []
    for layer, adapter in zip(params["layers"], adapters["layers"]):
        merged = dict(layer)
        for name, ab in adapter.items():
            w = layer[name]
            # a leading expert axis batches through the matmul
            delta = torch.matmul(ab["a"], ab["b"]) * config.scale
            if mesh is not None:
                delta = slice_for_rank(name, delta, mesh)
            merged[name] = (w.float() + delta).to(w.dtype)
        merged_layers.append(merged)
    return dict(params, layers=merged_layers)


def merge_lora(params: dict, adapters: dict, config: LoraConfig) -> dict:
    """The adapters folded into plain weights (the serving form): the
    arithmetic of :func:`apply_lora`, detached."""
    with torch.no_grad():
        return apply_lora(params, adapters, config)


def lora_param_count(adapters: dict) -> int:
    from .train import param_leaves

    return sum(t.numel() for t in param_leaves(adapters))


def init_lora_train_state(generator: torch.Generator, params: dict,
                          lora: LoraConfig, train_config) -> dict:
    """The adapters (leaves that require grad), their AdamW and the step
    count: the trainable state is the adapters alone."""
    from .train import make_optimizer, param_leaves, _unflatten

    adapters = init_lora_params(generator, params, lora)
    adapters = _unflatten(adapters, [
        t.detach().requires_grad_(True) for t in param_leaves(adapters)])
    return {"adapters": adapters,
            "optimizer": make_optimizer(train_config, adapters), "step": 0}


def adapter_grad_axes(adapters: dict, mesh) -> list[frozenset]:
    """The axes each adapter leaf's gradient sums over, in
    :func:`.train.param_leaves` order: ``data`` and ``seq`` (every rank
    saw other tokens) and the axes its base weight is split over (every
    rank saw another slice of ``A @ B``)."""
    from .train import sliced_axes

    return [frozenset(("data", "seq")) | sliced_axes(name, mesh)
            for layer in adapters["layers"] for name in sorted(layer)
            for _ in sorted(layer[name])]


def make_lora_train_step(model_config, train_config, frozen_params: dict,
                         lora: LoraConfig, device: str | torch.device = "cuda",
                         loss=None, mesh=None):
    """``step_fn(state, tokens) -> (state, loss)``: one adapter-only
    optimizer step on the frozen base.  ``loss(params, tokens,
    attention_fn)`` defaults to the GPT objective (the llama and MoE
    objectives come through the same seam).  It is
    :func:`.train.make_train_step` over the adapters, with the adapted
    weights built inside the objective: the same attention pick
    (``sliding_window`` bound in), accumulation, clip and AdamW.  With a
    ``mesh``: ``frozen_params`` are the rank's slices, ``loss`` a mesh
    objective (default :func:`.train.mesh_loss`), and the adapters'
    gradients sum as :func:`adapter_grad_axes` says."""
    from .train import loss_fn, make_train_step, mesh_loss

    if loss is None and mesh is not None:
        loss = mesh_loss(model_config, mesh, remat=train_config.remat)
    if loss is None:
        def loss(params, tokens, attention_fn):
            return loss_fn(params, tokens, model_config, attention_fn,
                           remat=train_config.remat)

    step = make_train_step(
        model_config, train_config, device,
        loss=lambda adapters, tokens, attention_fn: loss(
            apply_lora(frozen_params, adapters, lora, mesh), tokens,
            attention_fn),
        window=getattr(model_config, "sliding_window", None), mesh=mesh,
        grad_axes=adapter_grad_axes)

    def step_fn(state: dict, tokens: torch.Tensor):
        inner, loss_value = step({"params": state["adapters"],
                                  "optimizer": state["optimizer"],
                                  "step": state["step"]}, tokens)
        state["step"] = inner["step"]
        return state, loss_value

    return step_fn


def lora_checkpoint_state(frozen_params: dict, state: dict,
                          lora: LoraConfig) -> dict:
    """The on-disk form of a LoRA run: the MERGED weights under
    ``params`` (so the worker serves them, and
    :meth:`.checkpoint.TrainCheckpointer.restore_params` reads them, as
    any flat checkpoint) plus the adapter train state under ``lora``,
    which a resume restores.  The frozen base is not stored: the run
    rebuilds it from its seed or its HF source."""
    return {
        "params": merge_lora(frozen_params, state["adapters"], lora),
        "step": state["step"],
        "lora": {"adapters": state["adapters"],
                 "optimizer": state["optimizer"]},
    }
