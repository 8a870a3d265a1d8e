"""LoRA: low-rank adapter fine-tuning for both model families.

Counterpart of ``kube_sqs_autoscaler_tpu/workloads/lora.py``.  On a mesh
the adapters (and their AdamW moments) are replicated on every rank, each
rank adds its slice of ``A @ B`` to its slice of the frozen base, and the
adapters' gradients sum over every axis the base is split or replicated
over.  Through the pipeline (:func:`make_lora_pipeline_train_step`) the
adapters are stage-stacked like the weights they adapt, and each rank
keeps its stage's layers of them.  LoRA trains
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


# ---------------------------------------------------------------------------
# the pipeline's stage-stacked layout (the reference's lora.py:256-511)
# ---------------------------------------------------------------------------


def _pipeline_targets(targets: tuple) -> tuple:
    """Flat target names in the stage-stacked layout, whose fused
    projections are split (``wqkv`` adapts ``wq`` / ``wk`` / ``wv``: rank
    ``r`` per projection)."""
    split = {
        "wqkv": ("wq", "wk", "wv"),
        "wkv": ("wk", "wv"),
        "w_gate_up": ("w_gate", "w_up"),
        "w_gate_up_experts": ("w_gate_experts", "w_up_experts"),
    }
    out: list = []
    for name in targets:
        for t in split.get(name, (name,)):
            if t not in out:
                out.append(t)
    return tuple(out)


def init_pipeline_lora_params(generator: torch.Generator, params: dict,
                              config: LoraConfig) -> dict:
    """Adapters for the stage-stacked layout: one pair per targeted stack,
    ``a [L, in, r]`` and ``b [L, r, out]`` (``[L, E, ...]`` per expert for
    an expert stack), ``a ~ N(0, 1) / rank`` drawn in fp32 on the host
    target by target and ``b = 0``."""
    stages = params["stages"]
    adapters = {}
    for name in _pipeline_targets(config.targets):
        w = stages.get(name)
        if w is None or w.ndim not in (3, 4):
            continue
        draw = torch.randn((*w.shape[:-1], config.rank), generator=generator,
                           dtype=torch.float32)
        adapters[name] = {
            "a": (draw / config.rank).to(w.device),
            "b": torch.zeros((*w.shape[:-2], config.rank, w.shape[-1]),
                             dtype=torch.float32, device=w.device),
        }
    if not adapters:
        raise ValueError(
            f"no targeted stage weights found: targets={config.targets}, "
            f"stage keys={sorted(stages)}"
        )
    return {"stages": adapters}


def _stage_delta(name: str, ab: dict, config: LoraConfig, mesh=None):
    delta = torch.matmul(ab["a"], ab["b"]) * config.scale
    if mesh is None:
        return delta
    from .pipeline import stage_spec
    from .train import slice_param

    ax = mesh.axis("model")
    return slice_param(delta, stage_spec(name), ax.size, ax.index)


def apply_pipeline_lora(params: dict, adapters: dict, config: LoraConfig,
                        mesh=None) -> dict:
    """Effective stage stacks ``W + (alpha / r) A @ B`` (the leading layer
    and expert axes batch through the matmul); the other leaves pass
    through.  With a ``mesh``: a rank's part of the frozen tree and its
    stage's adapters, each ``A @ B`` sliced over ``model`` as its
    weight."""
    stages = dict(params["stages"])
    for name, ab in adapters["stages"].items():
        w = stages[name]
        stages[name] = (w.float() + _stage_delta(name, ab, config, mesh)).to(
            w.dtype)
    return dict(params, stages=stages)


def init_pipeline_lora_train_state(generator: torch.Generator, params: dict,
                                   lora: LoraConfig, train_config) -> dict:
    """:func:`init_lora_train_state` for the stage-stacked layout (the
    full adapters: :func:`place_pipeline_lora_state` keeps a rank's)."""
    from .train import _unflatten, make_optimizer, param_leaves

    adapters = init_pipeline_lora_params(generator, params, lora)
    adapters = _unflatten(adapters, [
        t.detach().requires_grad_(True) for t in param_leaves(adapters)])
    return {"adapters": adapters,
            "optimizer": make_optimizer(train_config, adapters), "step": 0}


def place_pipeline_lora_state(mesh, state: dict) -> dict:
    """A full adapter state placed on a pipeline mesh: each rank keeps its
    stage's layers of the adapters and of their AdamW moments (whole over
    ``model``); the optimizer clips by the global norm over ``pipe``."""
    from .pipeline import _stage_rows
    from .train import (
        _unflatten, make_optimizer, mesh_sq_norm, param_leaves,
    )

    leaves = [_stage_rows(t.detach(), mesh).to(mesh.device).contiguous()
              .clone().requires_grad_(True)
              for t in param_leaves(state["adapters"])]
    adapters = _unflatten(state["adapters"], leaves)
    optimizer = make_optimizer(state["optimizer"].config, adapters)
    moments = state["optimizer"].moments(state["step"])
    for key in ("mu", "nu"):
        moments[key] = [_stage_rows(t, mesh).to(mesh.device).contiguous()
                        for t in moments[key]]
    optimizer.load_moments(moments)
    optimizer.sq_norm = mesh_sq_norm(mesh, [frozenset(("pipe",))]
                                     * len(leaves))
    return {"adapters": adapters, "optimizer": optimizer,
            "step": state["step"]}


def gather_pipeline_lora_state(mesh, state: dict) -> dict:
    """The full adapters and their moments from every stage (collective)."""
    from .train import _unflatten, param_leaves

    pipe = mesh.axis("pipe")

    def full(t):
        t = t.detach()
        return torch.cat(mesh.transport.all_gather(t, pipe.group, pipe.size)
                         ) if pipe.size > 1 else t

    moments = state["optimizer"].moments(state["step"])
    for key in ("mu", "nu"):
        moments[key] = [full(t) for t in moments[key]]
    return {"adapters": _unflatten(state["adapters"], [
        full(t) for t in param_leaves(state["adapters"])]),
        "optimizer": moments, "step": state["step"]}


def lora_pipeline_grad_axes(adapters: dict, mesh) -> list[frozenset]:
    """The axes an adapter leaf's gradient sums over: ``data`` x ``seq``,
    and ``model`` where its weight is split (every model rank saw its own
    slice of ``A @ B``)."""
    from .pipeline import leaf_names, stage_spec

    model = (frozenset(("model",)) if mesh.shape["model"] > 1
             else frozenset())
    return [frozenset(("data", "seq")) | (model if stage_spec(name)
                                          is not None else frozenset())
            for name, _ in leaf_names(adapters)]


def lora_pipeline_value_and_grad(mesh, model_config, pcfg,
                                 frozen_params: dict, lora: LoraConfig,
                                 llama: bool = False, remat: bool = False,
                                 moe=None):
    """``vag(adapters, tokens) -> (loss share, adapter grads)`` through the
    pipeline, either schedule: the schedule differentiates the effective
    stage weights, and the chain rule of ``W + s A @ B`` takes their
    gradients to the adapters (the reference's 1F1B route, here for both
    schedules).  ``frozen_params`` is the rank's part of the base."""
    from .pipeline import _check_heads, run_pipeline
    from .train import _unflatten, param_leaves

    _check_heads(model_config, mesh)

    def vag(adapters, tokens):
        stages = dict(frozen_params["stages"])
        effective, names = [], sorted(adapters["stages"])
        for name in names:
            w = stages[name]
            eff = (w.float() + _stage_delta(name, adapters["stages"][name],
                                            lora, mesh)).to(w.dtype)
            effective.append(eff)
            stages[name] = eff.detach().requires_grad_(True)
        params = dict(frozen_params, stages=stages)
        loss, sums = run_pipeline(
            params, tokens, [stages[n] for n in names], model_config, pcfg,
            mesh, llama=llama, remat=remat, moe=moe)
        cots = [torch.zeros_like(e) if g is None else g.to(e.dtype)
                for e, g in zip(effective, sums)]
        leaves = param_leaves(adapters)
        grads = torch.autograd.grad(effective, leaves, cots)
        return loss, _unflatten(adapters, list(grads))

    return vag


def make_lora_pipeline_train_step(mesh, model_config, pcfg, train_config,
                                  frozen_params: dict, lora: LoraConfig,
                                  llama: bool = False, moe=None):
    """One adapter-only optimizer step through the pipeline, either
    schedule, through :func:`.train.make_train_step`'s seams (the frozen
    stage stacks are the rank's part, never updated; ``--grad-accum``
    splits the batch axis of ``[M, B_m, S]``).  ``state`` is
    :func:`place_pipeline_lora_state`'s."""
    from .pipeline import LOSS_AXES
    from .train import make_train_step

    if moe is not None:
        from .moe import _require_no_remat

        _require_no_remat(train_config)
    step = make_train_step(
        model_config, train_config, mesh.device, mesh=mesh,
        value_and_grad_fn=lora_pipeline_value_and_grad(
            mesh, model_config, pcfg, frozen_params, lora, llama=llama,
            remat=train_config.remat, moe=moe),
        grad_axes=lora_pipeline_grad_axes, loss_axes=LOSS_AXES,
        accum_axis=1)

    def step_fn(state: dict, tokens: torch.Tensor):
        inner, loss_value = step({"params": state["adapters"],
                                  "optimizer": state["optimizer"],
                                  "step": state["step"]}, tokens)
        state["step"] = inner["step"]
        return state, loss_value

    return step_fn


def lora_pipeline_checkpoint_state(frozen_params: dict, state: dict,
                                   lora: LoraConfig,
                                   llama: bool = False) -> dict:
    """:func:`lora_checkpoint_state` of a pipelined run (``state`` the full
    adapters, :func:`gather_pipeline_lora_state`): the merged weights
    unstacked to the flat serving layout, so the worker serves them as any
    flat checkpoint, and the stage-stacked adapter state a resume
    restores."""
    from .pipeline import unstack_layers, unstack_llama_layers

    with torch.no_grad():
        merged = apply_pipeline_lora(frozen_params, state["adapters"], lora)
    unstack = unstack_llama_layers if llama else unstack_layers
    return {
        "params": unstack(merged),
        "step": state["step"],
        "lora": {"adapters": state["adapters"],
                 "optimizer": state["optimizer"]},
    }
