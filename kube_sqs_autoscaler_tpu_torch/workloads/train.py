"""One optimizer step of the GPT, on one device or on a mesh of ranks.

Counterpart of ``kube_sqs_autoscaler_tpu/workloads/train.py``: the
objective (the next-token NLL with its memory-lean fused readout), AdamW
with the reference's warmup-cosine schedule and global-norm clip, fp32
gradient accumulation, and the step that ties them together.
:func:`make_train_step` keeps the reference's ``loss=`` and ``window=``
seams, through which the llama, MoE and LoRA steps run.

On a ``("data", "seq", "model")`` mesh (:mod:`.distributed`) each rank
holds its slices of the parameters (:data:`PARAM_AXES`: Megatron column-
and row-parallel weights split per head, the vocabulary-parallel
embedding and readout, experts over ``data``), its batch rows and its
sequence slice; its objective is its share of the reference's global
mean (:func:`mesh_loss`), and the step sums the gradients over the ranks
that hold the same slices.

Where the two frameworks differ:

- JAX is pure and ``optax`` returns new parameters; here the step updates
  the parameter tensors and the optimizer state in place (no second copy
  of the weights or the Adam moments), and returns the same state dict.
- ``torch.optim.AdamW`` decays decoupled, ``p <- p * (1 - lr * wd)`` before
  the Adam update, where ``optax.adamw`` adds ``-lr * wd * p`` to it; the
  two are equal in exact arithmetic and differ only in rounding.  Both
  keep the moments in the parameters' dtype (``optax``'s
  ``mu_dtype=None``), so bf16 runs agree only loosely and parity is
  checked in fp32.
- The clip is ``optax.clip_by_global_norm``'s: the gradients are scaled by
  ``max_norm / g_norm`` only when ``g_norm >= max_norm``
  (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm and gives
  other numbers).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from .model import ModelConfig, forward, forward_hidden, init_params, unembed
from .quantize import QuantizedTensor


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.95
    # recompute block activations in the backward instead of keeping them
    # (torch.utils.checkpoint around each block): same values, lower peak
    # memory
    remat: bool = False
    # > 1: split each batch into that many microbatches and average their
    # fp32-summed grads under one optimizer step
    grad_accum: int = 1
    # warmup_steps > 0 adds linear warmup from 0; decay_steps > 0 adds
    # cosine decay to min_lr_ratio * learning_rate over that many steps
    warmup_steps: int = 0
    decay_steps: int = 0
    min_lr_ratio: float = 0.1
    # > 0: clip the global gradient norm to this before the AdamW update
    grad_clip_norm: float = 0.0

    def __post_init__(self) -> None:
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum={self.grad_accum} must be >= 1")
        if self.warmup_steps < 0 or self.decay_steps < 0:
            raise ValueError("warmup_steps/decay_steps must be >= 0")
        if self.grad_clip_norm < 0:
            raise ValueError(
                f"grad_clip_norm={self.grad_clip_norm} must be >= 0"
            )

    def schedule(self) -> Callable[[int], float]:
        """The learning rate as a function of the number of updates
        already taken (``optax``'s ``count``), with ``optax``'s
        ``linear_schedule`` and ``warmup_cosine_decay_schedule``
        arithmetic."""
        peak = self.learning_rate
        warmup = self.warmup_steps
        if warmup == 0 and self.decay_steps == 0:
            return lambda count: peak
        if self.decay_steps == 0:
            return lambda count: _linear(0.0, peak, warmup, count)
        decay = self.decay_steps
        end = self.min_lr_ratio * peak
        alpha = 0.0 if peak == 0.0 else end / peak

        def warmup_cosine(count: int) -> float:
            if count < warmup:
                return _linear(0.0, peak, warmup, count)
            t = min(count - warmup, decay)
            cosine = 0.5 * (1 + math.cos(math.pi * t / decay))
            return peak * ((1 - alpha) * cosine + alpha)

        return warmup_cosine


def _linear(init: float, end: float, steps: int, count: int) -> float:
    # optax.polynomial_schedule with power 1 (a constant when steps <= 0)
    if steps <= 0:
        return init
    frac = 1 - min(max(count, 0), steps) / steps
    return (init - end) * frac + end


def _keys(tree: dict) -> list:
    # top level by name with "layers" last, as the port has always ordered
    # its parameters
    return sorted(k for k in tree if k != "layers") + (
        ["layers"] if "layers" in tree else [])


def param_leaves(params) -> list[torch.Tensor]:
    """The tensors of a nested dict / list tree in a fixed order: each
    dict's entries by name (``layers`` last), each list in order.  For the
    model's parameter dict that is the top level by name, then each layer
    by name; MoE expert stacks and LoRA adapter trees nest the same way."""
    if isinstance(params, torch.Tensor):
        return [params]
    if isinstance(params, dict):
        return [leaf for key in _keys(params)
                for leaf in param_leaves(params[key])]
    return [leaf for item in params for leaf in param_leaves(item)]


def _unflatten(params, leaves):
    """A tree shaped like ``params`` holding ``leaves`` in
    :func:`param_leaves` order."""
    leaves = iter(leaves)

    def build(tree):
        if isinstance(tree, (torch.Tensor, QuantizedTensor)):
            return next(leaves)
        if isinstance(tree, dict):
            return {key: build(tree[key]) for key in _keys(tree)}
        return [build(item) for item in tree]

    return build(params)


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float,
                        sq_norm=None) -> list[torch.Tensor]:
    """``optax.clip_by_global_norm``: every gradient times
    ``max_norm / g_norm`` when ``g_norm >= max_norm``, else unchanged.
    The norm is taken in fp32; no host sync.  ``sq_norm(grads)`` gives the
    squared global norm where the gradients are a rank's slices (a mesh's
    :func:`mesh_sq_norm`); default the sum of their squares."""
    g_norm = torch.sqrt(sq_norm(grads) if sq_norm is not None else
                        sum(g.float().square().sum() for g in grads))
    keep = g_norm < max_norm
    return [torch.where(keep, g, (g / g_norm.to(g.dtype)) * max_norm)
            for g in grads]


class AdamW:
    """``optax.chain(clip_by_global_norm, adamw(schedule))`` over a
    parameter dict: :class:`torch.optim.AdamW` (eps 1e-8, decay on every
    parameter) whose learning rate is set from the schedule at each
    update, after the optional clip."""

    def __init__(self, config: TrainConfig, params: dict) -> None:
        self.config = config
        self.schedule = config.schedule()
        self.leaves = param_leaves(params)
        # the squared global norm of a rank's gradient slices (set by
        # place_state on a mesh that slices parameters)
        self.sq_norm = None
        self.adamw = torch.optim.AdamW(
            self.leaves, lr=config.learning_rate, betas=(config.b1, config.b2),
            eps=1e-8, weight_decay=config.weight_decay,
        )

    def update(self, grads: list[torch.Tensor], count: int) -> None:
        """Apply one update with the gradients of :attr:`leaves`; ``count``
        is the number of updates already taken."""
        if self.config.grad_clip_norm > 0:
            grads = clip_by_global_norm(grads, self.config.grad_clip_norm,
                                        self.sq_norm)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(count)
        for leaf, grad in zip(self.leaves, grads):
            leaf.grad = grad
        self.adamw.step()
        for leaf in self.leaves:
            leaf.grad = None

    def moments(self, count: int) -> dict:
        """The optimizer's state in plain tensors and ints, in
        :attr:`leaves` order (``optax``'s ``mu``, ``nu`` and ``count``):
        what a checkpoint stores.  Zeros before the first update."""
        state = self.adamw.state
        return {
            "count": int(count),
            "mu": [state[leaf]["exp_avg"] if leaf in state
                   else torch.zeros_like(leaf) for leaf in self.leaves],
            "nu": [state[leaf]["exp_avg_sq"] if leaf in state
                   else torch.zeros_like(leaf) for leaf in self.leaves],
        }

    def load_moments(self, moments: dict) -> None:
        """Restore :meth:`moments`: the next update continues the saved
        run's exactly."""
        if len(moments["mu"]) != len(self.leaves):
            raise ValueError(
                f"checkpoint holds {len(moments['mu'])} moment tensors, the "
                f"optimizer has {len(self.leaves)} parameters"
            )
        self.adamw.state.clear()
        if not moments["count"]:
            return
        for leaf, mu, nu in zip(self.leaves, moments["mu"], moments["nu"]):
            if mu.shape != leaf.shape or nu.shape != leaf.shape:
                raise ValueError(
                    f"checkpoint moment of shape {tuple(mu.shape)} for a "
                    f"parameter of shape {tuple(leaf.shape)}"
                )
            self.adamw.state[leaf] = {
                "step": torch.tensor(float(moments["count"]),
                                     dtype=torch.float32),
                "exp_avg": mu.to(device=leaf.device, dtype=leaf.dtype),
                "exp_avg_sq": nu.to(device=leaf.device, dtype=leaf.dtype),
            }


def make_optimizer(config: TrainConfig, params: dict) -> AdamW:
    return AdamW(config, params)


def next_token_nll(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy from full-sequence fp32 logits (the
    shift happens on the logits)."""
    log_probs = torch.log_softmax(logits[:, :-1], dim=-1)
    targets = tokens[:, 1:].long()
    return -log_probs.gather(-1, targets[..., None]).mean()


class _FusedNextTokenNll(torch.autograd.Function):
    """``next_token_nll(unembed(x, embed), tokens)`` that saves only
    ``(embed, x, tokens, lse)`` — the per-row logsumexp is ``[B, S-1]``,
    vocab times smaller than the fp32 logits — and recomputes the logits
    in the backward (the reference's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, embed, x, tokens):
        logits = unembed(x[:, :-1], embed)
        targets = tokens[:, 1:].long()
        m = logits.amax(dim=-1)
        lse = m + torch.log(torch.exp(logits - m[..., None]).sum(dim=-1))
        target_logit = logits.gather(-1, targets[..., None])[..., 0]
        ctx.save_for_backward(embed, x, tokens, lse)
        return (lse - target_logit).mean()

    @staticmethod
    def backward(ctx, g):
        embed, x, tokens, lse = ctx.saved_tensors
        targets = tokens[:, 1:].long()
        x_shift = x[:, :-1]
        probs = torch.exp(unembed(x_shift, embed) - lse[..., None])
        # d loss / d logits = (softmax - onehot(target)) / n_targets; the
        # onehot subtracted in place, so no second [B, S-1, V] tensor
        probs.scatter_add_(-1, targets[..., None],
                           torch.full_like(targets[..., None], -1.0,
                                           dtype=probs.dtype))
        dlogits = (probs * (g / targets.numel())).to(x.dtype)
        dx_shift = dlogits @ embed
        dx = torch.cat([dx_shift, torch.zeros_like(x[:, -1:])], dim=1)
        dembed = (dlogits.flatten(0, 1).t() @ x_shift.flatten(0, 1)).to(
            embed.dtype)
        return dembed, dx, None


def fused_next_token_nll(embed: torch.Tensor, x: torch.Tensor,
                         tokens: torch.Tensor) -> torch.Tensor:
    """The training objective's readout and loss; its gradient reaches
    ``embed`` and ``x``, and adds to the embedding's gather gradient on
    the tied ``embed``."""
    return _FusedNextTokenNll.apply(embed, x, tokens)


def loss_fn(params: dict, tokens: torch.Tensor, config: ModelConfig,
            attention_fn=None, remat: bool = False) -> torch.Tensor:
    """Next-token cross-entropy in fp32: the hidden-state forward plus
    :func:`fused_next_token_nll`."""
    return fused_next_token_nll(
        params["embed"],
        forward_hidden(params, tokens, config, attention_fn, remat=remat),
        tokens,
    )


def train_state(params: dict, train_config: TrainConfig) -> dict:
    """A train state around existing parameters: each becomes a leaf that
    requires grad, and the optimizer is built over them."""
    params = _unflatten(params, [
        t.detach().requires_grad_(True) for t in param_leaves(params)
    ])
    return {"params": params,
            "optimizer": make_optimizer(train_config, params), "step": 0}


def init_train_state(generator: torch.Generator, model_config: ModelConfig,
                     train_config: TrainConfig,
                     device: str | torch.device = "cuda",
                     init_fn=init_params) -> dict:
    """Fresh params (``init_fn(model_config, generator, device)``), the
    optimizer and the step count."""
    return train_state(init_fn(model_config, generator, device), train_config)


def value_and_grad(loss, params: dict, tokens: torch.Tensor):
    """``(loss value, grads)`` of ``loss(params, tokens)``; grads are a
    dict shaped like ``params``."""
    value = loss(params, tokens)
    grads = torch.autograd.grad(value, param_leaves(params))
    return value.detach(), _unflatten(params, grads)


def accumulate_value_and_grad(vag, accum: int, accum_axis: int = 0):
    """Wrap ``vag(params, tokens) -> (loss, grads)`` in fp32 gradient
    accumulation over ``accum`` microbatches (``accum == 1`` returns
    ``vag``).  Microbatch ``j`` takes the rows ``≡ j (mod accum)`` along
    ``accum_axis`` (1 for the pipeline's ``[M, B_m, S]`` batches, whose
    axis 0 is its own microbatch schedule); grads are summed in fp32,
    averaged and cast back to each parameter's dtype."""
    if accum == 1:
        return vag

    def wrapped(params, tokens):
        ax = accum_axis
        n = tokens.shape[ax]
        if n % accum:
            raise ValueError(
                f"batch axis {ax} (size {n}) not divisible by "
                f"grad_accum={accum}"
            )
        micro = tokens.reshape(*tokens.shape[:ax], n // accum, accum,
                               *tokens.shape[ax + 1:])
        loss_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
        grad_sum = [torch.zeros_like(p, dtype=torch.float32)
                    for p in param_leaves(params)]
        for j in range(accum):
            loss, grads = vag(params, micro.select(ax + 1, j))
            loss_sum = loss_sum + loss
            for acc, grad in zip(grad_sum, param_leaves(grads)):
                acc.add_(grad.float())
        grads = [(acc / accum).to(p.dtype)
                 for acc, p in zip(grad_sum, param_leaves(params))]
        return loss_sum / accum, _unflatten(params, grads)

    return wrapped


def make_train_step(model_config, train_config: TrainConfig,
                    device: str | torch.device = "cuda", attention_fn=None,
                    loss=None, window: int | None = None, mesh=None,
                    grad_axes=None, value_and_grad_fn=None,
                    loss_axes=("data", "seq"), accum_axis: int = 0):
    """``step_fn(state, tokens) -> (state, loss)``: one optimizer step on
    ``[B, S]`` tokens, updating ``state`` in place.  The attention is
    ``flash.attention_fn_for(S, device, head_dim)`` — the CUDA kernels,
    forward and backward, on the card at the head dims they take; dense on
    the CPU and at any other head dim — with ``window`` bound in, unless
    ``attention_fn`` is given.  ``loss(params, tokens, attention_fn) ->
    scalar`` overrides the objective (default :func:`loss_fn` under
    ``train_config.remat``; the llama, MoE and LoRA steps pass theirs), so
    every family gets the same attention pick, accumulation, clip and
    AdamW.  ``loss`` is a detached fp32 scalar on the device (reading it
    is the caller's sync point).

    With a ``mesh`` (:class:`.distributed.Mesh`) the step runs on a rank:
    ``state`` holds its slices (:func:`place_state`), ``tokens`` its batch
    rows over the whole sequence (:func:`.data.prefetch_to_mesh`), the
    attention is :func:`mesh_attention_fn`'s and the objective the rank's
    share of the global loss (:func:`mesh_loss` by default); the step sums
    the gradients and the loss over the ranks that hold the same slices
    (``data`` x ``seq``, or the axes ``grad_axes(params, mesh)`` names
    leaf by leaf) before the update.

    ``value_and_grad_fn(params, tokens) -> (loss, grads)`` replaces the
    autograd of ``loss`` (the pipeline schedules, which run their own
    backward); on a mesh its loss is the rank's share, summed over
    ``loss_axes``.  ``accum_axis`` is the batch axis that ``--grad-accum``
    splits."""
    if mesh is not None:
        return _make_mesh_train_step(model_config, train_config, mesh,
                                     attention_fn, loss, window, grad_axes,
                                     value_and_grad_fn, loss_axes,
                                     accum_axis)
    from .flash import attention_fn_for, windowed

    attend = attention_fn or windowed(
        attention_fn_for(model_config.max_seq_len, device,
                         model_config.head_dim), window)
    if loss is None:
        def loss(params, tokens, attention_fn):
            return loss_fn(params, tokens, model_config, attention_fn,
                           remat=train_config.remat)

    compute_grads = accumulate_value_and_grad(
        value_and_grad_fn or (lambda params, tokens: value_and_grad(
            lambda p, t: loss(p, t, attend), params, tokens)),
        train_config.grad_accum, accum_axis,
    )

    def step_fn(state: dict, tokens: torch.Tensor):
        loss_value, grads = compute_grads(state["params"], tokens)
        state["optimizer"].update(param_leaves(grads), state["step"])
        state["step"] += 1
        return state, loss_value

    return step_fn


# ---------------------------------------------------------------------------
# The mesh: data, sequence and tensor parallelism over torch.distributed
# (the reference's train.py:35-173 and :369-416)
# ---------------------------------------------------------------------------

# logical axis name -> mesh axis (the reference's table)
_LOGICAL_TO_MESH = {
    "vocab": "model",
    "three_heads": "model",
    "heads": "model",
    "ff": "model",
    "model": None,  # d_model axes replicate (Megatron 1D sharding)
    "seq": None,
    "expert": "data",  # expert parallelism rides the data axis (ep = dp)
    "experts_out": None,  # the router's output axis replicates
    "kv_heads": "model",
    "ff2": "model",
}
# logical axes of the parameters, by name (the reference's
# model.PARAM_AXES, less the pipeline stage stacks)
PARAM_AXES = {
    "embed": ("vocab", "model"),
    "lm_head": ("vocab", "model"),
    "pos_embed": ("seq", "model"),
    "final_ln_scale": ("model",),
    "final_ln_bias": ("model",),
    "ln1_scale": ("model",),
    "ln1_bias": ("model",),
    "wqkv": ("model", "three_heads"),
    "wo": ("heads", "model"),
    "ln2_scale": ("model",),
    "ln2_bias": ("model",),
    "w_up": ("model", "ff"),
    "w_down": ("ff", "model"),
    "attn_norm": ("model",),
    "mlp_norm": ("model",),
    "final_norm": ("model",),
    "wq": ("model", "heads"),
    "wkv": ("model", "kv_heads"),
    "w_gate_up": ("model", "ff2"),
    "wk": ("model", "heads"),
    "wv": ("model", "heads"),
    "w_gate": ("model", "ff"),
    # MoE layers: the router replicates; expert stacks slice their expert
    # axis over data and their ff axis over model
    "router": ("model", "experts_out"),
    "w_up_experts": ("expert", "model", "ff"),
    "w_down_experts": ("expert", "ff", "model"),
    "w_gate_up_experts": ("expert", "model", "ff2"),
    # the pipeline's stage stacks split the fused SwiGLU expert projection
    "w_gate_experts": ("expert", "model", "ff"),
}
# a fused projection's output is several projections side by side; a rank
# takes its share of each, so q, k and v (gate and up) stay aligned head by
# head
_FUSED = {"three_heads": 3, "kv_heads": 2, "ff2": 2}


def mesh_attention_fn(mesh, window: int | None = None):
    """Ring attention when the mesh has a nontrivial ``seq`` axis, else
    the per-rank attention (:func:`.flash.make_sharded_attention`), with
    ``window`` threaded through either."""
    if mesh.shape["seq"] > 1:
        from .ring import make_ring_attention

        return make_ring_attention(mesh, window=window)
    from .flash import make_sharded_attention

    return make_sharded_attention(window)


def make_forward_step(mesh, model_config, params, forward_fn=None):
    """Sharded batch inference over a ``(data, model)`` mesh (the classify
    path the serving workers run; the reference's ``make_forward_step``).

    ``forward_fn(params, tokens, config, attention_fn, tp=)`` defaults to
    the gpt's :func:`.model.forward`; the llama family passes
    ``llama.llama_forward`` (the per-rank attention is GQA-native, so the
    same wiring serves both).  A ``sliding_window`` on the config is read
    off it and threaded through the attention.  ``params`` are the
    rank's.  Returns ``forward_step(params, tokens)``: every rank passes
    the global ``[B, S]`` batch, runs its rows over ``data`` and its
    heads over ``model`` (the flash forward on the card), and gets the
    global fp32 logits ``[B, S, V]`` back."""
    from .decode import gather_rows, rank_rows, require_serving_mesh

    require_serving_mesh(mesh)
    _check_divisible(mesh, model_config)
    attention_fn = mesh_attention_fn(
        mesh, window=getattr(model_config, "sliding_window", None))
    tp = tensor_parallel(mesh)
    forward_fn = forward_fn or forward

    def forward_step(params, tokens):
        tokens = torch.as_tensor(tokens, device=mesh.device)
        rows = rank_rows(mesh, tokens.shape[0])
        logits = forward_fn(params, tokens[rows], model_config, attention_fn,
                            tp=tp)
        return gather_rows(mesh, logits)

    return forward_step


def param_spec(name: str, axis: str = "model") -> tuple[int, int] | None:
    """``(dim, fused)`` of a parameter that slices over mesh ``axis``: the
    dimension and how many projections it fuses; ``None`` when it
    replicates over that axis."""
    axes = PARAM_AXES.get(name)
    if axes is None:
        return None
    for dim, logical in enumerate(axes):
        if _LOGICAL_TO_MESH[logical] == axis:
            return dim, _FUSED.get(logical, 1)
    return None


def sliced_axes(name: str, mesh) -> frozenset:
    """The nontrivial mesh axes a parameter slices over."""
    return frozenset(axis for axis in ("data", "model")
                     if mesh.shape[axis] > 1
                     and param_spec(name, axis) is not None)


def slice_for_rank(name: str, t: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's slice of the full parameter ``name``: its experts over
    ``data``, its heads, ff columns or vocabulary rows over ``model``."""
    for axis in ("data", "model"):
        ax = mesh.axis(axis)
        t = slice_param(t, param_spec(name, axis), ax.size, ax.index)
    return t


def gather_for_rank(name: str, t: torch.Tensor, mesh) -> torch.Tensor:
    """The full parameter ``name`` from every rank's slice (collective over
    the axes it slices over)."""
    for axis in ("model", "data"):
        spec = param_spec(name, axis)
        ax = mesh.axis(axis)
        if spec is not None and ax.size > 1:
            t = join_param(mesh.transport.all_gather(t, ax.group, ax.size),
                           spec)
    return t


def named_leaves(params, name: str = "") -> list[tuple[str, torch.Tensor]]:
    """:func:`param_leaves` with each tensor's parameter name (its
    innermost dict key); an int8 :class:`.quantize.QuantizedTensor` is one
    leaf."""
    if isinstance(params, (torch.Tensor, QuantizedTensor)):
        return [(name, params)]
    if isinstance(params, dict):
        return [leaf for key in _keys(params)
                for leaf in named_leaves(params[key], key)]
    return [leaf for item in params for leaf in named_leaves(item, name)]


def slice_param(t: torch.Tensor, spec, parts: int, index: int):
    """Rank ``index`` of ``parts``'s slice of a full parameter.  An int8
    :class:`.quantize.QuantizedTensor` slices its codes as the weight and
    its per-output-column scales with them when the slice cuts the output
    axis (a column-parallel weight); a row-parallel weight keeps every
    scale."""
    if spec is None or parts == 1:
        return t
    if isinstance(t, QuantizedTensor):
        dim, fused = spec
        scale = (slice_param(t.scale, (0, fused), parts, index) if dim == 1
                 else t.scale)
        return QuantizedTensor(slice_param(t.codes, spec, parts, index),
                               scale, t.dtype)
    dim, fused = spec
    n = t.shape[dim]
    if n % (fused * parts):
        raise ValueError(
            f"dimension {dim} of size {n} ({fused} fused projection(s)) "
            f"does not split over model_parallel={parts}")
    head, tail = t.shape[:dim], t.shape[dim + 1:]
    view = t.reshape(*head, fused, parts, n // (fused * parts), *tail)
    return view.select(dim + 1, index).reshape(*head, n // parts, *tail)


def join_param(pieces: list[torch.Tensor], spec) -> torch.Tensor:
    """The full parameter from every rank's slice (inverse of
    :func:`slice_param`)."""
    if spec is None or len(pieces) == 1:
        return pieces[0]
    dim, fused = spec
    n_local = pieces[0].shape[dim]
    head, tail = pieces[0].shape[:dim], pieces[0].shape[dim + 1:]
    split = [p.reshape(*head, fused, n_local // fused, *tail)
             for p in pieces]
    joined = torch.stack(split, dim=dim + 1)
    return joined.reshape(*head, n_local * len(pieces), *tail)


def _check_divisible(mesh, model_config, n_experts: int | None = None):
    """The shapes a mesh must split: over ``model`` the heads (the llama's
    kv heads among them: ``n_kv_heads % model_parallel``), the vocabulary
    and ``d_ff``; over ``data`` the experts."""
    if n_experts is not None and n_experts % mesh.shape["data"]:
        raise ValueError(f"n_experts={n_experts} not divisible by the data "
                         f"axis ({mesh.shape['data']}), which holds the "
                         "experts")
    tp = mesh.shape["model"]
    if tp == 1:
        return
    for what, n in (("n_heads", model_config.n_heads),
                    ("n_kv_heads", getattr(model_config, "n_kv_heads",
                                           model_config.n_heads)),
                    ("vocab_size", model_config.vocab_size),
                    ("d_ff", model_config.d_ff)):
        if n % tp:
            raise ValueError(f"{what}={n} not divisible by "
                             f"model_parallel={tp}")


def _own_leaf(t, device):
    """A rank's slice as a leaf of its own on ``device`` (an int8
    weight's codes and scales each)."""
    if isinstance(t, QuantizedTensor):
        return QuantizedTensor(_own_leaf(t.codes, device),
                               _own_leaf(t.scale, device), t.dtype)
    return t.detach().to(device).contiguous().clone()


def shard_params(params, mesh):
    """This rank's slices of a full parameter tree, on the mesh's device,
    each a leaf of its own (int8 serving weights included)."""
    leaves = [_own_leaf(slice_for_rank(name, t, mesh), mesh.device)
              for name, t in named_leaves(params)]
    return _unflatten(params, leaves)


def gather_params(params, mesh):
    """The full parameter tree from every rank's slices (all-gathers over
    the axes each slices over)."""
    return _unflatten(params, [gather_for_rank(name, t.detach(), mesh)
                               for name, t in named_leaves(params)])


def state_shardings(mesh, state: dict) -> dict:
    """How each tensor of a train state lies on the mesh: per parameter
    leaf ``{axis: (dim, fused, parts)}`` for the axes it slices over, or
    ``None`` (replicated); the AdamW moments follow their parameter; the
    count and step replicate."""
    specs = [{axis: (*param_spec(name, axis), mesh.shape[axis])
              for axis in sorted(sliced_axes(name, mesh))} or None
             for name, _ in named_leaves(state["params"])]
    return {"params": _unflatten(state["params"], specs),
            "optimizer": {"count": None, "mu": specs, "nu": specs},
            "step": None}


def mesh_sq_norm(mesh, sliced: list[frozenset]):
    """``sq_norm(grads)`` for :func:`clip_by_global_norm` on a rank: a
    sliced gradient's squares sum over the axes it slices over, a
    replicated one counts once (``sliced``: each leaf's axes)."""

    def sq_norm(grads):
        total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        buckets: dict = {}
        for g, axes in zip(grads, sliced):
            buckets[axes] = buckets.get(axes, 0) + g.float().square().sum()
        for axes, part in sorted(buckets.items(), key=lambda kv: sorted(
                kv[0])):
            if axes:
                part = mesh.transport.all_reduce(part.clone(),
                                                 mesh.group(*sorted(axes))
                                                 .group)
            total = total + part
        return total

    return sq_norm


def place_state(mesh, state: dict) -> dict:
    """A full train state (the same on every rank: the same seed, or a
    restored checkpoint) placed on the mesh: each rank keeps its slices of
    the parameters and of the AdamW moments, which follow their parameter;
    the count and the step replicate.  Returns a new state whose
    optimizer clips by the mesh's global norm."""
    optimizer = state["optimizer"]
    placed = train_state(shard_params(state["params"], mesh),
                         optimizer.config)
    names = [name for name, _ in named_leaves(state["params"])]
    moments = optimizer.moments(state["step"])
    for key in ("mu", "nu"):
        moments[key] = [slice_for_rank(name, t, mesh).to(mesh.device)
                        .contiguous() for name, t in zip(names, moments[key])]
    placed["optimizer"].load_moments(moments)
    sliced = [sliced_axes(name, mesh) for name in names]
    if any(sliced):
        placed["optimizer"].sq_norm = mesh_sq_norm(mesh, sliced)
    placed["step"] = state["step"]
    return placed


def gather_state(mesh, state: dict) -> dict:
    """The checkpointed form of a placed train state: the full parameters
    and moments gathered over ``model`` (the flat layout of a one-card
    run, which the single-card worker serves) and the step.  Every rank
    calls it (the gathers are collective)."""
    params = gather_params(state["params"], mesh)
    moments = state["optimizer"].moments(state["step"])
    names = [name for name, _ in named_leaves(state["params"])]
    for key in ("mu", "nu"):
        moments[key] = [gather_for_rank(name, t, mesh)
                        for name, t in zip(names, moments[key])]
    return {"params": params, "optimizer": moments, "step": state["step"]}


class TensorParallel:
    """The Megatron operators a block runs on a tensor-parallel rank:
    :meth:`copy` before a column-parallel matmul (identity forward,
    all-reduce backward), :meth:`reduce` after a row-parallel one (the
    transpose), and :meth:`embed`, the vocabulary-parallel lookup."""

    def __init__(self, mesh):
        self.mesh = mesh

    def copy(self, x):
        from .distributed import copy_to_model

        return copy_to_model(self.mesh, x)

    def reduce(self, x):
        from .distributed import reduce_from_model

        return reduce_from_model(self.mesh, x)

    @property
    def size(self) -> int:
        return self.mesh.shape["model"]

    def heads(self, n: int) -> int:
        """This rank's share of ``n`` heads (a cache's head count)."""
        return n // self.size

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The full last axis from every rank's slice of it, in rank order
        (all-gather over ``model``): the vocabulary-parallel readout's
        logits."""
        ax = self.mesh.axis("model")
        return torch.cat(self.mesh.transport.all_gather(x, ax.group, ax.size),
                         dim=-1)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor):
        """``embed_tokens`` of the full table from this rank's rows
        ``[V / tp, d]``: the rows it holds, zeros elsewhere, summed over
        ``model`` (the reference's gather rule on the full vocabulary)."""
        from .model import safe_ids

        ax = self.mesh.axis("model")
        rows = table.shape[0]
        ids = safe_ids(tokens, rows * ax.size) - ax.index * rows
        inside = (ids >= 0) & (ids < rows)
        out = table[ids.clamp(0, rows - 1)] * inside[..., None].to(
            table.dtype)
        return self.reduce(out)


def tensor_parallel(mesh) -> TensorParallel | None:
    """The mesh's :class:`TensorParallel`, ``None`` without a model
    axis."""
    return TensorParallel(mesh) if mesh.shape["model"] > 1 else None


class _ShardedNll(torch.autograd.Function):
    """``sum(weight * nll)`` of the next-token targets from the hidden
    states and a vocabulary-parallel readout ``[V / tp, d]`` (the
    reference's fused readout on a rank): fp32 logits of this rank's
    vocabulary slice, a max and a sum all-reduce over ``model`` for the
    logsumexp, the target logit from the rank that holds it.  Saves only
    ``(embed, x, targets, weight, lse)`` and recomputes the logits in the
    backward; ``x``'s gradient is summed over ``model`` there."""

    @staticmethod
    def forward(ctx, embed, x, targets, weight, mesh):
        import torch.distributed as dist

        from .model import unembed

        ax = mesh.axis("model")
        rows = embed.shape[0]
        logits = unembed(x, embed)
        m = mesh.transport.all_reduce(logits.amax(dim=-1), ax.group,
                                      dist.ReduceOp.MAX)
        sum_exp = mesh.transport.all_reduce(
            torch.exp(logits - m[..., None]).sum(dim=-1), ax.group)
        lse = m + torch.log(sum_exp)
        local = targets.long() - ax.index * rows
        inside = (local >= 0) & (local < rows)
        target_logit = mesh.transport.all_reduce(
            logits.gather(-1, local.clamp(0, rows - 1)[..., None])[..., 0]
            * inside, ax.group)
        ctx.save_for_backward(embed, x, targets, weight, lse)
        ctx.mesh = mesh
        return (weight * (lse - target_logit)).sum()

    @staticmethod
    def backward(ctx, g):
        from .model import unembed

        embed, x, targets, weight, lse = ctx.saved_tensors
        mesh = ctx.mesh
        ax = mesh.axis("model")
        rows = embed.shape[0]
        probs = torch.exp(unembed(x, embed) - lse[..., None])
        local = targets.long() - ax.index * rows
        inside = (local >= 0) & (local < rows)
        probs.scatter_add_(-1, local.clamp(0, rows - 1)[..., None],
                           -inside[..., None].to(probs.dtype))
        dlogits = (probs * (weight * g)[..., None]).to(x.dtype)
        dx = mesh.transport.all_reduce(dlogits @ embed, ax.group)
        dembed = (dlogits.flatten(0, 1).t() @ x.flatten(0, 1)).to(
            embed.dtype)
        return dembed, dx, None, None, None


def mesh_readout_loss(params, tokens, targets, weight, config, mesh, attend,
                      positions, remat: bool = False, forward_fn=None,
                      readout_fn=None, forward_factory=None) -> torch.Tensor:
    """A rank's share of the loss: the family's hidden states of its token
    slice ``[B_local, S_local]`` at ``positions`` (global, or permuted
    under zig-zag), then ``sum(weight * nll)`` of ``targets`` through the
    vocabulary-parallel readout.  ``forward_fn`` defaults to the gpt's
    :func:`.model.forward_hidden`, ``readout_fn(params)`` to the tied
    embedding.  ``forward_factory()`` (instead of ``forward_fn``) returns
    ``(forward_fn, finalize)`` afresh for each evaluation, and
    ``finalize(nll)`` is the share returned (the MoE aux term rides
    it)."""
    finalize = None
    if forward_factory is not None:
        forward_fn, finalize = forward_factory()
    forward_fn = forward_fn or forward_hidden
    x = forward_fn(params, tokens, config, attend, remat=remat,
                   positions=positions, tp=tensor_parallel(mesh))
    readout = (readout_fn or (lambda p: p["embed"]))(params)
    weight = weight.to(device=x.device, dtype=torch.float32)
    nll = _ShardedNll.apply(readout, x, targets, weight, mesh)
    return nll if finalize is None else finalize(nll)


def mesh_loss(config, mesh, remat: bool = False, forward_fn=None,
              readout_fn=None, forward_factory=None):
    """The natural-order objective on a rank, in the train step's
    loss-seam shape ``loss(params, tokens, attention_fn)``: ``tokens`` are
    the rank's batch rows over the whole sequence; the rank runs its
    contiguous ``S / P`` positions, whose targets are the next tokens (the
    first of the next rank's slice included), each weighted by ``1 / (B x
    (S - 1))`` of the global batch, so the shares of all ranks sum to the
    reference's mean.  Positions are global (``rank x S_local + i``)."""

    def loss(params, tokens, attention_fn):
        rows, seq = tokens.shape
        ax = mesh.axis("seq")
        if seq % ax.size:
            raise ValueError(f"sequence length {seq} not divisible by "
                             f"seq_parallel={ax.size}")
        seq_local = seq // ax.size
        lo = ax.index * seq_local
        positions = torch.arange(lo, lo + seq_local, device=tokens.device)
        next_tokens = torch.cat([tokens[:, 1:], tokens[:, :1] * 0], dim=1)
        count = rows * mesh.shape["data"] * (seq - 1)
        weight = (positions < seq - 1).float()[None, :] / count
        return mesh_readout_loss(
            params, tokens[:, lo:lo + seq_local],
            next_tokens[:, lo:lo + seq_local], weight, config, mesh,
            attention_fn, positions, remat=remat, forward_fn=forward_fn,
            readout_fn=readout_fn, forward_factory=forward_factory)

    return loss


def dense_grad_axes(params, mesh) -> list[frozenset]:
    """The axes each parameter's gradient sums over: those of ``data`` and
    ``seq`` that it does not slice over (an expert stack, sliced over
    ``data``, sums over ``seq`` only)."""
    return [frozenset(("data", "seq")) - sliced_axes(name, mesh)
            for name, _ in named_leaves(params)]


def reduce_grads(grads: list[torch.Tensor], mesh,
                 axes: list[frozenset]) -> None:
    """Sum each gradient over its ``axes`` (:func:`dense_grad_axes`), in
    place: one all-reduce of one flat buffer per set of axes and dtype."""
    buckets: dict = {}
    for g, group_axes in zip(grads, axes):
        group = mesh.group(*sorted(group_axes))
        if group is not None and group.group is not None:
            buckets.setdefault((tuple(sorted(group_axes)), g.dtype),
                               []).append(g)
    for (group_axes, _), same in sorted(buckets.items(),
                                        key=lambda kv: (kv[0][0],
                                                        str(kv[0][1]))):
        flat = torch.cat([g.reshape(-1) for g in same])
        mesh.transport.all_reduce(flat, mesh.group(*group_axes).group)
        offset = 0
        for g in same:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def _make_mesh_train_step(model_config, train_config, mesh, attention_fn,
                          loss, window, grad_axes=None,
                          value_and_grad_fn=None, loss_axes=("data", "seq"),
                          accum_axis: int = 0):
    if value_and_grad_fn is None:
        _check_divisible(mesh, model_config)
        attend = attention_fn or mesh_attention_fn(mesh, window)
        if loss is None:
            loss = mesh_loss(model_config, mesh, remat=train_config.remat)

        def value_and_grad_fn(params, tokens):
            return value_and_grad(lambda p, t: loss(p, t, attend), params,
                                  tokens)
    compute_grads = accumulate_value_and_grad(
        value_and_grad_fn, train_config.grad_accum, accum_axis)

    def step_fn(state: dict, tokens: torch.Tensor):
        loss_value, grads = compute_grads(state["params"], tokens)
        leaves = [g.contiguous() for g in param_leaves(grads)]
        reduce_grads(leaves, mesh, (grad_axes or dense_grad_axes)(
            state["params"], mesh))
        loss_value = mesh.transport.all_reduce(
            loss_value.clone(), mesh.group(*loss_axes).group)
        state["optimizer"].update(leaves, state["step"])
        state["step"] += 1
        return state, loss_value

    return step_fn
