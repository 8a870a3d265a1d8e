"""One optimizer step of the GPT on one device.

Counterpart of the single-device part of
``kube_sqs_autoscaler_tpu/workloads/train.py``: the objective (the
next-token NLL with its memory-lean fused readout), AdamW with the
reference's warmup-cosine schedule and global-norm clip, fp32 gradient
accumulation, and the step that ties them together.  The reference's mesh,
sharding and ring-attention functions wait for the mesh (ROADMAP Queue 1
item 5).  :func:`make_train_step` keeps the reference's ``loss=`` and
``window=`` seams, through which the llama, MoE and LoRA steps run.

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

from .model import ModelConfig, forward_hidden, init_params, unembed


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
        if isinstance(tree, torch.Tensor):
            return next(leaves)
        if isinstance(tree, dict):
            return {key: build(tree[key]) for key in _keys(tree)}
        return [build(item) for item in tree]

    return build(params)


def clip_by_global_norm(grads: list[torch.Tensor],
                        max_norm: float) -> list[torch.Tensor]:
    """``optax.clip_by_global_norm``: every gradient times
    ``max_norm / g_norm`` when ``g_norm >= max_norm``, else unchanged.
    The norm is taken in fp32; no host sync."""
    g_norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
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
        self.adamw = torch.optim.AdamW(
            self.leaves, lr=config.learning_rate, betas=(config.b1, config.b2),
            eps=1e-8, weight_decay=config.weight_decay,
        )

    def update(self, grads: list[torch.Tensor], count: int) -> None:
        """Apply one update with the gradients of :attr:`leaves`; ``count``
        is the number of updates already taken."""
        if self.config.grad_clip_norm > 0:
            grads = clip_by_global_norm(grads, self.config.grad_clip_norm)
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


def accumulate_value_and_grad(vag, accum: int):
    """Wrap ``vag(params, tokens) -> (loss, grads)`` in fp32 gradient
    accumulation over ``accum`` microbatches (``accum == 1`` returns
    ``vag``).  Microbatch ``j`` takes rows ``≡ j (mod accum)``; grads are
    summed in fp32, averaged and cast back to each parameter's dtype."""
    if accum == 1:
        return vag

    def wrapped(params, tokens):
        n = tokens.shape[0]
        if n % accum:
            raise ValueError(
                f"batch axis 0 (size {n}) not divisible by "
                f"grad_accum={accum}"
            )
        micro = tokens.reshape(n // accum, accum, *tokens.shape[1:])
        loss_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
        grad_sum = [torch.zeros_like(p, dtype=torch.float32)
                    for p in param_leaves(params)]
        for j in range(accum):
            loss, grads = vag(params, micro[:, j])
            loss_sum = loss_sum + loss
            for acc, grad in zip(grad_sum, param_leaves(grads)):
                acc.add_(grad.float())
        grads = [(acc / accum).to(p.dtype)
                 for acc, p in zip(grad_sum, param_leaves(params))]
        return loss_sum / accum, _unflatten(params, grads)

    return wrapped


def make_train_step(model_config, train_config: TrainConfig,
                    device: str | torch.device = "cuda", attention_fn=None,
                    loss=None, window: int | None = None):
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
    is the caller's sync point)."""
    from .flash import attention_fn_for, windowed

    attend = attention_fn or windowed(
        attention_fn_for(model_config.max_seq_len, device,
                         model_config.head_dim), window)
    if loss is None:
        def loss(params, tokens, attention_fn):
            return loss_fn(params, tokens, model_config, attention_fn,
                           remat=train_config.remat)

    compute_grads = accumulate_value_and_grad(
        lambda params, tokens: value_and_grad(
            lambda p, t: loss(p, t, attend), params, tokens),
        train_config.grad_accum,
    )

    def step_fn(state: dict, tokens: torch.Tensor):
        loss_value, grads = compute_grads(state["params"], tokens)
        state["optimizer"].update(param_leaves(grads), state["step"])
        state["step"] += 1
        return state, loss_value

    return step_fn
