"""Mixture-of-Experts MLP for both families, on one device.

Counterpart of ``kube_sqs_autoscaler_tpu/workloads/moe.py`` (its
pipeline step is :func:`.pipeline.make_pipeline_train_step`'s ``moe``:
inside a stage every data rank holds every expert).  On a mesh the experts
split over the ``data`` axis (expert parallelism: one ``all_to_all``
each way), each expert's ff columns over ``model``, and the routing runs
over the global token stream (:func:`make_mesh_moe_train_step`,
:func:`make_zigzag_moe_train_step`).  The routing is the reference's
GShard dense dispatch, kept as it is:

- **Dense dispatch**: routing is one-hot ``[G, T, E, C]`` dispatch and
  combine tensors with a static per-expert capacity ``C``, and the
  tokens reach the experts and come back through two einsums.  It is a
  plain large product the reference computes outside any kernel, so
  ``torch.einsum`` computes it here.  At the flagship width it costs more
  than the experts themselves (see ``PERF.md``); making it cheaper is
  performance work, not a port.
- **Groups over the flattened stream**: tokens are routed over the
  flattened ``[B*S]`` stream in groups of ``MoeConfig.group_size``
  (default: the largest divisor of the token count up to
  :data:`DEFAULT_GROUP_TOKENS`), so routing and capacity depend on the
  token stream alone, not on how the batch is shaped.
- **fp32 routing**: the router weight is fp32, its logits, softmax and
  top-k run in fp32, and the combine is in fp32 so the gate weighting is
  exact; the expert matmuls run in the model dtype.

Load balancing is the Switch-Transformer auxiliary loss
(``E * sum_e(frac_tokens_e * mean_prob_e)``), averaged over the layers
and added to the objective with ``MoeConfig.aux_loss_weight``.

Parameters keep the reference's names: per layer ``router [D, E]`` (fp32)
and ``w_up_experts [E, D, F]`` (GELU experts) or ``w_gate_up_experts
[E, D, 2F]`` (SwiGLU), and ``w_down_experts [E, F, D]``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import torch

from .llama import (
    init_llama_params, llama_forward, llama_forward_hidden, readout_weights,
)
from .model import (
    ModelConfig, _gelu, forward, forward_hidden, init_params,
)

# Default routing-group budget (tokens): bounded groups keep the
# [G, T, E, C] dispatch tensors linear in the batch size.
DEFAULT_GROUP_TOKENS = 4096


def _default_group(tokens: int) -> int:
    """Largest divisor of ``tokens`` that is <= DEFAULT_GROUP_TOKENS — a
    function of the token count alone, so routing stays invariant to a
    batch reshape."""
    group = min(DEFAULT_GROUP_TOKENS, tokens)
    while tokens % group:
        group -= 1
    return group


@dataclass(frozen=True)
class MoeConfig:
    """Routing hyper-parameters (defaults follow Switch/GShard practice).

    ``group_size`` fixes the routing-group length in tokens over the
    flattened ``[B*S]`` stream (``None`` = :func:`_default_group`).
    Capacity is per group."""

    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 1e-2
    group_size: int | None = None

    def __post_init__(self) -> None:
        if not 1 <= self.top_k <= self.n_experts:
            raise ValueError(
                f"top_k={self.top_k} must be in [1, n_experts={self.n_experts}]"
            )
        if self.group_size is not None and self.group_size < 1:
            raise ValueError(f"group_size={self.group_size} must be >= 1")

    def capacity(self, tokens_per_group: int) -> int:
        """Static per-expert slot count for a group of that many tokens."""
        return max(
            1,
            math.ceil(
                self.top_k * tokens_per_group * self.capacity_factor
                / self.n_experts
            ),
        )


def _add_expert_weights(params: dict, config, moe: MoeConfig,
                        generator: torch.Generator, device,
                        up_name: str, up_cols: int) -> dict:
    """Attach ``router`` (fp32) and the stacked expert weights to every
    layer of a dense-MLP-free parameter dict: std 0.02, ``0.02 / sqrt(2 *
    n_layers)`` on ``w_down_experts``, drawn in fp32 on the host."""
    out_scale = 0.02 / (2 * config.n_layers) ** 0.5

    def normal(shape, scale, dtype):
        draw = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (draw * scale).to(device=device, dtype=dtype)

    for layer in params["layers"]:
        # the router stays fp32: routing decisions are precision-sensitive
        layer["router"] = normal((config.d_model, moe.n_experts), 0.02,
                                 torch.float32)
        layer[up_name] = normal((moe.n_experts, config.d_model, up_cols),
                                0.02, config.dtype)
        layer["w_down_experts"] = normal(
            (moe.n_experts, config.d_ff, config.d_model), out_scale,
            config.dtype)
    return params


def init_moe_params(config: ModelConfig, moe: MoeConfig,
                    generator: torch.Generator,
                    device: str | torch.device = "cuda") -> dict:
    """The GPT's parameters with every layer's dense MLP replaced by
    ``router`` and stacked GELU expert weights."""
    params = init_params(config, generator, device, dense_mlp=False)
    return _add_expert_weights(params, config, moe, generator, device,
                               "w_up_experts", config.d_ff)


def init_llama_moe_params(config, moe: MoeConfig,
                          generator: torch.Generator,
                          device: str | torch.device = "cuda") -> dict:
    """Llama parameters with every layer's SwiGLU replaced by ``router``
    and stacked SwiGLU expert weights (``w_gate_up_experts [E, D, 2F]``,
    ``w_down_experts [E, F, D]``)."""
    params = init_llama_params(config, generator, device, dense_mlp=False)
    return _add_expert_weights(params, config, moe, generator, device,
                               "w_gate_up_experts", 2 * config.d_ff)


def _one_hot(index: torch.Tensor, n: int, dtype) -> torch.Tensor:
    # jax.nn.one_hot: an index outside [0, n) gives a row of zeros
    return (index[..., None] == torch.arange(n, device=index.device)).to(dtype)


def _top_k_routing(probs: torch.Tensor, moe: MoeConfig, capacity: int):
    """Greedy top-k assignment with per-expert capacity.

    ``probs``: fp32 ``[G, T, E]`` router softmax.  Returns ``dispatch
    [G, T, E, C]`` (0/1), ``combine [G, T, E, C]`` (gate-weighted
    dispatch) and the Switch aux loss.  A token that overflows an
    expert's capacity is dropped for that choice; gates are renormalized
    over the selected experts before the drop."""
    groups, tokens, n_experts = probs.shape
    remaining = probs
    choices = []  # (expert one-hot [G, T, E], gate [G, T])
    for _ in range(moe.top_k):
        # argmax takes the first of equal values, as jnp.argmax does
        onehot = _one_hot(remaining.argmax(dim=-1), n_experts, probs.dtype)
        choices.append((onehot, (probs * onehot).sum(dim=-1)))
        remaining = remaining * (1.0 - onehot)

    gate_sum = sum(g for _, g in choices)
    denom = torch.clamp(gate_sum, min=1e-9)

    dispatch = probs.new_zeros((groups, tokens, n_experts, capacity))
    combine = torch.zeros_like(dispatch)
    # slots already used per (group, expert) by earlier choices
    used = probs.new_zeros((groups, n_experts))
    for onehot, gate in choices:
        # each token's position within its chosen expert's slot sequence
        pos = torch.cumsum(onehot, dim=1) - onehot + used[:, None, :]
        used = used + onehot.sum(dim=1)
        kept = (onehot * (pos < capacity)).sum(dim=-1)  # [G, T] 0/1
        slot = (pos * onehot).sum(dim=-1).to(torch.int64)
        mask = onehot[..., None] * _one_hot(slot, capacity,
                                            probs.dtype)[:, :, None, :]
        mask = mask * kept[..., None, None]
        dispatch = dispatch + mask
        combine = combine + mask * (gate / denom)[..., None, None]

    # Switch aux loss on the first-choice assignment fractions
    frac_tokens = choices[0][0].mean(dim=(0, 1))  # [E]
    mean_prob = probs.mean(dim=(0, 1))  # [E]
    aux = n_experts * (frac_tokens * mean_prob).sum()
    return dispatch, combine, aux


def _routed_ffn(x: torch.Tensor, layer: dict, moe: MoeConfig, expert_ffn):
    """The family-agnostic route / dispatch / combine skeleton:
    ``[B, S, D] -> ([B, S, D], aux)``.  ``expert_ffn(expert_in, layer)``
    maps ``[E, G, C, D] -> [E, G, C, D]``."""
    b, s, d = x.shape
    tokens = b * s
    group = moe.group_size or _default_group(tokens)
    if tokens % group:
        raise ValueError(
            f"batch of {tokens} tokens not divisible by group_size={group}"
        )
    xg = x.reshape(tokens // group, group, d)
    capacity = moe.capacity(group)
    logits = torch.einsum("gtd,de->gte", xg.float(), layer["router"].float())
    probs = torch.softmax(logits, dim=-1)
    dispatch, combine, aux = _top_k_routing(probs, moe, capacity)
    # [G,T,E,C] x [G,T,D] -> [E,G,C,D]: the tokens to their experts
    expert_in = torch.einsum("gtec,gtd->egcd", dispatch.to(x.dtype), xg)
    expert_out = expert_ffn(expert_in, layer)
    # the way back in fp32, so the gate weighting is exact
    out = torch.einsum("gtec,egcd->gtd", combine, expert_out.float())
    return out.reshape(b, s, d).to(x.dtype), aux


def _gelu_experts(expert_in: torch.Tensor, layer: dict) -> torch.Tensor:
    hidden = _gelu(torch.einsum("egcd,edf->egcf", expert_in,
                                layer["w_up_experts"]))
    return torch.einsum("egcf,efd->egcd", hidden, layer["w_down_experts"])


def _swiglu_experts(expert_in: torch.Tensor, layer: dict) -> torch.Tensor:
    """SwiGLU experts from the fused ``w_gate_up_experts`` or the split
    ``w_gate_experts`` / ``w_up_experts`` of the pipeline's stage stacks
    (identical values)."""
    if "w_gate_up_experts" in layer:
        gate_up = torch.einsum("egcd,edf->egcf", expert_in,
                               layer["w_gate_up_experts"])
        gate, up = torch.chunk(gate_up, 2, dim=-1)
    else:
        gate = torch.einsum("egcd,edf->egcf", expert_in,
                            layer["w_gate_experts"])
        up = torch.einsum("egcd,edf->egcf", expert_in,
                          layer["w_up_experts"])
    silu = gate * torch.reciprocal(1 + torch.exp(-gate))
    return torch.einsum("egcf,efd->egcd", silu * up, layer["w_down_experts"])


def moe_mlp(x: torch.Tensor, layer: dict, moe: MoeConfig):
    """Sparse MLP of the GPT family: GELU experts behind the routing."""
    return _routed_ffn(x, layer, moe, _gelu_experts)


def llama_moe_mlp(x: torch.Tensor, layer: dict, moe: MoeConfig):
    """Sparse MLP of the llama family: SwiGLU experts (fused gate and up
    projection per expert) behind the same routing."""
    return _routed_ffn(x, layer, moe, _swiglu_experts)


def _collecting_mlp(expert_mlp, moe: MoeConfig):
    """Wrap an ``(h, layer, moe) -> (out, aux)`` expert MLP as a
    ``mlp(h, layer)`` seam that collects each layer's aux loss;
    ``mean_aux()`` is their mean."""
    aux_out = []

    def sparse_mlp(h, layer):
        out, aux = expert_mlp(h, layer, moe)
        aux_out.append(aux)
        return out

    def mean_aux():
        return sum(aux_out) / len(aux_out)

    return sparse_mlp, mean_aux


def moe_forward(params: dict, tokens: torch.Tensor, config: ModelConfig,
                moe: MoeConfig, attention_fn=None):
    """Logits and the mean auxiliary load-balance loss, through
    :func:`.model.forward`'s ``mlp`` seam."""
    sparse_mlp, mean_aux = _collecting_mlp(moe_mlp, moe)
    logits = forward(params, tokens, config, attention_fn, mlp=sparse_mlp)
    return logits, mean_aux()


def llama_moe_forward(params: dict, tokens: torch.Tensor, config,
                      moe: MoeConfig, attention_fn=None):
    """Llama counterpart of :func:`moe_forward` (RoPE, GQA and RMSNorm
    unchanged; the routed SwiGLU experts in the ``mlp`` seam)."""
    sparse_mlp, mean_aux = _collecting_mlp(llama_moe_mlp, moe)
    logits = llama_forward(params, tokens, config, attention_fn,
                           mlp=sparse_mlp)
    return logits, mean_aux()


def moe_loss_fn(params: dict, tokens: torch.Tensor, config: ModelConfig,
                moe: MoeConfig, attention_fn=None) -> torch.Tensor:
    """Next-token cross-entropy plus the weighted aux loss (fp32)."""
    from .train import fused_next_token_nll

    sparse_mlp, mean_aux = _collecting_mlp(moe_mlp, moe)
    x = forward_hidden(params, tokens, config, attention_fn, mlp=sparse_mlp)
    nll = fused_next_token_nll(params["embed"], x, tokens)
    return nll + moe.aux_loss_weight * mean_aux()


def llama_moe_loss_fn(params: dict, tokens: torch.Tensor, config,
                      moe: MoeConfig, attention_fn=None) -> torch.Tensor:
    """Llama-family MoE objective (cross-entropy plus weighted aux)."""
    from .train import fused_next_token_nll

    sparse_mlp, mean_aux = _collecting_mlp(llama_moe_mlp, moe)
    x = llama_forward_hidden(params, tokens, config, attention_fn,
                             mlp=sparse_mlp)
    nll = fused_next_token_nll(readout_weights(params), x, tokens)
    return nll + moe.aux_loss_weight * mean_aux()


def init_moe_train_state(generator: torch.Generator, config: ModelConfig,
                         moe: MoeConfig, train_config,
                         device: str | torch.device = "cuda") -> dict:
    from .train import train_state

    return train_state(init_moe_params(config, moe, generator, device),
                       train_config)


def init_llama_moe_train_state(generator: torch.Generator, config,
                               moe: MoeConfig, train_config,
                               device: str | torch.device = "cuda") -> dict:
    from .train import train_state

    return train_state(init_llama_moe_params(config, moe, generator, device),
                       train_config)


def _require_no_remat(train_config) -> None:
    """The MoE objectives collect each layer's aux loss through a closure
    over the ``mlp`` seam; a recomputing backward would run that closure
    again.  Refuse the flag instead of ignoring it."""
    if getattr(train_config, "remat", False):
        raise ValueError(
            "TrainConfig.remat is not supported for the MoE loss (the "
            "aux-loss collection is incompatible with a recomputing "
            "backward); set remat=False"
        )


def _make_moe_step(config, moe: MoeConfig, train_config, device, loss_fn):
    from .train import make_train_step

    _require_no_remat(train_config)
    objective = partial(loss_fn, config=config, moe=moe)
    return make_train_step(
        config, train_config, device,
        loss=lambda params, tokens, attention_fn: objective(
            params, tokens, attention_fn=attention_fn),
        # a llama MoE config may carry a window: it rides the same seam
        window=getattr(config, "sliding_window", None),
    )


def make_moe_train_step(config: ModelConfig, moe: MoeConfig, train_config,
                        device: str | torch.device = "cuda"):
    """One MoE optimizer step of the GPT through
    :func:`.train.make_train_step`'s loss seam."""
    return _make_moe_step(config, moe, train_config, device, moe_loss_fn)


def make_llama_moe_train_step(config, moe: MoeConfig, train_config,
                              device: str | torch.device = "cuda"):
    """The llama family's MoE optimizer step (same seams and
    constraints as :func:`make_moe_train_step`)."""
    return _make_moe_step(config, moe, train_config, device,
                          llama_moe_loss_fn)


# ---------------------------------------------------------------------------
# The mesh: expert parallelism over data, routing over the global stream
# (the reference's mesh paths of _make_moe_step and the zig-zag MoE step)
# ---------------------------------------------------------------------------

_token_index: dict = {}


def _local_tokens(batch: int, seq: int, group: int, mesh, device):
    """This rank's tokens in the flattened global ``[B, S]`` stream (batch
    rows over ``data``, sequence slices over ``seq``, in the ranks' own
    order: natural, or zig-zag's permuted one): each local token's routing
    group and position in it, and per group the local tokens it holds.
    Shapes alone decide them, so they are built once, on the host, and
    kept on the device."""
    data, seq_ax = mesh.axis("data"), mesh.axis("seq")
    key = (batch, seq, group, data.index, seq_ax.index, data.size,
           seq_ax.size, str(device))
    found = _token_index.get(key)
    if found is not None:
        return found
    rows = data.index * batch + torch.arange(batch)
    cols = seq_ax.index * seq + torch.arange(seq)
    index = (rows[:, None] * (seq * seq_ax.size) + cols[None, :]).reshape(-1)
    groups = (batch * data.size * seq * seq_ax.size) // group
    by_group = [(g, torch.nonzero(index // group == g)[:, 0].to(device))
                for g in range(groups)]
    found = ((index // group).to(device), (index % group).to(device),
             groups, by_group)
    _token_index[key] = found
    return found


def _mesh_routing(probs: torch.Tensor, moe: MoeConfig, mesh):
    """:func:`_top_k_routing` of the whole global stream, for this rank's
    tokens.  ``probs``: this rank's fp32 ``[B_l, S_l, E]``.  The routing
    decisions (argmax, capacity positions) need every token of a group,
    so the probabilities are all-gathered (without gradient) over
    ``data`` x ``seq``; the gates and the aux share come from this rank's
    own, differentiable probabilities.  Returns ``dispatch`` and
    ``combine`` ``[n_local, E, C]``, the group count, the capacity, this
    rank's share of the Switch aux loss (the shares of all ranks sum to
    the reference's) and, per group, the local tokens it holds."""
    b, s, n_experts = probs.shape
    rep = mesh.replicas
    dp, sp = mesh.shape["data"], mesh.shape["seq"]
    gathered = mesh.transport.all_gather(probs.detach().contiguous(),
                                         rep.group, rep.size)
    full = torch.stack(gathered).reshape(dp, sp, b, s, n_experts).permute(
        0, 2, 1, 3, 4).reshape(dp * b, sp * s, n_experts)
    tokens = full.shape[0] * full.shape[1]
    group = moe.group_size or _default_group(tokens)
    if tokens % group:
        raise ValueError(
            f"batch of {tokens} tokens not divisible by group_size={group}"
        )
    capacity = moe.capacity(group)
    group_of, place, groups, by_group = _local_tokens(b, s, group, mesh,
                                                      probs.device)
    remaining = full.reshape(groups, group, n_experts)
    onehots = []
    for _ in range(moe.top_k):
        onehot = _one_hot(remaining.argmax(dim=-1), n_experts, probs.dtype)
        onehots.append(onehot)
        remaining = remaining * (1.0 - onehot)
    local = probs.reshape(-1, n_experts)
    chosen = [onehot[group_of, place] for onehot in onehots]
    gates = [(local * onehot).sum(dim=-1) for onehot in chosen]
    denom = torch.clamp(sum(gates), min=1e-9)
    dispatch = local.new_zeros((local.shape[0], n_experts, capacity))
    combine = torch.zeros_like(dispatch)
    used = full.new_zeros((groups, n_experts))
    for onehot, mine, gate in zip(onehots, chosen, gates):
        pos = torch.cumsum(onehot, dim=1) - onehot + used[:, None, :]
        used = used + onehot.sum(dim=1)
        kept = (onehot * (pos < capacity)).sum(dim=-1)[group_of, place]
        slot = (pos * onehot).sum(dim=-1).to(torch.int64)[group_of, place]
        mask = mine[..., None] * _one_hot(slot, capacity,
                                          probs.dtype)[:, None, :]
        mask = mask * kept[:, None, None]
        dispatch = dispatch + mask
        combine = combine + mask * (gate / denom)[:, None, None]
    frac_tokens = onehots[0].mean(dim=(0, 1))  # [E], the whole stream
    mean_prob_share = local.sum(dim=0) / tokens
    aux = n_experts * (frac_tokens * mean_prob_share).sum()
    return dispatch, combine, groups, capacity, aux, by_group


def _mesh_routed_ffn(x: torch.Tensor, layer: dict, moe: MoeConfig,
                     expert_ffn, mesh):
    """:func:`_routed_ffn` on a rank of a mesh: ``[B_l, S_l, D] ->
    ([B_l, S_l, D], aux share)``.  The local tokens fill their slots of
    the one-hot ``[E, G, C, D]`` layout; with a data axis the experts are
    split over it (``layer``'s stacks hold this rank's ``E / dp``), and one
    ``all_to_all`` over ``data`` takes each expert's slots to its rank and
    another brings the outputs back; with a model axis each expert's ff
    columns are split (Megatron, its ``f`` and ``g`` around the expert
    FFN).  Every slot is filled by one token, so each rank's partial
    inputs add up to the reference's."""
    from .distributed import all_to_all, copy_to_model, reduce_from_model

    b, s, d = x.shape
    xl = x.reshape(-1, d)
    logits = xl.float() @ layer["router"].float()
    probs = torch.softmax(logits, dim=-1).reshape(b, s, -1)
    dispatch, combine, groups, capacity, aux, by_group = _mesh_routing(
        probs, moe, mesh)
    dispatch = dispatch.to(x.dtype)
    n_experts = moe.n_experts
    expert_in = torch.stack(
        [torch.einsum("tec,td->ecd", dispatch[sel], xl[sel])
         for _, sel in by_group], dim=1)  # [E, G, C, D]
    data = mesh.axis("data")
    mine = expert_in
    if data.size > 1:
        share = n_experts // data.size
        mine = all_to_all(mesh, "data", expert_in.reshape(
            data.size, share, groups, capacity, d)).sum(dim=0)
    mine = copy_to_model(mesh, mine)
    out_mine = reduce_from_model(mesh, expert_ffn(mine, layer))
    expert_out = out_mine
    if data.size > 1:
        expert_out = all_to_all(mesh, "data", out_mine.unsqueeze(0).expand(
            data.size, *out_mine.shape).contiguous()).reshape(
                n_experts, groups, capacity, d)
    out = xl.new_zeros(xl.shape, dtype=torch.float32)
    for g, sel in by_group:
        out = out.index_add(0, sel, torch.einsum(
            "tec,ecd->td", combine[sel], expert_out[:, g].float()))
    return out.reshape(b, s, d).to(x.dtype), aux


def mesh_forward_factory(moe: MoeConfig, mesh, llama: bool = False,
                         aux_weight: float | None = None):
    """``forward_factory()`` for the mesh objectives
    (:func:`.train.mesh_loss`, :func:`.zigzag.make_zigzag_loss`): a fresh
    family forward per loss evaluation whose ``mlp`` seam is the routed
    experts on the mesh, and ``finalize(nll)`` adding the weighted mean
    of the layers' aux shares (``aux_weight`` 0: the pure NLL, for
    eval)."""
    from .llama import llama_forward_hidden as llama_hidden

    expert_ffn = _swiglu_experts if llama else _gelu_experts
    weight = moe.aux_loss_weight if aux_weight is None else aux_weight

    def factory():
        aux_out = []

        def sparse_mlp(h, layer):
            out, aux = _mesh_routed_ffn(h, layer, moe, expert_ffn, mesh)
            aux_out.append(aux)
            return out

        # the experts run their own tensor parallelism (the router must
        # see every expert's full output)
        sparse_mlp.tp_native = True
        hidden = llama_hidden if llama else forward_hidden

        def fwd(params, tokens, config, attention_fn, remat=False,
                positions=None, tp=None):
            return hidden(params, tokens, config, attention_fn,
                          mlp=sparse_mlp, remat=remat, positions=positions,
                          tp=tp)

        def finalize(nll):
            return nll + weight * (sum(aux_out) / len(aux_out))

        return fwd, finalize

    return factory


def _make_mesh_moe_step(config, moe: MoeConfig, train_config, mesh, llama,
                        zigzag: bool = False):
    from .train import _check_divisible, make_train_step, mesh_loss

    _require_no_remat(train_config)
    _check_divisible(mesh, config, moe.n_experts)
    readout = readout_weights if llama else None
    factory = mesh_forward_factory(moe, mesh, llama)
    if zigzag:
        from .zigzag import make_zigzag_loss

        loss = make_zigzag_loss(mesh, config, readout_fn=readout,
                                forward_factory=factory)
    else:
        loss = mesh_loss(config, mesh, readout_fn=readout,
                         forward_factory=factory)
    return make_train_step(config, train_config, mesh.device, loss=loss,
                           window=getattr(config, "sliding_window", None),
                           mesh=mesh)


def make_mesh_moe_train_step(mesh, config, moe: MoeConfig, train_config,
                             llama: bool = False):
    """A dp x sp x tp x ep MoE step of either family (the reference's
    ``make_moe_train_step`` / ``make_llama_moe_train_step`` over a mesh):
    the experts split over ``data``, the routing over the global token
    stream, ring attention over ``seq``."""
    return _make_mesh_moe_step(config, moe, train_config, mesh, llama)


def make_zigzag_moe_train_step(mesh, config, moe: MoeConfig, train_config,
                               llama: bool = False):
    """MoE x zig-zag: the routed experts ride the permuted-order zig-zag
    objective (routing groups over the permuted stream, as the
    reference's)."""
    return _make_mesh_moe_step(config, moe, train_config, mesh, llama,
                               zigzag=True)
