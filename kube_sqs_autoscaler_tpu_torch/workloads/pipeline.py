"""Pipeline parallelism: GPipe and 1F1B microbatched stages over ranks.

Counterpart of ``kube_sqs_autoscaler_tpu/workloads/pipeline.py``.  The
layer stack is stage-stacked (one tensor per weight with a leading
``[n_layers]`` axis, the fused ``wqkv`` / ``wkv`` / ``w_gate_up`` split so
every projection slices by head or ff column) and a ``("pipe", "data",
"seq", "model")`` mesh (:func:`make_pipeline_mesh`) gives each rank of
``pipe`` index ``s`` the contiguous layers ``[s L/P, (s + 1) L/P)``, sliced
over ``model`` by the same Megatron rules as the flat mesh
(:data:`.train.PARAM_AXES`).  ``embed``, ``pos_embed``, the final norm
and an untied ``lm_head`` are whole on every rank, as the reference
replicates them.

A step runs a table of slots (:func:`gpipe_schedule`,
:func:`one_f_one_b_schedule`): in each slot a rank runs at most one
microbatch forward and one backward of its stage, then posts the slot's
hops in one exchange (:meth:`.distributed.Transport.exchange`): its
activation to ``pipe.next``, its input cotangent to ``pipe.prev``, and
the receives its neighbours' rows of the table announce.  Every rank
reads the same table, so the sends and receives of a slot pair up and
gloo cannot deadlock; the ``seq`` ring and the Megatron all-reduces run
inside a stage, on groups of ranks that share the table row.  Stage 0
embeds; the last stage applies the final norm, the readout and the
weighted NLL of its targets, so its "activation" is the loss share and
its cotangent 1.  The attention inside a stage is the kernel-backed one:
:func:`.flash.make_sharded_attention` (the lse forward and the dq / dk.dv
pair on the card), the ring (:mod:`.ring`) or zig-zag
(:mod:`.zigzag`) over ``seq``.

Where the port differs from the reference, computing the same function:

- only the ``M`` real microbatches run: the reference's lockstep body runs
  every stage ``M + P - 1`` times and masks the warm-up and drain slots;
- a backward slot differentiates the autograd graph its forward slot
  kept (at most ``min(M, P)`` in flight under 1F1B, ``M`` under GPipe),
  where the reference recomputes the stage forward in the backward slot
  because a ``jax.vjp`` closure cannot cross a ``lax.scan`` step; under
  ``remat`` each block is recomputed, as in the flat step;
- the hops are explicit sends of activations and cotangents, not a
  differentiated ``ppermute``; there is no ``_gpipe_tp_boundary``
  (``shard_map``'s autodiff conventions under ``check_vma=False`` have no
  counterpart in explicit autograd);
- every rank's objective is its share of the global mean (each target
  weighted ``1 / (M x B x (S - 1))``), so the gradients sum: stage leaves
  over ``data`` x ``seq``, the replicated leaves over ``pipe`` too (the
  tied embedding's lookup gradient from stage 0 meets its readout
  gradient from the last stage).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .distributed import Mesh, build_mesh, pipeline_mesh_shape
from .train import (
    PARAM_AXES, _FUSED, _LOGICAL_TO_MESH, _keys, _unflatten, join_param,
    param_leaves, slice_param,
)

# the objective's loss share sums over these axes (model ranks hold the
# same value)
LOSS_AXES = ("pipe", "data", "seq")


@dataclass(frozen=True)
class PipelineConfig:
    """How many microbatches, and which schedule: ``"gpipe"`` (every
    forward, then every backward; all ``M`` microbatches' activations
    live) or ``"1f1b"`` (interleaved; ``min(M, P)`` live)."""

    n_microbatches: int = 4
    schedule: str = "gpipe"

    def __post_init__(self) -> None:
        if self.schedule not in ("gpipe", "1f1b"):
            raise ValueError(
                f"schedule must be 'gpipe' or '1f1b', got {self.schedule!r}"
            )


def make_pipeline_mesh(pipe_parallel: int | None = None,
                       model_parallel: int = 1, seq_parallel: int = 1,
                       device: str | torch.device = "cuda") -> Mesh:
    """A ``("pipe", "data", "seq", "model")`` mesh over the world's ranks
    in enumeration order (``seq`` and ``model`` of size 1 unless asked
    for: the reference's ``("pipe", "data"[, "seq"][, "model"])``);
    ``pipe_parallel`` defaults to every rank."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    pipe = pipe_parallel if pipe_parallel is not None else world
    shape = pipeline_mesh_shape(world, pipe, model_parallel, seq_parallel)
    return build_mesh(list(range(world)), shape, device)


# ---------------------------------------------------------------------------
# the stage-stacked layout
# ---------------------------------------------------------------------------


def _stack(layers: list[dict]) -> dict:
    return {name: torch.stack([layer[name] for layer in layers])
            for name in layers[0]}


def _unstack(stages: dict) -> list[dict]:
    n_layers = next(iter(stages.values())).shape[0]
    return [{name: t[i] for name, t in stages.items()}
            for i in range(n_layers)]


def stack_layers(params: dict) -> dict:
    """``layers`` -> one dict of ``[L, ...]`` stacks, the fused ``wqkv``
    split into ``wq`` / ``wk`` / ``wv``."""
    stacked = _stack(params["layers"])
    stacked["wq"], stacked["wk"], stacked["wv"] = torch.chunk(
        stacked.pop("wqkv"), 3, dim=-1)
    return stacked


def unstack_layers(params: dict) -> dict:
    """A stage-stacked GPT tree back to the flat serving layout (``layers``
    with the fused ``wqkv``)."""
    stages = dict(params["stages"])
    stages["wqkv"] = torch.cat(
        [stages.pop("wq"), stages.pop("wk"), stages.pop("wv")], dim=-1)
    flat = {k: v for k, v in params.items() if k != "stages"}
    flat["layers"] = _unstack(stages)
    return flat


def stack_llama_layers(params: dict) -> dict:
    """The llama counterpart of :func:`stack_layers`: ``wkv`` splits into
    ``wk`` / ``wv``, ``w_gate_up`` into ``w_gate`` / ``w_up`` and
    ``w_gate_up_experts`` into ``w_gate_experts`` / ``w_up_experts``."""
    stacked = _stack(params["layers"])
    stacked["wk"], stacked["wv"] = torch.chunk(stacked.pop("wkv"), 2, dim=-1)
    if "w_gate_up" in stacked:
        stacked["w_gate"], stacked["w_up"] = torch.chunk(
            stacked.pop("w_gate_up"), 2, dim=-1)
    if "w_gate_up_experts" in stacked:
        stacked["w_gate_experts"], stacked["w_up_experts"] = torch.chunk(
            stacked.pop("w_gate_up_experts"), 2, dim=-1)
    return stacked


def unstack_llama_layers(params: dict) -> dict:
    """Inverse of the llama pipeline layout (fused ``wkv`` / ``w_gate_up``
    / ``w_gate_up_experts`` again)."""
    stages = dict(params["stages"])
    stages["wkv"] = torch.cat([stages.pop("wk"), stages.pop("wv")], dim=-1)
    if "w_gate" in stages:
        stages["w_gate_up"] = torch.cat(
            [stages.pop("w_gate"), stages.pop("w_up")], dim=-1)
    if "w_gate_experts" in stages:
        stages["w_gate_up_experts"] = torch.cat(
            [stages.pop("w_gate_experts"), stages.pop("w_up_experts")],
            dim=-1)
    flat = {k: v for k, v in params.items() if k != "stages"}
    flat["layers"] = _unstack(stages)
    return flat


def as_pipeline_params(params: dict) -> dict:
    """Flat GPT params -> the stage-stacked layout (the other leaves pass
    through)."""
    out = {k: v for k, v in params.items() if k != "layers"}
    out["stages"] = stack_layers(params)
    return out


def as_llama_pipeline_params(params: dict) -> dict:
    """Flat llama params -> the stage-stacked layout."""
    out = {k: v for k, v in params.items() if k != "layers"}
    out["stages"] = stack_llama_layers(params)
    return out


def check_stages(n_layers: int, n_stages: int) -> None:
    if n_layers % n_stages:
        raise ValueError(
            f"n_layers={n_layers} not divisible by n_stages={n_stages}"
        )


def init_pipeline_params(config, generator: torch.Generator, n_stages: int,
                         device: str | torch.device = "cuda") -> dict:
    """:func:`.model.init_params` in the stage-stacked layout."""
    from .model import init_params

    check_stages(config.n_layers, n_stages)
    return as_pipeline_params(init_params(config, generator, device))


def init_llama_pipeline_params(config, generator: torch.Generator,
                               n_stages: int,
                               device: str | torch.device = "cuda") -> dict:
    """:func:`.llama.init_llama_params` in the stage-stacked layout."""
    from .llama import init_llama_params

    check_stages(config.n_layers, n_stages)
    return as_llama_pipeline_params(init_llama_params(config, generator,
                                                      device))


# ---------------------------------------------------------------------------
# placement: a rank's stage, sliced over model
# ---------------------------------------------------------------------------


def stage_spec(name: str):
    """``(dim, fused)`` of a stage-stack leaf ``[L, ...]`` that slices over
    ``model`` (its Megatron axis, one past the layer axis), or ``None``.
    The router replicates and an expert stack keeps its expert axis whole:
    inside a stage the experts are not spread over ``data``."""
    axes = PARAM_AXES.get(name)
    if axes is None or name == "router":
        return None
    for dim, logical in enumerate(axes):
        if logical != "expert" and _LOGICAL_TO_MESH[logical] == "model":
            return dim + 1, _FUSED.get(logical, 1)
    return None


def leaf_names(params: dict) -> list[tuple[str, bool]]:
    """``(name, in_stages)`` of every leaf of a pipeline tree in
    :func:`.train.param_leaves` order: a stage leaf is named by its weight
    (an adapter's ``a`` and ``b`` by the weight they adapt)."""
    out = []
    for key in _keys(params):
        if key == "stages":
            for name in _keys(params["stages"]):
                out += [(name, True)] * len(param_leaves(
                    params["stages"][name]))
        else:
            out += [(key, False)] * len(param_leaves(params[key]))
    return out


def _stage_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    pipe = mesh.axis("pipe")
    check_stages(t.shape[0], pipe.size)
    per = t.shape[0] // pipe.size
    return t[pipe.index * per:(pipe.index + 1) * per]


def slice_stage(name: str, t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of a full stage stack: its layers, and its heads
    or ff columns over ``model``."""
    ax = mesh.axis("model")
    return slice_param(_stage_rows(t, mesh), stage_spec(name), ax.size,
                       ax.index)


def shard_pipeline_params(params: dict, mesh: Mesh) -> dict:
    """This rank's part of a full pipeline tree, on the mesh's device,
    each a leaf of its own: its stage's slices and the whole replicated
    leaves."""
    leaves = [(slice_stage(name, t.detach(), mesh) if staged else t.detach())
              .to(mesh.device).contiguous().clone()
              for (name, staged), t in zip(leaf_names(params),
                                           param_leaves(params))]
    return _unflatten(params, leaves)


def _gather_stage(name: str, t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    spec = stage_spec(name)
    model, pipe = mesh.axis("model"), mesh.axis("pipe")
    if spec is not None and model.size > 1:
        t = join_param(mesh.transport.all_gather(t, model.group, model.size),
                       spec)
    if pipe.size > 1:
        t = torch.cat(mesh.transport.all_gather(t, pipe.group, pipe.size))
    return t


def gather_pipeline_params(params: dict, mesh: Mesh) -> dict:
    """The full pipeline tree from every rank's part (collective: every
    rank calls it)."""
    return _unflatten(params, [
        _gather_stage(name, t.detach(), mesh) if staged else t.detach()
        for (name, staged), t in zip(leaf_names(params),
                                     param_leaves(params))])


def pipeline_sliced_axes(params: dict, mesh: Mesh) -> list[frozenset]:
    """The axes each leaf is split over, for the global-norm clip: a stage
    leaf over ``pipe`` (and ``model`` where it slices), a replicated leaf
    none (it counts once)."""
    return [(frozenset(("pipe",)) | (frozenset(("model",))
             if stage_spec(name) is not None and mesh.shape["model"] > 1
             else frozenset())) if staged else frozenset()
            for name, staged in leaf_names(params)]


def pipeline_grad_axes(params: dict, mesh: Mesh) -> list[frozenset]:
    """The axes each leaf's gradient sums over: a stage leaf over
    ``data`` x ``seq``; a replicated leaf over ``pipe`` too (only stage 0
    and the last stage use them)."""
    return [frozenset(("data", "seq")) if staged
            else frozenset(LOSS_AXES) for _, staged in leaf_names(params)]


def pipeline_state_shardings(mesh: Mesh, state: dict) -> dict:
    """How each tensor of a pipeline train state lies on the mesh: per
    leaf ``{"pipe": (0, 1, P), "model": (dim, fused, tp)}`` for a stage
    leaf (the axes it splits over), ``None`` for a replicated one; the
    AdamW moments follow their parameter."""
    specs = []
    for name, staged in leaf_names(state["params"]):
        spec = stage_spec(name)
        if not staged:
            specs.append(None)
            continue
        entry = {"pipe": (0, 1, mesh.shape["pipe"])}
        if spec is not None and mesh.shape["model"] > 1:
            entry["model"] = (*spec, mesh.shape["model"])
        specs.append(entry)
    return {"params": _unflatten(state["params"], specs),
            "optimizer": {"count": None, "mu": specs, "nu": specs},
            "step": None}


def place_pipeline_state(mesh: Mesh, state: dict) -> dict:
    """A full pipeline train state (the same on every rank) placed on the
    mesh: each rank keeps its stage's slices of the parameters and of the
    AdamW moments, and the replicated leaves whole; the optimizer clips by
    the mesh's global norm."""
    from .train import mesh_sq_norm, train_state

    optimizer = state["optimizer"]
    params = state["params"]
    placed = train_state(shard_pipeline_params(params, mesh),
                         optimizer.config)
    moments = optimizer.moments(state["step"])
    for key in ("mu", "nu"):
        moments[key] = [
            (slice_stage(name, t, mesh) if staged else t).to(mesh.device)
            .contiguous()
            for (name, staged), t in zip(leaf_names(params), moments[key])]
    placed["optimizer"].load_moments(moments)
    placed["optimizer"].sq_norm = mesh_sq_norm(
        mesh, pipeline_sliced_axes(params, mesh))
    placed["step"] = state["step"]
    return placed


def gather_pipeline_state(mesh: Mesh, state: dict) -> dict:
    """The checkpointed form of a placed pipeline state: the full stage
    stacks and moments (the reference's ``pipeline`` layout) and the
    step.  Every rank calls it."""
    names = leaf_names(state["params"])
    moments = state["optimizer"].moments(state["step"])
    for key in ("mu", "nu"):
        moments[key] = [_gather_stage(name, t, mesh) if staged else t
                        for (name, staged), t in zip(names, moments[key])]
    return {"params": gather_pipeline_params(state["params"], mesh),
            "optimizer": moments, "step": state["step"]}


def pipeline_rows(batch: np.ndarray, mesh: Mesh, n_micro: int) -> np.ndarray:
    """A rank's share of a global ``[B, S]`` batch as microbatch-major
    ``[M, B_m / dp, S]``: microbatch ``m`` is rows ``m B_m`` to ``(m + 1)
    B_m - 1`` (the reference's ``reshape(M, B // M, S)``), and the
    ``data`` axis splits each microbatch's rows."""
    rows, seq = batch.shape
    if rows % n_micro:
        raise ValueError(f"batch of {rows} rows not divisible by "
                         f"n_microbatches={n_micro}")
    micro = batch.reshape(n_micro, rows // n_micro, seq)
    data = mesh.axis("data")
    if micro.shape[1] % data.size:
        raise ValueError(f"microbatch of {micro.shape[1]} rows not "
                         f"divisible by the data axis ({data.size})")
    share = micro.shape[1] // data.size
    return micro[:, data.index * share:(data.index + 1) * share]


def prefetch_to_pipeline(batches, mesh: Mesh, n_micro: int, depth: int = 2):
    """:func:`.data.prefetch_to_device` of each rank's
    :func:`pipeline_rows` onto the mesh's device."""
    from .data import prefetch_to_device

    return prefetch_to_device(
        (np.ascontiguousarray(pipeline_rows(b, mesh, n_micro))
         for b in batches), mesh.device, depth)


# ---------------------------------------------------------------------------
# the schedules
# ---------------------------------------------------------------------------


def one_f_one_b_schedule(
    n_stages: int, n_micro: int
) -> tuple[np.ndarray, np.ndarray]:
    """Static 1F1B slot tables: ``(fwd[T, P], bwd[T, P])`` with the
    microbatch index each stage runs at each slot (-1 = idle); the
    reference's greedy construction, copied.

    Stage ``s`` runs ``min(M, P - s)`` warmup forwards, then prefers
    backward whenever one is ready.  ``fwd(s, m)`` needs ``fwd(s-1, m)``
    from an earlier slot; ``bwd(s, m)`` needs ``fwd(s, m)`` and (below the
    last stage) ``bwd(s+1, m)`` earlier.  The construction asserts the
    reference's mailbox disciplines."""
    P_, M = n_stages, n_micro
    warmup = [min(M, P_ - s) for s in range(P_)]
    fwd_done = [[-1] * M for _ in range(P_)]  # slot of fwd(s, m)
    bwd_done = [[-1] * M for _ in range(P_)]
    fwd_next = [0] * P_  # next microbatch each stage forwards
    bwd_next = [0] * P_
    fwd_rows, bwd_rows = [], []
    t = 0
    while any(b < M for b in bwd_next):
        fwd_row, bwd_row = [-1] * P_, [-1] * P_
        for s in range(P_):
            m_f, m_b = fwd_next[s], bwd_next[s]
            fwd_ready = m_f < M and (
                s == 0 or (fwd_done[s - 1][m_f] not in (-1, t)
                           and fwd_done[s - 1][m_f] < t)
            )
            bwd_ready = m_b < M and fwd_done[s][m_b] not in (-1,) and (
                fwd_done[s][m_b] < t
            ) and (
                s == P_ - 1
                or (bwd_done[s + 1][m_b] != -1 and bwd_done[s + 1][m_b] < t)
            )
            can_fwd = fwd_ready and (fwd_next[s] - bwd_next[s]) < warmup[s]
            if bwd_ready:
                bwd_row[s] = m_b
                bwd_done[s][m_b] = t
                bwd_next[s] += 1
            elif can_fwd:
                fwd_row[s] = m_f
                fwd_done[s][m_f] = t
                fwd_next[s] += 1
        fwd_rows.append(fwd_row)
        bwd_rows.append(bwd_row)
        t += 1
        if t > 4 * (M + P_):  # pragma: no cover - a loop that never ends
            raise RuntimeError("1F1B schedule did not converge")
    for s in range(1, P_):
        for m in range(M - 1):
            assert fwd_done[s][m] <= fwd_done[s - 1][m + 1], (s, m)
    for s in range(P_ - 1):
        for m in range(M - 1):
            assert bwd_done[s][m] <= bwd_done[s + 1][m + 1], (s, m)
    return np.asarray(fwd_rows), np.asarray(bwd_rows)


def gpipe_schedule(n_stages: int, n_micro: int,
                   backward: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """GPipe's slot tables in :func:`one_f_one_b_schedule`'s form: stage
    ``s`` forwards microbatch ``t - s`` at slot ``t``; then the backward
    runs from the last stage down (stage ``s`` differentiates microbatch
    ``t - (P - 1 - s)`` at backward slot ``t``).  ``backward=False`` keeps
    only the forward slots (eval)."""
    span = n_micro + n_stages - 1
    fwd = np.full((span, n_stages), -1)
    bwd = np.full((span, n_stages), -1)
    for t in range(span):
        for s in range(n_stages):
            if 0 <= t - s < n_micro:
                fwd[t, s] = t - s
            if 0 <= t - (n_stages - 1 - s) < n_micro:
                bwd[t, s] = t - (n_stages - 1 - s)
    if not backward:
        return fwd, np.full_like(fwd, -1)
    idle = np.full_like(fwd, -1)
    return np.concatenate([fwd, idle]), np.concatenate([idle, bwd])


def _run_slots(micro_fn, leaves, mesh: Mesh, fwd, bwd, act_like,
               train: bool = True):
    """Run this rank's column of the slot tables.  ``micro_fn(m, x_in) ->
    (out, extra)``: the stage's forward of microbatch ``m`` (``x_in`` the
    received activation, ``None`` on stage 0); ``out`` is the activation
    sent on, or on the last stage the scalar loss share, and ``extra`` a
    scalar share every stage adds to the objective (the MoE aux term) or
    ``None``.  ``act_like(m) -> (shape, dtype)`` of the activations.
    Returns the rank's loss share and, when ``train``, its fp32 gradient
    sums for ``leaves`` (``None`` for a leaf it never used)."""
    pipe = mesh.axis("pipe")
    size, s = pipe.size, pipe.index
    last = s == size - 1
    loss = torch.zeros((), dtype=torch.float32, device=mesh.device)
    sums = [None] * len(leaves)
    live, acts, cots = {}, {}, {}
    for t in range(fwd.shape[0]):
        m_f, m_b = int(fwd[t, s]), int(bwd[t, s])
        sends = []
        if m_f >= 0:
            x_in = acts.pop(m_f) if s > 0 else None
            if x_in is not None and train:
                x_in.requires_grad_(True)
            with torch.set_grad_enabled(train):
                out, extra = micro_fn(m_f, x_in)
            if last:
                loss = loss + out.detach().float()
            if extra is not None:
                loss = loss + extra.detach().float()
            if not last:
                sends.append((out.detach(), pipe.next))
            if train:
                live[m_f] = (x_in, out, extra)
        if m_b >= 0:
            x_in, out, extra = live.pop(m_b)
            outputs = [out]
            cot = [torch.ones_like(out) if last else cots.pop(m_b)]
            if extra is not None:
                outputs.append(extra)
                cot.append(torch.ones_like(extra))
            inputs = ([x_in] if s > 0 else []) + leaves
            grads = list(torch.autograd.grad(outputs, inputs, cot,
                                             allow_unused=True))
            if s > 0:
                sends.append((grads.pop(0), pipe.prev))
            for i, g in enumerate(grads):
                if g is not None:
                    sums[i] = g.float() if sums[i] is None else \
                        sums[i].add_(g.float())
        recvs, keys = [], []
        if s > 0 and fwd[t, s - 1] >= 0:
            m = int(fwd[t, s - 1])
            recvs.append((*act_like(m), pipe.prev))
            keys.append((acts, m))
        if not last and bwd[t, s + 1] >= 0:
            m = int(bwd[t, s + 1])
            recvs.append((*act_like(m), pipe.next))
            keys.append((cots, m))
        got = mesh.transport.exchange(sends, recvs, pipe.group, mesh.device)
        for (box, m), tensor in zip(keys, got):
            box[m] = tensor
    return loss, sums


# ---------------------------------------------------------------------------
# the stage program of either family
# ---------------------------------------------------------------------------


class _ReadoutNll(torch.autograd.Function):
    """``sum(weight * nll)`` of ``targets`` from hidden states ``[B, S,
    d]`` and a whole readout ``[V, d]`` (fp32 logits of model-dtype
    operands), saving only the per-row logsumexp and recomputing the
    logits in the backward, as :func:`.train.fused_next_token_nll` does."""

    @staticmethod
    def forward(ctx, readout, x, targets, weight):
        from .model import unembed

        logits = unembed(x, readout)
        m = logits.amax(dim=-1)
        lse = m + torch.log(torch.exp(logits - m[..., None]).sum(dim=-1))
        target_logit = logits.gather(-1, targets[..., None])[..., 0]
        ctx.save_for_backward(readout, x, targets, weight, lse)
        return (weight * (lse - target_logit)).sum()

    @staticmethod
    def backward(ctx, g):
        from .model import unembed

        readout, x, targets, weight, lse = ctx.saved_tensors
        probs = torch.exp(unembed(x, readout) - lse[..., None])
        probs.scatter_add_(-1, targets[..., None],
                           torch.full_like(targets[..., None], -1.0,
                                           dtype=probs.dtype))
        dlogits = (probs * (weight * g)[..., None]).to(x.dtype)
        dx = dlogits @ readout
        dreadout = (dlogits.flatten(0, 1).t() @ x.flatten(0, 1)).to(
            readout.dtype)
        return dreadout, dx, None, None


def _check_heads(config, mesh: Mesh) -> None:
    """The shapes a stage splits over ``model``: the heads, the kv heads
    and ``d_ff`` (the vocabulary stays whole)."""
    tp = mesh.shape["model"]
    for what, n in (("n_heads", config.n_heads),
                    ("n_kv_heads", getattr(config, "n_kv_heads",
                                           config.n_heads)),
                    ("d_ff", config.d_ff)):
        if n % tp:
            raise ValueError(f"{what}={n} not divisible by "
                             f"model_parallel={tp}")


def _stage_attention(config, mesh: Mesh, zigzag: bool):
    """The attention inside a stage: the rank's kernel pick without a
    ``seq`` axis, the ring (windowed for a windowed llama) or zig-zag
    over it."""
    window = getattr(config, "sliding_window", None)
    if mesh.shape["seq"] > 1:
        if zigzag:
            from .zigzag import make_zigzag_ring_attention

            return make_zigzag_ring_attention(mesh)
        from .ring import make_ring_attention

        return make_ring_attention(mesh, window=window)
    from .flash import make_sharded_attention

    return make_sharded_attention(window)


def _moe_mlp(moe, mesh: Mesh, llama: bool, aux_out: list):
    """The routed expert MLP of a stage: routing over the rank's own
    tokens, every expert on every data rank; under tp each expert's ff
    columns are split (Megatron's pair around the expert FFN, the router
    replicated).  Each layer's aux term goes to ``aux_out``."""
    from .distributed import copy_to_model, reduce_from_model
    from .moe import _gelu_experts, _routed_ffn, _swiglu_experts

    expert_ffn = _swiglu_experts if llama else _gelu_experts
    if mesh.shape["model"] > 1:
        inner = expert_ffn

        def expert_ffn(expert_in, layer):
            return reduce_from_model(mesh, inner(copy_to_model(
                mesh, expert_in), layer))

    def sparse_mlp(h, layer):
        out, aux = _routed_ffn(h, layer, moe, expert_ffn)
        aux_out.append(aux)
        return out

    sparse_mlp.tp_native = True
    return sparse_mlp


def _microbatch_program(params: dict, tokens: torch.Tensor, config,
                        mesh: Mesh, llama: bool, remat: bool, zigzag: bool,
                        moe=None, aux_weight: float | None = None):
    """``(micro_fn, act_like)`` of :func:`_run_slots` for this rank on
    ``tokens`` ``[M, B_local, S]`` (its rows over the whole sequence):
    stage 0 embeds the rank's sequence slice at its global (or zig-zag)
    positions, every stage runs its layers, the last stage reads out the
    weighted NLL of its targets.  Each target weighs ``1 / (M x B x (S -
    1))`` of the global batch."""
    from .model import _block, _embed, _layer_norm, embed_tokens
    from .train import tensor_parallel

    n_micro, rows, seq = tokens.shape
    if seq > config.max_seq_len:
        raise ValueError(
            f"sequence length {seq} exceeds max_seq_len={config.max_seq_len}"
        )
    pipe, sp = mesh.axis("pipe"), mesh.axis("seq")
    last = pipe.index == pipe.size - 1
    if seq % sp.size:
        raise ValueError(f"sequence length {seq} not divisible by "
                         f"seq_parallel={sp.size}")
    seq_local = seq // sp.size
    lo = sp.index * seq_local
    next_tokens = torch.cat([tokens[..., 1:], tokens[..., :1] * 0], dim=-1)
    if zigzag:
        from .zigzag import _device_permutation

        perm = _device_permutation(seq, sp.size, tokens.device)
        tokens, next_tokens = tokens[..., perm], next_tokens[..., perm]
        positions = perm[lo:lo + seq_local]
    else:
        positions = torch.arange(lo, lo + seq_local, device=tokens.device)
    tokens_in = tokens[..., lo:lo + seq_local]
    targets = next_tokens[..., lo:lo + seq_local].long()
    count = n_micro * rows * mesh.shape["data"] * (seq - 1)
    weight = ((positions < seq - 1).float() / count)[None, :].expand(
        rows, seq_local)

    stages = params["stages"]
    n_local = next(iter(stages.values())).shape[0]
    layers = [{name: t[i] for name, t in stages.items()}
              for i in range(n_local)]
    tp = tensor_parallel(mesh)
    attend = _stage_attention(config, mesh, zigzag)
    if llama:
        from .flash import gqa_adapt
        from .llama import (
            _llama_block, _rms_norm, readout_weights, rope_angles,
        )

        attend = gqa_adapt(attend)
        rope = rope_angles(positions, config.head_dim, config.rope_theta)
    weight_aux = None
    if moe is not None:
        weight_aux = (moe.aux_loss_weight if aux_weight is None
                      else aux_weight)
        weight_aux = weight_aux / (config.n_layers * n_micro
                                   * mesh.shape["data"])

    def micro_fn(m, x_in):
        aux_out = []
        mlp = None if moe is None else _moe_mlp(moe, mesh, llama, aux_out)
        if llama:
            if x_in is None:
                x, x32 = embed_tokens(params["embed"], tokens_in[m]), None
            else:
                x, x32 = x_in, None
            for layer in layers:
                args = (x, layer, config, rope, attend, x32, mlp, tp)
                x, x32 = (checkpoint(_llama_block, *args, use_reentrant=False)
                          if remat else _llama_block(*args))
        else:
            if x_in is None:
                x, x32 = _embed(params, tokens_in[m],
                                positions if sp.size > 1 or zigzag
                                else slice(0, seq))
            else:
                x, x32 = x_in, x_in.float()
            for layer in layers:
                args = (x, layer, config, attend, x32, mlp, tp)
                x, x32 = (checkpoint(_block, *args, use_reentrant=False)
                          if remat else _block(*args))
        extra = None
        if weight_aux:
            extra = sum(aux_out) * weight_aux
        if not last:
            return x, extra
        if llama:
            h = _rms_norm(x32, params["final_norm"], config.rms_eps, x.dtype)
            readout = readout_weights(params)
        else:
            h = _layer_norm(x32, params["final_ln_scale"],
                            params["final_ln_bias"], x.dtype)
            readout = params["embed"]
        out = _ReadoutNll.apply(readout, h, targets[m], weight)
        return (out if extra is None else out + extra), None

    def act_like(m):
        return (rows, seq_local, config.d_model), config.dtype

    return micro_fn, act_like


def _tables(pcfg: PipelineConfig, n_stages: int, train: bool = True):
    if pcfg.schedule == "1f1b" and train:
        return one_f_one_b_schedule(n_stages, pcfg.n_microbatches)
    return gpipe_schedule(n_stages, pcfg.n_microbatches, backward=train)


def _check_tokens(tokens: torch.Tensor, pcfg: PipelineConfig) -> None:
    if tokens.shape[0] != pcfg.n_microbatches:
        raise ValueError(
            f"tokens have {tokens.shape[0]} microbatches, config says "
            f"{pcfg.n_microbatches}"
        )


def run_pipeline(params: dict, tokens: torch.Tensor, leaves, config,
                 pcfg: PipelineConfig, mesh: Mesh, llama: bool = False,
                 remat: bool = False, zigzag: bool = False, moe=None):
    """One pass of the schedule on a rank: its loss share and the fp32
    gradient sums of ``leaves`` (tensors of ``params`` that require grad;
    ``None`` where the rank never used one)."""
    _check_tokens(tokens, pcfg)
    micro_fn, act_like = _microbatch_program(
        params, tokens, config, mesh, llama, remat, zigzag, moe)
    fwd, bwd = _tables(pcfg, mesh.shape["pipe"])
    return _run_slots(micro_fn, leaves, mesh, fwd, bwd, act_like)


def pipeline_value_and_grad(config, pcfg: PipelineConfig, mesh: Mesh,
                            llama: bool = False, remat: bool = False,
                            zigzag: bool = False, moe=None):
    """``vag(params, tokens) -> (loss share, grads)`` of the pipelined
    objective on a rank, either schedule: ``params`` the rank's part
    (:func:`place_pipeline_state`), ``tokens`` its ``[M, B_local, S]``
    rows (:func:`pipeline_rows`).  The loss share sums to the global mean
    over :data:`LOSS_AXES`, the gradients as :func:`pipeline_grad_axes`
    says (:func:`.train.make_train_step` does both).  ``moe`` adds the
    routed experts and their aux term; ``zigzag`` the balanced layout
    over ``seq``."""
    _check_heads(config, mesh)

    def vag(params, tokens):
        leaves = param_leaves(params)
        loss, sums = run_pipeline(params, tokens, leaves, config, pcfg, mesh,
                                  llama, remat, zigzag, moe)
        grads = [torch.zeros_like(p) if g is None else g.to(p.dtype)
                 for p, g in zip(leaves, sums)]
        return loss, _unflatten(params, grads)

    return vag


def pipeline_loss(params: dict, tokens: torch.Tensor, config,
                  pcfg: PipelineConfig, mesh: Mesh, llama: bool = False,
                  zigzag: bool = False, moe=None,
                  aux_weight: float | None = None) -> torch.Tensor:
    """The global objective (summed over the ranks: every rank gets it)
    by the forward slots alone, with no gradient: the trainer's held-out
    eval (``aux_weight=0.0``: the pure NLL of a routed model)."""
    _check_tokens(tokens, pcfg)
    with torch.no_grad():
        micro_fn, act_like = _microbatch_program(
            params, tokens, config, mesh, llama, False, zigzag, moe,
            aux_weight)
        fwd, bwd = _tables(pcfg, mesh.shape["pipe"], train=False)
        loss, _ = _run_slots(micro_fn, [], mesh, fwd, bwd, act_like,
                             train=False)
    return mesh.transport.all_reduce(loss, mesh.group(*LOSS_AXES).group)


def require_no_seq_axis(mesh: Mesh) -> None:
    """The MoE pipeline runs on ``(pipe, data[, model])`` meshes only."""
    if mesh.shape["seq"] > 1:
        raise ValueError(
            "this pipeline objective supports (pipe, data[, model]) "
            "meshes only — moe x pp does not combine with seq_parallel"
        )


def make_pipeline_train_step(mesh: Mesh, config, pcfg: PipelineConfig,
                             train_config, llama: bool = False,
                             zigzag: bool = False, moe=None):
    """One pp x dp (x sp) (x tp) optimizer step of either family and
    schedule, through :func:`.train.make_train_step`'s seams (the
    reference's ``make_pipeline_train_step``,
    ``make_llama_pipeline_train_step``,
    ``make_zigzag_pipeline_train_step`` and
    ``make_moe_pipeline_train_step``): ``--grad-accum`` splits the batch
    axis of ``[M, B_m, S]``."""
    from .train import make_train_step

    if zigzag:
        if getattr(config, "sliding_window", None) is not None:
            raise ValueError(
                "sliding_window does not compose with the zig-zag schedule; "
                "use plain pp x sp (windowed ring attention inside stages)"
            )
        if mesh.shape["seq"] < 2:
            raise ValueError(
                "the zig-zag pipeline objective needs a (pipe, data, seq) "
                "mesh with seq >= 2"
            )
    if moe is not None:
        from .moe import _require_no_remat

        _require_no_remat(train_config)
        require_no_seq_axis(mesh)
        if getattr(config, "sliding_window", None) is not None:
            raise ValueError(
                "sliding_window does not compose with the pipelined MoE "
                "stack's full-causal stage kernels"
            )
    return make_train_step(
        config, train_config, mesh.device, mesh=mesh,
        value_and_grad_fn=pipeline_value_and_grad(
            config, pcfg, mesh, llama=llama, remat=train_config.remat,
            zigzag=zigzag, moe=moe),
        grad_axes=pipeline_grad_axes, loss_axes=LOSS_AXES, accum_axis=1)
