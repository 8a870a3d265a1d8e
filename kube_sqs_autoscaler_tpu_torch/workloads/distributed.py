"""Process start-up, the ``("data", "seq", "model")`` mesh and its
transport on ``torch.distributed``.

Counterpart of ``kube_sqs_autoscaler_tpu/workloads/distributed.py`` and of
the mesh half of its ``train.py``.  The JAX package runs one SPMD program
over a ``jax.sharding.Mesh`` and lets XLA place the collectives; here each
rank is a process, the mesh is a set of process groups, one per axis, and
every collective is written out:

- :func:`initialize_from_env` — one call at trainer start-up.  It joins the
  process group when a launcher (``torch.distributed.run``) or the
  operator asked for it (``KSAT_DISTRIBUTED``, ``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR``), and is a no-op returning False in a lone process.
- :func:`choose_backend` — ``nccl`` when every rank of a node has a card of
  its own, ``gloo`` otherwise and always on the CPU.  NCCL refuses two
  ranks on one device, and gloo has no CUDA send/recv, so under ``gloo`` a
  rank whose tensors live on a card moves each collective's tensors
  through pinned host memory (:class:`Transport`); its compute stays on the
  card.  The transport never switches on an error.
- :func:`make_topology_mesh`, :func:`make_topology_pipeline_mesh` and
  :func:`make_hybrid_mesh` — the meshes of the reference's module.  Ranks
  are ordered node-major, so ``seq`` and ``model`` groups stay inside a
  node and ``data`` (``pipe`` first, on a pipeline mesh) crosses nodes; on
  one node that is enumeration order (the TPU torus placement has no
  counterpart).  A pipeline mesh adds the ``pipe`` axis outermost
  (:data:`PIPE_AXES`) and creates only the groups the pipeline reduces
  over.
- :func:`ring_shift`, :func:`copy_to_model` and
  :func:`reduce_from_model` — collectives that autograd differentiates:
  the ring rotation (backward: the rotation the other way) and the
  Megatron pair (identity forward / all-reduce backward, and the
  transpose).
"""

from __future__ import annotations

import logging
import itertools
import os
import socket
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

AXES = ("data", "seq", "model")
# env vars that make initialize_from_env join a process group: this
# framework's explicit opt-in and what torch.distributed.run exports
_TRIGGER_VARS = ("KSAT_DISTRIBUTED", "MASTER_ADDR")


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name, "")
    return int(value) if value.strip() else default


def choose_backend(device: str | torch.device) -> str:
    """``nccl`` when every rank on this node has a card of its own
    (``LOCAL_WORLD_SIZE`` <= the cards visible), ``gloo`` otherwise and
    always for the CPU."""
    if torch.device(device).type != "cuda":
        return "gloo"
    local_world = _env_int("LOCAL_WORLD_SIZE", _env_int("WORLD_SIZE", 1))
    if dist.is_nccl_available() and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device: str | torch.device) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count}`` for
    ``cuda``, the CPU for ``cpu``."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    return torch.device("cuda", _env_int("LOCAL_RANK", 0)
                        % max(1, torch.cuda.device_count()))


def initialize_from_env(require: bool = False,
                        device: str | torch.device = "cuda",
                        init_method: str | None = None,
                        rank: int | None = None,
                        world_size: int | None = None) -> bool:
    """Join the process group when launched as a multi-process job.

    Returns True when the process group is (or already was) up.
    Triggers: ``require=True``, an explicit ``init_method``, a
    ``WORLD_SIZE`` above 1, or ``KSAT_DISTRIBUTED`` / ``MASTER_ADDR`` set.
    ``rank`` and ``world_size`` default to the launcher's ``RANK`` and
    ``WORLD_SIZE``; the address to ``env://`` (``MASTER_ADDR`` and
    ``MASTER_PORT``).  The backend is :func:`choose_backend`'s, logged.
    """
    if dist.is_initialized():
        return True
    world = world_size if world_size is not None else _env_int(
        "WORLD_SIZE", 1)
    triggered = (require or init_method is not None or world > 1
                 or any(os.environ.get(v) for v in _TRIGGER_VARS))
    if not triggered:
        return False
    backend = choose_backend(device)
    rank = rank if rank is not None else _env_int("RANK", 0)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank_device(device))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world)
    log.info("torch.distributed initialized: rank %d/%d, backend %s%s",
             rank, world, backend,
             " (CUDA tensors staged through pinned host memory)"
             if backend == "gloo" and torch.device(device).type == "cuda"
             else "")
    return True


class Transport:
    """Every collective of the mesh.  Under ``gloo`` a CUDA tensor goes
    through a pinned host buffer: one device-to-host copy and a wait on
    the stream (the transport's only sync), the collective on the host,
    one host-to-device copy back; the compute never leaves the card.
    Under ``nccl``, and for CPU tensors, the collective takes the tensor
    as it is."""

    def __init__(self, backend: str):
        self.backend = backend
        self.staged = backend == "gloo"
        self.host_waits = 0  # stream waits of the host staging

    def _stage(self, tensors):
        if not (self.staged and tensors and tensors[0].is_cuda):
            return None
        self.host_waits += 1
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors]
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        torch.cuda.current_stream(tensors[0].device).synchronize()
        return host

    @staticmethod
    def _unstage(host, tensors) -> None:
        for h, t in zip(host, tensors):
            t.copy_(h, non_blocking=True)

    def all_reduce(self, tensor: torch.Tensor, group,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``tensor`` reduced over ``group``, in place; returns it."""
        if group is None:
            return tensor
        host = self._stage([tensor])
        dist.all_reduce(tensor if host is None else host[0], op=op,
                        group=group)
        if host is not None:
            self._unstage(host, [tensor])
        return tensor

    def all_gather(self, tensor: torch.Tensor, group,
                   size: int) -> list[torch.Tensor]:
        """Every group member's ``tensor`` (same shape), in group order."""
        if group is None:
            return [tensor]
        tensor = tensor.contiguous()
        outs = [torch.empty_like(tensor) for _ in range(size)]
        host_in = self._stage([tensor])
        if host_in is None:
            dist.all_gather(outs, tensor, group=group)
            return outs
        host_out = [torch.empty_like(host_in[0]) for _ in range(size)]
        dist.all_gather(host_out, host_in[0], group=group)
        self._unstage(host_out, outs)
        return outs

    def shift(self, tensors, send_to: int, recv_from: int,
              group) -> list[torch.Tensor]:
        """Send ``tensors`` to global rank ``send_to`` and receive tensors
        of the same shapes from ``recv_from``: one
        ``batch_isend_irecv``, every send issued before its receive in the
        same order on every rank, so gloo cannot deadlock."""
        tensors = [t.contiguous() for t in tensors]
        outs = [torch.empty_like(t) for t in tensors]
        host_in = self._stage(tensors)
        send, recv = (tensors, outs) if host_in is None else (
            host_in, [torch.empty_like(h) for h in host_in])
        ops = [dist.P2POp(dist.isend, t, send_to, group) for t in send]
        ops += [dist.P2POp(dist.irecv, t, recv_from, group) for t in recv]
        for request in dist.batch_isend_irecv(ops):
            request.wait()
        if host_in is not None:
            self._unstage(recv, outs)
        return outs

    def exchange(self, sends, recvs, group,
                 device: torch.device) -> list[torch.Tensor]:
        """Point-to-point messages in one ``batch_isend_irecv``: every
        ``(tensor, global rank)`` of ``sends`` sent, and a tensor of each
        ``(shape, dtype, global rank)`` of ``recvs`` received and returned
        in order, on ``device``.  The peers post the matching calls in
        the same order (a pipeline slot's hops), so gloo cannot deadlock;
        under gloo a CUDA tensor is staged through pinned host memory."""
        if not sends and not recvs:
            return []
        outs = [torch.empty(shape, dtype=dtype, device=device)
                for shape, dtype, _ in recvs]
        send_t = [t.contiguous() for t, _ in sends]
        staged = self.staged and device.type == "cuda"
        if staged:
            host = self._stage(send_t) or []
            recv_t = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                      for o in outs]
        else:
            host, recv_t = send_t, outs
        ops = [dist.P2POp(dist.isend, t, peer, group)
               for t, (_, peer) in zip(host, sends)]
        ops += [dist.P2POp(dist.irecv, t, peer, group)
                for t, (_, _, peer) in zip(recv_t, recvs)]
        for request in dist.batch_isend_irecv(ops):
            request.wait()
        if staged:
            self._unstage(recv_t, outs)
        return outs

    def all_to_all(self, tensor: torch.Tensor, group) -> torch.Tensor:
        """``all_to_all_single`` over equal splits of dim 0."""
        if group is None:
            return tensor
        tensor = tensor.contiguous()
        out = torch.empty_like(tensor)
        host = self._stage([tensor])
        if host is None:
            dist.all_to_all_single(out, tensor, group=group)
            return out
        host_out = torch.empty_like(host[0])
        dist.all_to_all_single(host_out, host[0], group=group)
        self._unstage([host_out], [out])
        return out


@dataclass
class Axis:
    """One mesh axis as this rank sees it: its ``size``, this rank's
    ``index`` along it, the global ``ranks`` of its group in axis order,
    and the process ``group`` (``None`` when the axis is trivial)."""

    name: str
    size: int
    index: int
    ranks: list[int]
    group: object = None

    @property
    def next(self) -> int:
        return self.ranks[(self.index + 1) % self.size]

    @property
    def prev(self) -> int:
        return self.ranks[(self.index - 1) % self.size]


@dataclass
class Mesh:
    """The mesh of one rank: a group for every set of its axes that the
    code uses (``axis("seq")``, ``group("data", "seq")``, ...), the
    ``replicas`` group (data x seq: the ranks holding the same slices of
    a dense model, over which its gradients sum), the device and the
    transport.  ``shape`` holds the axes in order: ``("data", "seq",
    "model")``, or ``("pipe", "data", "seq", "model")`` for a pipeline
    mesh (:data:`PIPE_AXES`)."""

    shape: dict
    rank: int
    device: torch.device
    transport: Transport
    groups: dict = field(default_factory=dict)

    @property
    def size(self) -> int:
        size = 1
        for n in self.shape.values():
            size *= n
        return size

    @property
    def axes(self) -> dict:
        return {name: self.groups[frozenset((name,))] for name in self.shape}

    @property
    def replicas(self) -> Axis:
        return self.groups[frozenset(("data", "seq"))]

    def axis(self, name: str) -> Axis:
        return self.groups[frozenset((name,))]

    def group(self, *names: str) -> Axis | None:
        """The group spanning ``names`` (``None`` for no axis)."""
        return self.groups[frozenset(names)] if names else None

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank}, "
                f"{ {n: a.index for n, a in self.axes.items()} }, "
                f"{self.device}, {self.transport.backend})")


def mesh_shape(n_devices: int, model_parallel: int,
               seq_parallel: int) -> tuple[int, int, int]:
    """Validated ``(data, seq, model)`` axis sizes for ``n_devices`` (the
    reference's arithmetic and message)."""
    if n_devices % (model_parallel * seq_parallel):
        raise ValueError(
            f"{n_devices} devices not divisible by "
            f"model_parallel={model_parallel} x seq_parallel={seq_parallel}"
        )
    return (n_devices // (model_parallel * seq_parallel), seq_parallel,
            model_parallel)


def pipeline_mesh_shape(n_devices: int, pipe_parallel: int,
                        model_parallel: int = 1,
                        seq_parallel: int = 1) -> tuple[int, int, int, int]:
    """Validated ``(pipe, data, seq, model)`` axis sizes (the reference's
    ``make_pipeline_mesh`` arithmetic and message)."""
    if n_devices % (pipe_parallel * model_parallel * seq_parallel):
        raise ValueError(
            f"{n_devices} devices not divisible by pipe_parallel="
            f"{pipe_parallel} x model_parallel={model_parallel} x "
            f"seq_parallel={seq_parallel}"
        )
    return (pipe_parallel,
            n_devices // (pipe_parallel * model_parallel * seq_parallel),
            seq_parallel, model_parallel)


def _world() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


# the groups a mesh creates, in one order on every rank: every set of the
# three axes, and for a pipeline mesh only the sets its code reduces over
# (gloo group creation is collective and slow)
_SUBSETS = (("data",), ("seq",), ("model",), ("data", "seq"),
            ("data", "model"), ("seq", "model"), ("data", "seq", "model"))
PIPE_AXES = ("pipe",) + AXES
_PIPE_SUBSETS = (("pipe",), ("data",), ("seq",), ("model",),
                 ("data", "seq"), ("pipe", "model"),
                 ("data", "seq", "model"), ("pipe", "data", "seq"))


def build_mesh(order: list[int], shape: tuple[int, ...],
               device: str | torch.device) -> Mesh:
    """The mesh whose grid, row-major over ``(data, seq, model)`` (or
    ``(pipe, data, seq, model)`` for a 4-tuple ``shape``), holds the
    global ranks ``order``.  Every rank calls this with the same arguments
    (the process groups are created collectively, in one order)."""
    rank, world = _world()
    if len(order) != world:
        raise ValueError(f"{len(order)} ranks in the order for a world of "
                         f"{world}")
    names, subsets = ((PIPE_AXES, _PIPE_SUBSETS) if len(shape) == 4
                      else (AXES, _SUBSETS))
    coords = list(itertools.product(*(range(n) for n in shape)))
    grid = dict(zip(coords, order))
    backend = dist.get_backend() if dist.is_initialized() else "gloo"
    mesh = Mesh(shape=dict(zip(names, shape)), rank=rank,
                device=rank_device(device), transport=Transport(backend))

    def make_axis(name: str, axis_ids: tuple[int, ...]) -> Axis:
        # every group of this axis set, in one order on every rank; its
        # ranks in row-major order of its axes
        mine = None
        for fixed in sorted({tuple(0 if a in axis_ids else c
                                   for a, c in enumerate(coord))
                             for coord in coords}):
            ranks = []
            for inner in itertools.product(*(range(shape[a])
                                             for a in axis_ids)):
                coord = list(fixed)
                for a, c in zip(axis_ids, inner):
                    coord[a] = c
                ranks.append(grid[tuple(coord)])
            group = dist.new_group(ranks) if len(ranks) > 1 else None
            if rank in ranks:
                mine = Axis(name, len(ranks), ranks.index(rank), ranks, group)
        return mine

    for subset in subsets:
        ids = tuple(names.index(n) for n in subset)
        mesh.groups[frozenset(subset)] = make_axis("x".join(subset), ids)
    return mesh


def _node_major_order() -> list[int]:
    """The global ranks ordered node-major: nodes by their lowest rank,
    ranks inside a node by ``LOCAL_RANK``."""
    rank, world = _world()
    if world == 1:
        return [0]
    me = (socket.gethostname(), _env_int("LOCAL_RANK", rank), rank)
    everyone = [None] * world
    dist.all_gather_object(everyone, me)
    first = {}
    for host, _local, r in everyone:
        first[host] = min(first.get(host, r), r)
    return [r for _h, _l, r in sorted(everyone,
                                      key=lambda e: (first[e[0]], e[1]))]


def nodes() -> int:
    """How many hosts the world spans."""
    rank, world = _world()
    if world == 1:
        return 1
    everyone = [None] * world
    dist.all_gather_object(everyone, socket.gethostname())
    return len(set(everyone))


def make_mesh(model_parallel: int | None = None, seq_parallel: int = 1,
              device: str | torch.device = "cuda") -> Mesh:
    """A ``("data", "seq", "model")`` mesh over the world's ranks in
    enumeration order (the reference's ``train.make_mesh``).
    ``model_parallel`` defaults to the largest of 4 and 2 that divides the
    world with ``seq_parallel``, else 1."""
    _, world = _world()
    if model_parallel is None:
        model_parallel = 1
        for candidate in (4, 2):
            if world % (candidate * seq_parallel) == 0:
                model_parallel = candidate
                break
    shape = mesh_shape(world, model_parallel, seq_parallel)
    return build_mesh(list(range(world)), shape, device)


def make_topology_mesh(model_parallel: int = 1, seq_parallel: int = 1,
                       device: str | torch.device = "cuda") -> Mesh:
    """A ``("data", "seq", "model")`` mesh with the ranks ordered
    node-major, so ``seq`` and ``model`` groups stay inside a node and
    ``data`` crosses nodes.  Same contract as :func:`make_mesh`."""
    _, world = _world()
    shape = mesh_shape(world, model_parallel, seq_parallel)
    return build_mesh(_node_major_order(), shape, device)


def make_topology_pipeline_mesh(pipe_parallel: int, model_parallel: int = 1,
                                seq_parallel: int = 1,
                                device: str | torch.device = "cuda") -> Mesh:
    """The pipeline mesh (``("pipe", "data", "seq", "model")``,
    :func:`.pipeline.make_pipeline_mesh`'s contract) with the ranks
    ordered node-major: ``model`` and ``seq`` groups stay inside a node,
    and ``pipe``, the outermost axis, crosses nodes first."""
    _, world = _world()
    shape = pipeline_mesh_shape(world, pipe_parallel, model_parallel,
                                seq_parallel)
    return build_mesh(_node_major_order(), shape, device)


def make_hybrid_mesh(dcn_data_parallel: int, model_parallel: int = 1,
                     seq_parallel: int = 1,
                     device: str | torch.device = "cuda") -> Mesh:
    """Multi-node mesh: ``data`` crosses nodes, ``seq``/``model`` stay
    inside one.  ``dcn_data_parallel`` is the node count and is required;
    1 degenerates to :func:`make_topology_mesh`."""
    dcn = dcn_data_parallel
    _, n = _world()
    if n % (dcn * model_parallel * seq_parallel):
        raise ValueError(
            f"{n} devices not divisible by dcn={dcn} x "
            f"model={model_parallel} x seq={seq_parallel}"
        )
    if dcn == 1:
        return make_topology_mesh(model_parallel, seq_parallel, device)
    found = nodes()
    if found != dcn:
        raise ValueError(
            f"dcn_data_parallel={dcn} needs the world to span {dcn} nodes; "
            f"it spans {found}"
        )
    # node-major order puts each node's ranks together, and data is the
    # slowest axis: data crosses nodes, seq/model stay inside one
    return build_mesh(_node_major_order(),
                      mesh_shape(n, model_parallel, seq_parallel), device)


# ---------------------------------------------------------------------------
# collectives that autograd differentiates
# ---------------------------------------------------------------------------


class _RingShift(torch.autograd.Function):
    """Forward: send to the axis's next rank, receive from its previous
    one.  Backward: the cotangents the other way (what JAX's transpose of
    ``ppermute`` gives).  Several tensors rotate in one exchange, so a
    pair's rotations can never interleave differently on two ranks."""

    @staticmethod
    def forward(ctx, transport, axis, *tensors):
        ctx.transport, ctx.axis = transport, axis
        ctx.like = [(t.shape, t.dtype, t.device) for t in tensors]
        return tuple(transport.shift(tensors, axis.next, axis.prev,
                                     axis.group))

    @staticmethod
    def backward(ctx, *grads):
        axis = ctx.axis
        grads = [torch.zeros(shape, dtype=dtype, device=device)
                 if g is None else g
                 for g, (shape, dtype, device) in zip(grads, ctx.like)]
        back = ctx.transport.shift(grads, axis.prev, axis.next, axis.group)
        return (None, None, *back)


def ring_shift(mesh: Mesh, axis: str, *tensors: torch.Tensor):
    """``tensors`` rotated one hop along ``axis`` (``i -> i + 1``),
    differentiably."""
    ax = mesh.axis(axis)
    if ax.size == 1:
        return tensors
    return _RingShift.apply(mesh.transport, ax, *tensors)


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the backward sums the cotangent over the group
    (Megatron's ``f``: the input of a column-parallel matmul)."""

    @staticmethod
    def forward(ctx, transport, axis, x):
        ctx.transport, ctx.axis = transport, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        return None, None, ctx.transport.all_reduce(g, ctx.axis.group)


class _ReduceFromGroup(torch.autograd.Function):
    """All-reduce sum forward; identity backward (Megatron's ``g``: the
    output of a row-parallel matmul)."""

    @staticmethod
    def forward(ctx, transport, axis, x):
        return transport.all_reduce(x.contiguous().clone(), axis.group)

    @staticmethod
    def backward(ctx, g):
        return None, None, g


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over equal splits of dim 0 (one chunk a group
    member); its backward is the same exchange."""

    @staticmethod
    def forward(ctx, transport, axis, x):
        ctx.transport, ctx.axis = transport, axis
        return transport.all_to_all(x, axis.group)

    @staticmethod
    def backward(ctx, g):
        return None, None, ctx.transport.all_to_all(g.contiguous(),
                                                    ctx.axis.group)


def all_to_all(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """``x``'s dim-0 chunk ``j`` sent to member ``j`` of ``axis``, the
    chunks received stacked in member order, differentiably."""
    ax = mesh.axis(axis)
    return x if ax.size == 1 else _AllToAll.apply(mesh.transport, ax, x)


def copy_to_model(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    ax = mesh.axis("model")
    return x if ax.size == 1 else _CopyToGroup.apply(mesh.transport, ax, x)


def reduce_from_model(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    ax = mesh.axis("model")
    return x if ax.size == 1 else _ReduceFromGroup.apply(mesh.transport, ax,
                                                         x)


# ---------------------------------------------------------------------------
# The host side of serving over ranks
# ---------------------------------------------------------------------------


def _broadcast_from_lead(value):
    """World rank 0's ``value`` on every rank (one object broadcast over
    the world group; ``value`` itself in a lone process)."""
    if not dist.is_initialized():
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def is_lead() -> bool:
    """Whether this process is world rank 0 (True without a process
    group)."""
    return _world()[0] == 0


class RankQueue:
    """A message queue that world rank 0 owns, for a worker that every
    rank of a serving mesh runs: rank 0 receives, replies and deletes; its
    reads (``receive_messages``, ``get_queue_attributes``) are broadcast,
    so every rank runs its host logic on the same messages; every other
    rank's writes are no-ops.  The reference is one controller process, so
    it needs none of this."""

    _READS = ("receive_messages", "get_queue_attributes")

    def __init__(self, queue) -> None:
        self.queue = queue
        self.lead = is_lead()

    def __getattr__(self, name: str):
        method = getattr(self.queue, name)
        if not callable(method):
            return method
        if name in self._READS:
            def read(*args, **kwargs):
                value = method(*args, **kwargs) if self.lead else None
                return _broadcast_from_lead(value)

            return read

        def write(*args, **kwargs):
            return method(*args, **kwargs) if self.lead else None

        return write


def rank_clock(now_fn):
    """``now_fn`` read on world rank 0 and broadcast: the clock of every
    host decision a serving mesh's ranks take (request TTLs, deadlines),
    so they take it alike.  Every rank calls it at the same points."""

    def now():
        return _broadcast_from_lead(now_fn() if is_lead() else None)

    return now


class RankClock:
    """A :class:`~..core.clock.Clock` that every rank of a serving mesh
    reads alike: ``now`` is world rank 0's ``clock.now()``, broadcast
    (:func:`rank_clock`); ``sleep`` is this rank's own.  A fleet's control
    loop over the mesh ticks on it, so every rank ticks at the same cycle
    and takes the same scaling decisions."""

    def __init__(self, clock) -> None:
        self.clock = clock
        self.now = rank_clock(clock.now)

    def sleep(self, seconds: float) -> None:
        self.clock.sleep(seconds)
