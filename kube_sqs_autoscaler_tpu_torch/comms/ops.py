"""Typed transfer ops — the data-movement taxonomy.

Every cross-shard / cross-plane byte move the serving stack performs
today is one of four kinds, and each kind already has an odometer
pinning it (``host_transfers`` / ``kv_transfers``):

==================  ==================================================
kind                the move
==================  ==================================================
``evacuation_kv``   a draining shard's in-flight rows leaving the
                    gang (``take_shard_inflight``): deferred firsts
                    flushed host-side + the rows' KV freed
``prefix_install``  a prefilled prefix entry written into the
                    per-tenant pool's stacked layers
``handoff_kv``      prefill-plane KV rows gathered into decode-plane
                    slots (the ``submit_resume``-shaped splice)
``settle_pull``     device→host pull of settled tokens — deferred
                    first-token arrays and the gang block's
                    token/count arrays
==================  ==================================================

A :class:`TransferOp` is the schedulable unit: destination, payload
size, the request ids it serves (for lifecycle ``transfer`` spans), and
a ``dispatch`` thunk that STARTS the move without blocking.  On the card
the engines issue every device-to-host copy when its result is produced
(a ``non_blocking`` copy into pinned memory behind a recorded event,
``workloads.continuous._HostCopy``), so a settle pull's dispatch starts
no second copy: it marks the op started, and the op's ``wait`` (the
copy's event) is what :meth:`~.scheduler.CollectiveScheduler.finish`
blocks on.  The scheduler decides WHEN to dispatch —
inside the dispatch-ahead window, while the next block computes — and
whether to coalesce it with its same-destination neighbours.

Size buckets follow the NCCL chunking observation (Demystifying NCCL):
transfer cost regimes switch by message size, so ops are bucketed and
only SMALL same-(destination, kind) ops coalesce into one batched
dispatch per cycle; large ops keep their own dispatch so one fat
gather never serializes behind a convoy of small ones.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

#: The four transfer kinds (see module table).
EVACUATION_KV = "evacuation_kv"
PREFIX_INSTALL = "prefix_install"
HANDOFF_KV = "handoff_kv"
SETTLE_PULL = "settle_pull"

TRANSFER_KINDS = (EVACUATION_KV, PREFIX_INSTALL, HANDOFF_KV, SETTLE_PULL)

#: Coalescing threshold: ops at or under this many bytes are "small"
#: and merge into one batched dispatch per (destination, kind) per
#: flush — the protocol-switch scale of the NCCL analysis (LL/LL128 vs
#: Simple sit near tens of KiB on real interconnects).
SMALL_OP_BYTES = 1 << 16

#: Size-bucket edges (bytes) for the by-bucket dispatch counters:
#: <=4KiB, <=64KiB, <=1MiB, bigger.
SIZE_BUCKETS = (1 << 12, 1 << 16, 1 << 20)
SIZE_BUCKET_LABELS = ("le4k", "le64k", "le1m", "gt1m")


def size_bucket(nbytes: int) -> str:
    """The bucket label of a payload size."""
    for edge, label in zip(SIZE_BUCKETS, SIZE_BUCKET_LABELS):
        if nbytes <= edge:
            return label
    return SIZE_BUCKET_LABELS[-1]


def _leaf_nbytes(node: Any) -> int | None:
    """Bytes of one array leaf from its metadata (``numel() *
    element_size()`` for a torch tensor, ``nbytes`` otherwise); None for
    a container.  Never reads the data, so never touches the device."""
    numel = getattr(node, "numel", None)
    element_size = getattr(node, "element_size", None)
    if callable(numel) and callable(element_size):
        return int(numel()) * int(element_size())
    if hasattr(node, "nbytes"):
        return int(node.nbytes)
    return None


def array_nbytes(arrays: Any) -> int:
    """Total payload bytes of an array / nested container of arrays
    (dicts counted by value; non-array leaves count zero)."""
    if arrays is None or isinstance(arrays, (str, bytes)):
        return 0
    leaf = _leaf_nbytes(arrays)
    if leaf is not None:
        return leaf
    if isinstance(arrays, dict):
        arrays = arrays.values()
    try:
        children = iter(arrays)
    except TypeError:
        return 0
    return sum(array_nbytes(child) for child in children)


@dataclass
class TransferOp:
    """One schedulable data movement (host bookkeeping only).

    ``dispatch`` starts the move device-side and must NOT block; the
    submitter keeps its own handle to the payload and calls
    :meth:`~..comms.scheduler.CollectiveScheduler.finish` at the moment
    the bytes are consumed host-side, closing the op's lifecycle
    ``transfer`` span.  Ops with no ``dispatch`` are accounting records
    for moves a kernel already launched (handoff gathers, prefix
    installs).
    """

    kind: str
    destination: str
    nbytes: int
    #: routing endpoint the bytes LEAVE — ``shard:N`` / ``prefill`` /
    #: ``device`` — used only when a topology is attached (producers
    #: that never set it default to host staging)
    source: str = "host"
    #: request ids this move serves — each gets paired
    #: ``transfer``/``transfer_done`` lifecycle stamps
    rids: tuple = ()
    dispatch: Callable[[], Any] | None = None
    #: blocks until the moved bytes are host-resident (the host copy's
    #: event); ``finish`` calls it.  None: nothing to wait for
    wait: Callable[[], Any] | None = None
    #: free-form context (rows, shard, entry index) for the trace
    args: dict = field(default_factory=dict)
    #: set by the scheduler at flush time
    dispatched: bool = False
    dispatched_t: float | None = None
    #: True once the flush that dispatched it ran inside the
    #: dispatch-ahead window (a block was in flight to hide behind)
    overlapped: bool = False
    finished: bool = False
    finished_t: float | None = None

    @property
    def bucket(self) -> str:
        return size_bucket(self.nbytes)

    @property
    def small(self) -> bool:
        return self.nbytes <= SMALL_OP_BYTES

    def coalesce_key(self) -> tuple:
        """Small ops sharing this key batch into one dispatch."""
        return (self.destination, self.kind)


def settle_pull_op(
    arrays: Any,
    *,
    wait: Callable[[], Any] | None = None,
    destination: str = "host",
    source: str = "device",
    rids: Sequence[str] = (),
    args: dict | None = None,
) -> TransferOp:
    """A device→host pull of one or more arrays whose host copies the
    engine already issued (see the module docstring).  ``arrays`` sizes
    the op (metadata only); ``wait`` blocks until the copies landed.  The
    dispatch marks the op started and makes no device call."""

    def _dispatch() -> None:
        # the copies are already on the stream behind their event
        return None

    return TransferOp(
        kind=SETTLE_PULL,
        destination=destination,
        source=source,
        nbytes=array_nbytes(arrays),
        rids=tuple(r for r in rids if r),
        dispatch=_dispatch,
        wait=wait,
        args=dict(args or {}),
    )
