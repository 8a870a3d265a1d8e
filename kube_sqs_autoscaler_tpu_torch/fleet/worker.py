"""FleetWorker: a :class:`~..workloads.continuous.ContinuousWorker` that
serves as one supervised replica of a :class:`~.pool.WorkerPool`.

The port's copy of ``kube_sqs_autoscaler_tpu/fleet/worker.py`` (without
tenancy's staging).  It is the continuous worker — same batcher, same
engine cycle, same at-least-once settle — with the hooks a supervised
fleet member needs:

- **admission gate** (``admitting``): a draining replica stops pulling
  queue traffic but keeps stepping its in-flight slots to completion;
- **deterministic fault injection** (``killed``/``hung``, flipped by
  :meth:`~.pool.WorkerPool.kill_worker` /
  :meth:`~.pool.WorkerPool.hang_worker`): a killed replica never steps
  again; a hung one looks alive but makes no progress until the pool's
  watchdog declares it dead;
- **reply dedup** through the pool's registry: the serving system is
  at-least-once (replies are sent *before* the input is deleted), so a
  request redelivered by the queue's visibility timeout, or re-dispatched
  from a dead replica, can reach two replicas.  The first completed
  settle wins; a later one deletes its input copy without replying;
- **in-flight handoff** (:meth:`take_inflight`): when the supervisor
  declares this replica dead, its un-replied busy slots' messages are
  re-dispatched to survivors (greedy decoding restarts from the prompt).

Construction shares the pool's params by reference and adopts the donor
replica's engine
(:meth:`~..workloads.continuous.ContinuousBatcher.adopt_engine`), so a
spin-up pays only for the replica's own KV cache.  A dead replica's rows
keep their device state (their ``done`` stays false, a block may still be
in flight): that is safe only because a killed or hung replica never
steps again, which :meth:`run_once` guarantees.
"""

from __future__ import annotations

from ..workloads.continuous import ContinuousWorker, _Slot
from ..workloads.service import request_id


class FleetWorker(ContinuousWorker):
    """One supervised fleet replica (see module docstring)."""

    def __init__(self, *args, pool=None, engine_source=None, **kwargs):
        super().__init__(*args, **kwargs)
        self._pool = pool
        if engine_source is not None:
            self.batcher.adopt_engine(engine_source)
        self.admitting = True
        self.killed = False
        self.hung = False

    # -- fault injection (pool.kill_worker / pool.hang_worker) ----------

    def kill(self) -> None:
        """Deterministic crash: the replica never steps again; its
        un-replied in-flight requests await :meth:`take_inflight`."""
        self.killed = True

    def hang(self) -> None:
        """Deterministic wedge: cycles become no-ops until the watchdog
        declares the replica dead."""
        self.hung = True

    # -- supervised engine cycle ----------------------------------------

    def run_once(self) -> int:
        if self.killed or self.hung:
            # a dead replica must not touch the queue or its device state;
            # a hung one consumes the cycle without progress, which is what
            # the pool's progress watchdog keys on
            return 0
        return super().run_once()

    def _refill(self) -> int:
        if not self.admitting:
            return 0  # draining: finish in-flight slots, admit nothing
        return super()._refill()

    # -- reply dedup through the pool registry --------------------------

    def _settle(self, message, tokens, *, error=None,
                counted: bool = True) -> bool:
        if self._pool is not None:
            rid = request_id(message)
            if self._pool.already_replied(rid):
                # a redelivered or re-dispatched copy of an answered
                # request: consume the input, never send a second reply,
                # and cancel run_once's completion count for it, so the
                # pool's `processed` counts unique requests
                self.queue.delete_message(
                    self.config.queue_url, message["ReceiptHandle"]
                )
                self._pool.note_duplicate(rid)
                if counted:
                    self.processed -= 1
                return False
        answered = super()._settle(
            message, tokens, error=error, counted=counted
        )
        if self._pool is not None:
            self._pool.mark_replied(request_id(message))
        return answered

    # -- failover handoff ------------------------------------------------

    def take_inflight(self) -> list[dict]:
        """Remove and return the un-replied in-flight messages (busy slots'
        payloads, in slot order).  Called once by the supervisor when this
        replica is declared dead: the slots are freed on the host (their
        requests now live elsewhere) and the device state is abandoned
        with the replica, which never steps again."""
        messages = []
        for row, slot in enumerate(self.batcher.slots):
            if slot.busy:
                messages.append(slot.payload)
                self.batcher.slots[row] = _Slot()
        self.batcher._invalidate_admission_cache()
        return messages

    def release_inflight(self) -> int:
        """Hand every un-replied in-flight request back to the queue (the
        drain-timeout path): visible again now through
        ``change_message_visibility(0)`` when the queue has it, else after
        its visibility timeout.  Returns the number released."""
        messages = self.take_inflight()
        nack = getattr(self.queue, "change_message_visibility", None)
        for message in messages:
            if nack is not None:
                nack(self.config.queue_url, message["ReceiptHandle"], 0)
        return len(messages)
