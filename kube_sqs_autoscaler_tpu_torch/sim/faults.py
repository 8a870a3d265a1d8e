"""Deterministic fault schedules for the fleet.

The port's copy of ``FleetFaultPlan`` from
``kube_sqs_autoscaler_tpu/sim/faults.py``, replica faults only: kills and
hangs.  The shard faults wait for the sharded plane and the admission
faults for the sharded admission plane; a plan that names them raises
``ValueError``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FleetFaultPlan:
    """Replica-fault schedule: faults are values applied at known *pool
    cycles* (flag flips via :meth:`~..fleet.WorkerPool.kill_worker` /
    :meth:`~..fleet.WorkerPool.hang_worker`), not process murder, so an
    episode's zero-lost / zero-duplicate gates replay identically every
    run.  ``kills``/``hangs`` are ``(cycle, replica_index)`` pairs; the
    :class:`~..fleet.FleetDriver` calls :meth:`apply` once per cycle
    BEFORE the cycle runs.
    Unknown replica indices fail loudly (a plan that kills nobody would
    gate nothing)."""

    kills: tuple[tuple[int, int], ...] = ()
    hangs: tuple[tuple[int, int], ...] = ()
    shard_poisons: tuple[tuple[int, int, int], ...] = ()
    shard_wedges: tuple[tuple[int, int, int], ...] = ()
    shard_mask_corruptions: tuple[tuple[int, int], ...] = ()
    admission_kills: tuple[tuple[int, int], ...] = ()
    admission_partitions: tuple[tuple[int, int, int], ...] = ()

    def __post_init__(self):
        for name in ("shard_poisons", "shard_wedges",
                     "shard_mask_corruptions", "admission_kills",
                     "admission_partitions"):
            if getattr(self, name):
                raise ValueError(
                    f"{name} is not yet ported to the PyTorch port's fleet "
                    "(replica kills and hangs only)"
                )

    def apply(self, cycle: int, pool) -> None:
        for at, index in self.kills:
            if at == cycle:
                pool.kill_worker(index)
        for at, index in self.hangs:
            if at == cycle:
                pool.hang_worker(index)
