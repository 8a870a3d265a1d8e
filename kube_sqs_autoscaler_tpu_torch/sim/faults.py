"""Deterministic fault schedules for the fleet.

The port's copy of ``FleetFaultPlan`` from
``kube_sqs_autoscaler_tpu/sim/faults.py``: replica kills and hangs, and the
sharded plane's shard faults.  The admission faults wait for the sharded
admission plane; a plan that names them raises ``ValueError``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FleetFaultPlan:
    """Replica- and shard-fault schedule: faults are values applied at
    known *pool cycles* (flag flips), not process murder, so an episode's
    zero-lost / zero-duplicate gates replay identically every run.  The
    :class:`~..fleet.FleetDriver` calls :meth:`apply` once per cycle BEFORE
    the cycle runs.

    - ``kills`` / ``hangs``: ``(cycle, replica_index)`` pairs
      (:meth:`~..fleet.WorkerPool.kill_worker` /
      :meth:`~..fleet.WorkerPool.hang_worker`); an unknown index fails
      loudly, as a plan that kills nobody would gate nothing;
    - ``shard_poisons`` / ``shard_wedges``: ``(start_cycle, end_cycle,
      shard)`` windows of :class:`~..fleet.ShardedWorkerPool`'s chaos
      seams, injected at ``start`` and healed at ``end`` (end-exclusive);
    - ``shard_mask_corruptions``: one-shot ``(cycle, shard)`` device-mask
      bit flips (the quarantine's mask write heals them).
    """

    kills: tuple[tuple[int, int], ...] = ()
    hangs: tuple[tuple[int, int], ...] = ()
    shard_poisons: tuple[tuple[int, int, int], ...] = ()
    shard_wedges: tuple[tuple[int, int, int], ...] = ()
    shard_mask_corruptions: tuple[tuple[int, int], ...] = ()
    admission_kills: tuple[tuple[int, int], ...] = ()
    admission_partitions: tuple[tuple[int, int, int], ...] = ()

    def __post_init__(self):
        for name in ("admission_kills", "admission_partitions"):
            if getattr(self, name):
                raise ValueError(
                    f"{name} is not yet ported to the PyTorch port's fleet "
                    "(replica and shard faults only)"
                )
        for name in ("shard_poisons", "shard_wedges"):
            for start, end, _ in getattr(self, name):
                if not start < end:
                    raise ValueError(
                        f"{name} window needs start < end, got "
                        f"[{start}, {end})"
                    )

    def apply(self, cycle: int, pool) -> None:
        for at, index in self.kills:
            if at == cycle:
                pool.kill_worker(index)
        for at, index in self.hangs:
            if at == cycle:
                pool.hang_worker(index)
        for start, end, shard in self.shard_poisons:
            if cycle == start:
                pool.poison_shard(shard, True)
            elif cycle == end:
                pool.poison_shard(shard, False)
        for start, end, shard in self.shard_wedges:
            if cycle == start:
                pool.wedge_shard(shard, True)
            elif cycle == end:
                pool.wedge_shard(shard, False)
        for at, shard in self.shard_mask_corruptions:
            if at == cycle:
                pool.corrupt_shard_mask(shard)

    def indices(self) -> set[int]:
        """Every replica index the plan touches (for pre-validation)."""
        return {i for _, i in self.kills} | {i for _, i in self.hangs}

    def shards(self) -> set[int]:
        """Every shard index the plan touches (for pre-validation)."""
        return (
            {s for _, _, s in self.shard_poisons}
            | {s for _, _, s in self.shard_wedges}
            | {s for _, s in self.shard_mask_corruptions}
        )
