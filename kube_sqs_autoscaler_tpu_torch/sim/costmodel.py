"""Virtual-time cost model: dispatches AND data movement, priced.

The comms benches price a serving episode as ``decode_cost_s`` per gang
dispatch + ``insert_cost_s`` per admission + ``transfer_cost_s`` per
transfer dispatch — honest about WHEN work happens but blind to WHERE
bytes go: a one-hop settle pull and a cross-torus evacuation cost the
same flat fee.  :class:`CostModel` closes that gap with the routing
layer's topology: transfer cost becomes the MODELED COMPLETION TIME of
the episode's transfer ops scheduled over the link graph
(:func:`~..comms.routing.simulate_schedule`), so contended links, hop
counts, and chunked disjoint-path routing all price in.

This is the honesty a knob-head trained against
virtual-time rewards can only learn to avoid a contended link if the
cost model charges for it.  Topology-free construction degrades to the
flat per-dispatch fee, byte-identical to the comms-bench arithmetic.

The port's copy of ``kube_sqs_autoscaler_tpu/sim/costmodel.py``.
"""

from __future__ import annotations

from typing import Any, Iterable

#: The comms-suite virtual-time fees (bench.py pins these numbers —
#: they are modeling constants, not measurements).
DECODE_COST_S = 0.002
INSERT_COST_S = 0.006
TRANSFER_COST_S = 0.001


class CostModel:
    """Price an episode's dispatches + transfers in virtual seconds."""

    def __init__(
        self,
        *,
        topology: Any = None,
        decode_cost_s: float = DECODE_COST_S,
        insert_cost_s: float = INSERT_COST_S,
        transfer_cost_s: float = TRANSFER_COST_S,
        routed: bool = True,
    ) -> None:
        self.topology = topology
        self.decode_cost_s = decode_cost_s
        self.insert_cost_s = insert_cost_s
        self.transfer_cost_s = transfer_cost_s
        self.routed = routed

    def compute_cost_s(
        self, *, decode_dispatches: int = 0, insert_dispatches: int = 0
    ) -> float:
        """The dispatch side of the bill (unchanged arithmetic)."""
        return (
            decode_dispatches * self.decode_cost_s
            + insert_dispatches * self.insert_cost_s
        )

    def transfer_cost(self, ops: Iterable[Any]) -> dict:
        """The data-movement side: with a topology, the modeled
        completion time of ``ops`` (TransferOps or dicts with
        kind/source/destination/nbytes) scheduled over the link graph,
        plus the per-link utilization the schedule implies; without
        one, the flat per-op fee the comms bench charges."""
        ops = list(ops)
        if self.topology is None:
            return {
                "model": "flat",
                "transfer_cost_s": len(ops) * self.transfer_cost_s,
                "ops": len(ops),
            }
        from ..comms.routing import simulate_schedule

        result = simulate_schedule(
            ops, self.topology, routed=self.routed,
        )
        return {
            "model": "routed" if self.routed else "when-only",
            "transfer_cost_s": result.makespan,
            "ops": len(ops),
            "link_utilization": dict(result.link_utilization),
            "link_bytes": dict(result.link_bytes),
        }

    def episode_cost_s(
        self,
        *,
        decode_dispatches: int = 0,
        insert_dispatches: int = 0,
        transfer_ops: Iterable[Any] = (),
    ) -> float:
        """Total virtual seconds: dispatches + the transfer model.
        Transfers overlap compute on the real engine, so this is the
        PESSIMAL serial bound — a stable reward denominator, not a
        latency claim."""
        return self.compute_cost_s(
            decode_dispatches=decode_dispatches,
            insert_dispatches=insert_dispatches,
        ) + float(self.transfer_cost(transfer_ops)["transfer_cost_s"])
