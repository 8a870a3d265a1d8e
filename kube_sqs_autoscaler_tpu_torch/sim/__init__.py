"""Fault schedules the port's fleet episodes replay."""

from .faults import FleetFaultPlan

__all__ = ["FleetFaultPlan"]
