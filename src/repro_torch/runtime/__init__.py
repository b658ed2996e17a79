"""Runtime of the port: checkpoints, fault tolerance and elastic
re-meshing."""

from . import checkpoint, elastic, fault_tolerance

__all__ = ["checkpoint", "elastic", "fault_tolerance"]
