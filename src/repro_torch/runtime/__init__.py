"""Training runtime of the port: checkpoints and fault tolerance."""

from . import checkpoint, fault_tolerance

__all__ = ["checkpoint", "fault_tolerance"]
