"""Sharded execution of the port: the logical-axis sharding rules
(:mod:`.sharding`) and the ranks, process groups and collectives that
carry them out (:mod:`.comm`)."""

from .comm import COMM_STATS, RankMesh, launch, reset_comm_stats
from .sharding import (MeshShape, Rules, constrain, current_rules,
                       make_rules, prepared_specs, use_rules)

__all__ = ["COMM_STATS", "RankMesh", "launch", "reset_comm_stats",
           "MeshShape", "Rules", "constrain", "current_rules", "make_rules",
           "prepared_specs", "use_rules"]
