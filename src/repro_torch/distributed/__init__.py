"""The mesh, its fault tolerance and the LM's layout — PyTorch port of the
JAX package's ``distributed``: a device mesh with in-process and
process-group collectives (``distributed.mesh``), the group executor with
retries, speculation and elastic regrouping (``distributed.fault``), and
the LM parameters' placements on a mesh (``distributed.sharding``)."""
from .fault import GroupExecutor, GroupRun, grow_groups, regroup, shrink_groups
from .mesh import GroupComm, LocalComm, Mesh, comm_for, make_mesh
from .sharding import (axis_rules, current_mesh, logical_to_pspec,
                       param_logical_axes, param_pspecs, param_shardings,
                       shard)

__all__ = ["GroupExecutor", "GroupRun", "grow_groups", "regroup",
           "shrink_groups", "Mesh", "make_mesh", "LocalComm", "GroupComm",
           "comm_for", "axis_rules", "current_mesh", "logical_to_pspec",
           "param_logical_axes", "param_pspecs", "param_shardings", "shard"]
