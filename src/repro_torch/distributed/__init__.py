"""The mesh and its fault tolerance — PyTorch port of the JAX package's
``distributed``: a device mesh with in-process and process-group
collectives (``distributed.mesh``), and the group executor with retries,
speculation and elastic regrouping (``distributed.fault``). The LM
parameter shardings (the JAX package's ``distributed.sharding``) come
with the train path (ROADMAP Queue A6)."""
from .fault import GroupExecutor, GroupRun, grow_groups, regroup, shrink_groups
from .mesh import GroupComm, LocalComm, Mesh, comm_for, make_mesh

__all__ = ["GroupExecutor", "GroupRun", "grow_groups", "regroup",
           "shrink_groups", "Mesh", "make_mesh", "LocalComm", "GroupComm",
           "comm_for"]
