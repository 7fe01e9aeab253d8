"""The client process group (port of the client-mesh part of
``repro.launch.mesh``).

The reference shards the federated client axis over a 1-D device mesh
whose axis is named ``data``; the port shards it over the ranks of a
``torch.distributed`` process group (NCCL on the cards, gloo across CPU
processes). Without an initialized group there is one shard, the
reference's one-device mesh. Defined as functions, so importing this
module touches no process-group state.

The production mesh and the parameter specs (``make_production_mesh``,
``param_specs``, a ``DeviceMesh``) wait for ROADMAP.md item 1.14.
"""
from __future__ import annotations

import torch.distributed as dist

__all__ = ["MESH_AXES", "make_client_group", "batch_shards", "shard_index"]

# the reference's client mesh axis; a group renders as it (ExecSpec.as_dict,
# ShardMapBackend.describe)
MESH_AXES = ("data",)


def make_client_group():
    """The default process group if one is initialized, else None (one
    shard)."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def batch_shards(group) -> int:
    """Number of shards the client axis splits into: the group's size, or
    1 with no group."""
    return 1 if group is None else dist.get_world_size(group)


def shard_index(group) -> int:
    """This process's shard: its rank in the group, or 0 with no group."""
    return 0 if group is None else dist.get_rank(group)
