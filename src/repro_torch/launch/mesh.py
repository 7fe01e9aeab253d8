"""Meshes and partition specs (port of ``repro.launch.mesh``).

The client process group: the reference shards the federated client axis
over a 1-D device mesh whose axis is named ``data``; the port shards it
over the ranks of a ``torch.distributed`` process group (NCCL on the cards,
gloo across CPU processes). Without an initialized group there is one
shard, the reference's one-device mesh.

The production mesh: a ``torch.distributed`` ``DeviceMesh`` of the
reference's production shape, (16, 16) with axes ``(data, model)`` or (2,
16, 16) with ``(pod, data, model)``, built over whatever process group of
256 or 512 ranks is initialized (the dry run opens a fake one,
``launch/dryrun.py``). :class:`PartitionSpec` is the reference's
``jax.sharding.PartitionSpec``: one entry a tensor dim, each None, a mesh
axis name or a tuple of them; :func:`placements` turns one into a
DTensor's placements on a mesh.

Defined as functions, so importing this module touches no process-group
state.
"""
from __future__ import annotations

import torch.distributed as dist

__all__ = ["MESH_AXES", "PartitionSpec", "make_client_group",
           "make_production_mesh", "batch_axes", "batch_shards",
           "mesh_chips", "placements", "shard_index"]

# the reference's client mesh axis; a group renders as it (ExecSpec.as_dict,
# ShardMapBackend.describe)
MESH_AXES = ("data",)


class PartitionSpec(tuple):
    """``PartitionSpec(*entries)``: entry d says how tensor dim d is split
    over the mesh, None (replicated), one mesh axis name, or a tuple of
    names (split over their product, the first the major one). Dims past
    the entries are replicated, as in the reference's ``P``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def make_client_group():
    """The default process group if one is initialized, else None (one
    shard)."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: 16x16 = 256 ranks, axes (data, model). Multi-pod:
    2x16x16 = 512 ranks, axes (pod, data, model). Over the initialized
    default process group, which must have exactly that many ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 512 if multi_pod else 256
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else None)
    if world != n:
        raise ValueError(
            f"the production mesh {'x'.join(map(str, shape))} needs a process "
            f"group of {n} ranks; "
            + ("none is initialized" if world is None else f"this one has {world}"))
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def batch_axes(mesh) -> tuple:
    """The axes the (client/batch) dimension shards over."""
    names = mesh.mesh_dim_names
    return ("pod", "data") if "pod" in names else ("data",)


def batch_shards(mesh) -> int:
    """Number of shards the client/batch dimension splits into: over a
    ``DeviceMesh``, the product of its batch axes' sizes; over a client
    process group, the group's size; 1 with neither."""
    if mesh is None:
        return 1
    if hasattr(mesh, "mesh_dim_names"):
        n = 1
        for ax in batch_axes(mesh):
            n *= mesh.size(mesh.mesh_dim_names.index(ax))
        return n
    return dist.get_world_size(mesh)


def shard_index(group) -> int:
    """This process's shard: its rank in the group, or 0 with no group."""
    return 0 if group is None else dist.get_rank(group)


def mesh_chips(mesh) -> int:
    return mesh.size()


def placements(spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` for the tensor dim d whose entry names it, else
    ``Replicate()``. A tuple entry splits its dim over those axes in the
    mesh's order (the first the major one, as the reference's); an axis
    named by two dims, or a tuple out of the mesh's order, raises, as the
    reference's ``P`` refuses such a spec."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    owner: dict = {}
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            tuple(entry) if isinstance(entry, tuple) else (entry,))
        order = [names.index(a) if a in names else -1 for a in axes]
        if -1 in order:
            raise ValueError(f"{spec}: axis not in the mesh {names}")
        if order != sorted(order):
            raise ValueError(f"{spec}: axes {axes} not in the mesh's order "
                             f"{names}")
        for a in axes:
            if a in owner:
                raise ValueError(f"{spec}: mesh axis {a!r} names tensor dims "
                                 f"{owner[a]} and {d}")
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in names)
