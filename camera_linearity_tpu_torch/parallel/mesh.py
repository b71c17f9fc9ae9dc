"""Device meshes over the processes of a ``torch.distributed`` group.

Port of ``camera_linearity_tpu/parallel/mesh.py``.  There is one process
per GPU: a mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose
positions are the processes of the default process group, in rank order,
with a ``data`` axis (the batch of scenes) and a ``pixel`` axis (image
rows).  It takes the place of ``jax.sharding.Mesh``.  Where the JAX package
places a global array on the mesh, each process here holds its own block as
an ordinary tensor on its device: the block a ``PartitionSpec`` gives the
JAX device at the same mesh position.  The collectives are explicit
(parallel/sharded.py, parallel/distributed.py).

A mesh needs an initialized process group: ``distributed.initialize`` (a
world of one process will do) or ``torch.distributed.init_process_group``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..utils.device import resolve_device

__all__ = ["make_mesh", "data_pixel_mesh", "shard_scene_stack",
           "shard_batch_of_scenes", "replicate", "axis_size", "mesh_device"]


def _world() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a mesh spans the processes of a torch.distributed process "
            "group, and none is initialized: call camera_linearity_tpu_"
            "torch.parallel.distributed.initialize(...) first (a world of "
            "one process will do)")
    return dist.get_world_size()


def make_mesh(axis_shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data",),
              device=None) -> DeviceMesh:
    """Mesh over the group's processes; defaults to a 1-D ``data`` axis of
    all of them.  ``device`` (by default the card) gives the type of the
    devices the processes compute on."""
    world = _world()
    axis_shape = (world,) if axis_shape is None else tuple(axis_shape)
    n = 1
    for size in axis_shape:
        n *= size
    if n != world:
        raise ValueError(f"a {axis_shape} mesh has {n} positions, but the "
                         f"process group has {world} processes")
    return init_device_mesh(resolve_device(device).type, axis_shape,
                            mesh_dim_names=tuple(axis_names))


def data_pixel_mesh(n_data: Optional[int] = None,
                    n_pixel: Optional[int] = None,
                    device=None) -> DeviceMesh:
    """2-D mesh (data, pixel): scenes shard over ``data``, image rows over
    ``pixel``."""
    n = _world()
    if n_data is None and n_pixel is None:
        # favor the pixel axis; scenes may be few
        n_data, n_pixel = 1, n
    elif n_data is None:
        n_data = n // n_pixel
    elif n_pixel is None:
        n_pixel = n // n_data
    return make_mesh((n_data, n_pixel), ("data", "pixel"), device)


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """The length of the mesh's axis ``name`` (``jax.sharding.Mesh.shape
    [name]``)."""
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this process computes on in ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def block_of(n: int, mesh: DeviceMesh, axis: str, what: str) -> slice:
    """This process's contiguous block of ``n`` items sharded over
    ``axis``; an uneven split raises, as a JAX sharding does."""
    parts = axis_size(mesh, axis)
    if n % parts:
        raise ValueError(
            f"{n} {what} do not shard evenly over the {parts}-way {axis} "
            "axis; pad the batch or choose a divisor mesh")
    per = n // parts
    i = mesh.get_local_rank(axis)
    return slice(i * per, (i + 1) * per)


def _local(x, index, mesh: DeviceMesh) -> torch.Tensor:
    """``x[index]`` (a tensor or numpy array) on this process's device."""
    return torch.as_tensor(x[index], device=mesh_device(mesh))


def shard_scene_stack(stack, mesh: DeviceMesh, row_axis: str = "pixel"):
    """This process's row band of an (N, H, W, C) exposure stack."""
    rows = block_of(stack.shape[1], mesh, row_axis, "rows")
    return _local(stack, (slice(None), rows), mesh)


def shard_batch_of_scenes(batch, mesh: DeviceMesh):
    """This process's block of a (B, N, H, W, C) batch: its scenes of the
    ``data`` axis, its rows of the ``pixel`` axis."""
    scenes = block_of(batch.shape[0], mesh, "data", "scenes")
    rows = block_of(batch.shape[2], mesh, "pixel", "rows")
    return _local(batch, (scenes, slice(None), rows), mesh)


def replicate(x, mesh: DeviceMesh):
    """``x`` on this process's device, as the process at the mesh's first
    position holds it (a broadcast)."""
    t = torch.as_tensor(x, device=mesh_device(mesh)).clone()
    dist.broadcast(t, src=int(mesh.mesh.reshape(-1)[0]))
    return t
