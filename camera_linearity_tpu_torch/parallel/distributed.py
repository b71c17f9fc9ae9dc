"""Multi-process entry point: ``torch.distributed`` wiring and scene
blocks.

Port of ``camera_linearity_tpu/parallel/distributed.py``.  The JAX package
joins one multi-process JAX runtime; here each process joins one
``torch.distributed`` process group, with one process per GPU (NCCL on
CUDA, gloo on the CPU).  The canonical mesh is ``(data, pixel)`` with
``data`` spanning the processes and ``pixel`` of length one.  Scenes shard
as contiguous blocks over ``data``: each process decodes ONLY its own block
and merges it on its own card, since the merge is pointwise over pixels;
the statistics and the calibration energies cross processes by explicit
collectives (parallel/sharded.py, models/calibration.py).

tests/test_torch_distributed.py runs the flow in several processes on the
CPU over gloo.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..utils.device import resolve_device
from .mesh import axis_size, block_of, data_pixel_mesh, mesh_device

Tensor = torch.Tensor

__all__ = ["initialize", "shutdown", "is_initialized", "process_count",
           "process_index", "all_gather", "scene_mesh", "local_scene_block",
           "global_scene_batch", "fetch_local_scenes"]

_ENV_COORD = "CL_COORDINATOR_ADDRESS"
_ENV_NPROC = "CL_NUM_PROCESSES"
_ENV_PID = "CL_PROCESS_ID"
_ENV_LOCAL_DEVICES = "CL_LOCAL_DEVICE_IDS"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None,
               backend: Optional[str] = None, device=None,
               timeout_s: float = 300.0) -> bool:
    """Join (or skip joining) a multi-process run; idempotent.

    Resolution order per argument: explicit parameter, then environment
    (``CL_COORDINATOR_ADDRESS`` / ``CL_NUM_PROCESSES`` / ``CL_PROCESS_ID``
    / ``CL_LOCAL_DEVICE_IDS`` as a comma list).  With NO configuration
    anywhere this is a no-op that returns False: single-process mode, the
    common case.  Otherwise all of the address, the process count and the
    process id are needed, and the group rendezvouses at
    ``tcp://<coordinator_address>`` (an address with a scheme, such as
    ``file:///path``, is used as it is), failing after ``timeout_s``.

    On ``device`` (by default the card) the process computes on
    ``cuda:<first local device id>``, device 0 without ids, and the
    backend is NCCL; on the CPU it is gloo.  ``backend`` overrides that:
    processes that share one card need ``"gloo"``, because NCCL refuses
    two ranks on one device.  Returns True when the run has more than one
    process.
    """
    if is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    coordinator_address = coordinator_address or env.get(_ENV_COORD)
    if num_processes is None and env.get(_ENV_NPROC):
        num_processes = int(env[_ENV_NPROC])
    if process_id is None and env.get(_ENV_PID):
        process_id = int(env[_ENV_PID])
    if local_device_ids is None and env.get(_ENV_LOCAL_DEVICES):
        local_device_ids = [int(x) for x in
                            env[_ENV_LOCAL_DEVICES].split(",") if x]
    given = {"coordinator address": coordinator_address,
             "process count": num_processes, "process id": process_id}
    if all(v is None for v in given.values()):
        return False
    missing = [k for k, v in given.items() if v is None]
    if missing:
        raise ValueError(
            f"initialize: no {', no '.join(missing)} given; a multi-process "
            "run needs all three (arguments, or CL_COORDINATOR_ADDRESS, "
            "CL_NUM_PROCESSES and CL_PROCESS_ID)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(local_device_ids[0] if local_device_ids
                              else 0)
    init_method = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init_method, world_size=num_processes,
        rank=process_id, timeout=timedelta(seconds=timeout_s))
    return num_processes > 1


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def shutdown() -> None:
    if is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    """The number of processes of the run (1 without a process group)."""
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def all_gather(t: Tensor, group=None) -> List[Tensor]:
    """Every process's ``t`` (of one shape on all of them) in the group's
    rank order, on ``t``'s device.  Gloo gathers CPU tensors only, so a
    CUDA tensor crosses the host there."""
    stage = t.is_cuda and dist.get_backend(group) == "gloo"
    src = t.cpu() if stage else t.contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return [o.to(t.device) for o in out] if stage else out


def scene_mesh(device=None) -> DeviceMesh:
    """The canonical multi-process ``(data, pixel)`` mesh: ``data`` spans
    the processes, ``pixel`` has length one (one process per card)."""
    if not is_initialized():
        raise RuntimeError(
            "scene_mesh needs a process group: call initialize(...) first "
            "(a world of one process will do)")
    return data_pixel_mesh(dist.get_world_size(), 1, device)


def local_scene_block(n_scenes: int, mesh: DeviceMesh) -> slice:
    """The contiguous block of scene indices THIS process owns when the
    scene axis shards over ``data``: the block a ``PartitionSpec("data",
    ...)`` sharding gives its mesh position."""
    return block_of(n_scenes, mesh, "data", "scenes")


def global_scene_batch(local_val: np.ndarray, mesh: DeviceMesh,
                       n_scenes: int) -> Tensor:
    """This process's block of the global (B, N, H, W, C) scene batch, on
    its device, from its host-local block of decoded scenes: its rows of
    the ``pixel`` axis.

    Every process's block must have the same shape, and the blocks must
    make up ``n_scenes`` scenes: a mismatch raises on every process (one
    small all-gather of the shapes), where it would otherwise
    desynchronize the collectives that follow.
    """
    shape = torch.tensor(local_val.shape, dtype=torch.int64)
    if mesh.device_type == "cuda":
        shape = shape.to(mesh_device(mesh))
    shapes = torch.stack(all_gather(shape)).cpu()
    blocks = shapes.shape[0] // axis_size(mesh, "pixel")
    if not (shapes == shapes[0]).all() or \
            int(shapes[0, 0]) * blocks != n_scenes:
        raise ValueError(
            f"global_scene_batch: the processes' blocks {shapes.tolist()} "
            f"do not make up {n_scenes} scenes of one geometry")
    rows = block_of(local_val.shape[2], mesh, "pixel", "rows")
    return torch.as_tensor(local_val[:, :, rows], device=mesh_device(mesh))


def fetch_local_scenes(global_out: Tensor, mesh: DeviceMesh,
                       block: slice) -> Tensor:
    """THIS process's merged scenes (B_loc, H, W, C) on its device.

    ``global_out`` is this process's (B_loc, H_loc, W, C) block of the
    merge output (where the JAX package passes the global sharded array,
    each process here holds its own block as a plain tensor): the row
    bands gather over the ``pixel`` axis (the scene axis stays put)."""
    if axis_size(mesh, "pixel") > 1:
        global_out = torch.cat(
            all_gather(global_out, mesh.get_group("pixel")), dim=1)
    if global_out.shape[0] != block.stop - block.start:
        raise AssertionError(
            f"local scene block {global_out.shape[0]} != owned block "
            f"{block.stop - block.start}")
    return global_out
