"""Device meshes for the codec pipelines, over the ranks of the
initialised ``torch.distributed`` process group.

The JAX package is single-controller: one process sees every chip and a
``Mesh`` is an array of its devices. PyTorch is SPMD: one process (rank)
drives one device, so a mesh here is an array of ranks, and every rank of
the world builds it (``torch.distributed`` makes groups collectively). A
mesh may be smaller than the world (JAX takes the first ``n`` devices):
the ranks outside it hold it but take no part in its work.

Ranks lie on the mesh in row-major order (rank = the flattened mesh
index), which is the order of the JAX package's ``_shard_linear_index``:
the encoder's wire offsets depend on it.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard


def mesh_device_type(device_type: str | None) -> str:
    """``None`` means the card (NCCL); ``"cpu"`` (gloo) only when asked
    for. Raises for the card without one."""
    if device_type is None:
        device_type = "cuda"
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported mesh device type {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device_type='cpu' "
                           "explicitly for a gloo mesh on the CPU")
    return device_type


def make_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...],
              device_type: str | None = None) -> DeviceMesh:
    """A mesh of the given logical shape over the first prod(shape) ranks,
    with one flat process group over all of them (the whole-mesh
    collectives, JAX's psum over every axis, use it: ``flat_group``).
    Every rank of the world must call it."""
    device_type = mesh_device_type(device_type)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no torch.distributed process group; call "
                           "parallel.initialize (or init_process_group) "
                           "first")
    n = math.prod(shape)
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"mesh shape {tuple(shape)} needs {n} ranks, have "
                         f"{world}")
    mesh = DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axis_names))
    mesh.vct_flat_group = dist.new_group(ranks=list(range(n)))
    return mesh


def codec_mesh(n_devices: int | None = None, seg_parallel: int | None = None,
               device_type: str | None = None) -> DeviceMesh:
    """Standard codec mesh: ('data', 'seg').

    'data' shards frames, 'seg' shards restart segments (blocks) within a
    frame. n_devices defaults to the world size; seg_parallel to the
    largest of 4 and 2 that divides n_devices, else 1."""
    if n_devices is None:
        mesh_device_type(device_type)
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("no torch.distributed process group; call "
                               "parallel.initialize (or init_process_group) "
                               "first")
        n_devices = dist.get_world_size()
    if seg_parallel is None:
        seg_parallel = next((c for c in (4, 2) if n_devices % c == 0), 1)
    return make_mesh((n_devices // seg_parallel, seg_parallel),
                     ("data", "seg"), device_type)


def flat_group(mesh: DeviceMesh):
    """The process group over every rank of the mesh, in mesh order."""
    group = getattr(mesh, "vct_flat_group", None)
    if group is None:
        raise ValueError("mesh was not built by parallel.make_mesh or "
                         "codec_mesh (it has no flat process group)")
    return group


def mesh_index(mesh: DeviceMesh) -> int:
    """This rank's row-major index on the mesh; raises off the mesh."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not on the mesh")
    idx = 0
    for size, c in zip(mesh.shape, coord):
        idx = idx * size + c
    return idx


def shard_rows(local: torch.Tensor, mesh: DeviceMesh) -> DTensor:
    """Each rank's equal run of rows → the global DTensor sharded on its
    leading axis over every mesh dimension (row-major rank order)."""
    return DTensor.from_local(local, mesh, [Shard(0)] * mesh.ndim,
                              run_check=False)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on for the mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
