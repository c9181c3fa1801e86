"""Multi-process codec pipelines: one rank a device, on one host or many.

Every process runs this same code. ``initialize`` joins the process
group; ``global_codec_mesh`` lays every rank on a ('data', 'seg') mesh;
each rank feeds its own frames (``local_frames_to_global``) and the
shardings of ``pipeline.py`` do the rest. With one process this is the
one-rank mesh.

    torchrun --nproc-per-node 4 prog.py      (or, in each process:)
    initialize("host0:1234", num_processes=4, process_id=i)
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from .mesh import codec_mesh, mesh_device, mesh_device_type
from .pipeline import mjpeg_codec_step


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               device_type: str | None = None) -> None:
    """Join the process group: NCCL on the card (the default; this rank
    takes card ``process_id % device_count``), gloo with
    ``device_type="cpu"``, rendezvous at ``tcp://coordinator_address``.
    A no-op for a single process."""
    if not num_processes or num_processes <= 1:
        return
    device_type = mesh_device_type(device_type)
    if device_type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)


def global_codec_mesh(seg_parallel: int | None = None,
                      device_type: str | None = None):
    """Codec mesh over every rank of the process group."""
    return codec_mesh(dist.get_world_size(), seg_parallel, device_type)


def local_frames_to_global(mesh, local_frames) -> DTensor:
    """Each rank's local frames as its shard of one global array sharded
    over the mesh's 'data' axis (frames) and replicated over the others:
    ranks that share a 'data' index pass the same frames.

    local_frames: (F_local, N, 8, 8) — this rank's frames."""
    local = torch.from_numpy(np.ascontiguousarray(local_frames)) \
        if not isinstance(local_frames, torch.Tensor) else local_frames
    place = [Shard(0) if name == "data" else Replicate()
             for name in mesh.mesh_dim_names]
    return DTensor.from_local(local.to(mesh_device(mesh)), mesh, place,
                              run_check=False)


def mjpeg_multihost_step(mesh, local_frames, quant):
    """One frame-sharded codec step over the (multi-process) mesh: every
    rank passes its local (F_local, N, 8, 8) frames; returns what
    ``mjpeg_codec_step`` returns."""
    return mjpeg_codec_step(mesh, local_frames_to_global(mesh, local_frames),
                            quant)
