"""Sharded codec pipelines over a rank mesh.

Every rank calls each function with the same host arrays (as every JAX
process does); each rank uploads and computes only its own rows, with the
kernels of the single-device path:

- block batches shard along the block axis over every mesh axis (K2, K3
  on the rank's rows; a sharded result is a ``DTensor`` with ``Shard(0)``
  on every mesh dimension, PyTorch's counterpart of a ``NamedSharding``);
- ``sharded_decode_e2e`` shards restart segments (K5, then K2);
- ``mjpeg_codec_step`` shards frames over 'data' and blocks over 'seg'.

Collectives are explicit: ``all_reduce(SUM)`` where JAX has ``psum`` (the
per-frame rates over 'seg', the SSE over the whole mesh) and
``all_gather_into_tensor`` where JAX has ``all_gather``. Results that JAX
replicates (rates, PSNR) are plain tensors, equal on every rank.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..entropy import gather_pack, huffman_decode
from ..entropy.decode_tables import range_tables
from ..entropy.huffman_encode import device_encoder_tables
from ..entropy.tables import DecoderTables, pack_encoder_tables
from ..model.header import Parameters
from ..ops import datapath
from .mesh import flat_group, mesh_device, mesh_index, shard_rows


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def _all_shard0(mesh) -> list:
    return [Shard(0)] * mesh.ndim


def _local_rows(x, mesh, dev) -> torch.Tensor:
    """This rank's contiguous run of x's leading axis (split evenly over
    the flattened mesh), contiguous on ``dev``. A DTensor gives its local
    shard after a redistribution to ``Shard(0)`` on every mesh
    dimension."""
    if isinstance(x, DTensor):
        return x.redistribute(x.device_mesh, _all_shard0(mesh)) \
            .to_local().to(dev).contiguous()
    t = _as_tensor(x)
    n = mesh.size()
    if t.shape[0] % n:
        raise ValueError(f"leading axis {t.shape[0]} does not divide over "
                         f"{n} mesh ranks")
    step = t.shape[0] // n
    r = mesh_index(mesh)
    return t[r * step:(r + 1) * step].to(dev).contiguous()


def sharded_decode_datapath(mesh, coefs, quant) -> DTensor:
    """Decode datapath (K2) with the block axis sharded over every mesh
    axis. coefs, quant: (N, 64) int32, N divisible by the mesh size.
    Returns (N, 8, 8) uint8 pixels with the same sharding."""
    dev = mesh_device(mesh)
    return shard_rows(datapath.decode_datapath(
        _local_rows(coefs, mesh, dev).to(torch.int32),
        _local_rows(quant, mesh, dev).to(torch.int32)), mesh)


def sharded_encode_datapath(mesh, pixels, quant) -> DTensor:
    """Encode datapath (K3) with the block axis sharded over every mesh
    axis. pixels (N, 8, 8) uint8, quant (N, 64) int32 → (N, 64) int32."""
    dev = mesh_device(mesh)
    return shard_rows(datapath.encode_datapath(
        _local_rows(pixels, mesh, dev).to(torch.uint8),
        _local_rows(quant, mesh, dev).to(torch.int32)), mesh)


def _psnr(sse_local: torch.Tensor, n: int, mesh) -> torch.Tensor:
    """PSNR from each rank's float32 SSE, summed over the whole mesh."""
    dist.all_reduce(sse_local, group=flat_group(mesh))
    mse = sse_local / n
    return 10.0 * torch.log10(255.0 ** 2 / mse)


def _sse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a.to(torch.float32) - b.to(torch.float32)
    return (d * d).sum()


def _local_flat(x, mesh, dev) -> torch.Tensor:
    """This rank's disjoint piece of x, flattened: a DTensor's local shard
    (after dropping replication), else its run of the flattened array."""
    if isinstance(x, DTensor):
        if any(isinstance(p, Replicate) for p in x.placements):
            x = x.redistribute(x.device_mesh, _all_shard0(mesh))
        return x.to_local().to(dev).reshape(-1)
    return _local_rows(_as_tensor(x).reshape(-1), mesh, dev)


def distributed_psnr(mesh, a, b) -> torch.Tensor:
    """PSNR between two pixel tensors sharded over the whole mesh (plain
    arrays: each rank takes its run of the flattened array; DTensors: the
    local shards, with the same placements for a and b). The float32 SSE
    is summed with ``all_reduce`` over every mesh rank. Returns a 0-d
    float32 tensor, equal on every rank."""
    dev = mesh_device(mesh)
    la, lb = _local_flat(a, mesh, dev), _local_flat(b, mesh, dev)
    n = int(np.prod(a.shape))
    return _psnr(_sse(la, lb), n, mesh)


def rate_estimate_bits(qcoefs) -> torch.Tensor:
    """Entropy-rate proxy per block: the summed magnitude size categories
    (integer compares). For the true coded size see ``rate_exact_bits``."""
    q = _as_tensor(qcoefs)
    mag = q.to(torch.int32).abs()
    thresholds = torch.tensor([1 << k for k in range(12)], dtype=torch.int32,
                              device=q.device)
    return (mag[..., None] >= thresholds).sum(dim=(-2, -1),
                                              dtype=torch.int32)


@functools.lru_cache(maxsize=1)
def _luma_rate_tables():
    """Annex-K luma encoder tables (dc_bits, dc_len, ac_bits, ac_len) —
    the default tables for exact rate estimation on raw block batches."""
    p = Parameters.c420(16, 16, 75)
    tabs = pack_encoder_tables([p.dc_huffman_tables[0].data],
                               [p.ac_huffman_tables[0].data])
    return tuple(np.asarray(t) for t in device_encoder_tables(tabs))


def rate_exact_bits(qcoefs, dc_bits, dc_len, ac_bits, ac_len
                    ) -> torch.Tensor:
    """Exact coded bits per block, each block its own restart segment
    (the DC predictor resets, so the DC difference is the DC): the
    restart_interval=1 stream's segment sizes before byte padding and
    stuffing. qcoefs (N, 64) int32 zigzag; returns (N,) int32."""
    q = _as_tensor(qcoefs).to(torch.int32)
    dev = q.device
    dc_bits, dc_len, ac_bits, ac_len = (_as_tensor(t).to(dev, torch.int32)
                                        for t in (dc_bits, dc_len, ac_bits,
                                                  ac_len))
    dc_flat = ((dc_bits << 5) | dc_len).reshape(-1)
    ac_flat = ((ac_bits << 5) | ac_len).reshape(-1)
    n = q.shape[0]
    return gather_pack.segment_coded_bits(
        q, torch.zeros(n, dtype=torch.int32, device=dev),
        torch.full((1,), -1, dtype=torch.int32, device=dev), dc_flat,
        ac_flat, blocks_per_segment=1)


def sharded_decode_e2e(mesh, segbytes, seg_blocks, comp_sched,
                       tables: DecoderTables, quant,
                       blocks_per_segment: int) -> DTensor:
    """Full decode (Huffman and block datapath) with restart segments
    sharded over every mesh axis: each rank runs K5 on its rows of the
    padded matrix, then K2.

    segbytes: (S, L) uint8 destuffed zero-padded segments (>= 4 guard
    bytes), S divisible by the mesh size; seg_blocks (S,); comp_sched
    (B,); tables: the packed ``DecoderTables`` — K5's range tables are
    built from them (the JAX function takes the 2^16-entry expanded LUTs
    instead, which feed a plain loop no kernel here consumes); quant (B,
    64) per-position quant rows. Returns (S, B, 8, 8) uint8 pixels
    sharded like the input."""
    dev = mesh_device(mesh)
    B = blocks_per_segment
    lo, hi, offset, values = (_as_tensor(a).to(dev) for a in
                              range_tables(tables))
    seg_local = _local_rows(segbytes, mesh, dev).to(torch.uint8)
    coefs = huffman_decode.decode_segments(
        seg_local, _local_rows(seg_blocks, mesh, dev).to(torch.int32),
        _as_tensor(comp_sched).to(dev, torch.int32).contiguous(), lo, hi,
        offset, values, blocks_per_segment=B,
        n_components=len(tables.dc_maxbits))
    s = coefs.shape[0]
    pixels = datapath.decode_datapath(
        coefs.view(s * B, 64),
        _as_tensor(quant).to(dev, torch.int32).contiguous())
    return shard_rows(pixels.view(s, B, 8, 8), mesh)


def mjpeg_codec_step(mesh, frames_pixels, quant):
    """One full codec step over a ('data', 'seg') mesh: frames sharded
    over 'data', blocks within each frame over 'seg'; the encode datapath
    (K3), the exact per-frame rate (``all_reduce`` over 'seg', then
    ``all_gather`` over 'data'), the decode datapath (K2) and the PSNR
    (SSE summed over the whole mesh).

    frames_pixels: (F, N, 8, 8) uint8 (or int32 in 0..255), F % data ==
    0, N % seg == 0, as an array or a DTensor. quant: (N, 64) int32.
    Returns (qcoefs (F, N, 64) int32 DTensor, recon (F, N, 8, 8) uint8
    DTensor — both ``[Shard(0), Shard(1)]`` over ('data', 'seg') —,
    rates (F,) int32 exact coded bits per frame, psnr 0-d float32); rates
    and psnr are plain tensors, equal on every rank."""
    dev = mesh_device(mesh)
    names = mesh.mesh_dim_names
    d_dim, s_dim = names.index("data"), names.index("seg")
    D, S = mesh.shape[d_dim], mesh.shape[s_dim]
    d, s = (mesh.get_coordinate()[i] for i in (d_dim, s_dim))
    place = [None] * 2
    place[d_dim], place[s_dim] = Shard(0), Shard(1)
    if isinstance(frames_pixels, DTensor):
        px = frames_pixels.redistribute(frames_pixels.device_mesh, place) \
            .to_local().to(dev)
        F, N = frames_pixels.shape[:2]
    else:
        full = _as_tensor(frames_pixels)
        F, N = full.shape[:2]
        if F % D or N % S:
            raise ValueError(f"({F}, {N}) frames x blocks do not divide "
                             f"over the ({D}, {S}) mesh")
        px = full[d * (F // D):(d + 1) * (F // D),
                  s * (N // S):(s + 1) * (N // S)].to(dev)
    f, n = px.shape[:2]
    px = px.to(torch.uint8).reshape(f * n, 8, 8).contiguous()
    q = _as_tensor(quant)[s * n:(s + 1) * n].to(dev, torch.int32) \
        .contiguous()
    qc = datapath.encode_datapath(px, q)
    rate = rate_exact_bits(qc, *_luma_rate_tables()).view(f, n) \
        .sum(dim=1, dtype=torch.int32)
    dist.all_reduce(rate, group=mesh.get_group("seg"))
    rates = torch.empty(F, dtype=torch.int32, device=dev)
    dist.all_gather_into_tensor(rates, rate, group=mesh.get_group("data"))
    recon = datapath.decode_datapath(qc, q)
    psnr = _psnr(_sse(px, recon), F * N * 64, mesh)
    qcoefs = DTensor.from_local(qc.view(f, n, 64), mesh, place,
                                run_check=False)
    recon_d = DTensor.from_local(recon.view(f, n, 8, 8), mesh, place,
                                 run_check=False)
    return qcoefs, recon_d, rates, psnr
