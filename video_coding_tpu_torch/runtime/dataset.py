"""JPEG → device-tensor input pipeline (the decode-for-training path).

Compressed frames (a Motion-JPEG stream, or a list of JPEG byte strings)
become batched ``(B, H, W, 3)`` uint8 RGB tensors decoded on the device:
Huffman decode, K2, chroma upsampling and color conversion
(``JpegDecoderSession.decode_device_rgb_batch``), with host work limited to
header checks, byte slicing and the destuff. Batches are prefetched on
worker threads, so the decode of batch i+1 overlaps the consumer's step on
batch i. With ``sharding`` (a rank mesh) each rank decodes only its frames
of every batch and yields them as its shard of a ``DTensor``, the input
of a data-parallel training step.

All frames must share headers (the MJPEG steady state); the first frame
fixes the session geometry.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

from ..common.bitstream import BitReader
from ..entropy.scan import _pipelined_map
from ..model.header import DecodeError, Header
from ..parallel.mesh import mesh_device
from .engine import JpegDecoderSession


def _payload(frame_bytes: bytes) -> tuple[Header, bytes]:
    bits = BitReader(frame_bytes)
    header = Header.decode(bits)
    return header, frame_bytes[bits.bit_pos >> 3:]


class JpegRgbDataset:
    """Iterable of device-resident RGB batches from compressed frames.

    frames: list of complete JPEG byte strings, or a raw MJPEG stream
            (concatenated JPEGs) as a single ``bytes``.
    batch_size: frames per yielded ``(B, H, W, 3)`` tensor. A short final
            batch is yielded as it is unless ``drop_remainder``.
    sharding: optional ``DeviceMesh`` (``parallel.codec_mesh``): every
            rank takes its frames of each batch — the batch split over the
            flattened mesh as ``Shard(0)`` on every mesh dimension splits
            it — decodes them on its device of the mesh, and yields a
            ``DTensor`` (B, H, W, 3) sharded on the batch axis. Every rank
            of the mesh iterates.
    prefetch: batches in flight on worker threads.
    session: a decoder session to use; else one is built from the first
            frame's headers on ``device`` (None: the card, or this rank's
            device of the mesh).
    """

    def __init__(self, frames, batch_size: int = 8,
                 sharding=None, drop_remainder: bool = False,
                 prefetch: int = 2, session: JpegDecoderSession | None = None,
                 device=None):
        if sharding is not None and not isinstance(sharding, DeviceMesh):
            raise TypeError("sharding must be a DeviceMesh (from "
                            "parallel.codec_mesh) or None")
        if isinstance(frames, (bytes, bytearray)):
            from ..tools.mjpeg import split_stream

            frames = split_stream(bytes(frames))
        if not frames:
            raise ValueError("no frames")
        self.batch_size = batch_size
        self.sharding = sharding
        self.drop_remainder = drop_remainder
        self.prefetch = prefetch
        header, first_payload = _payload(frames[0])
        if session is None:
            if sharding is not None and device is None:
                device = mesh_device(sharding)
            session = JpegDecoderSession(header, device=device)
        if len(session.components) != 3:
            raise DecodeError("RGB dataset needs 3-component scans")
        self.session = session
        self.payloads = [first_payload] + [_payload(fb)[1]
                                           for fb in frames[1:]]

    def __len__(self) -> int:
        n = len(self.payloads)
        return (n // self.batch_size if self.drop_remainder
                else -(-n // self.batch_size))

    @property
    def frame_shape(self) -> tuple[int, int, int]:
        c = self.session.components[0]
        return (c.actual_height, c.actual_width, 3)

    def _batches(self):
        b = self.batch_size
        n = len(self.payloads)
        end = (n // b) * b if self.drop_remainder else n
        for i in range(0, end, b):
            yield self.payloads[i:i + b]

    def _shard(self, b: int) -> slice:
        """This rank's frames of a batch of b: the batch chunked over each
        mesh dimension in turn, as ``torch.chunk`` (and so ``Shard(0)``)
        splits a tensor."""
        lo, hi = 0, b
        for size, c in zip(self.sharding.shape,
                           self.sharding.get_coordinate()):
            chunk = -(-(hi - lo) // size)
            lo, hi = min(lo + c * chunk, hi), min(lo + (c + 1) * chunk, hi)
        return slice(lo, hi)

    def _decode_batch(self, payloads):
        if self.sharding is None:
            return self.session.decode_device_rgb_batch(payloads)
        mine = payloads[self._shard(len(payloads))]
        h, w, _ = shape = self.frame_shape
        local = (self.session.decode_device_rgb_batch(mine) if mine else
                 torch.empty((0, *shape), dtype=torch.uint8,
                             device=self.session.device))
        mesh = self.sharding
        return DTensor.from_local(local, mesh, [Shard(0)] * mesh.ndim,
                                  run_check=False,
                                  shape=(len(payloads), *shape),
                                  stride=(h * w * 3, w * 3, 3, 1))

    def __iter__(self):
        return _pipelined_map(self._decode_batch, self._batches(),
                              self.prefetch)
