"""JPEG → device-tensor input pipeline (the decode-for-training path).

Compressed frames (a Motion-JPEG stream, or a list of JPEG byte strings)
become batched ``(B, H, W, 3)`` uint8 RGB tensors decoded on the device:
Huffman decode, K2, chroma upsampling and color conversion
(``JpegDecoderSession.decode_device_rgb_batch``), with host work limited to
header checks, byte slicing and the destuff. Batches are prefetched on
worker threads, so the decode of batch i+1 overlaps the consumer's step on
batch i.

All frames must share headers (the MJPEG steady state); the first frame
fixes the session geometry.
"""

from __future__ import annotations

from ..common.bitstream import BitReader
from ..entropy.scan import _pipelined_map
from ..model.header import DecodeError, Header
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
    sharding: must be None. Spreading batches over several devices belongs
            to the multi-device work (ROADMAP Queue 1 item 5); anything
            else raises ``NotImplementedError``.
    prefetch: batches in flight on worker threads.
    session: a decoder session to use; else one is built from the first
            frame's headers on ``device`` (None: the card).
    """

    def __init__(self, frames, batch_size: int = 8,
                 sharding=None, drop_remainder: bool = False,
                 prefetch: int = 2, session: JpegDecoderSession | None = None,
                 device=None):
        if sharding is not None:
            raise NotImplementedError(
                "JpegRgbDataset(sharding=...) is multi-device work (ROADMAP "
                "Queue 1 item 5), not ported yet; pass sharding=None")
        if isinstance(frames, (bytes, bytearray)):
            from ..tools.mjpeg import split_stream

            frames = split_stream(bytes(frames))
        if not frames:
            raise ValueError("no frames")
        self.batch_size = batch_size
        self.drop_remainder = drop_remainder
        self.prefetch = prefetch
        header, first_payload = _payload(frames[0])
        if session is None:
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

    def __iter__(self):
        return _pipelined_map(self.session.decode_device_rgb_batch,
                              self._batches(), self.prefetch)
