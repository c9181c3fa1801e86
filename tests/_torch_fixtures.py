"""Shared inputs for the PyTorch port's parity tests: seeded synthetic
frames and the reference model's encodes of them."""

from __future__ import annotations

import numpy as np

from video_coding_tpu.common.bitstream import BitReader
from video_coding_tpu.common.frame import ChromaSubsampling, Frame
from video_coding_tpu.common.plane import Plane
from video_coding_tpu.model import decoder as mdec
from video_coding_tpu.model import encoder as menc

ENCODERS = {
    "420": (ChromaSubsampling.C420, menc.encode_420, menc.Parameters.c420),
    "422": (ChromaSubsampling.C422, menc.encode_422, menc.Parameters.c422),
    "440": (ChromaSubsampling.C440, menc.encode_440, menc.Parameters.c440),
    "444": (ChromaSubsampling.C444, menc.encode_444, menc.Parameters.c444),
}


def synth_frame(sub: str, w: int, h: int, seed: int) -> Frame:
    """Gradient + edges + noise frame (compressible like camera content,
    with enough detail to exercise long AC runs and ZRLs)."""
    rng = np.random.default_rng(seed)
    csub = ENCODERS[sub][0]
    cw, ch = csub.chroma_width(w), csub.chroma_height(h)

    def plane(pw, ph, base):
        yy, xx = np.mgrid[0:ph, 0:pw]
        p = base + 60 * np.sin(xx / 7.0) * np.cos(yy / 5.0) + 0.4 * xx
        x0, y0 = rng.integers(0, max(pw // 2, 1)), rng.integers(0, max(ph // 2, 1))
        p[y0:y0 + ph // 3, x0:x0 + pw // 3] = rng.integers(0, 256)
        p = p + rng.normal(0, 8, p.shape)
        return Plane(data=np.clip(p, 0, 255).astype(np.uint8))

    return Frame(plane(w, h, 100), plane(cw, ch, 128), plane(cw, ch, 128),
                 csub)


def encode(sub: str, frame: Frame, q: int, ri: int) -> bytes:
    return ENCODERS[sub][1](frame, q, restart_interval=ri)


def synth_plane(w: int, h: int, seed: int) -> Plane:
    """The luma plane of ``synth_frame`` (for monochrome streams)."""
    return synth_frame("444", w, h, seed).y


def encode_monochrome(plane: Plane, q: int, ri: int) -> bytes:
    return menc.encode_monochrome(plane, q, restart_interval=ri)


def header_payload(stream: bytes):
    """(reference Header, entropy payload) of a stream."""
    bits = BitReader(stream)
    header = mdec.Header.decode(bits)
    return header, stream[bits.bit_pos >> 3:]


def golden_transcode(sub: str, stream: bytes, q: int, ri: int) -> bytes:
    """The reference model's decode followed by its encode."""
    return encode(sub, mdec.decode_a_frame(stream), q, ri)
