"""Motion-JPEG stream utilities.

An MJPEG stream here is the standard concatenation of complete JPEG
images (SOI…EOI). These helpers split and join streams and drive one
cached decoder or encoder session over them. Where a helper builds the
session itself it builds it on ``device`` (None: the card).
"""

from __future__ import annotations

from ..common.bitstream import BitReader
from ..common.frame import Frame
from ..model import marker_codes
from ..model.header import DecodeError, Header


def _frame_end(data: bytes, soi: int) -> int:
    """End offset (past EOI) of the JPEG frame starting at ``soi``.

    Header segments are skipped via their length fields (so payload bytes
    can't fake an EOI); the entropy-coded scan is walked honoring stuffing
    and RSTn."""
    bits = BitReader(data[soi:])
    try:
        Header.decode(bits)  # consumes everything through the SOS header
    except DecodeError:
        return len(data)  # truncated/garbage trailer: consume the rest
    pos = soi + (bits.bit_pos >> 3)
    n = len(data)
    while pos + 1 < n:
        if data[pos] != 0xFF:
            pos += 1
            continue
        m = data[pos + 1]
        if m == 0x00 or marker_codes.is_rst(m):
            pos += 2
        elif m == 0xFF:
            pos += 1
        elif m == marker_codes.EOI:
            return pos + 2
        else:
            return pos  # unexpected marker terminates the frame
    return n


def split_stream(data: bytes) -> list[bytes]:
    """Split a concatenated-JPEG stream into per-frame byte strings."""
    frames = []
    pos = 0
    n = len(data)
    while pos < n:
        soi = data.find(b"\xff\xd8", pos)
        if soi < 0:
            break
        end = _frame_end(data, soi)
        frames.append(data[soi:end])
        pos = end
    return frames


def join_stream(frames: list[bytes]) -> bytes:
    return b"".join(frames)


def decode_stream(data: bytes, session=None, resync: bool = False,
                  device=None) -> list[Frame]:
    """Decode an MJPEG stream through one cached decoder session (all
    frames must share headers — the MJPEG steady state).

    With ``resync=True`` the stream is error-resilient at two levels:
    damaged restart segments inside a frame are concealed (see
    JpegDecoderSession.decode), and a frame whose headers are too
    corrupt to parse is replaced by a mid-gray frame instead of killing
    the stream."""
    from ..runtime.engine import JpegDecoderSession

    frame_bytes = split_stream(data)
    if not frame_bytes:
        return []
    payloads = []
    header = None
    for fb in frame_bytes:
        try:
            bits = BitReader(fb)
            h = Header.decode(bits)
        except DecodeError:
            if not resync:
                raise
            payloads.append(None)  # unparseable frame: conceal
            continue
        if header is None:
            header = h
        payloads.append(fb[bits.bit_pos >> 3:])
    if header is None:
        return []
    if session is None:
        session = JpegDecoderSession(header, device=device)
    if not resync:
        return session.decode_batch(payloads)
    gray = None
    out = []
    for p in payloads:
        if p is None:
            if gray is None:
                gray = _gray_frame(session)
            out.append(gray)
            continue
        try:
            out.append(session.decode(p, resync=True))
        except DecodeError:
            if gray is None:
                gray = _gray_frame(session)
            out.append(gray)
    return out


def _gray_frame(session) -> Frame:
    """Mid-gray concealment frame matching the session geometry."""
    import numpy as np

    from ..common.plane import Plane

    planes = [Plane(data=np.full((c.actual_height, c.actual_width), 128,
                                 dtype=np.uint8))
              for c in session.components]
    return Frame.of_planes(*planes)


def _encoder_session(f0: Frame, quality: int, restart_interval: int,
                     device):
    """An encoder session for frames of ``f0``'s geometry and sampling."""
    from ..runtime.engine import SUBSAMPLING_PRESETS, JpegEncoderSession

    maker = SUBSAMPLING_PRESETS[f0.chroma_subsampling]
    return JpegEncoderSession(maker(f0.width, f0.height, quality),
                              restart_interval, device=device)


def encode_stream(frames: list[Frame], quality: int = 75,
                  restart_interval: int = 0, session=None,
                  device=None) -> bytes:
    """Encode frames (same geometry) into an MJPEG stream through one
    cached encoder session."""
    if not frames:
        return b""
    if session is None:
        session = _encoder_session(frames[0], quality, restart_interval,
                                   device)
    return join_stream(session.encode_batch(frames))


def decode_stream_iter(data: bytes, session=None, depth: int = 2,
                       device=None):
    """Streaming variant of decode_stream: an ordered Frame generator with
    ``depth`` frames in flight (host entropy overlapping device numerics
    via ``JpegDecoderSession.decode_iter``): constant memory over
    arbitrarily long streams."""
    from ..runtime.engine import JpegDecoderSession

    def payloads():
        nonlocal session
        pos = 0
        n = len(data)
        while pos < n:
            soi = data.find(b"\xff\xd8", pos)
            if soi < 0:
                break
            end = _frame_end(data, soi)
            fb = data[soi:end]
            pos = end
            bits = BitReader(fb)
            h = Header.decode(bits)
            if session is None:
                session = JpegDecoderSession(h, device=device)
            yield fb[bits.bit_pos >> 3:]

    gen = payloads()
    try:
        first = next(gen)
    except StopIteration:
        return
    import itertools
    yield from session.decode_iter(itertools.chain([first], gen), depth)


def encode_stream_iter(frames, quality: int = 75,
                       restart_interval: int = 0, session=None,
                       depth: int = 2, device=None):
    """Streaming variant of encode_stream: yields one complete JPEG byte
    string per input frame, ``depth`` frames in flight."""
    it = iter(frames)
    try:
        f0 = next(it)
    except StopIteration:
        return
    if session is None:
        session = _encoder_session(f0, quality, restart_interval, device)
    import itertools
    yield from session.encode_iter(itertools.chain([f0], it), depth)
