"""The golden decoder in numpy: the single-scan ``Decoder`` (full-frame
decode with a sequenced per-block API for lockstep testing), the
multi-scan (non-interleaved) ``MultiScanDecoder``, and the pieces the
decoder session's host paths take from them: the magnitude decode, the
destuffing segment walk, the restart-segment alignment that resync is
built on and the one-block Huffman decode.

Restart markers are honoured: the entropy stream is split into segments at
RSTn boundaries and DC predictors reset per segment. The bulk decode is
phase-split: a sequential entropy decode into a (num_blocks, 64)
coefficient array, then batched dequant → dezigzag → IDCT → recon, the
contract of the decode datapath K2. Geometry and tables come from
``model/header.py`` (``DecoderGeometry``), as in the sessions.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..common.bitstream import BitReader
from ..common.frame import Frame
from ..common.plane import Plane
from . import marker_codes, markers
from .dct import chen_inverse_8x8
from . import header as _header
from .header import (DecodeError, DecoderGeometry, Header, _find_component,
                     _find_huffman_lut, _find_quant_table, _round_up)
from .huffman import Lut
from .zigzag import INVERSE as ZIGZAG_INVERSE


def mag(cat: int, code: int) -> int:
    """Magnitude (sign-extension) decode of a size-``cat`` value."""
    if cat == 0:
        return 0
    if code & (1 << (cat - 1)):
        return code
    return (code | (-1 << cat)) + 1


def extract_entropy_segments_span(
        bits: BitReader) -> tuple[list[bytes], list[int], int]:
    """De-stuff the entropy-coded data, splitting at RSTn markers.

    0xFF00 → 0xFF; RST0-7 ends the current segment and starts the next;
    0xFFFF is a fill byte; any other marker terminates the scan. Also
    returns the RSTn modulo-8 index of each segment terminator (len =
    len(segments) - 1), the hook for re-aligning segments after marker
    loss (resync), and the byte offset of the terminating marker's 0xFF
    (== len(buf) when the scan runs to the end), so multi-scan decoding
    can resume the marker loop there."""
    buf = bits.buffer
    pos = bits.bit_pos >> 3
    segments: list[bytes] = []
    marker_indices: list[int] = []
    out = bytearray()
    n = len(buf)
    end = n
    while True:
        nxt = buf.find(b"\xff", pos)
        if nxt == -1:
            out.extend(buf[pos:])
            break
        out.extend(buf[pos:nxt])
        marker = buf[nxt + 1] if nxt + 1 < n else 0xD9
        if marker == 0x00:
            out.append(0xFF)
            pos = nxt + 2
        elif marker_codes.is_rst(marker):
            segments.append(bytes(out))
            marker_indices.append(marker & 7)
            out = bytearray()
            pos = nxt + 2
        elif marker == 0xFF:
            # fill bytes before a marker are legal; keep scanning
            pos = nxt + 1
        else:
            end = nxt
            break
    segments.append(bytes(out))
    return segments, marker_indices, end


def extract_entropy_segments_with_markers(
        bits: BitReader) -> tuple[list[bytes], list[int]]:
    segments, marker_indices, _end = extract_entropy_segments_span(bits)
    return segments, marker_indices


def extract_entropy_segments(bits: BitReader) -> list[bytes]:
    return extract_entropy_segments_span(bits)[0]


def plan_segment_alignment(marker_indices: list[int], n_received: int,
                           expected: int) -> tuple[list, list[int]]:
    """Assign received restart segments to expected segment slots using
    the RSTn modulo-8 marker indices (segment s is terminated by RST(s%8)).

    A destroyed RSTn merges two received segments: its terminator index
    jumps by k, and the segment is decoded as a run of k+1 slots (its
    payload bytes are intact), so later segments stay aligned. A jump
    whose next terminator matches the single-slot continuation is a
    corrupted index byte, not a merge.

    Returns ``(items, uncovered)``: items are ``(slot0, n_slots, j)`` —
    received segment j holds slots [slot0, slot0+n_slots) — and uncovered
    lists slots no received segment claims (to be concealed)."""
    items = []
    p = 0
    for j in range(n_received):
        if p >= expected:
            break  # extra trailing segments: ignore
        m = marker_indices[j] if j < len(marker_indices) else None
        if m is None or m == p % 8:
            items.append((p, 1, j))
            p += 1
            continue
        k = (m - p) % 8
        nxt = marker_indices[j + 1] if j + 1 < len(marker_indices) else None
        if nxt is not None and nxt == (p + 1) % 8:
            items.append((p, 1, j))
            p += 1
        elif p + k < expected:
            # k markers lost: segment j carries slots p..p+k back to back
            items.append((p, k + 1, j))
            p += k + 1
        else:
            # index jump past the scan end: unreliable, best-effort single
            items.append((p, 1, j))
            p += 1
    slots = set()
    for slot0, n_slots, _j in items:
        slots.update(range(slot0, slot0 + n_slots))
    uncovered = [s for s in range(expected) if s not in slots]
    return items, uncovered


def huffman_decode_block(bits: BitReader, dc_tab: Lut, ac_tab: Lut,
                         coefs: np.ndarray) -> None:
    """One 8x8 block of Huffman + magnitude decode into zigzag-order
    ``coefs``. Exhausting the reader (a read that starts past the end) is
    a DecodeError."""
    try:
        _huffman_decode_block_inner(bits, dc_tab, ac_tab, coefs)
    except DecodeError:
        raise
    except ValueError as e:
        raise DecodeError(f"entropy data exhausted: {e}") from e


def _huffman_decode_block_inner(bits: BitReader, dc_tab: Lut, ac_tab: Lut,
                                coefs: np.ndarray) -> None:
    length, data = dc_tab.lookup(bits.show(dc_tab.max_bits))
    if length == 0:
        raise DecodeError("Can't find dc code")
    bits.advance(length)
    coefs[0] = mag(data, bits.get(data) if data else 0)
    cof_cnt = 1
    ac_max = ac_tab.max_bits
    while cof_cnt < 64:
        length, data = ac_tab.lookup(bits.show(ac_max))
        if length == 0:
            raise DecodeError("Can't find ac code")
        bits.advance(length)
        run, size = (data >> 4) & 0xF, data & 0xF
        value = mag(size, bits.get(size) if size else 0)
        if value == 0 and run == 0:
            break  # EOB
        cof_cnt += run
        if cof_cnt >= 64:
            raise DecodeError(
                f"coefficient index out of range: {cof_cnt}")
        coefs[cof_cnt] = value
        cof_cnt += 1


class SegmentDecodeError(DecodeError, ValueError):
    """Malformed entropy data; ``block`` is the failing global block. A
    ``DecodeError`` for the golden decoder's callers and a ``ValueError``
    for the host decoder's (``entropy/scan.py``), as in the JAX package."""

    def __init__(self, block: int):
        super().__init__(f"entropy decode failed at block {block}")
        self.block = block


def _decode_slot(bits: BitReader, slot: int, coefs: np.ndarray, keys: list,
                 luts, bps: int, bit_limit: int | None = None):
    """Decode one restart slot's blocks into ``coefs``. Returns None, or
    the index of the failing block (zeroed; earlier blocks are valid).
    With ``bit_limit`` (resync), consuming past the segment's real bits
    means zero-fill garbage, an error."""
    dc_preds = {}
    for i in range(slot * bps, min((slot + 1) * bps, len(keys))):
        key = keys[i]
        row = coefs[i]
        try:
            huffman_decode_block(bits, *luts[key], row)
            if bit_limit is not None and bits.bit_pos > bit_limit:
                raise DecodeError("segment data exhausted")
        except DecodeError:
            row[:] = 0  # the failing block may be partly written
            return i
        dc_preds[key] = dc_preds.get(key, 0) + int(row[0])
        row[0] = dc_preds[key]
    return None


def decode_slot_run(seg: bytes, slot0: int, n_slots: int,
                    coefs: np.ndarray, keys: list, luts,
                    bps: int) -> list[int]:
    """Resync decode of one received segment that carries the slots
    ``slot0 .. slot0 + n_slots - 1`` back to back (``n_slots`` > 1 when
    RSTn markers were lost; each slot is 1-padded to a byte boundary and
    resets the DC predictors). An error zeroes from the failing block to
    the run's end. Returns the run's damaged slots."""
    n = len(keys)
    bits = BitReader(seg)
    for t in range(n_slots):
        slot = slot0 + t
        if slot * bps >= n:
            break
        if t:
            bits.align_to_byte()  # slots are 1-padded to bytes
        bad = _decode_slot(bits, slot, coefs, keys, luts, bps,
                           bit_limit=8 * len(seg))
        if bad is not None:
            coefs[bad:min((slot0 + n_slots) * bps, n)] = 0
            return [s for s in range(slot, slot0 + n_slots) if s * bps < n]
    return []


def decode_scan_blocks(segments: list[bytes], marker_indices: list[int],
                       keys: list, luts, blocks_per_segment: int,
                       resync: bool = False):
    """Entropy decode of one scan's blocks from its destuffed restart
    segments → ((len(keys), 64) int32 zigzag coefficients with the DC
    prediction resolved, the concealed segments or None). ``keys[i]``
    names block i's component (its DC predictor) and ``luts[keys[i]]`` is
    its (DC, AC) table pair. Restart segments reset the DC predictors.

    Without ``resync`` a missing segment raises DecodeError and a
    malformed one SegmentDecodeError naming its failing block. With it,
    the received segments are realigned to their slots by their RSTn
    modulo-8 index (``plan_segment_alignment``) and each run is
    decoded (``decode_slot_run``), zeroed from its first failing block to
    the run's end; slots no segment claims stay zero. Both are listed,
    sorted."""
    n = len(keys)
    bps = blocks_per_segment
    n_segments = -(-n // bps)
    coefs = np.zeros((n, 64), dtype=np.int32)
    if not resync:
        for slot in range(n_segments):
            if slot >= len(segments):
                raise DecodeError(f"missing restart segment {slot}")
            bad = _decode_slot(BitReader(segments[slot]), slot, coefs, keys,
                               luts, bps)
            if bad is not None:
                raise SegmentDecodeError(bad)
        return coefs, None
    items, uncovered = plan_segment_alignment(marker_indices, len(segments),
                                              n_segments)
    damaged = set(uncovered)
    for slot0, n_slots, j in items:
        damaged.update(decode_slot_run(segments[j], slot0, n_slots, coefs,
                                       keys, luts, bps))
    return coefs, sorted(damaged)


def reconstruct_blocks(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """(N, 64) zigzag coefficients and (N, 64) zigzag quant values →
    (N, 8, 8) uint8 pixels: dequant, clamp to the 12-bit coefficient
    width (valid streams always fit; corrupt ones saturate here as in
    every datapath, K2 included), dezigzag, Chen IDCT, clip, level shift."""
    dequant_zz = coefs.astype(np.int64) * quant
    np.clip(dequant_zz, -2048, 2047, out=dequant_zz)
    dequant = np.zeros_like(dequant_zz)
    dequant[:, ZIGZAG_INVERSE] = dequant_zz
    idct = chen_inverse_8x8(dequant.reshape(-1, 8, 8))
    return (np.clip(idct, -128, 127) + 128).astype(np.uint8)


@dataclasses.dataclass
class Component(_header.Component):
    """A scan component's geometry and tables with its decode state: the
    padded plane and, for the sequenced per-block API, the position and
    scratch of the last block."""

    plane: Plane = None
    scan: markers.ScanComponent = None
    dc_pred: int = 0
    x: int = 0
    y: int = 0
    coefs: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(64, dtype=np.int32))
    dequant: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(64, dtype=np.int64))
    idct: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(64, dtype=np.int64))
    recon: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(64, dtype=np.int64))


class Decoder:
    """Full-frame decoder of one interleaved scan."""

    def __init__(self, header: Header, bits: BitReader):
        geom = DecoderGeometry(header)
        self.header = header
        self.components: list[Component] = [
            Component(**vars(g),
                      plane=Plane(g.decoded_width, g.decoded_height),
                      scan=sc)
            for g, sc in zip(geom.components, header.scan.scan_components)]
        self.entropy_segments, self.entropy_marker_indices = (
            extract_entropy_segments_with_markers(bits))
        self.restart_interval = geom.restart_interval
        self._geometry = geom
        self._schedule = None

    # -- geometry ---------------------------------------------------------
    @property
    def macroblocks_wide(self) -> int:
        c = self.components[0]
        return c.decoded_width // (8 * c.component.horizontal_sampling_factor)

    @property
    def macroblocks_high(self) -> int:
        c = self.components[0]
        return c.decoded_height // (8 * c.component.vertical_sampling_factor)

    def block_schedule(self) -> list[tuple[int, int, int]]:
        """Flat (component_index, x, y) schedule in scan (MCU) order.
        Memoized."""
        if self._schedule is None:
            self._schedule = self._geometry.block_schedule()
        return self._schedule

    # -- entropy ----------------------------------------------------------
    def decode_entropy(self, resync: bool = False) -> np.ndarray:
        """Sequential entropy decode of the whole scan: (num_blocks, 64)
        int32 zigzag coefficients with the DC prediction resolved, in
        ``block_schedule`` order (``decode_scan_blocks``). With
        ``resync=True`` damaged restart segments are concealed instead of
        raising, and ``self.damaged_segments`` lists them."""
        sched = self.block_schedule()
        mcu_size = sum(c.component.horizontal_sampling_factor
                       * c.component.vertical_sampling_factor
                       for c in self.components)
        coefs, damaged = decode_scan_blocks(
            self.entropy_segments, self.entropy_marker_indices,
            [s[0] for s in sched],
            [(c.dc_tab, c.ac_tab) for c in self.components],
            (self.restart_interval * mcu_size if self.restart_interval
             else len(sched)), resync)
        self.damaged_segments: list[int] = damaged or []
        return coefs

    # -- numerics (batched) ----------------------------------------------
    def reconstruct(self, coefs: np.ndarray) -> None:
        """Batched dequant → 12-bit clamp → dezigzag → Chen IDCT →
        clip/level shift → plane writes."""
        sched = self.block_schedule()
        comp_idx = np.array([s[0] for s in sched], dtype=np.int32)
        qtabs = np.stack([c.quant_table for c in self.components])
        recon = reconstruct_blocks(coefs, qtabs[comp_idx])
        for i, (ci, x, y) in enumerate(sched):
            self.components[ci].plane.data[y:y + 8, x:x + 8] = recon[i]

    def decode(self, resync: bool = False) -> None:
        self.reconstruct(self.decode_entropy(resync=resync))

    # -- sequenced per-block API (lockstep testing hook) ------------------
    def decode_blocks_seq(self):
        """Generator yielding the Component after each block's decode, with
        its coefs/dequant/idct/recon scratch filled."""
        sched = self.block_schedule()
        coefs_all = self.decode_entropy()
        for i, (ci, x, y) in enumerate(sched):
            comp = self.components[ci]
            comp.x, comp.y = x, y
            comp.coefs[:] = coefs_all[i]
            comp.dc_pred = int(coefs_all[i][0])
            dq = comp.coefs.astype(np.int64) * comp.quant_table
            np.clip(dq, -2048, 2047, out=dq)  # 12-bit coefficient width
            comp.dequant[ZIGZAG_INVERSE] = dq
            comp.idct[:] = chen_inverse_8x8(
                comp.dequant.reshape(8, 8)).reshape(64)
            comp.recon[:] = np.clip(comp.idct, -128, 127) + 128
            comp.plane.data[y:y + 8, x:x + 8] = (
                comp.recon.reshape(8, 8).astype(np.uint8))
            yield comp

    # -- output -----------------------------------------------------------
    def _crop(self, comp: Component) -> Plane:
        """The decoded plane cropped to the component's actual size."""
        if (comp.decoded_width != comp.actual_width
                or comp.decoded_height != comp.actual_height):
            out = Plane(comp.actual_width, comp.actual_height)
            comp.plane.blit_available(out)
            return out
        return comp.plane

    def get_decoded_planes(self) -> list[Plane]:
        return [c.plane for c in self.components]

    def get_planes(self) -> list[Plane]:
        return [self._crop(c) for c in self.components]

    def get_yuv_frame(self) -> Frame:
        planes = self.get_planes()
        return Frame.of_planes(planes[0], planes[1], planes[2])


class MultiScanDecoder:
    """Baseline decoder for multi-scan streams — non-interleaved (one
    component per SOS) or mixed — on the host in numpy.

    Per T.81: each frame component appears in exactly one scan; a scan
    with Ns>1 is interleaved in MCU order over the frame grid, a scan
    with Ns=1 rasters over ceil(xi/8) × ceil(yi/8) blocks of that
    component alone (A.2.2, with xi = ceil(X·Hi/Hmax)); DRI applies per
    scan with the restart interval counted in that scan's MCUs, and
    tables may be (re)defined between scans."""

    def __init__(self, header: Header, bits: BitReader):
        frame = header.frame
        if frame is None or header.scan is None:
            raise DecodeError("missing start of frame or start of scan")
        self.header = header
        self.bits = bits
        self.max_h = max(c.horizontal_sampling_factor
                         for c in frame.components)
        self.max_v = max(c.vertical_sampling_factor
                         for c in frame.components)
        self.rounded_w = _round_up(frame.width, self.max_h * 8)
        self.rounded_h = _round_up(frame.height, self.max_v * 8)
        self.planes: dict[int, Plane] = {}
        self.actual_dims: dict[int, tuple[int, int]] = {}
        for comp in frame.components:
            dw = self.rounded_w * comp.horizontal_sampling_factor // self.max_h
            dh = self.rounded_h * comp.vertical_sampling_factor // self.max_v
            # T.81 A.1.1: xi = ceil(X·Hi/Hmax)
            aw = -(-frame.width * comp.horizontal_sampling_factor
                   // self.max_h)
            ah = -(-frame.height * comp.vertical_sampling_factor
                   // self.max_v)
            self.planes[comp.identifier] = Plane(dw, dh)
            self.actual_dims[comp.identifier] = (aw, ah)
        self.decoded_components: list[int] = []

    def _scan_schedule(self, scan: markers.Sos
                       ) -> tuple[list[tuple[int, int, int]], int]:
        """Coded-order [(identifier, x, y)] plus blocks per MCU."""
        frame = self.header.frame
        if len(scan.scan_components) > 1:
            comps = [_find_component(sc, frame)
                     for sc in scan.scan_components]
            mcus_w = self.rounded_w // (8 * self.max_h)
            mcus_h = self.rounded_h // (8 * self.max_v)
            sched = []
            for my in range(mcus_h):
                for mx in range(mcus_w):
                    for comp in comps:
                        hs = comp.horizontal_sampling_factor
                        vs = comp.vertical_sampling_factor
                        for v in range(vs):
                            for h in range(hs):
                                sched.append((comp.identifier,
                                              (mx * hs + h) * 8,
                                              (my * vs + v) * 8))
            return sched, sum(c.horizontal_sampling_factor
                              * c.vertical_sampling_factor for c in comps)
        comp = _find_component(scan.scan_components[0], frame)
        aw, ah = self.actual_dims[comp.identifier]
        bw, bh = -(-aw // 8), -(-ah // 8)
        sched = [(comp.identifier, bx * 8, by * 8)
                 for by in range(bh) for bx in range(bw)]
        return sched, 1

    def _decode_scan(self, scan_idx: int = 0,
                     resync: bool = False) -> None:
        header = self.header
        scan = header.scan
        sched, mcu_blocks = self._scan_schedule(scan)
        tabs: dict[int, tuple] = {}
        for sc in scan.scan_components:
            comp = _find_component(sc, header.frame)
            tabs[sc.selector] = (
                _find_quant_table(header.quant_tables,
                                  comp.quantization_table_identifier),
                _find_huffman_lut(header.huffman_tables, 0,
                                  sc.dc_coef_selector, ac=False),
                _find_huffman_lut(header.huffman_tables, 1,
                                  sc.ac_coef_selector, ac=True),
            )
            self.decoded_components.append(sc.selector)
        segments, marks, end = extract_entropy_segments_span(self.bits)
        self.bits.bit_pos = end * 8  # resume the marker loop here
        ri = (header.restart_interval.restart_interval
              if header.restart_interval else 0)
        coefs, damaged = decode_scan_blocks(
            segments, marks, [ident for ident, _x, _y in sched],
            {k: t[1:] for k, t in tabs.items()},
            ri * mcu_blocks if ri else len(sched), resync)
        if resync:  # realigned and concealed per scan
            self.damaged_segments.extend((scan_idx, s) for s in damaged)
        recon = reconstruct_blocks(
            coefs, np.stack([tabs[ident][0] for ident, _x, _y in sched]))
        for i, (ident, x, y) in enumerate(sched):
            self.planes[ident].data[y:y + 8, x:x + 8] = recon[i]

    def decode(self, resync: bool = False) -> None:
        """With ``resync=True``, damaged restart segments are concealed
        per scan (``self.damaged_segments`` lists (scan, segment) pairs),
        inter-scan header damage stops cleanly, and components whose scan
        never arrived fill mid-gray (``self.missing_components``)."""
        self.damaged_segments: list[tuple[int, int]] = []
        scan_idx = 0
        while True:
            self._decode_scan(scan_idx, resync=resync)
            try:
                more = self.header.decode_next_scan(self.bits)
            except DecodeError:
                if not resync:
                    raise
                more = False
            if not more:
                break
            scan_idx += 1
        missing = [c.identifier for c in self.header.frame.components
                   if c.identifier not in self.decoded_components]
        if missing:
            if not resync:
                raise DecodeError(f"components never scanned: {missing}")
            for ident in missing:  # conceal never-scanned planes mid-gray
                self.planes[ident].data[:] = 128
            self.missing_components = missing

    def get_planes(self) -> list[Plane]:
        out = []
        for comp in self.header.frame.components:
            p = self.planes[comp.identifier]
            aw, ah = self.actual_dims[comp.identifier]
            if (p.width, p.height) != (aw, ah):
                cropped = Plane(aw, ah)
                p.blit_available(cropped)
                p = cropped
            out.append(p)
        return out

    def get_yuv_frame(self) -> Frame:
        planes = self.get_planes()
        if len(planes) != 3:
            raise DecodeError("YUV frame needs 3 components")
        return Frame.of_planes(planes[0], planes[1], planes[2])


def decode_a_frame(data: bytes) -> Frame:
    """One-shot full decode of a JPEG byte stream. Streams whose first
    scan covers only part of the frame's components (non-interleaved,
    multi-scan) go to ``MultiScanDecoder``."""
    bits = BitReader(data)
    header = Header.decode(bits)
    if (header.frame is not None and header.scan is not None
            and len(header.scan.scan_components)
            < len(header.frame.components)):
        mdec = MultiScanDecoder(header, bits)
        mdec.decode()
        return mdec.get_yuv_frame()
    dec = Decoder(header, bits)
    dec.decode()
    return dec.get_yuv_frame()


def decode_frame_bytes(path: str) -> Frame:
    with open(path, "rb") as f:
        return decode_a_frame(f.read())
