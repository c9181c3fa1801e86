"""Header parse, encode parameters and the block geometry of a session.

The sessions take their geometry from the golden model: the decoder's
component planner and MCU block schedule, and the encoder's scans, block
schedule and header writer. This module holds exactly those pieces of the
golden model (no pixel numerics, no Python entropy coder) so the port
derives the same arrays the reference sessions derive.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..common.bitstream import BitWriter
from . import marker_codes, markers, quant_tables
from .huffman import (AC_CHROMA, AC_LUMA, DC_CHROMA, DC_LUMA, Lut, Spec,
                      encoder_ac_table, encoder_dc_table)


class DecodeError(Exception):
    pass


@dataclasses.dataclass
class Header:
    """Parsed headers up to (and including) SOS."""

    frame: markers.Sof | None = None
    quant_tables: list = dataclasses.field(default_factory=list)
    huffman_tables: list = dataclasses.field(default_factory=list)
    restart_interval: markers.Dri | None = None
    scan: markers.Sos | None = None

    @classmethod
    def decode(cls, bits) -> "Header":
        """Marker scan loop: find 0xFF, dispatch, stop at SOS. Truncated
        input raises DecodeError."""
        try:
            return cls._decode(bits)
        except ValueError as e:
            raise DecodeError(f"truncated or invalid header: {e}") from e

    @classmethod
    def _decode(cls, bits) -> "Header":
        t = cls()
        while True:
            bits.align_to_byte()
            while bits.get(8) != 0xFF:
                pass
            code = bits.get(8)
            if code == marker_codes.SOF0:
                t.frame = markers.Sof.decode(bits)
            elif code == marker_codes.SOS:
                t.scan = markers.Sos.decode(bits)
                return t
            elif code == marker_codes.DQT:
                t.quant_tables.extend(markers.Dqt.decode_segment(bits))
            elif code == marker_codes.DHT:
                t.huffman_tables.extend(markers.Dht.decode_segment(bits))
            elif code == marker_codes.DRI:
                t.restart_interval = markers.Dri.decode(bits)
            elif code == marker_codes.SOI:
                pass
            elif marker_codes.is_app(code) or code == marker_codes.COM:
                length = bits.show(16)
                bits.advance(length * 8)
            else:
                raise DecodeError(f"unsupported marker code 0x{code:02x}")

    def decode_next_scan(self, bits) -> bool:
        """Resume the marker loop after a scan's entropy data (``bits``
        positioned at the terminating marker's 0xFF): table segments
        update this header, the next SOS replaces ``self.scan`` and
        returns True, EOI returns False. The hook for non-interleaved
        (multi-scan) streams."""
        try:
            while True:
                bits.align_to_byte()
                while bits.get(8) != 0xFF:
                    pass
                code = bits.get(8)
                if code == 0xFF:  # fill byte
                    bits.advance(-8)
                    continue
                if code == marker_codes.EOI:
                    return False
                if code == marker_codes.SOS:
                    self.scan = markers.Sos.decode(bits)
                    return True
                if code == marker_codes.DQT:
                    self.quant_tables.extend(markers.Dqt.decode_segment(bits))
                elif code == marker_codes.DHT:
                    self.huffman_tables.extend(
                        markers.Dht.decode_segment(bits))
                elif code == marker_codes.DRI:
                    self.restart_interval = markers.Dri.decode(bits)
                elif marker_codes.is_app(code) or code == marker_codes.COM:
                    length = bits.show(16)
                    bits.advance(length * 8)
                else:
                    raise DecodeError(
                        f"unsupported marker code 0x{code:02x} between scans")
        except ValueError as e:
            raise DecodeError(f"truncated stream between scans: {e}") from e


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def _schedule_array(mcus_wide: int, mcus_high: int,
                    factors: list[tuple[int, int]]) -> np.ndarray:
    """``block_schedule`` as an (n_blocks, 3) int64 array of (component,
    x, y) rows, in the same order: MCU rows, MCUs, components, then each
    component's (h, v) blocks row by row. ``factors`` are the components'
    (horizontal, vertical) sampling factors."""
    tmpl = np.array([(ci, h, v, hs, vs)
                     for ci, (hs, vs) in enumerate(factors)
                     for v in range(vs) for h in range(hs)], dtype=np.int64)
    my, mx = np.divmod(np.arange(mcus_wide * mcus_high, dtype=np.int64),
                       mcus_wide)
    out = np.empty((len(my), len(tmpl), 3), dtype=np.int64)
    out[:, :, 0] = tmpl[:, 0]
    out[:, :, 1] = (mx[:, None] * tmpl[:, 3] + tmpl[:, 1]) * 8
    out[:, :, 2] = (my[:, None] * tmpl[:, 4] + tmpl[:, 2]) * 8
    return out.reshape(-1, 3)


# ---------------------------------------------------------------------------
# decoder geometry
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Component:
    """Geometry and tables of one scan component."""

    decoded_width: int
    decoded_height: int
    actual_width: int
    actual_height: int
    component: markers.Component
    quant_table: np.ndarray  # 64 entries, zigzag order
    dc_tab: Lut
    ac_tab: Lut


def _find_component(scan: markers.ScanComponent,
                    frame: markers.Sof) -> markers.Component:
    for c in frame.components:
        if c.identifier == scan.selector:
            return c
    raise DecodeError("unable to find component identifier")


def _find_quant_table(quant_tables_, ident) -> np.ndarray:
    # last match: a later DQT legally redefines the identifier
    for q in reversed(quant_tables_):
        if q.table_identifier == ident:
            return np.asarray(q.elements, dtype=np.int64)
    raise DecodeError("unable to find quantisation table")


def _find_huffman_lut(huffman_tables, table_class, ident, ac: bool) -> Lut:
    for h in reversed(huffman_tables):
        if h.table_class == table_class and h.destination_identifier == ident:
            spec = Spec(lengths=tuple(h.lengths), values=tuple(h.values))
            codes = spec.ac_code_table() if ac else spec.dc_code_table()
            return Lut(codes, ac=ac)
    raise DecodeError("unable to find huffman table")


class DecoderGeometry:
    """The golden decoder's component planner and MCU block schedule."""

    def __init__(self, header: Header):
        frame, scan = header.frame, header.scan
        if frame is None or scan is None:
            raise DecodeError("missing start of frame or start of scan")
        max_h = max(c.horizontal_sampling_factor for c in frame.components)
        max_v = max(c.vertical_sampling_factor for c in frame.components)
        rounded_w = _round_up(frame.width, max_h * 8)
        rounded_h = _round_up(frame.height, max_v * 8)
        self.components: list[Component] = []
        for sc in scan.scan_components:
            comp = _find_component(sc, frame)
            self.components.append(Component(
                decoded_width=rounded_w * comp.horizontal_sampling_factor
                // max_h,
                decoded_height=rounded_h * comp.vertical_sampling_factor
                // max_v,
                actual_width=frame.width * comp.horizontal_sampling_factor
                // max_h,
                actual_height=frame.height * comp.vertical_sampling_factor
                // max_v,
                component=comp,
                quant_table=_find_quant_table(
                    header.quant_tables, comp.quantization_table_identifier),
                dc_tab=_find_huffman_lut(
                    header.huffman_tables, 0, sc.dc_coef_selector, ac=False),
                ac_tab=_find_huffman_lut(
                    header.huffman_tables, 1, sc.ac_coef_selector, ac=True),
            ))
        self.restart_interval = (
            header.restart_interval.restart_interval
            if header.restart_interval else 0)

    def block_schedule(self) -> list[tuple[int, int, int]]:
        """Flat (component_index, x, y) schedule in scan (MCU) order."""
        c0 = self.components[0]
        mbw = c0.decoded_width // (8 * c0.component.horizontal_sampling_factor)
        mbh = c0.decoded_height // (8 * c0.component.vertical_sampling_factor)
        sched = []
        for mcu_y in range(mbh):
            for mcu_x in range(mbw):
                for ci, comp in enumerate(self.components):
                    hs = comp.component.horizontal_sampling_factor
                    vs = comp.component.vertical_sampling_factor
                    for v in range(vs):
                        for h in range(hs):
                            sched.append((ci, (mcu_x * hs + h) * 8,
                                          (mcu_y * vs + v) * 8))
        return sched

    def block_schedule_array(self) -> np.ndarray:
        """``block_schedule`` as an (n_blocks, 3) int64 array, built
        without a Python loop over blocks (the sessions' form)."""
        c0 = self.components[0]
        return _schedule_array(
            c0.decoded_width // (8 * c0.component.horizontal_sampling_factor),
            c0.decoded_height // (8 * c0.component.vertical_sampling_factor),
            [(c.component.horizontal_sampling_factor,
              c.component.vertical_sampling_factor)
             for c in self.components])


# ---------------------------------------------------------------------------
# encoder parameters and geometry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Identified:
    identifier: int
    data: object


@dataclasses.dataclass(frozen=True)
class ScanComponentParams:
    quant_table: int
    dc_huffman_table: int
    ac_huffman_table: int
    component: int
    horizontal_sampling_factor: int
    vertical_sampling_factor: int


@dataclasses.dataclass(frozen=True)
class Parameters:
    width: int
    height: int
    quant_tables: tuple      # Identified[np.ndarray (64, zigzag order)]
    dc_huffman_tables: tuple  # Identified[Spec]
    ac_huffman_tables: tuple  # Identified[Spec]
    scan_components: tuple   # ScanComponentParams

    @classmethod
    def yuv(cls, width: int, height: int, quality: int,
            scales: tuple) -> "Parameters":
        qnt_luma = quant_tables.scale(quant_tables.LUMA, quality)
        qnt_chroma = quant_tables.scale(quant_tables.CHROMA, quality)
        return cls(
            width=width, height=height,
            quant_tables=(Identified(0, qnt_luma), Identified(1, qnt_chroma)),
            dc_huffman_tables=(Identified(0, DC_LUMA),
                               Identified(1, DC_CHROMA)),
            ac_huffman_tables=(Identified(0, AC_LUMA),
                               Identified(1, AC_CHROMA)),
            scan_components=(
                ScanComponentParams(0, 0, 0, 1, scales[0], scales[1]),
                ScanComponentParams(1, 1, 1, 2, scales[2], scales[3]),
                ScanComponentParams(1, 1, 1, 3, scales[4], scales[5]),
            ),
        )

    @classmethod
    def c420(cls, width: int, height: int, quality: int) -> "Parameters":
        return cls.yuv(width, height, quality, (2, 2, 1, 1, 1, 1))

    @classmethod
    def c422(cls, width: int, height: int, quality: int) -> "Parameters":
        return cls.yuv(width, height, quality, (2, 2, 1, 2, 1, 2))

    @classmethod
    def c440(cls, width: int, height: int, quality: int) -> "Parameters":
        return cls.yuv(width, height, quality, (2, 2, 2, 1, 2, 1))

    @classmethod
    def c444(cls, width: int, height: int, quality: int) -> "Parameters":
        return cls.yuv(width, height, quality, (1, 1, 1, 1, 1, 1))

    @classmethod
    def monochrome(cls, width: int, height: int,
                   quality: int) -> "Parameters":
        qnt_luma = quant_tables.scale(quant_tables.LUMA, quality)
        return cls(
            width=width, height=height,
            quant_tables=(Identified(0, qnt_luma),),
            dc_huffman_tables=(Identified(0, DC_LUMA),),
            ac_huffman_tables=(Identified(0, AC_LUMA),),
            scan_components=(ScanComponentParams(0, 0, 0, 1, 1, 1),),
        )


def _find_identified(kind: str, ident: int, items) -> object:
    for it in items:
        if it.identifier == ident:
            return it.data
    raise KeyError(f"Failed to find {kind} identifier {ident}")


@dataclasses.dataclass
class Scan:
    """Geometry of one encoded component: sampling factors, padded plane
    size and its zigzag-ordered quant table."""

    hscale: int
    vscale: int
    width: int
    height: int
    quant_table: np.ndarray


class EncoderGeometry:
    """The golden encoder's scans, block schedule and header writer."""

    def __init__(self, params: Parameters, restart_interval: int = 0):
        self.params = params
        self.restart_interval = restart_interval
        max_h = max(sc.horizontal_sampling_factor
                    for sc in params.scan_components)
        max_v = max(sc.vertical_sampling_factor
                    for sc in params.scan_components)
        # round the luma (MCU) grid first, then scale per component — the
        # same geometry the decoder derives
        rounded_w = _round_up(params.width, 8 * max_h)
        rounded_h = _round_up(params.height, 8 * max_v)
        self.scans: list[Scan] = [
            Scan(hscale=sc.horizontal_sampling_factor,
                 vscale=sc.vertical_sampling_factor,
                 width=rounded_w * sc.horizontal_sampling_factor // max_h,
                 height=rounded_h * sc.vertical_sampling_factor // max_v,
                 quant_table=_find_identified(
                     "quant", sc.quant_table, params.quant_tables))
            for sc in params.scan_components]

    def block_schedule(self) -> list[tuple[int, int, int]]:
        """Flat (scan_index, x, y) schedule in scan (MCU) order."""
        s0 = self.scans[0]
        sched = []
        for y_mb in range(s0.height // (8 * s0.vscale)):
            for x_mb in range(s0.width // (8 * s0.hscale)):
                for si, s in enumerate(self.scans):
                    for y_sub in range(s.vscale):
                        for x_sub in range(s.hscale):
                            sched.append((si,
                                          (x_mb * s.hscale + x_sub) * 8,
                                          (y_mb * s.vscale + y_sub) * 8))
        return sched

    def block_schedule_array(self) -> np.ndarray:
        """``block_schedule`` as an (n_blocks, 3) int64 array, built
        without a Python loop over blocks (the sessions' form)."""
        s0 = self.scans[0]
        return _schedule_array(s0.width // (8 * s0.hscale),
                               s0.height // (8 * s0.vscale),
                               [(s.hscale, s.vscale) for s in self.scans])

    def huffman_specs(self) -> tuple[list[Spec], list[Spec]]:
        """(DC specs, AC specs), one per scan component."""
        p = self.params
        return ([_find_identified("dc_huffman", sc.dc_huffman_table,
                                  p.dc_huffman_tables)
                 for sc in p.scan_components],
                [_find_identified("ac_huffman", sc.ac_huffman_table,
                                  p.ac_huffman_tables)
                 for sc in p.scan_components])

    def write_headers(self, w: BitWriter, sos: bool = True) -> None:
        """SOI, APP0, DQTs, [DRI], SOF0, DHTs and, with ``sos``, the SOS
        of one interleaved scan of every component."""
        p = self.params
        marker = functools.partial(write_marker, w)

        marker(marker_codes.SOI)
        app0 = b"video-coding-tpu"
        marker(marker_codes.APP0)
        w.put_bits(2 + len(app0), 16, stuffing=False)
        for b in app0:
            w.put_bits(b, 8, stuffing=False)
        for qt in p.quant_tables:
            marker(marker_codes.DQT)
            markers.Dqt(0, 8, qt.identifier, list(qt.data)).encode(w)
        if self.restart_interval:
            marker(marker_codes.DRI)
            markers.Dri(4, self.restart_interval).encode(w)
        marker(marker_codes.SOF0)
        markers.Sof(
            length=0, sample_precision=8, width=p.width, height=p.height,
            number_of_components=len(p.scan_components),
            components=[
                markers.Component(
                    identifier=sc.component,
                    horizontal_sampling_factor=sc.horizontal_sampling_factor,
                    vertical_sampling_factor=sc.vertical_sampling_factor,
                    quantization_table_identifier=sc.quant_table)
                for sc in p.scan_components],
        ).encode(w)
        for t in p.dc_huffman_tables:
            marker(marker_codes.DHT)
            markers.Dht(0, 0, t.identifier, list(t.data.lengths),
                        list(t.data.values)).encode(w)
        for t in p.ac_huffman_tables:
            marker(marker_codes.DHT)
            markers.Dht(0, 1, t.identifier, list(t.data.lengths),
                        list(t.data.values)).encode(w)
        if sos:
            write_sos(w, p.scan_components)


def write_marker(w: BitWriter, code: int) -> None:
    w.put_bits(0xFF, 8, stuffing=False)
    w.put_bits(code, 8, stuffing=False)


def write_sos(w: BitWriter, scan_components) -> None:
    """SOS of one scan over ``scan_components`` (ScanComponentParams)."""
    write_marker(w, marker_codes.SOS)
    markers.Sos(
        length=0,
        number_of_image_components=len(scan_components),
        scan_components=[
            markers.ScanComponent(
                selector=sc.component,
                dc_coef_selector=sc.dc_huffman_table,
                ac_coef_selector=sc.ac_huffman_table)
            for sc in scan_components],
        start_of_predictor_selection=0,
        end_of_predictor_selection=63,
        successive_approximation_bit_high=0,
        successive_approximation_bit_low=0,
    ).encode(w)


__all__ = ["DecodeError", "Header", "DecoderGeometry", "EncoderGeometry",
           "Parameters", "encoder_dc_table", "encoder_ac_table"]
