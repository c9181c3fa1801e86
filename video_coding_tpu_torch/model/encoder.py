"""Baseline JPEG software encoder (the golden model), in numpy.

Level shift → Chen fDCT (x4 scaled) → quantize with scale compensation and
round-half-away → forward zigzag → DC-prediction differences + RLE →
size/magnitude + Huffman with ZRL splitting and EOB → stuffed bitstream;
the header writer (SOI/APP0/DQT/[DRI]/SOF0/DHT/SOS); 4:2:0, 4:2:2, 4:4:0,
4:4:4 and monochrome presets; an optional decode-back reconstruction error.

``restart_interval`` emits DRI and RSTn markers every N MCUs, resetting
the DC predictors, so every stream it writes is decodable a segment at a
time. ``interleaved=False`` writes one single-component scan per
component. The block numerics run batched over all blocks; the entropy
coding is sequential.

``Parameters``, ``Scan``, ``Identified`` and ``ScanComponentParams`` are
``model/header.py``'s, re-exported: the sessions and this encoder share
one copy. ``EncoderScan`` adds the encoder's per-scan state (padded plane,
Huffman code tables, DC predictor) to a ``Scan``'s geometry.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..common.bitstream import BitWriter
from ..common.frame import Frame
from ..common.plane import Plane
from . import marker_codes
from .dct import chen_forward_8x8, chen_inverse_8x8
from .header import (EncoderGeometry, Identified, Parameters, Scan,
                     ScanComponentParams, _find_identified, write_marker,
                     write_sos)
from .huffman import encoder_ac_table, encoder_dc_table
from .zigzag import INVERSE as ZIGZAG_INVERSE

__all__ = ["Encoder", "EncoderScan", "Identified", "Parameters", "Scan",
           "ScanComponentParams", "encode_420", "encode_422", "encode_440",
           "encode_444", "encode_monochrome", "magnitude_bits",
           "quant_and_scale", "size_category"]


def size_category(value: int) -> int:
    """Bit-size category of a coefficient."""
    return 0 if value == 0 else int(abs(value)).bit_length()


def magnitude_bits(size: int, value: int) -> int:
    """Magnitude code for a value of the given size."""
    mask = (1 << size) - 1
    return value & mask if value >= 0 else (value - 1) & mask


def quant_and_scale(fdct: np.ndarray, qnt: np.ndarray) -> np.ndarray:
    """Quantize x4-scaled fDCT coefficients, rounding half away from zero
    with truncating division."""
    fdct = fdct.astype(np.int64)
    qnt = qnt.astype(np.int64)
    pos = (fdct + qnt * 2) // (qnt * 4)
    neg = -((-fdct + qnt * 2) // (qnt * 4))
    return np.where(fdct < 0, neg, pos)


@dataclasses.dataclass
class EncoderScan(Scan):
    """A scan's geometry and the golden encoder's state for it."""

    plane: Plane | None = None
    dc_huffman_table: list | None = None  # Code, indexed by size
    ac_huffman_table: list | None = None  # Code, indexed [run][size]
    dc_pred: int = 0


class Encoder:
    """Streaming JPEG encoder over padded planes."""

    def __init__(self, params: Parameters, writer: BitWriter | None = None,
                 *, compute_reconstruction_error: bool = False,
                 restart_interval: int = 0, interleaved: bool = True):
        """``interleaved=False`` emits one single-component SOS per
        component (T.81 non-interleaved scans, each rastering its own
        ceil(xi/8) × ceil(yi/8) block grid)."""
        self.params = params
        self.writer = writer if writer is not None else BitWriter()
        self.compute_reconstruction_error = compute_reconstruction_error
        self.restart_interval = restart_interval
        self.interleaved = interleaved
        self.geometry = EncoderGeometry(params, restart_interval)
        dc_tables = [Identified(t.identifier, encoder_dc_table(t.data))
                     for t in params.dc_huffman_tables]
        ac_tables = [Identified(t.identifier, encoder_ac_table(t.data))
                     for t in params.ac_huffman_tables]
        # the luma (MCU) grid is rounded first, then scaled per component:
        # the geometry the decoder derives
        self.scans = [
            EncoderScan(**vars(g), plane=Plane(g.width, g.height),
                        dc_huffman_table=_find_identified(
                            "dc_huffman", sc.dc_huffman_table, dc_tables),
                        ac_huffman_table=_find_identified(
                            "ac_huffman", sc.ac_huffman_table, ac_tables))
            for g, sc in zip(self.geometry.scans, params.scan_components)]
        # filled by encode() when the reconstruction error is asked for
        self.last_error_sum = 0
        self._schedule = None

    # -- geometry ---------------------------------------------------------
    @property
    def macroblocks_wide(self) -> int:
        s = self.scans[0]
        return s.plane.width // (8 * s.hscale)

    @property
    def macroblocks_high(self) -> int:
        s = self.scans[0]
        return s.plane.height // (8 * s.vscale)

    def block_schedule(self) -> list[tuple[int, int, int]]:
        """Flat (scan_index, x, y) schedule in scan order. Memoized."""
        if self._schedule is None:
            self._schedule = self.geometry.block_schedule()
        return self._schedule

    # -- input ------------------------------------------------------------
    def load_frame(self, frame: Frame) -> None:
        frame.y.blit_available(self.scans[0].plane)
        frame.u.blit_available(self.scans[1].plane)
        frame.v.blit_available(self.scans[2].plane)

    def load_plane(self, plane: Plane) -> None:
        plane.blit_available(self.scans[0].plane)

    # -- headers -----------------------------------------------------------
    def _write_marker(self, code: int) -> None:
        write_marker(self.writer, code)

    def write_headers(self) -> None:
        """SOI, APP0, DQTs, [DRI], SOF0, DHTs and, interleaved, the SOS."""
        self.geometry.write_headers(self.writer, sos=self.interleaved)

    # -- numerics (batched) -----------------------------------------------
    def quantized_blocks(self) -> np.ndarray:
        """Level shift → batched Chen fDCT → quant → zigzag for every block
        in schedule order: (num_blocks, 64) int32 zigzag coefficients, the
        contract of the encode datapath K3."""
        sched = self.block_schedule()
        pixels = np.empty((len(sched), 8, 8), dtype=np.int64)
        for i, (si, x, y) in enumerate(sched):
            pixels[i] = self.scans[si].plane.data[y:y + 8, x:x + 8]
        fdct = chen_forward_8x8(pixels - 128).reshape(len(sched), 64)
        qtabs = np.stack([s.quant_table for s in self.scans])
        scan_idx = np.array([s[0] for s in sched], dtype=np.int32)
        q = qtabs[scan_idx]  # zigzag-ordered quant values per block
        # zigzag position p quantizes natural index ZIGZAG_INVERSE[p]
        qzz = quant_and_scale(fdct[:, ZIGZAG_INVERSE], q)
        return qzz.astype(np.int32)

    # -- entropy -----------------------------------------------------------
    def _write_block(self, scan: EncoderScan, qcoefs: np.ndarray) -> None:
        """RLE + Huffman + magnitude write of one quantized block."""
        put = self.writer.put_bits

        def write_code(code, size, value):
            put(code.bits, code.length, stuffing=True)
            put(magnitude_bits(size, value), size, stuffing=True)

        dc = int(qcoefs[0])
        diff = dc - scan.dc_pred
        scan.dc_pred = dc
        size = size_category(diff)
        write_code(scan.dc_huffman_table[size], size, diff)
        ac_table = scan.ac_huffman_table
        run = 0
        nz = np.nonzero(qcoefs[1:])[0]
        if len(nz) == 0:
            write_code(ac_table[0][0], 0, 0)  # EOB
            return
        last_nz = int(nz[-1]) + 1
        for pos in range(1, last_nz + 1):
            value = int(qcoefs[pos])
            if value == 0:
                run += 1
                continue
            while run >= 16:
                write_code(ac_table[15][0], 0, 0)  # ZRL
                run -= 16
            size = size_category(value)
            write_code(ac_table[run][size], size, value)
            run = 0
        if last_nz < 63:
            write_code(ac_table[0][0], 0, 0)  # EOB

    # -- non-interleaved (one scan per component) ---------------------------
    def _noninterleaved_schedule(self, si: int) -> list[tuple[int, int]]:
        """Raster block (x, y) positions of component ``si``'s own scan:
        ceil(xi/8) × ceil(yi/8) blocks over its ceil-scaled dims (T.81
        A.2.2)."""
        p = self.params
        max_h = max(sc.horizontal_sampling_factor
                    for sc in p.scan_components)
        max_v = max(sc.vertical_sampling_factor
                    for sc in p.scan_components)
        sc = p.scan_components[si]
        aw = -(-p.width * sc.horizontal_sampling_factor // max_h)
        ah = -(-p.height * sc.vertical_sampling_factor // max_v)
        bw, bh = -(-aw // 8), -(-ah // 8)
        return [(bx * 8, by * 8) for by in range(bh) for bx in range(bw)]

    def _encode_noninterleaved(self) -> None:
        for si, (scan, sc) in enumerate(zip(self.scans,
                                            self.params.scan_components)):
            write_sos(self.writer, [sc])
            sched = self._noninterleaved_schedule(si)
            pixels = np.empty((len(sched), 8, 8), dtype=np.int64)
            for i, (x, y) in enumerate(sched):
                pixels[i] = scan.plane.data[y:y + 8, x:x + 8]
            fdct = chen_forward_8x8(pixels - 128).reshape(len(sched), 64)
            qall = quant_and_scale(fdct[:, ZIGZAG_INVERSE],
                                   np.broadcast_to(scan.quant_table,
                                                   (len(sched), 64)))
            scan.dc_pred = 0
            rst_n = 0
            for i in range(len(sched)):
                if (self.restart_interval and i > 0
                        and i % self.restart_interval == 0):
                    self.writer.flush_with_1s(stuffing=True)
                    self._write_marker(marker_codes.RST0 + rst_n)
                    rst_n = (rst_n + 1) & 7
                    scan.dc_pred = 0
                self._write_block(scan, qall[i])
            # byte-align before the next SOS / EOI marker
            self.writer.flush_with_1s(stuffing=True)

    def encode(self) -> None:
        """Entropy-encode the whole image (headers written first)."""
        if not self.interleaved:
            self._encode_noninterleaved()
            return
        sched = self.block_schedule()
        qall = self.quantized_blocks()
        mcu_size = sum(s.hscale * s.vscale for s in self.scans)
        rst_blocks = (self.restart_interval * mcu_size
                      if self.restart_interval else 0)
        rst_n = 0
        for s in self.scans:
            s.dc_pred = 0
        for i, (si, _x, _y) in enumerate(sched):
            if rst_blocks and i > 0 and i % rst_blocks == 0:
                self.writer.flush_with_1s(stuffing=True)
                self._write_marker(marker_codes.RST0 + rst_n)
                rst_n = (rst_n + 1) & 7
                for s in self.scans:
                    s.dc_pred = 0
            self._write_block(self.scans[si], qall[i])
        if self.compute_reconstruction_error:
            self._compute_reconstruction_error(sched, qall)

    def _compute_reconstruction_error(self, sched, qall) -> None:
        """Decode-back path for debugging: the sum of absolute differences
        between the source and its reconstruction."""
        qtabs = np.stack([s.quant_table for s in self.scans])
        scan_idx = np.array([s[0] for s in sched], dtype=np.int32)
        dequant_zz = qall.astype(np.int64) * qtabs[scan_idx]
        dequant = np.zeros_like(dequant_zz)
        dequant[:, ZIGZAG_INVERSE] = dequant_zz
        idct = chen_inverse_8x8(dequant.reshape(-1, 8, 8))
        recon = np.clip(idct + 128, 0, 255)
        err = 0
        for i, (si, x, y) in enumerate(sched):
            src = self.scans[si].plane.data[y:y + 8, x:x + 8].astype(np.int64)
            err += int(np.abs(recon[i] - src).sum())
        self.last_error_sum = err

    def complete_and_write_eoi(self) -> None:
        """Flush with 1-bits and write EOI."""
        self.writer.flush_with_1s(stuffing=True)
        self._write_marker(marker_codes.EOI)


def _encode_with_params(frame: Frame, params: Parameters,
                        restart_interval: int = 0,
                        interleaved: bool = True) -> bytes:
    enc = Encoder(params, restart_interval=restart_interval,
                  interleaved=interleaved)
    enc.load_frame(frame)
    enc.write_headers()
    enc.encode()
    enc.complete_and_write_eoi()
    return enc.writer.get_buffer()


def encode_420(frame: Frame, quality: int, restart_interval: int = 0,
               interleaved: bool = True) -> bytes:
    return _encode_with_params(
        frame, Parameters.c420(frame.width, frame.height, quality),
        restart_interval, interleaved)


def encode_422(frame: Frame, quality: int, restart_interval: int = 0,
               interleaved: bool = True) -> bytes:
    return _encode_with_params(
        frame, Parameters.c422(frame.width, frame.height, quality),
        restart_interval, interleaved)


def encode_440(frame: Frame, quality: int, restart_interval: int = 0,
               interleaved: bool = True) -> bytes:
    return _encode_with_params(
        frame, Parameters.c440(frame.width, frame.height, quality),
        restart_interval, interleaved)


def encode_444(frame: Frame, quality: int, restart_interval: int = 0,
               interleaved: bool = True) -> bytes:
    return _encode_with_params(
        frame, Parameters.c444(frame.width, frame.height, quality),
        restart_interval, interleaved)


def encode_monochrome(plane: Plane, quality: int,
                      restart_interval: int = 0) -> bytes:
    params = Parameters.monochrome(plane.width, plane.height, quality)
    enc = Encoder(params, restart_interval=restart_interval)
    enc.load_plane(plane)
    enc.write_headers()
    enc.encode()
    enc.complete_and_write_eoi()
    return enc.writer.get_buffer()
