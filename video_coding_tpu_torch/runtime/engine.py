"""JPEG sessions on one torch device: host sequencing + device kernels.

  host:   header parse → geometry plan → table packing → destuff and
          length-sorted lane prep
  device: K1 Huffman decode (one restart segment per lane) → K2 decode
          datapath → plane assembly → pad clean → block gather → K3 encode
          datapath → K4 entropy encode (one segment per lane) → wire
          assembly; the host joins header + body + EOI.

Sessions run on ``cuda`` unless the caller passes a device (the tests pass
``device="cpu"``, which runs every kernel's plain PyTorch version). With
no device and no GPU they raise; nothing falls back silently.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..common.bitstream import BitWriter
from ..entropy.assemble import assemble_frames
from ..entropy.decode_tables import range_tables
from ..entropy.huffman_decode import decode_flat
from ..entropy.huffman_encode import (device_encoder_tables, encode_segments,
                                      m_out_for)
from ..entropy.scan import _chunked, _destuff_parts, _pipelined_map
from ..entropy.tables import pack_decoder_tables, pack_encoder_tables
from ..model import marker_codes
from ..model.header import (DecodeError, DecoderGeometry, EncoderGeometry,
                            Header, Parameters)
from ..ops import datapath
from ..state import DecoderState, EncoderState

_EOI = bytes((0xFF, marker_codes.EOI))


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the GPU, and raises when
    there is none (pass ``device="cpu"`` to run the plain versions)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' explicitly to "
                "run the plain PyTorch versions of the kernels")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{dev} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _plane_from_blocks(blocks: torch.Tensor, nby: int,
                       nbx: int) -> torch.Tensor:
    """(F, nby·nbx, 8, 8) raster-order blocks → (F, nby·8, nbx·8)."""
    f = blocks.shape[0]
    return (blocks.view(f, nby, nbx, 8, 8).permute(0, 1, 3, 2, 4)
            .reshape(f, nby * 8, nbx * 8))


def _blocks_from_plane(plane: torch.Tensor, nby: int,
                       nbx: int) -> torch.Tensor:
    """(F, nby·8, nbx·8) → (F, nby·nbx, 8, 8) raster-order blocks."""
    f = plane.shape[0]
    return (plane.reshape(f, nby, 8, nbx, 8).permute(0, 1, 3, 2, 4)
            .reshape(f, nby * nbx, 8, 8))


class JpegDecoderSession:
    """Decoder for a fixed header geometry (dims, sampling, tables): feed
    it the entropy data of any frame with the same headers."""

    def __init__(self, header: Header, device=None):
        self.device = resolve_device(device)
        self.header = header
        geom = DecoderGeometry(header)
        self.components = geom.components
        sched = geom.block_schedule()
        self.n_blocks = len(sched)
        self.comp_idx = np.array([s[0] for s in sched], dtype=np.int32)
        qtabs = np.stack([c.quant_table for c in self.components])
        self.quant = qtabs[self.comp_idx].astype(np.int32)
        self.mcu_size = sum(c.component.horizontal_sampling_factor
                            * c.component.vertical_sampling_factor
                            for c in self.components)
        self.restart_interval = geom.restart_interval
        self.blocks_per_segment = (
            self.restart_interval * self.mcu_size if self.restart_interval
            else self.n_blocks)
        self.tables = pack_decoder_tables(
            [c.dc_tab for c in self.components],
            [c.ac_tab for c in self.components])
        # per-component plane-assembly rows: schedule rows of the
        # component's blocks in raster order
        self.plane_geom = []
        for ci, comp in enumerate(self.components):
            rows = [i for i, s in enumerate(sched) if s[0] == ci]
            order = sorted(rows, key=lambda i: (sched[i][2], sched[i][1]))
            self.plane_geom.append((np.array(order, dtype=np.int32),
                                    comp.decoded_height // 8,
                                    comp.decoded_width // 8))
        self.load_state(DecoderState.from_numpy(self.numpy_state(),
                                                self.device))

    def numpy_state(self) -> dict:
        """The arrays this session computes with (see state.py)."""
        return {"quant": self.quant, "comp_idx": self.comp_idx,
                "plane_geom": self.plane_geom,
                "range_tables": range_tables(self.tables)}

    def load_state(self, state: DecoderState) -> None:
        """Compute with ``state`` from here on (e.g. state built from
        another implementation's arrays by state.from_numpy)."""
        if int(state.quant.min()) < 1 or state.quant.shape != (self.n_blocks,
                                                               64):
            raise ValueError("decoder quant must be (n_blocks, 64), >= 1")
        B = self.blocks_per_segment
        self.state = state
        self._comp_sched = state.comp_idx[:B].contiguous()
        self._quant_seg = state.quant[:B].contiguous()
        # the inverse lane permutation folds into the plane gather: block
        # idx of a frame is offset idx % B of stream segment idx // B
        self._plane_seg = [(idx // B, idx % B, nby, nbx)
                           for idx, nby, nbx in state.plane_idx]

    @property
    def n_segments(self) -> int:
        """Restart segments per frame (= K1 lanes per frame)."""
        return -(-self.n_blocks // self.blocks_per_segment)

    def _expected_seg_blocks(self, S: int) -> np.ndarray:
        B = self.blocks_per_segment
        n_seg_expected = (self.n_blocks + B - 1) // B
        if S != n_seg_expected:
            raise DecodeError(
                f"expected {n_seg_expected} restart segments, got {S}")
        seg_blocks = np.full(S, B, dtype=np.int32)
        if self.n_blocks % B:
            seg_blocks[-1] = self.n_blocks % B
        return seg_blocks

    @staticmethod
    def _flat_lane_inputs(lens64: np.ndarray, seg_blocks: np.ndarray):
        """Host prep for the flat-buffer decode: per-segment offsets into
        the flat buffer and a length-sorted lane order (long segments
        share warps, so short ones do not idle behind them). Returns
        (starts, lens, seg_blocks, inv_perm) with the per-lane arrays in
        sorted order; inv_perm[g] is segment g's lane."""
        S = len(lens64)
        lens = lens64.astype(np.int32)
        starts = np.zeros(S, np.int32)
        np.cumsum(lens[:-1], out=starts[1:])
        order = np.argsort(-lens64, kind="stable")
        inv_perm = np.empty(S, np.int32)
        inv_perm[order] = np.arange(S, dtype=np.int32)
        return starts[order], lens[order], seg_blocks[order], inv_perm

    def _decode_coefs_pool(self, entropy_list: list[bytes]):
        """Entropy bytes of F frames → ((S, B, 64) coefficients in lane
        order, inv_perm (S,) int64) on the device, S = F·n_segments."""
        F = len(entropy_list)
        n_seg = self.n_segments
        parts, lens_parts = _destuff_parts(entropy_list, n_seg)
        flat = np.concatenate(parts) if len(parts) > 1 else parts[0]
        lens64 = np.concatenate(lens_parts)
        seg_blocks = np.tile(self._expected_seg_blocks(n_seg), F)
        starts, lens, segb, inv_perm = self._flat_lane_inputs(lens64,
                                                              seg_blocks)
        dev = self.device
        st = self.state
        coefs = decode_flat(
            _upload(flat, dev), _upload(starts, dev), _upload(lens, dev),
            _upload(segb, dev), self._comp_sched, st.lo, st.hi, st.offset,
            st.values, blocks_per_segment=self.blocks_per_segment,
            n_components=len(self.components))
        return coefs, _upload(inv_perm, dev).to(torch.int64)

    def _decode_tail_pool(self, coefs_pool: torch.Tensor,
                          inv_perm: torch.Tensor, f: int):
        """Lane-order (S·B, 64) coefficient pool → tuple of (f, H, W)
        uint8 plane stacks. K2 runs on the pool as it is (every segment
        shares one block schedule, so block j of any lane uses quant row
        j % B); the inverse lane permutation folds into the plane
        gather, so stream-ordered coefficients are never materialized."""
        B = self.blocks_per_segment
        pixels = datapath.decode_datapath(coefs_pool, self._quant_seg)
        ip = inv_perm.view(f, -1)
        out = []
        for seg_i, off_i, nby, nbx in self._plane_seg:
            cidx = ip[:, seg_i] * B + off_i
            out.append(_plane_from_blocks(pixels[cidx], nby, nbx))
        return tuple(out)

    def decode_batch_stacked(self, entropy_list: list[bytes]):
        """Entropy bytes of F frames → per-component (F, H, W) uint8 plane
        stacks (decoded, i.e. MCU-padded, sizes) on the device."""
        coefs, inv_perm = self._decode_coefs_pool(entropy_list)
        return self._decode_tail_pool(coefs.view(-1, 64), inv_perm,
                                      len(entropy_list))


class JpegEncoderSession:
    """Encoder for fixed parameters (dims, quality, subsampling, restart
    interval)."""

    def __init__(self, params: Parameters, restart_interval: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.params = params
        self.restart_interval = restart_interval
        self._geom = EncoderGeometry(params, restart_interval)
        self.scans = self._geom.scans
        sched = self._geom.block_schedule()
        self.n_blocks = len(sched)
        self.comp_idx = np.array([s[0] for s in sched], dtype=np.int32)
        qtabs = np.stack([s.quant_table for s in self.scans])
        self.quant = qtabs[self.comp_idx].astype(np.int32)
        mcu_size = sum(s.hscale * s.vscale for s in self.scans)
        self.blocks_per_segment = (
            restart_interval * mcu_size if restart_interval
            else self.n_blocks)
        self.tables = pack_encoder_tables(*self._geom.huffman_specs())
        # per-scan block extraction: schedule row i takes block (x, y) of
        # scan si → index into that scan's raster blocks
        self.gather = []
        for si, s in enumerate(self.scans):
            nbx = s.width // 8
            rows = [(i, sched[i]) for i in range(len(sched))
                    if sched[i][0] == si]
            take = np.array([(y // 8) * nbx + (x // 8)
                             for _i, (_si, x, y) in rows], dtype=np.int32)
            dest = np.array([i for i, _ in rows], dtype=np.int32)
            self.gather.append((take, dest, s.height // 8, nbx))
        # composed stream-order permutation over the scan-major
        # concatenation of every scan's raster blocks
        perm = np.zeros(self.n_blocks, np.int32)
        off = 0
        for take, dest, nby, nbx in self.gather:
            perm[dest] = off + take
            off += nby * nbx
        self.perm = perm
        # per-segment byte budget, locked after the first encode that fits,
        # and the body-fetch cap it implies
        self._seg_budget = None
        self._body_cap = None
        self.load_state(EncoderState.from_numpy(self.numpy_state(),
                                                self.device))

    def numpy_state(self) -> dict:
        """The arrays this session computes with (see state.py)."""
        return {"quant": self.quant, "comp_idx": self.comp_idx,
                "perm": self.perm, "gather": self.gather,
                "tables": device_encoder_tables(self.tables)}

    def load_state(self, state: EncoderState) -> None:
        """Compute with ``state`` from here on."""
        if int(state.quant.min()) < 1 or state.quant.shape != (self.n_blocks,
                                                               64):
            raise ValueError("encoder quant must be (n_blocks, 64), >= 1")
        self.state = state
        self._comp_sched = state.comp_idx[:self.blocks_per_segment] \
            .contiguous()
        self._valid = {}

    # -- planes → quantized coefficients ------------------------------------
    def load_planes(self, planes) -> list[np.ndarray]:
        """Blit (y, u, v) uint8 arrays into zero-padded scan planes."""
        out = []
        for s, src in zip(self.scans, planes):
            src = np.asarray(src, dtype=np.uint8)
            padded = np.zeros((s.height, s.width), dtype=np.uint8)
            h = min(src.shape[0], s.height)
            w = min(src.shape[1], s.width)
            padded[:h, :w] = src[:h, :w]
            out.append(padded)
        return out

    def _gather_blocks(self, planes_batched) -> torch.Tensor:
        """Stacked (f, H, W) uint8 planes → (f·n_blocks, 8, 8) uint8
        blocks in stream order (the relayout and gather stay uint8)."""
        blocks = torch.cat([_blocks_from_plane(p, nby, nbx)
                            for p, (nby, nbx) in zip(planes_batched,
                                                     self.state.plane_dims)],
                           dim=1)
        return blocks[:, self.state.perm].reshape(-1, 8, 8)

    def _encode_qc_batch(self, planes_batched) -> torch.Tensor:
        """Stacked (f, H, W) uint8 planes → (f·n_blocks, 64) int32
        quantized coefficients in stream order (K3 widens)."""
        return datapath.encode_datapath(self._gather_blocks(planes_batched),
                                        self.state.quant)

    # -- entropy encode + wire assembly -------------------------------------
    def _enc_geometry(self, max_seg_bytes: int):
        """(B, n_blocks, n_seg, sp, n_padded, m_out, cap) for a raw
        per-segment byte budget; cap is the worst-case wire size."""
        B = self.blocks_per_segment
        n_seg = (self.n_blocks + B - 1) // B
        sp = n_seg
        m_out = m_out_for(max_seg_bytes)
        return B, self.n_blocks, n_seg, sp, sp * B, m_out, sp * m_out + 2 * sp

    def _valid_batch(self, f: int) -> torch.Tensor:
        """(f·sp, B) uint8 mask of the real blocks of f frames."""
        if f not in self._valid:
            B, n_blocks, _n, sp, n_padded, _m, _c = self._enc_geometry(0)
            v = (np.arange(n_padded) < n_blocks).astype(np.uint8)
            self._valid[f] = _upload(np.tile(v, f).reshape(f * sp, B),
                                     self.device)
        return self._valid[f]

    def _pack_graph(self, qc_seg: torch.Tensor, f: int, max_seg_bytes: int):
        """(f·sp, B·64) int32 coefficients → (bufs (f, cap) uint8, totals
        (f,), max segment length, overflow) — K4 then the wire assembly
        (the single-device form of the reference's _pack_graph)."""
        _B, _nb, n_seg, sp, _np, m_out, cap = self._enc_geometry(
            max_seg_bytes)
        out, lens, overflow = encode_segments(
            qc_seg, self._valid_batch(f), self._comp_sched, self.state.dctab,
            self.state.actab, m_out=m_out)
        bufs, totals = assemble_frames(out, lens, frames=f, n_seg=n_seg,
                                       cap=cap)
        max_len = lens.view(f, sp)[:, :n_seg].max()
        return bufs, totals, max_len, overflow

    def _pad_segments(self, qc: torch.Tensor, f: int) -> torch.Tensor:
        """(f·n_blocks, 64) → (f·sp, B·64), zero blocks past n_blocks."""
        B, n_blocks, _n, sp, n_padded, _m, _c = self._enc_geometry(0)
        qc = qc.view(f, n_blocks, 64)
        if n_padded != n_blocks:
            qc = torch.cat([qc, qc.new_zeros((f, n_padded - n_blocks, 64))],
                           dim=1)
        return qc.reshape(f * sp, B * 64)

    def _enc_budget_ladder(self) -> tuple:
        """Raw per-segment byte budgets to try, smallest first; after the
        first success the observed size (power-of-two bucket, locked)
        leads."""
        B = self.blocks_per_segment
        ladder = [B * 24 + 64, B * 128 + 64, B * 512 + 64]
        if self._seg_budget is not None:
            ladder = [self._seg_budget] + [b for b in ladder
                                           if b > self._seg_budget]
        return tuple(ladder)

    def _record_seg_bytes(self, max_len: int) -> None:
        if self._seg_budget is not None:
            return
        b = max(64, int(max_len) * 5 // 4 + 16)
        self._seg_budget = 1 << (b - 1).bit_length()

    @staticmethod
    def _body_bucket(total: int) -> int:
        """Body-fetch cap with 25% headroom: power-of-two below 64 KB,
        64 KB granularity above."""
        b = total * 5 // 4
        if b < 65536:
            return max(4096, 1 << (b - 1).bit_length())
        return -(-b // 65536) * 65536

    def _run_enc_ladder_batch(self, launch, F: int) -> list[bytes]:
        """``launch(msb)`` → (bufs (F, CAP), totals (F,), max_len,
        overflow) on the device. Walks the budget ladder until a launch
        does not overflow; with a known body cap the capped bodies come
        back in the same fetch as the scalars."""
        cap = self._body_cap
        bodies = None
        for msb in self._enc_budget_ladder():
            bufs, totals, max_len, overflow = launch(msb)
            meta = torch.cat([totals.to(torch.int64),
                              max_len.to(torch.int64).view(1),
                              overflow.to(torch.int64).view(1)]).cpu()
            totals_np = meta[:F].numpy()
            max_i, ovf = int(meta[F]), bool(meta[F + 1])
            if ovf:
                continue
            top = int(totals_np.max())
            if cap is not None and top <= cap:
                host = bufs[:, :cap].cpu().numpy()
            else:
                host = bufs[:, :top].cpu().numpy()
                self._body_cap = self._body_bucket(top)
            bodies = [host[f, :totals_np[f]].tobytes() for f in range(F)]
            break
        else:
            raise ValueError("device entropy encode overflow")
        self._record_seg_bytes(max_i)
        return bodies

    @functools.cached_property
    def _header_bytes(self) -> bytes:
        """SOI..SOS header bytes — fixed for the session's parameters."""
        w = BitWriter()
        self._geom.write_headers(w)
        return w.get_buffer()

    def _encode_stacked(self, stacked) -> list[bytes]:
        f = stacked[0].shape[0]
        qc_seg = self._pad_segments(self._encode_qc_batch(stacked), f)
        bodies = self._run_enc_ladder_batch(
            lambda msb: self._pack_graph(qc_seg, f, msb), f)
        hdr = self._header_bytes
        return [b"".join((hdr, body, _EOI)) for body in bodies]

    def encode_planes_device(self, planes) -> bytes:
        """(y, u, v) uint8 arrays (zero-padded to the scan planes) → JPEG
        bytes."""
        return self.encode_device_batch([planes])[0]

    def encode_device_batch(self, frames: list) -> list[bytes]:
        """Frames as (y, u, v) uint8 arrays → JPEG bytes each: one batched
        device pass for numerics, entropy and wire assembly."""
        planes = [self.load_planes(f) for f in frames]
        stacked = [_upload(np.stack([p[i] for p in planes]), self.device)
                   for i in range(len(self.scans))]
        return self._encode_stacked(stacked)


def _parameters_maker(frame_hdr):
    """Encode preset for a 3-component frame's sampling factors."""
    hs = [c.horizontal_sampling_factor for c in frame_hdr.components]
    vs = [c.vertical_sampling_factor for c in frame_hdr.components]
    if hs == [2, 1, 1] and vs == [2, 1, 1]:
        return Parameters.c420
    if hs == [2, 1, 1] and vs in ([2, 2, 2], [1, 1, 1]):
        # the 4:2:2 preset is 2x2/1x2/1x2; foreign streams often use
        # 2x1/1x1/1x1 — same chroma dims, different MCU height
        return Parameters.c422
    if hs in ([2, 2, 2], [1, 1, 1]) and vs == [2, 1, 1]:
        # 4:4:0: the 2x2/2x1/2x1 preset or the 1x2/1x1/1x1 foreign form
        return Parameters.c440
    return Parameters.c444


class JpegTranscodeSession:
    """JPEG → JPEG transcode (re-quantize / re-segment) with pixels never
    leaving the device: K1 → K2 → plane assembly → pad clean → K3 → K4 →
    wire assembly. Host traffic per frame = two compressed bitstreams."""

    def __init__(self, header: Header, quality: int = 75,
                 restart_interval: int = 0, device=None):
        self.device = resolve_device(device)
        frame_hdr = header.frame
        if frame_hdr is None or len(frame_hdr.components) != 3:
            raise DecodeError("transcode supports 3-component scans")
        self.decoder = JpegDecoderSession(header, device=self.device)
        maker = _parameters_maker(frame_hdr)
        params = maker(frame_hdr.width, frame_hdr.height, quality)
        self.encoder = JpegEncoderSession(params, restart_interval,
                                          device=self.device)
        for comp, scan in zip(self.decoder.components, self.encoder.scans):
            if (comp.decoded_height, comp.decoded_width) != \
                    (scan.height, scan.width):
                raise DecodeError("transcode geometry mismatch")
        # the pad region is zeroed so output bytes are identical to a
        # host-roundtrip re-encode (load_planes pads with zeros)
        self._pad_masks = [(comp.actual_height, comp.actual_width)
                           for comp in self.decoder.components]

    def _clean_planes(self, stacks) -> list[torch.Tensor]:
        """Zero every plane stack outside the frame's actual size."""
        cleaned = []
        for p, (ah, aw) in zip(stacks, self._pad_masks):
            if (ah, aw) != tuple(p.shape[1:]):
                p = p.clone()
                p[:, ah:, :] = 0
                p[:, :, aw:] = 0
            cleaned.append(p)
        return cleaned

    def transcode(self, entropy_data: bytes) -> bytes:
        return self.transcode_batch([entropy_data])[0]

    def transcode_batch(self, entropy_list: list[bytes]) -> list[bytes]:
        """F frames' entropy bytes → F JPEG streams, one device pass."""
        cleaned = self._clean_planes(
            self.decoder.decode_batch_stacked(entropy_list))
        return self.encoder._encode_stacked(cleaned)

    def transcode_batch_iter(self, entropy_iter, batch: int = 8,
                             depth: int = 2):
        """Pipelined batched transcode: chunks of ``batch`` frames each run
        as one transcode_batch, with up to ``depth`` chunks in flight so
        chunk i's host prep and fetch overlap chunk i+1's device work.
        Yields frames in order."""
        for outs in _pipelined_map(self.transcode_batch,
                                   _chunked(entropy_iter, batch), depth):
            yield from outs
