"""JPEG sessions on one torch device: host sequencing + device kernels.

  host:   header parse → geometry plan → table packing → destuff and
          length-sorted lane prep (restart-free streams: an index scan
          that cuts the one segment into virtual segments), all in the
          host entropy engine (``entropy/native.py``)
  device: Huffman decode, one segment per lane (K1, or by stream shape
          and strategy K5, K6, K7) → K2 decode datapath → plane assembly
          → pad clean → block gather → K3 encode datapath → entropy
          encode, one segment per lane (K4 for segments of at most 32
          blocks, else symbol construction with K9 and the packer K8, or
          the gather packer by ``device_pack``) → wire assembly; the host
          joins header + body + EOI.

``decode_device_rgb(_batch)`` end the decode on the device in RGB: the
planes are cropped, the chroma upsampled and converted to (…, H, W, 3)
uint8 (``ops/color.py``, plain torch), the input of a training step.

The decoder session also has the host-entropy route: the host Huffman
decoder (the C++ engine, or pure Python; with resync, error concealment
by restart segment) or the padded-matrix decode on the device, then a
dense or sparse coefficient upload, K2 and the plane gather. The encoder
session has its counterpart: K3 on the device, a dense or sparse
coefficient download, then the host coder (the engine, or pure Python) or
the gather packer per frame; the transcode session can end in it
(``entropy_out="host"``).

Sessions run on ``cuda`` unless the caller passes a device (the tests pass
``device="cpu"``, which runs every kernel's plain PyTorch version). With
no device and no GPU they raise; nothing falls back silently.
"""

from __future__ import annotations

import functools
import logging
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..common.bitstream import BitReader, BitWriter
from ..common.frame import ChromaSubsampling, Frame
from ..common.plane import Plane
from ..device import resolve_device
from ..entropy.assemble import assemble_frames
from ..entropy import gather_pack, huffman_decode, pack_stuff
from ..entropy.decode_tables import (expand_luts, flat_words_route,
                                     range_tables)
from ..entropy.huffman_encode import (device_encoder_tables, encode_segments,
                                      m_out_for)
from ..entropy import scan as entropy_scan
from ..entropy.scan import (_chunked, _pipelined_map, destuff_dispatch,
                            destuff_flat, flat_size, index_scan,
                            pack_lanes_sorted, pool_map)
from ..entropy.symbols import prev_same_component
from ..entropy.tables import pack_decoder_tables, pack_encoder_tables
from ..model import marker_codes
from ..model.decoder import MultiScanDecoder
from ..model.header import (DecodeError, DecoderGeometry, EncoderGeometry,
                            Header, Parameters)
from ..ops import color, datapath, sparse
from ..parallel.mesh import flat_group, mesh_device, mesh_index, shard_rows
from ..state import DecoderState, EncoderState
from . import trace

_EOI = bytes((0xFF, marker_codes.EOI))
# the encoder preset of each chroma subsampling
SUBSAMPLING_PRESETS = {ChromaSubsampling.C420: Parameters.c420,
                       ChromaSubsampling.C422: Parameters.c422,
                       ChromaSubsampling.C440: Parameters.c440,
                       ChromaSubsampling.C444: Parameters.c444}


def _session_device(device, mesh) -> torch.device:
    """A session's device: ``resolve_device``'s rule, or on a mesh this
    rank's device of the mesh (a named device must be of its type)."""
    if mesh is None:
        return resolve_device(device)
    dev = mesh_device(mesh) if device is None else resolve_device(device)
    if dev.type != mesh.device_type:
        raise ValueError(f"device {dev} is not of the mesh's type "
                         f"{mesh.device_type!r}")
    return dev


def _mesh_size(mesh) -> int:
    return 1 if mesh is None else mesh.size()


def _mesh_depth(mesh, depth: int) -> int:
    """Chunks in flight for a pipelined map: one at a time on a mesh,
    where the collectives must come in the same order on every rank."""
    return depth if mesh is None else 1


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: an ``upload`` span (``bytes``)."""
    a = np.ascontiguousarray(a)
    with trace.span("upload", bytes=a.nbytes):
        return torch.from_numpy(a).to(device)


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


def _segment_rows(a: torch.Tensor, B: int) -> torch.Tensor:
    """The first ``B`` rows of a per-block array, repeated when the frame
    has fewer blocks (one segment, shorter than the restart interval):
    ``np.resize``'s rule. The block schedule repeats with the MCU, so
    every lane of B blocks shares these rows."""
    return a[torch.arange(B, device=a.device) % a.shape[0]].contiguous()


def _check_flat_bytes(total: int) -> None:
    """The Huffman kernels take each lane's start in its dispatch's flat
    buffer as int32: refuse a dispatch whose entropy data reach 2 GiB,
    where the offsets would wrap (and a kernel read outside the buffer)."""
    if total >= 1 << 31:
        raise ValueError(f"a dispatch's entropy data must be under 2 GiB "
                         f"(got {total} bytes): decode fewer frames a call")


def _lane_bucket(max_len: int, floor_log2: int) -> int:
    """Power-of-two lane length with >= 4 guard bytes past the longest
    lane."""
    return 1 << max(floor_log2, (max_len + 4 - 1).bit_length())


def _lane_order(lens64: np.ndarray):
    """Length-sorted lane order (long segments share warps, so short ones
    do not idle behind them) and its inverse: inv_perm[g] is segment g's
    lane."""
    order = np.argsort(-lens64, kind="stable")
    inv_perm = np.empty(len(lens64), np.int32)
    inv_perm[order] = np.arange(len(lens64), dtype=np.int32)
    return order, inv_perm


class _LanePlan(NamedTuple):
    """A dispatch's Huffman lanes in lane order (``_lane_plan``): each
    lane's int32 start in the flat buffer, bytes and blocks, and on the
    indexed route its start state (the first bit in its first byte, its
    (C,) DC predictors; else None). ``order`` lists the stream-order lanes
    in lane order, ``inv_perm`` is its inverse, ``L`` the lane bucket and
    ``lane_bytes`` the bytes of every lane."""
    starts: np.ndarray
    lens: np.ndarray
    blocks: np.ndarray
    bitpos: np.ndarray | None
    dc: np.ndarray | None
    order: np.ndarray
    inv_perm: np.ndarray
    L: int
    lane_bytes: int


def _lane_plan(starts64: np.ndarray, lens64: np.ndarray,
               blocks: np.ndarray, bitpos: np.ndarray | None = None,
               dc: np.ndarray | None = None, *, matrix: bool = False,
               multiple: int = 1) -> _LanePlan:
    """The lane plan of a dispatch's lanes in stream order: int64 starts
    into the flat buffer and lengths, int32 blocks a lane and (indexed
    route) start state. Lanes that the kernel reads from the flat buffer
    are checked under 2 GiB and bucketed from 2^6 bytes; ``matrix`` lanes
    go up host-packed (``pack_lanes_sorted`` by ``order``), bucketed from
    2^5. ``multiple`` pads with zero-length lanes, which decode nothing
    and sort last, from where the last lane ends to a multiple of it."""
    end = int(starts64[-1] + lens64[-1])
    if not matrix:
        _check_flat_bytes(end)
    pad = -len(lens64) % multiple
    if pad:
        starts64 = np.pad(starts64, (0, pad), constant_values=end)
        lens64, blocks = np.pad(lens64, (0, pad)), np.pad(blocks, (0, pad))
    order, inv_perm = _lane_order(lens64)
    lens = lens64.astype(np.int32)[order]
    return _LanePlan(starts64.astype(np.int32)[order], lens, blocks[order],
                     None if bitpos is None else bitpos[order],
                     None if dc is None else dc[order], order, inv_perm,
                     # the longest lane comes first
                     _lane_bucket(int(lens[0]), 5 if matrix else 6),
                     int(lens.sum(dtype=np.int64)))


def _huffman_route(S: int, L: int, B: int, arrive: str, device_huffman: str,
                   decode_gather: str) -> str:
    """The Huffman route of S lanes of at most L bytes and B blocks that
    arrive as ``"flat"`` (the flat buffer), ``"matrix"`` (a host-packed
    (S, L) matrix) or ``"indexed"`` (the flat buffer and a start state a
    lane). Indexed lanes, and flat ones that ``flat_words_route`` takes,
    are read from the flat buffer by K1 (``"flat"``) or, with
    ``decode_gather="dma"``, K7 (``"staged"``). Every other route reads
    the (S, L) matrix: ``device_huffman``, and under ``"auto"``
    ``auto_strategy``'s choice of ``"pallas_t"``, ``"streamed"`` or
    ``"pallas"``."""
    if arrive == "indexed" or (arrive == "flat" and flat_words_route(
            S, L, B, device_huffman)):
        return "staged" if decode_gather == "dma" else "flat"
    if device_huffman == "auto":
        return huffman_decode.auto_strategy(S, L, B)
    return device_huffman


# the wrapper (in ``huffman_decode``, looked up at each launch) of each
# route that reads the flat buffer; the others go to ``decode_padded``
_FLAT_WRAPPERS = {"flat": "decode_flat", "staged": "decode_flat_staged"}


class JpegDecoderSession:
    """Decoder for a fixed header geometry (dims, sampling, tables): feed
    it the entropy data of any frame with the same headers.

    ``device_huffman`` picks the Huffman decode strategy: ``"auto"``
    (by stream shape: K1 for many short segments, K6 for long ones, K5
    otherwise — never a plain version on the card), ``"pallas_t"`` (K1),
    ``"pallas"`` (K5), or the plain PyTorch loops on the padded lane
    matrix, for an explicit selection only: ``"range"`` (range-table
    match) and ``"lut"`` (one load from the tables expanded to every
    16-bit window). All are bit-identical on valid streams.
    ``decode_gather`` says how K1's
    lanes reach the kernel from the flat buffer: ``"gather"`` (K1 reads
    global memory) or ``"dma"`` (K7 stages each lane's rows in shared
    memory itself); the default reads the environment variable
    ``VCT_DECODE_GATHER``.

    Restart-free streams (one segment a frame, as cameras write them)
    decode wide all the same when the frame has at least 8 virtual
    segments' worth of blocks: a host index scan records the bit offset
    and DC predictors every ``_index_stride()`` blocks and every virtual
    segment becomes a K1 lane with that start state. Smaller restart-free
    frames run as one serial lane (``device_entropy_parallel`` is False
    and the first such call logs a warning).

    ``decode``, ``decode_batch`` and ``decode_iter`` take the host-entropy
    route: ``decode_entropy`` gives (n_blocks, 64) coefficients on the
    host by ``entropy`` — ``"native"`` (the host entropy engine's fused
    destuff and decode, its segments on a thread pool), ``"python"`` (the
    golden model's decoder in pure Python: seconds for a 1080p frame) or
    ``"tpu"`` (the padded lane matrix decoded on the session's device by
    ``device_huffman``, so ``"auto"`` runs K1, K6 or K5) — and
    ``decode_planes_device`` uploads them by ``coef_transfer``:
    ``"dense"`` (int32), ``"sparse"`` (occupancy bitmask + packed
    nonzeros) or ``"auto"`` (sparse on a GPU), then runs K2 and the plane
    gather. ``resync=True`` decodes on the host with error concealment by
    restart segment (in pure Python for ``"python"``, else the engine)
    and leaves the concealed segments in ``last_damaged_segments``.

    ``mesh`` (a ``DeviceMesh`` from ``parallel.codec_mesh``) shards the
    fused device decode over its ranks: every rank destuffs the frames,
    the length-sorted lane pool is padded with zero-length lanes (which
    decode nothing) to a multiple of the mesh size, and each rank uploads
    and decodes only its contiguous run of lanes (the Huffman decode by
    ``device_huffman``, then K2); an ``all_gather`` of the pixels gives
    ``decode_device``, ``decode_device_e2e`` and ``decode_device_batch``
    the same planes on every rank. ``decode_device_batch_stacked`` keeps
    the planes frame-sharded (a ``DTensor``, ``Shard(0)`` on every mesh
    dimension) when the mesh size divides the frame count. The session's
    device is then this rank's device of the mesh. The host-entropy route
    does not shard."""

    STRATEGIES = ("auto", "pallas", "pallas_t", "range", "lut")
    ENTROPY = ("native", "python", "tpu")
    COEF_TRANSFER = ("auto", "dense", "sparse")

    def __init__(self, header: Header, device=None,
                 device_huffman: str = "auto",
                 decode_gather: str | None = None, entropy: str = "native",
                 coef_transfer: str = "auto", mesh=None):
        self.device = _session_device(device, mesh)
        self.mesh = mesh
        for name, value, allowed in (
                ("device_huffman", device_huffman, self.STRATEGIES),
                ("entropy", entropy, self.ENTROPY),
                ("coef_transfer", coef_transfer, self.COEF_TRANSFER)):
            if value not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got "
                                 f"{value!r}")
        if decode_gather is None:
            decode_gather = ("dma" if os.environ.get("VCT_DECODE_GATHER")
                             == "dma" else "gather")
        if decode_gather not in ("gather", "dma"):
            raise ValueError("decode_gather must be 'gather' or 'dma'")
        self.device_huffman = device_huffman
        self.decode_gather = decode_gather
        self.entropy = entropy
        self.coef_transfer = coef_transfer
        self._sparse = coef_transfer == "sparse" or (
            coef_transfer == "auto" and self.device.type == "cuda")
        self.last_damaged_segments: list[int] = []
        self.header = header
        geom = DecoderGeometry(header)
        self.components = geom.components
        sched = geom.block_schedule_array()
        self.n_blocks = len(sched)
        self.comp_idx = sched[:, 0].astype(np.int32)
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
            rows = np.flatnonzero(sched[:, 0] == ci)
            order = rows[np.lexsort((sched[rows, 1], sched[rows, 2]))]
            self.plane_geom.append((order.astype(np.int32),
                                    comp.decoded_height // 8,
                                    comp.decoded_width // 8))
        self._warned_serial_entropy = False
        self.load_state(DecoderState.from_numpy(self.numpy_state(),
                                                self.device))

    def numpy_state(self) -> dict:
        """The arrays this session computes with (see state.py)."""
        return {"quant": self.quant, "comp_idx": self.comp_idx,
                "plane_geom": self.plane_geom,
                "range_tables": range_tables(self.tables),
                "luts": expand_luts(self.tables)}

    def load_state(self, state: DecoderState) -> None:
        """Compute with ``state`` from here on (e.g. state built from
        another implementation's arrays by state.from_numpy)."""
        if int(state.quant.min()) < 1 or state.quant.shape != (self.n_blocks,
                                                               64):
            raise ValueError("decoder quant must be (n_blocks, 64), >= 1")
        self.state = state
        self._views = {}

    def _seg_view(self, seg_div: int):
        """(comp_sched, quant rows, plane gather) for lanes of ``seg_div``
        blocks: every lane shares one block schedule, and the inverse lane
        permutation folds into the plane gather — block idx of a frame is
        offset idx % seg_div of stream segment idx // seg_div."""
        if seg_div not in self._views:
            st = self.state
            self._views[seg_div] = (
                _segment_rows(st.comp_idx, seg_div),
                _segment_rows(st.quant, seg_div),
                [(idx // seg_div, idx % seg_div, nby, nbx)
                 for idx, nby, nbx in st.plane_idx])
        return self._views[seg_div]

    @property
    def _comp_sched(self) -> torch.Tensor:
        return self._seg_view(self.blocks_per_segment)[0]

    @property
    def _quant_seg(self) -> torch.Tensor:
        return self._seg_view(self.blocks_per_segment)[1]

    @property
    def n_segments(self) -> int:
        """Restart segments per frame (= decode lanes per frame)."""
        return -(-self.n_blocks // self.blocks_per_segment)

    entropy_segments_per_frame = n_segments

    @property
    def device_entropy_parallel(self) -> bool:
        """True when the stream is restart-segmented, i.e. a frame has
        more than one lane of its own. False for restart-free streams —
        see the class docstring."""
        return self.n_segments > 1

    def _index_stride(self) -> int:
        """Virtual blocks per lane for the indexed decode of restart-free
        streams: a multiple of the MCU (so every virtual segment shares
        the block schedule) near 24 blocks."""
        return self.mcu_size * max(1, -(-24 // self.mcu_size))

    def _indexable(self) -> bool:
        return (self.n_segments == 1
                and self.n_blocks >= 8 * self._index_stride())

    def _check_device_entropy_route(self) -> None:
        if (self.device_entropy_parallel or self._warned_serial_entropy
                or (self._indexable() and self.mesh is None)):
            return
        self._warned_serial_entropy = True
        logging.getLogger("video_coding_tpu_torch").warning(
            "decoding a single-segment stream (no restart interval, or one "
            "longer than the frame) too small for the indexed route: one "
            "lane, serial — bit-exact but slow")

    def _expected_seg_blocks(self, S: int, B: int | None = None
                             ) -> np.ndarray:
        """Blocks in each of a frame's S lanes of B blocks (None: its
        restart segments), the last one short; DecodeError unless S lanes
        of B cover the frame."""
        B = B or self.blocks_per_segment
        n_seg_expected = (self.n_blocks + B - 1) // B
        if S != n_seg_expected:
            raise DecodeError(
                f"expected {n_seg_expected} restart segments, got {S}")
        seg_blocks = np.full(S, B, dtype=np.int32)
        if self.n_blocks % B:
            seg_blocks[-1] = self.n_blocks % B
        return seg_blocks

    # -- lane plan, route and launch of the Huffman decode ------------------
    def _segment_plan(self, d, **kw) -> _LanePlan:
        """The lane plan of a destuffed dispatch (``scan.Destuffed``) of
        restart-segmented streams: a lane a segment (``_lane_plan``'s
        keywords)."""
        return _lane_plan(d.starts.reshape(-1), d.lens.reshape(-1),
                          np.tile(self._expected_seg_blocks(self.n_segments),
                                  len(d.lens)), **kw)

    @staticmethod
    def _gather_lanes(flat, starts, lens, L: int) -> torch.Tensor:
        """(S, L) zero-padded lane matrix from the flat buffer, on the
        device (bytes past a segment's length are zeroed)."""
        cols = torch.arange(L, device=flat.device, dtype=torch.int64)[None]
        idx = (starts.to(torch.int64)[:, None] + cols).clamp(
            0, flat.shape[0] - 1)
        return torch.where(cols < lens[:, None], flat[idx],
                           flat.new_zeros(())).contiguous()

    def _launch(self, plan: _LanePlan, buf: np.ndarray, B: int):
        """The Huffman decode of a plan's lanes of B blocks from ``buf``,
        the flat buffer or the host-packed (S, L) matrix: the uploads of
        what the lanes arrive as, the routed wrapper under
        ``decode.launch`` (stage ``huffman``, ``route``), then the upload
        of inv_perm. Returns ((S, B, 64) coefficients in lane order,
        inv_perm int64)."""
        up = functools.partial(_upload, device=self.device)
        arrive = ("matrix" if buf.ndim == 2 else
                  "flat" if plan.bitpos is None else "indexed")
        bp0 = dc0 = None
        if arrive == "matrix":
            lanes, segb = up(buf), up(plan.blocks)
        elif arrive == "flat":
            flat, starts, lens, segb = map(up, (buf, *plan[:3]))
        else:           # the lane arrays go up before the flat buffer
            starts, lens, segb, bp0, dc0 = map(up, plan[:5])
            flat = up(buf)
        route = _huffman_route(len(plan.lens), plan.L, B, arrive,
                               self.device_huffman, self.decode_gather)
        st = self.state
        tabs = (self._seg_view(B)[0], st.lo, st.hi, st.offset, st.values)
        kw = dict(blocks_per_segment=B, n_components=len(self.components))
        with trace.span("decode.launch", stage="huffman", route=route):
            if route in _FLAT_WRAPPERS:
                coefs = getattr(huffman_decode, _FLAT_WRAPPERS[route])(
                    flat, starts, lens, segb, *tabs, init_bitpos=bp0,
                    init_dc=dc0, **kw)
            else:
                if arrive == "flat":
                    lanes = self._gather_lanes(flat, starts, lens, plan.L)
                coefs = huffman_decode.decode_padded(
                    route, lanes, segb, *tabs, luts=st.luts, **kw)
        return coefs, up(plan.inv_perm).to(torch.int64)

    def _decode_coefs_pool(self, d):
        """A destuffed dispatch (``scan.Destuffed``) → ((S, B, 64)
        coefficients in lane order, inv_perm (S,) int64) on the device, S
        = F·n_segments. A single frame uploads its lanes host-packed, a
        batch the flat buffer (about half the bytes)."""
        with trace.span("decode.lane_prep"):
            matrix = len(d.lens) == 1
            plan = self._segment_plan(d, matrix=matrix)
            buf = (pack_lanes_sorted(d.flat, d.lens.reshape(-1), plan.order,
                                     plan.L, starts=d.starts.reshape(-1))
                   if matrix else d.flat)
            trace.attrs(lanes=len(plan.lens), lane_len=plan.L,
                        lane_bytes=plan.lane_bytes)
        return self._launch(plan, buf, self.blocks_per_segment)

    def _decode_device_batch_indexed(self, d):
        """Indexed decode of a destuffed dispatch of restart-free streams
        (``scan.Destuffed``): every frame's one segment is index-scanned
        on the host (the standing pool over the frames, each on its view
        of the flat buffer) and all frames' virtual segments pool into one
        K1 lane set, each lane starting at its recorded bit offset and DC
        predictors. Returns stacked planes — or None when the index scan
        meets a malformed symbol: the golden model conceals such input
        where the scan raises, so the caller decodes that batch as one
        serial lane a frame instead. (That data-dependent case is the
        only one that leaves this route.)"""
        stride = self._index_stride()

        def scan(fl):
            with trace.span("decode.index_scan", bytes_in=len(fl)):
                try:
                    return index_scan(fl, self.comp_idx, stride, self.tables)
                except ValueError:
                    return None

        bases = d.bases.tolist()
        flats = [d.flat[b:b + n]
                 for b, n in zip(bases, d.lens[:, 0].tolist())]
        idxs = pool_map(scan, flats)
        if any(i is None for i in idxs):
            return None
        with trace.span("decode.lane_prep"):
            bo = np.stack([i[0] for i in idxs])     # (F, R) start bits
            s64 = bo >> 3
            ends = np.empty_like(bo)
            # a lane's last byte may hold the next lane's first bits: its
            # block count ends it, not its length
            ends[:, :-1] = (bo[:, 1:] + 7) >> 3
            ends[:, -1] = d.lens[:, 0]
            C = len(self.components)
            plan = _lane_plan(
                (s64 + d.bases[:, None]).ravel(), (ends - s64).ravel(),
                np.tile(self._expected_seg_blocks(bo.shape[1], stride),
                        len(bo)), (bo - 8 * s64).astype(np.int32).ravel(),
                np.concatenate([dp[:, :C] for _, dp in idxs]).astype(
                    np.int32))
            # K1 reads the lanes from the flat buffer: no lane matrix
            trace.attrs(lanes=len(plan.lens), lane_bytes=plan.lane_bytes)
        coefs, inv_perm = self._launch(plan, d.flat, stride)
        return self._decode_tail_pool(coefs.view(-1, 64), inv_perm,
                                      len(bo), stride)

    def _decode_tail_pool(self, coefs_pool: torch.Tensor,
                          inv_perm: torch.Tensor, f: int,
                          seg_div: int | None = None):
        """Lane-order (S·seg_div, 64) coefficient pool → tuple of (f, H, W)
        uint8 plane stacks. K2 runs on the pool as it is (every lane
        shares one block schedule, so block j of any lane uses quant row
        j % seg_div); the inverse lane permutation folds into the plane
        gather, so stream-ordered coefficients are never materialized."""
        seg_div = seg_div or self.blocks_per_segment
        with trace.span("decode.launch", stage="tail"):
            pixels = datapath.decode_datapath(coefs_pool,
                                              self._seg_view(seg_div)[1])
            return self._assemble_planes(pixels, inv_perm.view(f, -1),
                                         seg_div)

    def _assemble_planes(self, pixels: torch.Tensor, ip: torch.Tensor,
                         seg_div: int):
        """Lane-order (·, 8, 8) pixels and the inverse lane permutation
        of f frames, (f, segments a frame) → tuple of (f, H, W) plane
        stacks."""
        out = []
        for seg_i, off_i, nby, nbx in self._seg_view(seg_div)[2]:
            cidx = ip[:, seg_i] * seg_div + off_i
            out.append(_plane_from_blocks(pixels[cidx], nby, nbx))
        return tuple(out)

    # -- entry points -------------------------------------------------------
    def decode_device_batch_stacked(self, entropy_list: list[bytes]):
        """Entropy bytes of F frames → per-component (F, H, W) uint8 plane
        stacks (decoded, i.e. MCU-padded, sizes) on the device: all
        frames' segments are one lane pool, one Huffman decode launch and
        one datapath launch. On a mesh whose size divides F the stacks are
        frame-sharded DTensors (see the class docstring)."""
        return self._stacked(entropy_list, frame_sharded=True)

    def _stacked(self, entropy_list: list[bytes], frame_sharded: bool):
        """The batch decode of every route: a ``decode.dispatch`` span
        (``frames``, ``bytes_in``)."""
        self._check_device_entropy_route()
        with trace.span("decode.dispatch", frames=len(entropy_list),
                        bytes_in=sum(map(len, entropy_list))):
            if self.mesh is not None:
                return self._decode_mesh(entropy_list, frame_sharded)
            d = destuff_dispatch(entropy_list, self.n_segments)
            if self._indexable():
                out = self._decode_device_batch_indexed(d)
                if out is not None:
                    return out
            coefs, inv_perm = self._decode_coefs_pool(d)
            return self._decode_tail_pool(coefs.view(-1, 64), inv_perm,
                                          len(entropy_list))

    decode_batch_stacked = decode_device_batch_stacked

    def _decode_mesh(self, entropy_list: list[bytes], frame_sharded: bool):
        """The mesh-sharded batch decode (class docstring): this rank
        decodes its contiguous run of the length-sorted lanes
        (``_mesh_run``), then K2; the pixels are gathered from
        every rank and the planes assembled (this rank's frames only, as
        a DTensor, when ``frame_sharded`` and the mesh size divides F)."""
        mesh, B = self.mesh, self.blocks_per_segment
        n, r, F = mesh.size(), mesh_index(mesh), len(entropy_list)
        coefs, ip = self._launch(*self._mesh_run(
            destuff_dispatch(entropy_list, self.n_segments), n, r), B)
        with trace.span("decode.launch", stage="tail"):
            pixels = datapath.decode_datapath(coefs.view(-1, 64),
                                              self._quant_seg)
            every = pixels.new_empty((n * pixels.shape[0], 8, 8))
            dist.all_gather_into_tensor(every, pixels,
                                        group=flat_group(mesh))
            ip = ip.view(F, -1)
            if frame_sharded and F % n == 0:
                k = F // n
                return tuple(shard_rows(p, mesh)
                             for p in self._assemble_planes(
                                 every, ip[r * k:(r + 1) * k], B))
            return self._assemble_planes(every, ip, B)

    def _mesh_run(self, d, n: int, r: int):
        """This rank's lanes of a destuffed dispatch on a mesh of n: the
        lane plan padded with zero-length lanes to a multiple of n, cut to
        the r-th of n contiguous runs, with L that run's own, and a flat
        buffer of that run's segment bytes only, in stream order (the
        dispatch's own on a mesh of one). Its inv_perm indexes the lanes
        of all n runs in order. Returns (plan, flat)."""
        with trace.span("decode.lane_prep"):
            plan, flat = self._segment_plan(d, multiple=n), d.flat
            if n > 1:
                step = len(plan.lens) // n
                starts, lens, segb = (a[r * step:(r + 1) * step]
                                      for a in plan[:3])
                by = np.argsort(starts, kind="stable")
                packed = np.empty_like(starts)
                packed[by] = np.cumsum(lens[by]) - lens[by]
                idx = (np.repeat(starts[by] - packed[by], lens[by])
                       + np.arange(int(lens.sum())))
                flat = np.zeros(flat_size(len(idx)), np.uint8)
                np.take(d.flat, idx, out=flat[:len(idx)])
                plan = plan._replace(
                    starts=packed, lens=lens, blocks=segb,
                    inv_perm=plan.inv_perm[:d.lens.size],
                    L=_lane_bucket(int(lens.max()), 6),
                    lane_bytes=int(lens.sum(dtype=np.int64)))
            trace.attrs(lanes=len(plan.lens), lane_len=plan.L,
                        lane_bytes=plan.lane_bytes)
        return plan, flat

    def decode_device_batch(self, entropy_list: list[bytes]):
        """Like decode_device_batch_stacked, as a list of per-frame plane
        tuples (device tensors, the same on every rank of a mesh)."""
        planes = self._stacked(entropy_list, frame_sharded=False)
        return [tuple(p[i] for p in planes)
                for i in range(len(entropy_list))]

    def decode_device_batch_iter(self, entropy_iter, batch: int = 8,
                                 depth: int = 2):
        """Pipelined batched decode for device-resident consumers: chunks
        of ``batch`` frames each decode as one dispatch with ``depth``
        chunks in flight, so chunk i+1's host prep and upload overlap
        chunk i's device work (one chunk at a time on a mesh). Yields
        per-chunk stacked plane tuples."""
        return _pipelined_map(self.decode_device_batch_stacked,
                              _chunked(entropy_iter, batch),
                              _mesh_depth(self.mesh, depth))

    def decode_device_e2e(self, entropy_data: bytes):
        """Raw entropy bytes of one frame → decoded (MCU-padded) planes on
        the device: only the destuffed bitstream goes up and only the
        planes come back. A single frame uploads the padded lane matrix;
        a restart-free frame takes the indexed route."""
        return tuple(p[0] for p in
                     self._stacked([entropy_data], frame_sharded=False))

    def decode_device(self, entropy_data: bytes) -> Frame | list[Plane]:
        """One frame → a ``Frame`` of its planes cropped to the frame's
        actual size (three components), else a list of ``Plane``s."""
        return self._to_frame(self.decode_device_e2e(entropy_data))

    # -- RGB for training ----------------------------------------------------
    def _rgb_tail(self, planes):
        """Decoded (MCU-padded) planes, (H, W) or (F, H, W) each → (…, H,
        W, 3) uint8 RGB on their device. Chroma is cropped before
        upsampling (the edge replication sees the frame's edge, not the MCU
        padding), then to luma's size.

        Chroma is cropped to T.81's chroma size, luma's divided by the
        sampling ratio and rounded up: at a 61-wide 4:2:0 frame that is
        31 columns, the last of them the stream's own. The JAX package's
        tail crops to the rounded-down ``actual_width`` and raises a shape
        error at such sizes; at every other size the two agree."""
        comps = self.components
        yw, yh = comps[0].actual_width, comps[0].actual_height
        sh = (comps[0].component.horizontal_sampling_factor
              // comps[1].component.horizontal_sampling_factor)
        sv = (comps[0].component.vertical_sampling_factor
              // comps[1].component.vertical_sampling_factor)

        def chroma(p):
            p = p[..., :-(-yh // sv), :-(-yw // sh)]
            if sh == 2 and sv == 2:
                p = color.upsample_hv2(p)
            elif sh == 2:
                p = color.upsample_h2(p)
            elif sv == 2:  # 4:4:0, vertical-only subsampling
                p = color.upsample_v2(p)
            return p[..., :yh, :yw]

        y = planes[0][..., :yh, :yw]
        return color.yuv444_to_rgb(y, chroma(planes[1]), chroma(planes[2]))

    def _check_rgb(self) -> None:
        if len(self.components) != 3:
            raise DecodeError("RGB output needs a 3-component scan")

    def decode_device_rgb(self, entropy_data: bytes) -> torch.Tensor:
        """Entropy bytes of one frame → (H, W, 3) uint8 RGB on the device:
        Huffman decode, K2, chroma upsampling and color conversion all
        there (the decode-for-training path)."""
        self._check_rgb()
        return self._rgb_tail(self.decode_device_e2e(entropy_data))

    def decode_device_rgb_batch(self,
                                entropy_list: list[bytes]) -> torch.Tensor:
        """Entropy bytes of F frames → (F, H, W, 3) uint8 RGB on the device:
        one Huffman decode launch and one K2 launch for all frames, then the
        RGB tail on the (F, H, W) plane stacks."""
        self._check_rgb()
        return self._rgb_tail(self._stacked(entropy_list,
                                            frame_sharded=False))

    def _to_frame(self, planes_dev) -> Frame | list[Plane]:
        planes = [Plane(data=np.ascontiguousarray(
            p.cpu().numpy()[:comp.actual_height, :comp.actual_width]))
            for comp, p in zip(self.components, planes_dev)]
        if len(planes) == 3:
            return Frame.of_planes(*planes)
        return planes

    # -- host-entropy route -------------------------------------------------
    def decode_entropy(self, entropy_data: bytes,
                       resync: bool = False) -> np.ndarray:
        """Raw (stuffed) entropy-coded bytes → (n_blocks, 64) int32 zigzag
        coefficients on the host, by ``self.entropy``.

        With ``resync=True`` the host decoder conceals corrupt or
        truncated data per restart segment (damaged segments zeroed from
        the failing block; see ``entropy.scan.decode_scan_resync``)
        instead of raising: the engine unless ``entropy`` is
        ``"python"`` (the device decoders have no error strobes);
        ``self.last_damaged_segments`` reports what was concealed."""
        native = self.entropy != "python"
        if resync:
            segments, marks = entropy_scan.destuff_segments_with_markers(
                entropy_data, use_native=native)
            coefs, damaged = entropy_scan.decode_scan_resync(
                segments, self.comp_idx, self.blocks_per_segment,
                self.tables, use_native=native, marker_indices=marks)
            self.last_damaged_segments = damaged
            return coefs
        self.last_damaged_segments = []
        if self.entropy == "tpu":
            return self._decode_entropy_device(entropy_data)
        if native:
            return entropy_scan.destuff_and_decode_scan(
                entropy_data, self.comp_idx, self.blocks_per_segment,
                self.tables)
        return entropy_scan.decode_scan(
            entropy_scan.destuff_segments(entropy_data, use_native=False),
            self.comp_idx, self.blocks_per_segment, self.tables,
            use_native=False)

    def _decode_entropy_device(self, entropy_data: bytes) -> np.ndarray:
        """``entropy="tpu"``: the frame's segments as a length-sorted
        padded (S, L) matrix, decoded on the device by the session's
        strategy, brought back to stream order and downloaded."""
        self._check_device_entropy_route()
        flat, lens64 = destuff_flat(entropy_data)
        starts64 = np.zeros_like(lens64)
        np.cumsum(lens64[:-1], out=starts64[1:])
        plan = _lane_plan(starts64, lens64,
                          self._expected_seg_blocks(len(lens64)), matrix=True)
        coefs, inv_perm = self._launch(
            plan, pack_lanes_sorted(flat, lens64, plan.order, plan.L,
                                    starts=starts64), self.blocks_per_segment)
        return coefs[inv_perm].view(-1, 64)[:self.n_blocks].cpu().numpy()

    @staticmethod
    def _pack_upload(coefs: np.ndarray):
        """Host sparse pack, the value buffer zero-padded to a power-of-two
        bucket as the reference uploads it: (mask, values)."""
        mask, values, nnz = sparse.pack_host(coefs)
        cap = max(256, 1 << (max(nnz, 1) - 1).bit_length())
        return mask, np.pad(values, (0, cap - nnz))

    def _decode_coefs_host(self, coefs: np.ndarray, f: int):
        """(f·n_blocks, 64) host coefficients of f frames → tuple of (f, H,
        W) uint8 plane stacks on the device: the dense or sparse upload,
        then K2 and the plane gather (one lane a frame)."""
        dev = self.device
        if self._sparse:
            mask, values = self._pack_upload(coefs)
            pool = sparse.unpack_device(_upload(mask, dev),
                                        _upload(values, dev), coefs.shape[0])
        else:
            pool = _upload(coefs.astype(np.int32, copy=False), dev)
        return self._decode_tail_pool(
            pool, torch.arange(f, device=dev), f, self.n_blocks)

    def decode_planes_device(self, coefs: np.ndarray):
        """(n_blocks, 64) coefficients → tuple of decoded (MCU-padded)
        planes on the device. With sparse transfer only the occupancy
        bitmask and the packed nonzeros go up (the device scatters them
        back to dense before K2)."""
        return tuple(p[0] for p in self._decode_coefs_host(coefs, 1))

    def decode(self, entropy_data: bytes,
               resync: bool = False) -> Frame | list[Plane]:
        """One frame through the host-entropy route → a ``Frame`` of
        cropped planes (three components), else a list of ``Plane``s."""
        coefs = self.decode_entropy(entropy_data, resync=resync)
        return self._to_frame(self.decode_planes_device(coefs))

    def decode_batch(self, entropy_list: list[bytes]) -> list:
        """Decode many same-geometry frames: the entropy decode of each on
        the standing pool (``scan.pool_map``), then one upload and one K2
        launch for all."""
        coefs = pool_map(self.decode_entropy, entropy_list)
        f = len(entropy_list)
        planes = self._decode_coefs_host(np.concatenate(coefs), f)
        return [self._to_frame([p[i] for p in planes]) for i in range(f)]

    def decode_iter(self, entropy_iter, depth: int = 2):
        """Pipelined streaming decode: an ordered generator of frames with
        up to ``depth`` in flight — frame i+1's entropy decode overlaps
        frame i's upload, K2 and plane download."""
        return _pipelined_map(self.decode, entropy_iter, depth)


class JpegEncoderSession:
    """Encoder for fixed parameters (dims, quality, subsampling, restart
    interval).

    Two families of entry points. ``encode_device*`` run everything on
    the device: K3, the entropy encode and the wire assembly; only the
    bodies come back. ``device_pack`` picks their bitstream packer:
    ``"pallas"`` (the hand-written kernels: K4 for segments of at most 32
    blocks, else symbol construction with K9 feeding the packer K8),
    ``"xla"`` (the gather packer in plain torch) or ``"auto"`` (the
    kernels when the reference's lane-chunk rule gives at least 128 lanes
    for this segment size and budget and the dispatch has at least 64
    segments, else the gather packer). All are byte-identical.

    ``encode``, ``encode_planes``, ``encode_batch`` and ``encode_iter``
    run K3 on the device, download the quantized coefficients and code the
    entropy per frame by ``entropy``: ``"native"`` (the host entropy
    engine: its segments on a thread pool, joined with RSTn markers in its
    own buffers), ``"python"`` (the host coder in pure Python: about a
    second for a 1080p frame) or ``"tpu"`` (the gather packer on the
    session's device). ``coef_transfer`` is the
    download: ``"dense"`` (int16), ``"sparse"`` (occupancy bitmask +
    packed nonzeros, dense when the value budget overflows) or ``"auto"``
    (sparse on a GPU).

    ``mesh`` (a ``DeviceMesh`` from ``parallel.codec_mesh``) shards
    ``encode_device*`` over its ranks: the restart segments of every frame
    are padded to a multiple of the mesh size, each rank runs K3 and the
    routed packer on its contiguous run of segments, the segment lengths
    are exchanged with ``all_gather_into_tensor``, each rank writes its
    segments and their RSTn markers at their places in the wire buffer,
    and an ``all_reduce(SUM)`` joins the disjoint buffers (the overflow
    flag is reduced with MAX). Every rank gets the bytes the unsharded
    session gives. The host-entropy route does not shard."""

    ENTROPY = ("native", "python", "tpu")
    COEF_TRANSFER = ("auto", "dense", "sparse")
    DEVICE_PACK = ("auto", "pallas", "xla")

    def __init__(self, params: Parameters, restart_interval: int = 0,
                 device=None, entropy: str = "native",
                 coef_transfer: str = "auto", device_pack: str = "auto",
                 mesh=None):
        self.device = _session_device(device, mesh)
        self.mesh = mesh
        for name, value, allowed in (
                ("entropy", entropy, self.ENTROPY),
                ("coef_transfer", coef_transfer, self.COEF_TRANSFER),
                ("device_pack", device_pack, self.DEVICE_PACK)):
            if value not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got "
                                 f"{value!r}")
        self.entropy = entropy
        self.coef_transfer = coef_transfer
        self.device_pack = device_pack
        self._sparse = coef_transfer == "sparse" or (
            coef_transfer == "auto" and self.device.type == "cuda")
        # sparse download: nonzero-value budget per block (adaptive — a
        # frame that overflows it doubles it and goes down dense)
        self._cap_per_block = 16
        self._cap_locked = False
        self.params = params
        self.restart_interval = restart_interval
        self._geom = EncoderGeometry(params, restart_interval)
        self.scans = self._geom.scans
        sched = self._geom.block_schedule_array()
        self.n_blocks = len(sched)
        self.comp_idx = sched[:, 0].astype(np.int32)
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
            dest = np.flatnonzero(sched[:, 0] == si)
            take = (sched[dest, 2] // 8) * nbx + sched[dest, 1] // 8
            self.gather.append((take.astype(np.int32),
                                dest.astype(np.int32), s.height // 8, nbx))
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
        sched = np.resize(self.comp_idx[:self.blocks_per_segment],
                          self.blocks_per_segment)
        return {"quant": self.quant, "comp_idx": self.comp_idx,
                "perm": self.perm, "gather": self.gather,
                "tables": device_encoder_tables(self.tables),
                "prev_same_comp": np.array(prev_same_component(sched),
                                           dtype=np.int32)}

    def load_state(self, state: EncoderState) -> None:
        """Compute with ``state`` from here on."""
        if int(state.quant.min()) < 1 or state.quant.shape != (self.n_blocks,
                                                               64):
            raise ValueError("encoder quant must be (n_blocks, 64), >= 1")
        if state.prev_same_comp.shape != (self.blocks_per_segment,):
            raise ValueError("prev_same_comp must be (blocks_per_segment,)")
        self.state = state
        self._comp_sched = _segment_rows(state.comp_idx,
                                         self.blocks_per_segment)
        self._valid = {}
        self._local = {}     # f → this mesh rank's block gather (K3 run)

    # -- planes → quantized coefficients ------------------------------------
    def load_planes(self, frame) -> list[np.ndarray]:
        """Blit a Frame, a single Plane or bare (y, u, v) uint8 arrays
        into zero-padded scan planes."""
        if isinstance(frame, Frame):
            sources = [frame.y.data, frame.u.data, frame.v.data]
        elif isinstance(frame, Plane):
            sources = [frame.data]
        else:
            sources = frame
        out = []
        for s, src in zip(self.scans, sources):
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
        per-segment byte budget: sp is a frame's segments padded to a
        multiple of the mesh size, cap the worst-case wire size."""
        B = self.blocks_per_segment
        n_seg = (self.n_blocks + B - 1) // B
        n_dev = _mesh_size(self.mesh)
        sp = -(-n_seg // n_dev) * n_dev
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

    def _pack_route(self, S: int, max_seg_bytes: int) -> str:
        """The packer of a dispatch of S segments at a raw byte budget:
        "fused" (K4), "split" (K9 + K8) or "gather" (plain torch). A
        function of (B, budget, S), so a rung of the budget ladder may
        change route."""
        B = self.blocks_per_segment
        how = self.device_pack
        if how == "auto":
            wide = pack_stuff.max_lane_chunk(B, max_seg_bytes) >= 128
            how = "pallas" if wide and S >= 64 else "xla"
        if how == "xla":
            return "gather"
        return "fused" if B <= pack_stuff.FUSED_MAX_BLOCKS else "split"

    def _pack_graph(self, qc_seg: torch.Tensor, f: int, max_seg_bytes: int,
                    first: int = 0):
        """(S, B·64) int32 coefficients of the segments ``first`` ..
        ``first + S`` of f·sp → (bufs (f, cap) uint8, totals (f,), max
        segment length, overflow) — the routed entropy encode then the
        wire assembly (the reference's _pack_graph). On a mesh, S is this
        rank's run and the lengths, buffers and overflow flag are joined
        over the mesh. An ``encode.launch`` span (stage ``pack``:
        ``route``, ``segments`` S, ``budget`` the rung's byte budget)."""
        B, n_blocks, n_seg, sp, n_padded, m_out, cap = self._enc_geometry(
            max_seg_bytes)
        S = qc_seg.shape[0]
        route = self._pack_route(S, max_seg_bytes)
        with trace.span("encode.launch", stage="pack", route=route,
                        segments=S, budget=max_seg_bytes):
            valid = self._valid_batch(f)[first:first + S]
            if route == "fused":
                out, lens, overflow = encode_segments(
                    qc_seg, valid, self._comp_sched, self.state.dctab,
                    self.state.actab, m_out=m_out)
            else:
                fn = (pack_stuff.encode_segments_split if route == "split"
                      else gather_pack.encode_segments_device)
                st = self.state
                out, lens, overflow = fn(
                    qc_seg.view(-1, 64), self._comp_sched.repeat(S),
                    st.prev_same_comp, st.dctab, st.actab,
                    blocks_per_segment=B, max_seg_bytes=max_seg_bytes,
                    valid=valid.reshape(-1) if n_padded != n_blocks
                    else None)
            lens_all = lens
            if self.mesh is not None:
                group = flat_group(self.mesh)
                lens_all = torch.empty(f * sp, dtype=lens.dtype,
                                       device=lens.device)
                dist.all_gather_into_tensor(lens_all, lens.contiguous(),
                                            group=group)
                overflow = overflow.to(torch.int32).view(1)
                dist.all_reduce(overflow, op=dist.ReduceOp.MAX, group=group)
                overflow = overflow[0] != 0
            bufs, totals = assemble_frames(out, lens, frames=f, n_seg=n_seg,
                                           cap=cap, lens_all=lens_all,
                                           first=first)
            if self.mesh is not None:
                dist.all_reduce(bufs, group=group)
            max_len = lens_all.view(f, sp)[:, :n_seg].max()
            return bufs, totals, max_len, overflow

    def _encode_qc_local(self, stacked) -> tuple[torch.Tensor, int]:
        """Per-scan (f, H, W) uint8 stacks → (this rank's contiguous run of
        the f·sp padded segments as (S, B·64) int32, its first segment):
        K3 on the run's real blocks only, zero coefficients in the padding
        (as ``_pad_segments`` gives)."""
        f = stacked[0].shape[0]
        B, n_blocks, _n, sp, n_padded, _m, _c = self._enc_geometry(0)
        step = f * sp // self.mesh.size()
        first = mesh_index(self.mesh) * step
        if f not in self._local:
            pos = np.arange(first * B, (first + step) * B)
            k = pos % n_padded
            real = k < n_blocks
            total = sum(nby * nbx for nby, nbx in self.state.plane_dims)
            src = (pos // n_padded) * total + self.perm[np.minimum(
                k, n_blocks - 1)]
            self._local[f] = tuple(
                _upload(a, self.device).to(torch.int64) for a in
                (src[real], k[real], np.flatnonzero(real)))
        src, qrow, dst = self._local[f]
        out = torch.zeros((step * B, 64), dtype=torch.int32,
                          device=self.device)
        if not dst.numel():          # a run of padding segments only
            return out.view(step, B * 64), first
        blocks = torch.cat([_blocks_from_plane(p, nby, nbx)
                            for p, (nby, nbx) in zip(stacked,
                                                     self.state.plane_dims)],
                           dim=1).reshape(-1, 8, 8)
        out[dst] = datapath.encode_datapath(
            blocks[src], self.state.quant[qrow].contiguous())
        return out.view(step, B * 64), first

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

    def _run_enc_ladder_batch(self, launch,
                              F: int) -> tuple[list[bytes], int]:
        """``launch(msb)`` → (bufs (F, CAP), totals (F,), max_len,
        overflow) on the device. Walks the budget ladder until a launch
        does not overflow; with a known body cap the capped bodies come
        back in the same fetch as the scalars. Returns the F bodies and
        the launches taken. Each copy to the host is an ``encode.fetch``
        span (``bytes``, ``rung``: the launch's place on the ladder,
        ``overflow``)."""
        cap = self._body_cap
        bodies = None
        for rung, msb in enumerate(self._enc_budget_ladder()):
            bufs, totals, max_len, overflow = launch(msb)
            with trace.span("encode.fetch", rung=rung, bytes=8 * (F + 2)):
                meta = torch.cat([totals.to(torch.int64),
                                  max_len.to(torch.int64).view(1),
                                  overflow.to(torch.int64).view(1)]).cpu()
                totals_np = meta[:F].numpy()
                max_i, ovf = int(meta[F]), bool(meta[F + 1])
                trace.attrs(overflow=int(ovf))
            if ovf:
                continue
            top = int(totals_np.max())
            capped = cap is not None and top <= cap
            width = cap if capped else top
            with trace.span("encode.fetch", rung=rung, bytes=F * width,
                            overflow=0):
                host = bufs[:, :width].cpu().numpy()
            if not capped:
                self._body_cap = self._body_bucket(top)
            bodies = [host[f, :totals_np[f]].tobytes() for f in range(F)]
            break
        else:
            raise ValueError("device entropy encode overflow")
        self._record_seg_bytes(max_i)
        return bodies, rung + 1

    @functools.cached_property
    def _header_bytes(self) -> bytes:
        """SOI..SOS header bytes — fixed for the session's parameters."""
        w = BitWriter()
        self._geom.write_headers(w)
        return w.get_buffer()

    def _encode_stacked(self, stacked) -> list[bytes]:
        """Per-scan (f, H, W) uint8 stacks on the device → f JPEG streams:
        an ``encode.dispatch`` span (``frames``, ``bytes_out``, ``rungs``)
        over an ``encode.launch`` (stage ``datapath``: the block gather, K3
        and the segment pad), the ladder's launches and fetches, and the
        ``encode.wire`` join."""
        f = stacked[0].shape[0]
        with trace.span("encode.dispatch", frames=f):
            with trace.span("encode.launch", stage="datapath"):
                if self.mesh is None:
                    qc_seg = self._pad_segments(
                        self._encode_qc_batch(stacked), f)
                    first = 0
                else:
                    qc_seg, first = self._encode_qc_local(stacked)
            bodies, rungs = self._run_enc_ladder_batch(
                lambda msb: self._pack_graph(qc_seg, f, msb, first), f)
            with trace.span("encode.wire"):
                hdr = self._header_bytes
                out = [b"".join((hdr, body, _EOI)) for body in bodies]
            trace.attrs(bytes_out=sum(map(len, out)), rungs=rungs)
        return out

    def encode_device(self, frame) -> bytes:
        """One Frame (or bare planes) → JPEG bytes with the block numerics
        and the entropy packing on the device: only planes go up and the
        assembled wire bytes come back."""
        return self.encode_device_batch([frame])[0]

    def encode_planes_device(self, planes) -> bytes:
        """(y, u, v) uint8 arrays (zero-padded to the scan planes) → JPEG
        bytes."""
        return self.encode_device_batch([planes])[0]

    def _stack_frames(self, frames: list) -> list[torch.Tensor]:
        """Frames → per-scan (F, H, W) uint8 stacks on the device."""
        planes = [self.load_planes(f) for f in frames]
        return [_upload(np.stack([p[i] for p in planes]), self.device)
                for i in range(len(self.scans))]

    def encode_device_batch(self, frames: list) -> list[bytes]:
        """Frames (Frame objects or (y, u, v) uint8 arrays) → JPEG bytes
        each: one batched device pass for numerics, entropy and wire
        assembly."""
        return self._encode_stacked(self._stack_frames(frames))

    # -- device quantization + per-frame entropy ----------------------------
    def _quantize_stacked(self, stacked) -> np.ndarray:
        """Per-scan (f, H, W) uint8 stacks on the device → (f, n_blocks,
        64) quantized coefficients on the host. With sparse transfer only
        the occupancy bitmask and the nonzeros cross the link; a value
        budget that proves too small falls back to dense for this call and
        doubles for later ones."""
        f = stacked[0].shape[0]
        n = f * self.n_blocks
        qc = self._encode_qc_batch(stacked)
        if self._sparse:
            cap = self._cap_per_block * n
            mask, values, nnz = sparse.pack_device(qc, cap)
            nnz = int(nnz)
            if nnz <= cap:
                self._adapt_cap(nnz, n)
                return sparse.unpack_host(
                    mask.cpu().numpy(), values[:nnz].cpu().numpy(), nnz,
                    n).reshape(f, self.n_blocks, 64)
            self._cap_per_block = min(64, max(1, self._cap_per_block) * 2)
        # quantized coefficients are bounded by ±1024: int16 halves the
        # download
        return qc.to(torch.int16).cpu().numpy().reshape(f, self.n_blocks,
                                                        64)

    def quantize_device(self, planes) -> np.ndarray:
        """Padded planes (numpy arrays or tensors) → (n_blocks, 64)
        quantized coefficients on the host (int16 dense, int32 sparse)."""
        stacked = [(p if isinstance(p, torch.Tensor)
                    else torch.from_numpy(np.ascontiguousarray(p)))
                   .to(self.device)[None] for p in planes]
        return self._quantize_stacked(stacked)[0]

    def _adapt_cap(self, nnz: int, total_blocks: int) -> None:
        """Shrink the sparse value budget toward the observed density
        (power-of-two buckets, 2x headroom), once: content density is
        stable within a session. Growth happens only on overflow."""
        if self._cap_locked:
            return
        per_block = max(2, -(-2 * nnz // total_blocks))
        target = 1 << (per_block - 1).bit_length()
        if target < self._cap_per_block:
            self._cap_per_block = target
        self._cap_locked = True

    def _assemble(self, segments: list[bytes]) -> bytes:
        """Header + byte-aligned segments interleaved with RSTn + EOI."""
        return b"".join((self._header_bytes,
                         entropy_scan.join_segments(segments), _EOI))

    def _entropy_frame(self, qcoefs: np.ndarray) -> bytes:
        """One frame's (n_blocks, 64) coefficients → JPEG bytes by
        ``self.entropy``."""
        args = (qcoefs, self.comp_idx, self.blocks_per_segment, self.tables)
        if self.entropy == "tpu":
            return self._assemble(gather_pack.encode_scan_tpu(
                *args, device=self.device))
        if self.entropy == "native":
            return b"".join((self._header_bytes,
                             entropy_scan.encode_scan_stream(*args), _EOI))
        return self._assemble(entropy_scan.encode_scan(*args,
                                                       use_native=False))

    def encode_planes(self, planes) -> bytes:
        """Padded planes (numpy arrays or tensors) → JPEG bytes: device
        quantization, the coefficient download, then the entropy coder of
        ``self.entropy``."""
        return self._entropy_frame(self.quantize_device(planes))

    def encode(self, frame) -> bytes:
        return self.encode_planes(self.load_planes(frame))

    def _entropy_frames(self, q_batch: np.ndarray) -> list[bytes]:
        """(f, n_blocks, 64) host coefficients → f JPEG streams, the
        entropy coder of ``self.entropy`` per frame on the standing pool
        (``scan.pool_map``)."""
        return pool_map(self._entropy_frame, q_batch)

    def encode_batch(self, frames: list) -> list[bytes]:
        """Encode many frames: one batched device call for the block
        numerics and one download, then the entropy coder per frame on
        the standing pool."""
        return self._entropy_frames(
            self._quantize_stacked(self._stack_frames(frames)))

    def encode_iter(self, frames, depth: int = 2):
        """Pipelined streaming encode: an ordered generator of JPEG byte
        strings with up to ``depth`` frames in flight — frame i's entropy
        coding overlaps frame i+1's device quantization and download."""
        return _pipelined_map(self.encode, frames, depth)


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
    leaving the device: Huffman decode → K2 → plane assembly → pad clean →
    K3 → K4 → wire assembly. Host traffic per frame = two compressed
    bitstreams. Restart-free input takes the decoder's indexed route, so a
    camera JPEG comes out restart-segmented.

    ``entropy_out`` says where the output's entropy is coded:
    ``"device"`` (as above), ``"host"`` (after K3 the quantized
    coefficients come down, sparse on a GPU, and the encoder session's
    host entropy engine codes each frame) or ``"auto"``, which is
    ``"device"`` on every device. (The reference picks ``"host"`` off its
    accelerator because its C++ coder beats its simulated device packer on
    a CPU; the port keeps ``"device"`` there, so a CPU run checks the
    plain versions of the device packers.) Both give the same bytes.

    ``mesh`` goes to both halves (see the sessions' ``mesh``): the decode
    is sharded and gathered, then the encode sharded and joined — two
    steps, as the reference takes with a mesh."""

    ENTROPY_OUT = ("auto", "device", "host")

    def __init__(self, header: Header, quality: int = 75,
                 restart_interval: int = 0, device=None,
                 entropy_out: str = "auto", mesh=None):
        self.device = _session_device(device, mesh)
        if entropy_out not in self.ENTROPY_OUT:
            raise ValueError(f"entropy_out must be one of {self.ENTROPY_OUT}"
                             f", got {entropy_out!r}")
        self.entropy_out = "device" if entropy_out == "auto" else entropy_out
        frame_hdr = header.frame
        if frame_hdr is None or len(frame_hdr.components) != 3:
            raise DecodeError("transcode supports 3-component scans")
        self.decoder = JpegDecoderSession(header, device=self.device,
                                          mesh=mesh)
        maker = _parameters_maker(frame_hdr)
        params = maker(frame_hdr.width, frame_hdr.height, quality)
        self.encoder = JpegEncoderSession(params, restart_interval,
                                          device=self.device, mesh=mesh)
        # the preset keeps the stream's chroma sizes; its MCU may differ
        # (libjpeg's 4:2:2 is 2x1/1x1/1x1, the preset 2x2/1x2/1x2), and so
        # may the padded plane sizes
        scans = self.encoder.scans
        hmax = max(s.hscale for s in scans)
        vmax = max(s.vscale for s in scans)
        for comp, scan in zip(self.decoder.components, scans):
            if (comp.actual_height, comp.actual_width) != (
                    frame_hdr.height * scan.vscale // vmax,
                    frame_hdr.width * scan.hscale // hmax):
                raise DecodeError("transcode geometry mismatch")
        self._pad_masks = [(comp.actual_height, comp.actual_width)
                           for comp in self.decoder.components]
        self._enc_dims = [(s.height, s.width) for s in scans]

    def _clean_planes(self, stacks) -> list[torch.Tensor]:
        """Each plane stack zeroed outside the frame's actual size and
        cut or zero-padded to the encoder's plane size, so the output
        bytes are those of a host-roundtrip re-encode (load_planes pads
        with zeros). An ``encode.launch`` span of stage ``datapath``, before
        the encoder's ``encode.dispatch``."""
        cleaned = []
        with trace.span("encode.launch", stage="datapath"):
            for p, (ah, aw), (eh, ew) in zip(stacks, self._pad_masks,
                                             self._enc_dims):
                if not ah == eh == p.shape[1] or not aw == ew == p.shape[2]:
                    fitted = p.new_zeros((p.shape[0], eh, ew))
                    fitted[:, :ah, :aw] = p[:, :ah, :aw]
                    p = fitted
                cleaned.append(p)
        return cleaned

    def transcode(self, entropy_data: bytes) -> bytes:
        return self.transcode_batch([entropy_data])[0]

    def transcode_batch(self, entropy_list: list[bytes]) -> list[bytes]:
        """F frames' entropy bytes → F JPEG streams: one device pass, then
        (``entropy_out="host"``) one download and the host coder per
        frame."""
        cleaned = self._clean_planes(
            self.decoder._stacked(entropy_list, frame_sharded=False))
        enc = self.encoder
        if self.entropy_out == "host":
            return enc._entropy_frames(enc._quantize_stacked(cleaned))
        return enc._encode_stacked(cleaned)

    def transcode_iter(self, entropy_iter, depth: int = 2):
        """Pipelined streaming transcode: an ordered generator of JPEG
        byte strings with up to ``depth`` frames in flight — frame i's
        host work overlaps frame i+1's device work (one frame at a time on
        a mesh)."""
        return _pipelined_map(self.transcode, entropy_iter,
                              _mesh_depth(self.decoder.mesh, depth))

    def transcode_batch_iter(self, entropy_iter, batch: int = 8,
                             depth: int = 2):
        """Pipelined batched transcode: chunks of ``batch`` frames each run
        as one transcode_batch, with up to ``depth`` chunks in flight so
        chunk i's host prep and fetch overlap chunk i+1's device work.
        Yields frames in order (one chunk at a time on a mesh)."""
        for outs in _pipelined_map(self.transcode_batch,
                                   _chunked(entropy_iter, batch),
                                   _mesh_depth(self.decoder.mesh, depth)):
            yield from outs


def decode_jpeg(data: bytes, resync: bool = False, device=None):
    """One-shot decode of a whole JPEG byte stream through
    ``JpegDecoderSession.decode`` (the host-entropy route). Multi-scan
    (non-interleaved) streams go to the model's ``MultiScanDecoder``, on
    the host in numpy: the sessions assume the one interleaved scan every
    camera and encoder emits."""
    bits = BitReader(data)
    header = Header.decode(bits)
    if (header.frame is not None and header.scan is not None
            and len(header.scan.scan_components)
            < len(header.frame.components)):
        mdec = MultiScanDecoder(header, bits)
        mdec.decode(resync=resync)
        return mdec.get_yuv_frame()
    session = JpegDecoderSession(header, device=device)
    return session.decode(data[bits.bit_pos >> 3:], resync=resync)


def encode_jpeg(frame: Frame, quality: int = 75,
                subsampling: ChromaSubsampling = ChromaSubsampling.C420,
                restart_interval: int = 0, device=None) -> bytes:
    """One-shot encode of a Frame."""
    params = SUBSAMPLING_PRESETS[subsampling](frame.width, frame.height,
                                              quality)
    return JpegEncoderSession(params, restart_interval,
                              device=device).encode(frame)
