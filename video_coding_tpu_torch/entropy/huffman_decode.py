"""The Huffman decode kernels K1, K5, K6 and K7, each with its plain
PyTorch version beside it.

All four run one automaton per lane — DC code + magnitude, then AC
(run, size) codes + magnitudes until EOB or position 63 — against
canonical range tables (``range_tables``; row t = comp for DC, C + comp
for AC; values are (run<<4 | size) bytes), with DC differences
accumulating per component, into (S, B, 64) int32 zigzag coefficients,
zero where nothing was decoded. They differ in how a lane's bytes are
given, what a peek past the lane's end reads, whether written values are
saturated, and where the symbol cap sits:

``decode_flat`` (K1, the reference's ``decode_flat_pallas_t``)
    lane s is ``flat[starts[s] : starts[s] + lens[s]]``; bytes past the
    length read as zero; values saturated to int16; a cap of
    2·((65·B + 64)//2 + 2) symbols a lane. With the start-state hooks a
    lane begins at bit ``init_bitpos[s]`` of its byte range with the DC
    predictors ``init_dc[s]`` (the virtual segments of a restart-free
    stream; the block count ends such a lane, not its length).
``decode_flat_staged`` (K7, ``decode_flat_pallas_dma``)
    K1's arguments and K1's result, bit for bit; the kernel copies each
    lane's 16-byte rows into shared memory itself and runs K1's loop on
    them.
``decode_segments`` (K5, ``decode_segments_pallas``)
    lane s is row s of a padded (S, L) matrix; peeks read the reference's
    byte-granular 32-bit windows with a clamped index; values not
    saturated; K1's cap (it never binds: a block ends within 64 symbols).
    Two regimes by shape (``k5_regime``): a thread a row for many short
    rows, a CTA a row (K6's self-synchronising decode) for long ones.
``decode_segments_streamed`` (K6, ``decode_segments_pallas_bs``)
    as K5 with 16-bit-stride windows, for long segments: whole blocks
    are written out (blocks at or past ``seg_blocks[s]`` as zeros) and
    the cap is 134 symbols a block (it never binds: a block ends within
    64 symbols).

K1, K5, K6 and K7 look symbols up in ``decode_lut``, a two-level table built
from the range tables on every call (2^``LUT_BITS`` entries per table row,
then ``LUT_POOL`` blocks for the prefixes of longer codes), and run the
range match only where the blocks run out.

Every wrapper runs its plain version for CPU tensors and launches its
CUDA kernel for CUDA tensors (or raises).

``decode_segments_lut_plain`` is the reference's flat-table loop
(``decode_segments_device``) in plain PyTorch, on any device: the padded
matrix with unpadded windows, one load from the tables expanded to every
16-bit window a symbol, values not saturated. The decoder session runs it
only when ``device_huffman="lut"`` is asked for.
"""

from __future__ import annotations

import torch

import numpy as np

from .. import kernels
from ..device import resolve_device
from ..runtime import trace
from .decode_tables import (auto_strategy, expand_luts, pack_segments,
                            range_tables)

MAX_COMPONENTS = 4
# K6's symbol cap a block: the reference's (66 + 64)//2 + 2 iterations of
# two symbols
BLOCK_STEPS = 2 * ((66 + 64) // 2 + 2)


# lookup table: index bits of the 16-bit window at level 1, level-2
# blocks (one per prefix whose windows disagree), the level-1 entry that
# names a block (| its slot) and the one that sends a symbol to the range
# match
LUT_BITS = 10
LUT_POOL = 32
LUT_POOLED = 0x8000
LUT_FALLBACK = 0xC000
# K6's subsequence length in bits (one a thread at a time; see
# csrc/huffman_decode_streamed.cu)
STREAMED_SUB_BITS = 1024
# what K6 records for each row; K5's "row" regime records the same and
# whether the row was staged in shared memory (1) or read from global (0)
STREAMED_STATS = ("rounds", "subsequences", "threads")
K5_ROW_STATS = STREAMED_STATS + ("staged",)
# K5's regimes, in the order of the C entry's ``regime`` argument, and the
# "row" regime's subsequence length in bits (read at each call)
K5_REGIMES = ("lane", "row")
PADDED_ROW_SUB_BITS = 2048


def max_steps(blocks_per_segment: int) -> int:
    """Per-lane symbol cap, equal to the reference kernel's iteration cap
    times its two symbols per iteration."""
    return 2 * ((blocks_per_segment * 65 + 64) // 2 + 2)


# --- plain versions ---------------------------------------------------------

def _stream_peek(flat, starts, lens):
    """peek16(bitpos) over lanes of a flat buffer: the 16 stream bits at
    ``bitpos`` of every lane (int64), bytes past the lane's length read
    as zero."""
    starts = starts.to(torch.int64)
    lens = lens.to(torch.int64)
    last = flat.numel() - 1

    def peek16(bitpos):
        byte0 = bitpos >> 3
        word = torch.zeros_like(bitpos)
        for k in range(3):
            pos = byte0 + k
            if last >= 0:
                b = flat[(starts + pos).clamp(0, last)].to(torch.int64)
                b = torch.where(pos < lens, b, torch.zeros_like(b))
            else:
                b = torch.zeros_like(pos)
            word = (word << 8) | b
        return (word >> (8 - (bitpos & 7))) & 0xFFFF

    return peek16


def _window_peek(segbytes, unit: int, tile: int):
    """peek16(bitpos) over the rows of a padded (S, L) matrix, as the
    reference kernels read them: one big-endian 32-bit window per
    ``unit`` bytes, the window array zero-padded to a multiple of
    ``tile``, and 16 bits taken from window clamp(bitpos // (8·unit), 0,
    padded count - 1) at offset bitpos % (8·unit)."""
    S, L = segbytes.shape
    seg = segbytes.to(torch.int64)
    if unit == 1:
        n = L - 3
        parts = [seg[:, k:k + n] for k in range(4)]
    else:
        n = max((L - 2) // 2, 1)
        parts = [seg[:, k:k + 2 * n - 1:2] for k in range(4)]
    words = (parts[0] << 24) | (parts[1] << 16) | (parts[2] << 8) | parts[3]
    n_pad = -(-n // tile) * tile
    words = torch.nn.functional.pad(words, (0, n_pad - n))
    lane = torch.arange(S, device=segbytes.device)
    ushift = 3 if unit == 1 else 4

    def peek16(bitpos):
        w32 = words[lane, (bitpos >> ushift).clamp(0, n_pad - 1)]
        return (w32 >> (16 - (bitpos & (8 * unit - 1)))) & 0xFFFF

    return peek16


def _match_plain(w16, lo_t, hi_t, off_t, values):
    """The range match of 16-bit windows ``w16`` (N,) against table rows
    lo_t/hi_t/off_t (N, 16): (code length, data byte), int64; the sum
    over matching lengths, (0, 0) where none matches."""
    lens16 = torch.arange(1, 17, device=w16.device, dtype=torch.int64)
    valid = (w16[:, None] >= lo_t) & (w16[:, None] < hi_t)
    code_len = torch.where(valid, lens16, 0).sum(1)
    lo_sel = torch.where(valid, lo_t, 0).sum(1)
    off_sel = torch.where(valid, off_t, 0).sum(1)
    shift = 16 - code_len.clamp(1, 16)
    idx = (off_sel + ((w16 - lo_sel) >> shift)).clamp(0, values.shape[0] - 1)
    return code_len, torch.where(code_len > 0, values[idx] & 0xFF, 0)


def _symbol_loop_plain(peek16, seg_blocks, comp_sched, lo, hi, offset,
                       values, *, blocks_per_segment: int, n_components: int,
                       saturate: bool, total_cap, block_cap,
                       init_bitpos=None, init_dc=None,
                       lookup=None) -> torch.Tensor:
    """The symbol loop of all four kernels, vectorized over lanes. With
    ``lookup`` (a callable (table row t, window w16) → (code length,
    data), int64), symbols come from it instead of the range tables,
    which may then be None."""
    dev = seg_blocks.device
    S = seg_blocks.shape[0]
    B = blocks_per_segment
    C = n_components
    nblk = seg_blocks.to(torch.int64).clamp(max=B)
    sched = comp_sched.to(torch.int64)
    if lookup is None:
        lo, hi, off = (x.to(torch.int64) for x in (lo, hi, offset))
        values = values.to(torch.int64)

        def lookup(t, w16):
            return _match_plain(w16, lo[t], hi[t], off[t], values)
    lane = torch.arange(S, device=dev, dtype=torch.int64)
    zero = torch.zeros(S, device=dev, dtype=torch.int64)

    bitpos = zero.clone() if init_bitpos is None \
        else init_bitpos.to(torch.int64).clone()
    dc = torch.zeros((S, C), device=dev, dtype=torch.int64) \
        if init_dc is None else init_dc.to(torch.int64).clone()
    blk = zero.clone()
    cof = zero.clone()
    bsteps = zero.clone()
    in_ac = torch.zeros(S, device=dev, dtype=torch.bool)
    # one extra slot absorbs the writes of lanes that write nothing
    out = torch.zeros(S * B * 64 + 1, device=dev, dtype=torch.int32)
    sink = S * B * 64
    step = 0
    while total_cap is None or step < total_cap:
        active = blk < nblk
        if step % 16 == 0 and not bool(active.any()):
            break
        step += 1
        # schedule entries past the tables clamp to the last component, as
        # in the kernels (the sessions never produce them)
        comp = sched[blk.clamp(0, B - 1)].clamp(0, C - 1)
        t = comp + torch.where(in_ac, C, 0)
        w16 = peek16(bitpos)
        code_len, data = lookup(t, w16)
        run = torch.where(in_ac, (data >> 4) & 0xF, 0)
        cat = torch.where(in_ac, data & 0xF, data).clamp(max=16)
        code = peek16(bitpos + code_len) >> (16 - cat.clamp(min=1))
        one = torch.ones_like(cat)
        neg = (code & (one << (cat - 1).clamp(min=0))) == 0
        val = torch.where(neg, code - (one << cat) + 1, code)
        val = torch.where(cat > 0, val, 0)
        bitpos = torch.where(active, bitpos + code_len + cat, bitpos)

        # DC phase
        is_dc = ~in_ac & active
        dc_val = dc[lane, comp] + torch.where(is_dc, val, 0)
        dc[lane, comp] = dc_val
        # AC phase
        is_eob = in_ac & (run == 0) & (cat == 0)
        nc = cof + run
        write_ac = in_ac & ~is_eob & active & (nc < 64)
        do_write = is_dc | write_ac
        wcof = torch.where(is_dc, 0, nc.clamp(0, 63))
        wval = torch.where(is_dc, dc_val, val)
        if saturate:
            wval = wval.clamp(-32768, 32767)
        widx = torch.where(do_write,
                           (lane * B + blk.clamp(0, B - 1)) * 64 + wcof, sink)
        out[widx] = wval.to(torch.int32)

        cof_after = torch.where(in_ac, torch.where(is_eob, 64, nc + 1), 1)
        done = in_ac & (is_eob | (cof_after >= 64))
        if block_cap is not None:
            # a block that reaches its cap is left as it stands
            bsteps = bsteps + 1
            done = done | (bsteps >= block_cap)
            bsteps = torch.where(done, 0, bsteps)
        blk = torch.where(done & active, blk + 1, blk)
        in_ac = torch.where(done, False, torch.where(in_ac, in_ac, True))
        cof = torch.where(done, 0, cof_after)
    return out[:sink].reshape(S, B, 64)


def _staged_view(starts, lens, init_bitpos):
    """K7's view of a lane: it starts at its 16-byte row, the slack before
    the segment rides the bit cursor and the effective length."""
    slack = starts & 15
    bitpos = 8 * slack if init_bitpos is None else 8 * slack + init_bitpos
    return starts - slack, lens + slack, bitpos


def decode_flat_plain(flat, starts, lens, seg_blocks, comp_sched, lo, hi,
                      offset, values, *, blocks_per_segment: int,
                      n_components: int, init_bitpos=None,
                      init_dc=None) -> torch.Tensor:
    """Plain PyTorch K1."""
    return _symbol_loop_plain(
        _stream_peek(flat, starts, lens), seg_blocks, comp_sched, lo, hi,
        offset, values, blocks_per_segment=blocks_per_segment,
        n_components=n_components, saturate=True,
        total_cap=max_steps(blocks_per_segment), block_cap=None,
        init_bitpos=init_bitpos, init_dc=init_dc)


def decode_flat_staged_plain(flat, starts, lens, seg_blocks, comp_sched, lo,
                             hi, offset, values, *, blocks_per_segment: int,
                             n_components: int, init_bitpos=None,
                             init_dc=None) -> torch.Tensor:
    """Plain PyTorch K7: K1's loop on the row-aligned view of each lane."""
    row_starts, lens_eff, bitpos = _staged_view(starts, lens, init_bitpos)
    return decode_flat_plain(
        flat, row_starts, lens_eff, seg_blocks, comp_sched, lo, hi, offset,
        values, blocks_per_segment=blocks_per_segment,
        n_components=n_components, init_bitpos=bitpos, init_dc=init_dc)


def decode_segments_plain(segbytes, seg_blocks, comp_sched, lo, hi, offset,
                          values, *, blocks_per_segment: int,
                          n_components: int) -> torch.Tensor:
    """Plain PyTorch K5."""
    return _symbol_loop_plain(
        _window_peek(segbytes, 1, 128), seg_blocks, comp_sched, lo, hi,
        offset, values, blocks_per_segment=blocks_per_segment,
        n_components=n_components, saturate=False,
        total_cap=max_steps(blocks_per_segment), block_cap=None)


def decode_segments_streamed_plain(segbytes, seg_blocks, comp_sched, lo, hi,
                                   offset, values, *, blocks_per_segment: int,
                                   n_components: int) -> torch.Tensor:
    """Plain PyTorch K6."""
    return _symbol_loop_plain(
        _window_peek(segbytes, 2, 8), seg_blocks, comp_sched, lo, hi,
        offset, values, blocks_per_segment=blocks_per_segment,
        n_components=n_components, saturate=False, total_cap=None,
        block_cap=BLOCK_STEPS)


def lut_steps(blocks_per_segment: int) -> int:
    """Per-lane symbol cap of the ``"lut"`` strategy: the reference loop's
    iteration cap times its four symbols per iteration."""
    return 4 * ((blocks_per_segment * 65 + 64) // 4 + 2)


def decode_segments_lut_plain(segbytes, seg_blocks, comp_sched, luts, *,
                              blocks_per_segment: int,
                              n_components: int) -> torch.Tensor:
    """The ``"lut"`` strategy, a plain PyTorch loop on any device (the
    reference's ``decode_segments_device``): the padded (S, L) matrix
    read through byte-granular 32-bit windows (clamped, no tile padding),
    symbols looked up in the expanded tables ``luts`` (2C, 65536) int32
    (rows [0, C) DC, [C, 2C) AC; entry (code_length << 16) | data),
    values not saturated → (S, B, 64) int32."""
    luts = luts.to(torch.int64)

    def lookup(t, w16):
        entry = luts[t, w16]
        return entry >> 16, entry & 0xFFFF

    return _symbol_loop_plain(
        _window_peek(segbytes, 1, 1), seg_blocks, comp_sched, None, None,
        None, None, blocks_per_segment=blocks_per_segment,
        n_components=n_components, saturate=False,
        total_cap=lut_steps(blocks_per_segment), block_cap=None,
        lookup=lookup)


def decode_lut_plain(lo, hi, offset, values) -> torch.Tensor:
    """Plain PyTorch form of the lookup table, int16 (T·2^LUT_BITS +
    LUT_POOL·2^(16 - LUT_BITS),): level-1 entry (t, i) is
    (code_len << 8) | data when every 16-bit window whose top LUT_BITS
    bits are i gives that match in row t (and code_len <= 16); else the
    prefixes, in order, take level-2 blocks (entry LUT_POOLED | slot; the
    block holds (code_len << 8) | data of each of the prefix's windows)
    until they run out, and the rest get LUT_FALLBACK. Unused blocks are
    zero."""
    T = lo.shape[0]
    span = 1 << (16 - LUT_BITS)
    w16 = torch.arange(1 << 16, device=lo.device, dtype=torch.int64)
    values = values.to(torch.int64)
    res = []
    for t in range(T):
        lo_t, hi_t, off_t = (x[t].to(torch.int64).expand(1 << 16, 16)
                             for x in (lo, hi, offset))
        code_len, data = _match_plain(w16, lo_t, hi_t, off_t, values)
        res.append(((code_len << 8) | data).view(1 << LUT_BITS, span))
    res = torch.cat(res)                       # (T·2^LUT_BITS, span)
    uniform = (res == res[:, :1]).all(1) & (res[:, 0] >> 8 <= 16)
    level1 = torch.where(uniform, res[:, 0], LUT_FALLBACK)
    marked = torch.nonzero(~uniform).flatten()
    pooled = marked[:LUT_POOL]
    level1[pooled] = LUT_POOLED + torch.arange(len(pooled), device=lo.device)
    pool = torch.zeros((LUT_POOL, span), dtype=torch.int64, device=lo.device)
    pool[:len(pooled)] = res[pooled]
    return torch.cat([level1, pool.flatten()]).to(torch.int16)


# --- wrappers ---------------------------------------------------------------

def _check(named, dev) -> None:
    """``named``: (name, tensor, dtype, shape) rows; all must be contiguous
    on ``dev``."""
    for name, t, dtype, shape in named:
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


def _table_rows(comp_sched, lo, hi, offset, values, B: int, C: int):
    if not 1 <= C <= MAX_COMPONENTS:
        raise ValueError(f"n_components must be 1..{MAX_COMPONENTS}")
    T = lo.shape[0]
    if T != 2 * C:
        raise ValueError(f"expected {2 * C} range tables, got {T}")
    return [("comp_sched", comp_sched, torch.int32, (B,)),
            ("lo", lo, torch.int32, (T, 16)),
            ("hi", hi, torch.int32, (T, 16)),
            ("offset", offset, torch.int32, (T, 16)),
            ("values", values, torch.int32, (values.shape[0],))]


def _check_flat(flat, starts, lens, seg_blocks, comp_sched, lo, hi, offset,
                values, init_bitpos, init_dc, B: int, C: int) -> None:
    S = starts.shape[0]
    rows = [("flat", flat, torch.uint8, (flat.shape[0],)),
            ("starts", starts, torch.int32, (S,)),
            ("lens", lens, torch.int32, (S,)),
            ("seg_blocks", seg_blocks, torch.int32, (S,))]
    rows += _table_rows(comp_sched, lo, hi, offset, values, B, C)
    if init_bitpos is not None:
        rows.append(("init_bitpos", init_bitpos, torch.int32, (S,)))
    if init_dc is not None:
        rows.append(("init_dc", init_dc, torch.int32, (S, C)))
    _check(rows, starts.device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _lut_buffer(T: int, dev) -> torch.Tensor:
    return torch.empty(T * (1 << LUT_BITS) + LUT_POOL * (1 << (16 - LUT_BITS)),
                       dtype=torch.int16, device=dev)


def decode_lut(lo: torch.Tensor, hi: torch.Tensor, offset: torch.Tensor,
               values: torch.Tensor) -> torch.Tensor:
    """The lookup table of K1, K5, K6 and K7 from the range tables:
    lo/hi/offset int32 (T, 16), values int32 (V,) → int16 (T·2^LUT_BITS +
    LUT_POOL·2^(16 - LUT_BITS),), as ``decode_lut_plain``."""
    T = lo.shape[0]
    _check([("lo", lo, torch.int32, (T, 16)),
            ("hi", hi, torch.int32, (T, 16)),
            ("offset", offset, torch.int32, (T, 16)),
            ("values", values, torch.int32, (values.shape[0],))], lo.device)
    if lo.device.type == "cpu":
        return decode_lut_plain(lo, hi, offset, values)
    lut = _lut_buffer(T, lo.device)
    kernels.launch("vct_huffman_lut", lo.data_ptr(), hi.data_ptr(),
                   offset.data_ptr(), T, values.data_ptr(), values.shape[0],
                   lut.data_ptr())
    decode_lut.launches += 1
    return lut


decode_lut.launches = 0


def decode_flat(flat: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
                seg_blocks: torch.Tensor, comp_sched: torch.Tensor,
                lo: torch.Tensor, hi: torch.Tensor, offset: torch.Tensor,
                values: torch.Tensor, *, blocks_per_segment: int,
                n_components: int, init_bitpos: torch.Tensor | None = None,
                init_dc: torch.Tensor | None = None) -> torch.Tensor:
    """K1: flat uint8 (M,), starts/lens/seg_blocks int32 (S,), comp_sched
    int32 (B,), lo/hi/offset int32 (T, 16), values int32 (V,), optional
    init_bitpos int32 (S,) and init_dc int32 (S, C) → (S, B, 64) int32
    zigzag coefficients."""
    S = starts.shape[0]
    B = blocks_per_segment
    C = n_components
    dev = starts.device
    _check_flat(flat, starts, lens, seg_blocks, comp_sched, lo, hi, offset,
                values, init_bitpos, init_dc, B, C)
    if dev.type == "cpu":
        return decode_flat_plain(flat, starts, lens, seg_blocks, comp_sched,
                                 lo, hi, offset, values,
                                 blocks_per_segment=B, n_components=C,
                                 init_bitpos=init_bitpos, init_dc=init_dc)
    # the kernel's entry point builds the lookup table here first
    lut = _lut_buffer(lo.shape[0], dev)
    # every block is written by the kernel (past a lane's end as zeros)
    out = torch.empty((S, B, 64), dtype=torch.int32, device=dev)
    kernels.launch("vct_k1_huffman_decode", flat.data_ptr(), flat.shape[0],
                   starts.data_ptr(), lens.data_ptr(), seg_blocks.data_ptr(),
                   S, comp_sched.data_ptr(), B, C, lo.data_ptr(),
                   hi.data_ptr(), offset.data_ptr(), lo.shape[0],
                   values.data_ptr(), values.shape[0], lut.data_ptr(),
                   max_steps(B), _ptr(init_bitpos), _ptr(init_dc),
                   out.data_ptr())
    decode_flat.launches += 1
    decode_lut.launches += 1
    if init_bitpos is not None or init_dc is not None:
        decode_flat.hook_launches += 1
    return out


decode_flat.launches = 0
decode_flat.hook_launches = 0   # those of ``launches`` with a start state


def decode_flat_staged(flat: torch.Tensor, starts: torch.Tensor,
                       lens: torch.Tensor, seg_blocks: torch.Tensor,
                       comp_sched: torch.Tensor, lo: torch.Tensor,
                       hi: torch.Tensor, offset: torch.Tensor,
                       values: torch.Tensor, *, blocks_per_segment: int,
                       n_components: int,
                       init_bitpos: torch.Tensor | None = None,
                       init_dc: torch.Tensor | None = None) -> torch.Tensor:
    """K7: K1's arguments and result. ``flat`` must be zero-padded to a
    multiple of 16 bytes. The kernel streams every lane through a fixed
    ring of rows, whatever its length, so it takes no lane-length bucket
    (the reference's ``L``)."""
    S = starts.shape[0]
    B = blocks_per_segment
    C = n_components
    dev = starts.device
    _check_flat(flat, starts, lens, seg_blocks, comp_sched, lo, hi, offset,
                values, init_bitpos, init_dc, B, C)
    if flat.shape[0] % 16:
        raise ValueError("flat: length must be a multiple of 16")
    if dev.type == "cpu":
        return decode_flat_staged_plain(
            flat, starts, lens, seg_blocks, comp_sched, lo, hi, offset,
            values, blocks_per_segment=B, n_components=C,
            init_bitpos=init_bitpos, init_dc=init_dc)
    if flat.data_ptr() % 16:
        raise ValueError("flat: storage must be 16-byte aligned")
    # the kernel's entry point builds the lookup table here first
    lut = _lut_buffer(lo.shape[0], dev)
    # every block is written by the kernel (past a lane's end as zeros)
    out = torch.empty((S, B, 64), dtype=torch.int32, device=dev)
    kernels.launch("vct_k7_huffman_decode_staged", flat.data_ptr(),
                   flat.shape[0], starts.data_ptr(), lens.data_ptr(),
                   seg_blocks.data_ptr(), S, comp_sched.data_ptr(), B, C,
                   lo.data_ptr(), hi.data_ptr(), offset.data_ptr(),
                   lo.shape[0], values.data_ptr(), values.shape[0],
                   lut.data_ptr(), max_steps(B), _ptr(init_bitpos),
                   _ptr(init_dc), out.data_ptr())
    decode_flat_staged.launches += 1
    decode_lut.launches += 1
    return out


decode_flat_staged.launches = 0


def _check_segments(segbytes, seg_blocks, comp_sched, lo, hi, offset, values,
                    B: int, C: int) -> None:
    if segbytes.dim() != 2 or segbytes.shape[1] < 4:
        raise ValueError("segbytes: expected (S, L) with L >= 4, got "
                         f"{tuple(segbytes.shape)}")
    S = segbytes.shape[0]
    rows = [("segbytes", segbytes, torch.uint8, tuple(segbytes.shape)),
            ("seg_blocks", seg_blocks, torch.int32, (S,))]
    rows += _table_rows(comp_sched, lo, hi, offset, values, B, C)
    _check(rows, segbytes.device)


# K5 decodes a CTA a row (the "row" regime) where rows take at least
# K5_ROW_MIN_BYTES and there are at most one of them for every
# K5_ROW_BYTES_PER_ROW bytes of a row, and at most K5_ROW_MAX_ROWS
K5_ROW_MIN_BYTES = 4096
K5_ROW_BYTES_PER_ROW = 4
K5_ROW_MAX_ROWS = 4096


def k5_regime(S: int, L: int, blocks_per_segment: int) -> str:
    """K5's regime for S rows of L bytes and B blocks, by shape alone:
    ``"row"`` (a CTA a row, self-synchronising) where a row holds several
    subsequences (L >= K5_ROW_MIN_BYTES) and there are few enough rows
    (S <= min(L // K5_ROW_BYTES_PER_ROW, K5_ROW_MAX_ROWS)), else
    ``"lane"`` (a thread a row, 32 rows a CTA). The "lane" regime's time
    follows its longest row's serial chain whatever S, the "row" regime's
    grows with S past a wave of CTAs, so the rows it wins on grow with L.
    Rows of 2^24 blocks or more (past the row regime's state) keep
    ``"lane"``. From a sweep of both regimes on the H100 (PERF.md §6):
    "row" is 1.35-17.6x faster inside the rule, and slower at S = 2,048 of
    L = 4,096 (0.85x), S = 4,096 of 8,192 (0.93x), S = 8,160 of 16,384 and
    32,768 (0.80x, 0.95x) and everywhere past S = 1,088 at L = 1,024."""
    if (L >= K5_ROW_MIN_BYTES
            and S <= min(L // K5_ROW_BYTES_PER_ROW, K5_ROW_MAX_ROWS)
            and blocks_per_segment < 1 << 24):
        return "row"
    return "lane"


def decode_segments(segbytes: torch.Tensor, seg_blocks: torch.Tensor,
                    comp_sched: torch.Tensor, lo: torch.Tensor,
                    hi: torch.Tensor, offset: torch.Tensor,
                    values: torch.Tensor, *, blocks_per_segment: int,
                    n_components: int) -> torch.Tensor:
    """K5: segbytes uint8 (S, L) destuffed zero-padded rows (>= 4 guard
    bytes), seg_blocks int32 (S,), comp_sched int32 (B,), range tables →
    (S, B, 64) int32 zigzag coefficients, not saturated, every block
    written by the kernel (the output is not zeroed first)."""
    S, L = segbytes.shape[0], segbytes.shape[-1]
    B = blocks_per_segment
    C = n_components
    _check_segments(segbytes, seg_blocks, comp_sched, lo, hi, offset, values,
                    B, C)
    if segbytes.device.type == "cpu":
        return decode_segments_plain(segbytes, seg_blocks, comp_sched, lo,
                                     hi, offset, values,
                                     blocks_per_segment=B, n_components=C)
    if L >= 1 << 28:
        raise ValueError("segbytes: rows must be shorter than 2^28 bytes")
    dev = segbytes.device
    regime = k5_regime(S, L, B)
    trace.attrs(k5_regime=regime)
    lut = _lut_buffer(lo.shape[0], dev)     # built by the entry point
    U = PADDED_ROW_SUB_BITS
    scratch = stats = None
    if regime == "row":
        n_sub_max = min(-(-(8 * L + 32) // U), (2**31 - 1) // U)
        # per row: the records of n_sub_max subsequences (entry and exit
        # states, 8 bytes each; block count and 4 DC sums, 4 bytes each),
        # rounded up to 16 bytes
        scratch = torch.empty(S * -(-40 * n_sub_max // 16) * 2,
                              dtype=torch.int64, device=dev)
        stats = torch.empty((S, len(K5_ROW_STATS)), dtype=torch.int32,
                            device=dev)
    out = torch.empty((S, B, 64), dtype=torch.int32, device=dev)
    kernels.launch("vct_k5_huffman_decode_padded", segbytes.data_ptr(), S, L,
                   seg_blocks.data_ptr(), comp_sched.data_ptr(), B, C,
                   lo.data_ptr(), hi.data_ptr(), offset.data_ptr(),
                   lo.shape[0], values.data_ptr(), values.shape[0],
                   lut.data_ptr(), max_steps(B), K5_REGIMES.index(regime), U,
                   _ptr(scratch), _ptr(stats), out.data_ptr())
    decode_segments.launches += 1
    if regime == "row":
        decode_segments.row_launches += 1
    decode_lut.launches += 1
    decode_segments.stats = stats
    return out


decode_segments.launches = 0
decode_segments.row_launches = 0    # those of ``launches`` in "row"
# (S, len(K5_ROW_STATS)) int32 on the card after a "row" launch, else None
decode_segments.stats = None


def decode_segments_streamed(segbytes: torch.Tensor,
                             seg_blocks: torch.Tensor,
                             comp_sched: torch.Tensor, lo: torch.Tensor,
                             hi: torch.Tensor, offset: torch.Tensor,
                             values: torch.Tensor, *, blocks_per_segment: int,
                             n_components: int) -> torch.Tensor:
    """K6: K5's arguments, for long segments → (S, B, 64) int32 zigzag
    coefficients, not saturated, every block written by the kernel (the
    output is not zeroed first)."""
    S, L = segbytes.shape[0], segbytes.shape[-1]
    B = blocks_per_segment
    C = n_components
    _check_segments(segbytes, seg_blocks, comp_sched, lo, hi, offset, values,
                    B, C)
    if segbytes.device.type == "cpu":
        return decode_segments_streamed_plain(
            segbytes, seg_blocks, comp_sched, lo, hi, offset, values,
            blocks_per_segment=B, n_components=C)
    if B >= 1 << 24:
        raise ValueError("blocks_per_segment must be below 2^24")
    dev = segbytes.device
    lut = _lut_buffer(lo.shape[0], dev)     # built by the entry point
    U = STREAMED_SUB_BITS
    n_sub_max = (8 * L + 32 + U - 1) // U
    # per (row, subsequence): entry and exit states (8 bytes each), block
    # count and 4 DC sums (4 bytes each)
    scratch = torch.empty(S * n_sub_max * 5, dtype=torch.int64, device=dev)
    stats = torch.empty((S, len(STREAMED_STATS)), dtype=torch.int32,
                        device=dev)
    out = torch.empty((S, B, 64), dtype=torch.int32, device=dev)
    kernels.launch("vct_k6_huffman_decode_streamed", segbytes.data_ptr(), S,
                   L, seg_blocks.data_ptr(), comp_sched.data_ptr(), B, C,
                   lo.data_ptr(), hi.data_ptr(), offset.data_ptr(),
                   lo.shape[0], values.data_ptr(), values.shape[0],
                   lut.data_ptr(), U, n_sub_max, scratch.data_ptr(),
                   stats.data_ptr(), out.data_ptr())
    decode_segments_streamed.launches += 1
    decode_lut.launches += 1
    decode_segments_streamed.stats = stats
    return out


decode_segments_streamed.launches = 0
# (S, len(STREAMED_STATS)) int32 on the card after each launch
decode_segments_streamed.stats = None


def decode_segments_lanes(segbytes: torch.Tensor, seg_blocks: torch.Tensor,
                          comp_sched: torch.Tensor, lo: torch.Tensor,
                          hi: torch.Tensor, offset: torch.Tensor,
                          values: torch.Tensor, *, blocks_per_segment: int,
                          n_components: int) -> torch.Tensor:
    """K1 over the rows of a padded (S, L) matrix (the reference's
    ``decode_segments_pallas_t``): row s is lane s, whole."""
    S, L = segbytes.shape
    starts = torch.arange(S, dtype=torch.int32, device=segbytes.device) * L
    return decode_flat(segbytes.reshape(-1), starts,
                       torch.full_like(starts, L), seg_blocks, comp_sched,
                       lo, hi, offset, values,
                       blocks_per_segment=blocks_per_segment,
                       n_components=n_components)


def decode_padded(how: str, segbytes: torch.Tensor, seg_blocks: torch.Tensor,
                  comp_sched: torch.Tensor, lo: torch.Tensor,
                  hi: torch.Tensor, offset: torch.Tensor,
                  values: torch.Tensor, *, blocks_per_segment: int,
                  n_components: int,
                  luts: torch.Tensor | None = None) -> torch.Tensor:
    """A padded (S, L) lane matrix → (S, B, 64) coefficients by strategy:
    ``"pallas_t"`` (K1 over the rows), ``"streamed"`` (K6), ``"pallas"``
    (K5), ``"auto"`` (``auto_strategy``'s choice of those by shape; the
    decoder session resolves it before the call, in its route), or a
    plain loop, for an explicit choice only: ``"range"`` and ``"lut"``
    (which reads the expanded tables ``luts``)."""
    B = blocks_per_segment
    if how == "lut":
        return decode_segments_lut_plain(segbytes, seg_blocks, comp_sched,
                                         luts, blocks_per_segment=B,
                                         n_components=n_components)
    if how == "auto":
        how = auto_strategy(segbytes.shape[0], segbytes.shape[1], B)
    fn = {"pallas_t": decode_segments_lanes,
          "streamed": decode_segments_streamed,
          "pallas": decode_segments,
          "range": decode_segments_plain}[how]
    return fn(segbytes, seg_blocks, comp_sched, lo, hi, offset, values,
              blocks_per_segment=B, n_components=n_components)


def decode_scan_tpu(segments: list[bytes], comp_idx, blocks_per_segment: int,
                    tables, mode: str = "auto", device=None) -> np.ndarray:
    """Drop-in alternative to ``scan.decode_scan`` with the Huffman decode
    on ``device`` (None: the card, raising without one): destuffed
    segments padded into one lane matrix and decoded by ``mode`` (see
    ``decode_padded``; ``"auto"`` runs K1, K6 or K5 on the card). Returns
    (n_blocks, 64) int32 zigzag coefficients."""
    dev = resolve_device(device)
    n_blocks = len(comp_idx)
    B = blocks_per_segment
    segbytes, _lens = pack_segments(segments)
    S = len(segments)
    seg_blocks = np.full(S, B, dtype=np.int32)
    if n_blocks % B:
        seg_blocks[-1] = n_blocks % B
    comp_sched = np.resize(np.asarray(comp_idx[:B], dtype=np.int32), B)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    luts = up(np.concatenate(expand_luts(tables))) if mode == "lut" \
        else None
    out = decode_padded(mode, up(segbytes), up(seg_blocks), up(comp_sched),
                        *map(up, range_tables(tables)), blocks_per_segment=B,
                        n_components=len(tables.dc_maxbits), luts=luts)
    return out.view(S * B, 64)[:n_blocks].cpu().numpy()
