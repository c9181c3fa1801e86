"""Plain NumPy baseline JPEG codec: the benchmark's source encoder and the
reference that the port's outputs are held against.

A frozen copy of the golden model's numerics (level shift, the integer
Chen transforms, quantisation rounding half away from zero, the 12-bit
dequantisation clamp, the Annex K tables, the header layout, restart
segments padded with 1-bits, 0xFF00 stuffing). It imports nothing of
the program under test: neither the JAX package nor its PyTorch port.

The entropy coder is vectorised (one NumPy pass over all symbols of a
frame); the entropy decoder is a plain Python loop, slow at full size,
which the tests use to prove that the streams carry the coefficients the
encoder coded.

``reconstruct(..., dct="float32")`` swaps the integer Chen IDCT for the
orthonormal DCT as float32 matrix products: the lower-precision control
that has to fail the comparison.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

# --- tables (ITU-T T.81 Annex K; quant tables indexed by zigzag position,
# the golden model's convention) ------------------------------------------

LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], dtype=np.int64)
CHROMA_QUANT = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
] + [99] * 32, dtype=np.int64)

# (16 code-length counts, symbol values): DC luma, DC chroma, AC luma, AC
# chroma
DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
           bytes(range(12)))
DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
             bytes(range(12)))
AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125),
           bytes.fromhex(
               "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
               "2433627282090a161718191a25262728292a3435363738393a43444546474849"
               "4a535455565758595a636465666768696a737475767778797a83848586878889"
               "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
               "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
               "f9fa"))
AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119),
             bytes.fromhex(
                 "000102031104052131061241510761711322328108144291a1b1c109233352f0"
                 "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
                 "494a535455565758595a636465666768696a737475767778797a828384858687"
                 "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
                 "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
                 "f9fa"))


def _zigzag() -> np.ndarray:
    """Natural (raster) index of each zigzag position (T.81 Figure 5)."""
    order = sorted(((x + y, (y if (x + y) % 2 else x), y * 8 + x)
                    for y in range(8) for x in range(8)))
    return np.array([o[2] for o in order], dtype=np.int64)


ZIGZAG = _zigzag()


def quality_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg quality scaling of an Annex K table."""
    q = min(max(int(quality), 1), 100)
    s = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * s + 50) // 100, 1, 255).astype(np.int64)


def _codes(spec) -> dict:
    """Canonical Huffman codes of a (counts, values) spec: value →
    (code, length)."""
    counts, values = spec
    out, code, k = {}, 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            out[values[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return out


def _code_arrays(dc_spec, ac_spec):
    """(code, length) of every DC size (12) and AC run/size byte (256);
    length 0 where the table has no code."""
    code = np.zeros(12 + 256, np.int64)
    length = np.zeros(12 + 256, np.int64)
    for base, spec in ((0, dc_spec), (12, ac_spec)):
        for value, (c, n) in _codes(spec).items():
            code[base + value], length[base + value] = c, n
    return code, length


# table set 0 (luma), 1 (chroma): [set, 12 DC sizes + 256 AC symbols]
_CODE, _LEN = (np.stack(a) for a in zip(_code_arrays(DC_LUMA, AC_LUMA),
                                        _code_arrays(DC_CHROMA, AC_CHROMA)))


# --- geometry ---------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Layout:
    """A frame's block layout: three components with sampling factors
    ``factors`` ((h, v) each), luma first, interleaved MCUs."""

    width: int
    height: int
    factors: tuple = ((2, 2), (1, 1), (1, 1))

    @property
    def hmax(self) -> int:
        return max(h for h, _ in self.factors)

    @property
    def vmax(self) -> int:
        return max(v for _, v in self.factors)

    @property
    def mcus(self) -> tuple[int, int]:
        """(MCU rows, MCU columns)."""
        return (-(-self.height // (8 * self.vmax)),
                -(-self.width // (8 * self.hmax)))

    @property
    def blocks_per_mcu(self) -> int:
        return sum(h * v for h, v in self.factors)

    @property
    def n_blocks(self) -> int:
        my, mx = self.mcus
        return my * mx * self.blocks_per_mcu

    def padded(self, c: int) -> tuple[int, int]:
        """Component c's plane size padded to whole MCUs."""
        h, v = self.factors[c]
        my, mx = self.mcus
        return my * v * 8, mx * h * 8

    def actual(self, c: int) -> tuple[int, int]:
        """Component c's size (T.81: luma's, scaled and rounded up)."""
        h, v = self.factors[c]
        return (-(-self.height * v // self.vmax),
                -(-self.width * h // self.hmax))

    def comp_idx(self) -> np.ndarray:
        """Component of each block in stream order."""
        per_mcu = np.repeat(np.arange(len(self.factors)),
                            [h * v for h, v in self.factors])
        return np.tile(per_mcu, self.n_blocks // self.blocks_per_mcu)

    def table_idx(self) -> np.ndarray:
        """Table set (0 luma, 1 chroma) of each block in stream order."""
        return np.minimum(self.comp_idx(), 1)

    def pad(self, planes) -> list[np.ndarray]:
        """Planes at their actual sizes → zero-padded to whole MCUs."""
        out = []
        for c, p in enumerate(planes):
            full = np.zeros(self.padded(c), np.uint8)
            ah, aw = self.actual(c)
            full[:ah, :aw] = p[:ah, :aw]
            out.append(full)
        return out

    def blocks(self, planes) -> np.ndarray:
        """Padded planes → (N, 8, 8) int64 blocks in stream order."""
        my, mx = self.mcus
        parts = []
        for p, (h, v) in zip(planes, self.factors):
            g = np.asarray(p, np.int64).reshape(my, v, 8, mx, h, 8)
            parts.append(g.transpose(0, 3, 1, 4, 2, 5).reshape(
                my, mx, v * h, 8, 8))
        return np.concatenate(parts, axis=2).reshape(-1, 8, 8)

    def planes(self, blocks: np.ndarray) -> list[np.ndarray]:
        """(N, 8, 8) blocks in stream order → padded planes."""
        my, mx = self.mcus
        b = blocks.reshape(my, mx, self.blocks_per_mcu, 8, 8)
        out, k = [], 0
        for c, (h, v) in enumerate(self.factors):
            g = b[:, :, k:k + v * h].reshape(my, mx, v, h, 8, 8)
            out.append(np.ascontiguousarray(
                g.transpose(0, 2, 4, 1, 3, 5).reshape(self.padded(c))))
            k += v * h
        return out


# --- the integer Chen transforms (the golden model's, vectorised) ---------

W1, W2, W3, W5, W6, W7 = 2841, 2676, 2408, 1609, 1108, 565


def _idct_pass(b: np.ndarray, first: bool) -> np.ndarray:
    """One pass of the Chen IDCT along the last axis: rows (``first``),
    then columns."""
    if first:
        x0, x1 = (b[..., 0] << 11) + 128, b[..., 4] << 11
        r0, r1 = 0, 0
    else:
        x0, x1 = (b[..., 0] << 8) + 8192, b[..., 4] << 8
        r0, r1 = 4, 3
    x2, x3, x4, x5, x6, x7 = (b[..., i] for i in (6, 2, 1, 7, 5, 3))
    x8 = W7 * (x4 + x5) + r0
    x4 = (x8 + (W1 - W7) * x4) >> r1
    x5 = (x8 - (W1 + W7) * x5) >> r1
    x8 = W3 * (x6 + x7) + r0
    x6 = (x8 - (W3 - W5) * x6) >> r1
    x7 = (x8 - (W3 + W5) * x7) >> r1
    x8 = x0 + x1
    x0 = x0 - x1
    x1 = W6 * (x3 + x2) + r0
    x2 = (x1 - (W2 + W6) * x2) >> r1
    x3 = (x1 + (W2 - W6) * x3) >> r1
    x1 = x4 + x6
    x4 = x4 - x6
    x6 = x5 + x7
    x5 = x5 - x7
    x7 = x8 + x3
    x8 = x8 - x3
    x3 = x0 + x2
    x0 = x0 - x2
    x2 = (181 * (x4 + x5) + 128) >> 8
    x4 = (181 * (x4 - x5) + 128) >> 8
    s = 8 if first else 14
    return np.stack([(x7 + x1) >> s, (x3 + x2) >> s, (x0 + x4) >> s,
                     (x8 + x6) >> s, (x8 - x6) >> s, (x0 - x4) >> s,
                     (x3 - x2) >> s, (x7 - x1) >> s], axis=-1)


def chen_inverse(b: np.ndarray) -> np.ndarray:
    """(N, 8, 8) int64 → integer Chen IDCT, rows then columns."""
    b = _idct_pass(b, True)
    return _idct_pass(b.swapaxes(-1, -2), False).swapaxes(-1, -2)


def _fdct_pass(b: np.ndarray) -> np.ndarray:
    """One forward Chen pass along the last axis."""
    def c4(f, g):
        return (362 * (f + g)) >> 9

    a0, c3 = b[..., 0] + b[..., 7], b[..., 0] - b[..., 7]
    a1, c2 = b[..., 1] + b[..., 6], b[..., 1] - b[..., 6]
    a2, c1 = b[..., 2] + b[..., 5], b[..., 2] - b[..., 5]
    a3, c0 = b[..., 3] + b[..., 4], b[..., 3] - b[..., 4]
    b0, b1, b2, b3 = a0 + a3, a1 + a2, a1 - a2, a0 - a3
    o0, o4 = c4(b0, b1), c4(b0, -b1)
    o2 = (196 * b2 + 473 * b3) >> 9
    o6 = (196 * b3 - 473 * b2) >> 9
    b0, b1 = c4(c2, -c1), c4(c2, c1)
    a0, a1, a2, a3 = c0 + b0, c0 - b0, c3 - b1, c3 + b1
    o1 = (100 * a0 + 502 * a3) >> 9
    o5 = (426 * a1 + 284 * a2) >> 9
    o3 = (426 * a2 - 284 * a1) >> 9
    o7 = (100 * a3 - 502 * a0) >> 9
    return np.stack([o0, o1, o2, o3, o4, o5, o6, o7], axis=-1)


def chen_forward(b: np.ndarray) -> np.ndarray:
    """(N, 8, 8) int64 → integer Chen fDCT scaled x4, columns then rows."""
    b = _fdct_pass(b.swapaxes(-1, -2)).swapaxes(-1, -2)
    return _fdct_pass(b)


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)[:, None]
    m = np.sqrt(2 / 8) * np.cos(np.pi / 8 * (np.arange(8)[None] + 0.5) * k)
    m[0] = 1 / np.sqrt(8)
    return m.astype(np.float32)


def _float32_inverse(b: np.ndarray) -> np.ndarray:
    m = _dct_matrix()
    return np.rint(m.T @ b.astype(np.float32) @ m).astype(np.int64)


INVERSE = {"chen": chen_inverse, "float32": _float32_inverse}


# --- block numerics -----------------------------------------------------------

def block_quant(layout: Layout, quality: int) -> np.ndarray:
    """(N, 64) zigzag quant values of every block."""
    tables = np.stack([quality_table(LUMA_QUANT, quality),
                       quality_table(CHROMA_QUANT, quality)])
    return tables[layout.table_idx()]


def quantize(planes, layout: Layout, quality: int) -> np.ndarray:
    """Padded planes → (N, 64) zigzag coefficients: level shift, fDCT,
    quantisation rounding half away from zero."""
    f = chen_forward(layout.blocks(planes) - 128).reshape(-1, 64)
    f = f[:, ZIGZAG]
    q4 = block_quant(layout, quality) * 4
    pos = (f + q4 // 2) // q4
    neg = -((-f + q4 // 2) // q4)
    return np.where(f < 0, neg, pos)


def reconstruct(coefs: np.ndarray, layout: Layout, quality: int,
                dct: str = "chen") -> list[np.ndarray]:
    """(N, 64) zigzag coefficients → padded uint8 planes: dequantise,
    clamp to 12 bits, IDCT, clip, level shift."""
    deq = np.clip(coefs.astype(np.int64) * block_quant(layout, quality),
                  -2048, 2047)
    nat = np.zeros_like(deq)
    nat[:, ZIGZAG] = deq
    pix = INVERSE[dct](nat.reshape(-1, 8, 8))
    return layout.planes((np.clip(pix, -128, 127) + 128).astype(np.uint8))


# --- entropy coding -------------------------------------------------------------

def _bit_length(a: np.ndarray) -> np.ndarray:
    a = np.abs(a)
    n = np.zeros(a.shape, np.int64)
    for s in range(16):
        n += a >= (1 << s)
    return n


def _magnitude(v: np.ndarray, size: np.ndarray) -> np.ndarray:
    return np.where(v >= 0, v, v - 1) & ((1 << size) - 1)


@dataclasses.dataclass
class Entropy:
    body: bytes          # stuffed entropy-coded data with RSTn markers
    symbols: int         # Huffman symbols coded (DC, AC, ZRL, EOB)
    raw_bytes: int       # entropy bytes once destuffed, markers removed


def entropy_encode(coefs: np.ndarray, layout: Layout,
                   restart_interval: int) -> Entropy:
    """(N, 64) zigzag coefficients → the scan's entropy-coded bytes, with
    an RSTn marker every ``restart_interval`` MCUs (0: none)."""
    coefs = coefs.astype(np.int64)
    n = len(coefs)
    comp = layout.comp_idx()
    tset = layout.table_idx()
    bseg = restart_interval * layout.blocks_per_mcu or n
    seg = np.arange(n) // bseg
    # DC differences, predictors reset at each segment
    diff = np.empty(n, np.int64)
    for c in range(len(layout.factors)):
        idx = np.flatnonzero(comp == c)
        dc = coefs[idx, 0]
        prev = np.concatenate([[0], dc[:-1]])
        fresh = np.concatenate([[True], seg[idx[1:]] != seg[idx[:-1]]])
        diff[idx] = dc - np.where(fresh, 0, prev)
    keys, codes, lens = [], [], []

    def emit(key, t, sym, value, size):
        keys.append(key)
        codes.append((_CODE[t, sym] << size) | _magnitude(value, size))
        lens.append(_LEN[t, sym] + size)

    size = _bit_length(diff)
    emit(np.arange(n) * 1024, tset, size, diff, size)
    b, p = np.nonzero(coefs[:, 1:])
    pos = p + 1
    first = np.concatenate([[True], b[1:] != b[:-1]])
    run = pos - np.where(first, 0, np.concatenate([[0], pos[:-1]])) - 1
    v = coefs[b, pos]
    size = _bit_length(v)
    emit(b * 1024 + 4 * pos + 3, tset[b], 12 + ((run & 15) << 4) + size, v,
         size)
    for j in range(3):                                 # ZRLs before a value
        z = (run >> 4) > j
        nil = np.zeros(int(z.sum()), np.int64)
        emit(b[z] * 1024 + 4 * pos[z] + j, tset[b[z]], 12 + 0xF0, nil, nil)
    last = np.zeros(n, np.int64)
    np.maximum.at(last, b, pos)
    eob = last < 63
    nil = np.zeros(int(eob.sum()), np.int64)
    emit(np.flatnonzero(eob) * 1024 + 256, tset[eob], 12, nil, nil)
    n_symbols = sum(len(k) for k in keys)
    # pad each segment with 1-bits to a byte boundary
    seg_bits = np.bincount(np.concatenate(keys) // 1024 // bseg,
                           weights=np.concatenate(lens)).astype(np.int64)
    pad = -seg_bits % 8
    ends = np.minimum((np.arange(len(seg_bits)) + 1) * bseg, n) - 1
    keys.append(ends * 1024 + 1000)
    codes.append((1 << pad) - 1)
    lens.append(pad)
    key = np.concatenate(keys)
    order = np.argsort(key, kind="stable")
    code = np.concatenate(codes)[order].astype(np.uint64)
    length = np.concatenate(lens)[order]
    off = np.concatenate([[0], np.cumsum(length)[:-1]])
    n_raw = int(length.sum()) // 8
    word = code << (64 - (off & 7) - length).astype(np.uint64)
    base = off >> 3
    raw = np.zeros(n_raw + 8)
    for k in range(5):
        raw += np.bincount(base + k, minlength=n_raw + 8, weights=(
            (word >> np.uint64(56 - 8 * k)) & np.uint64(0xFF)).astype(
                np.float64))
    raw = raw[:n_raw].astype(np.uint8)
    # stuff 0x00 after every 0xFF; RSTn between segments
    seg_start = np.concatenate([[0], np.cumsum(seg_bits + pad)[:-1] // 8])
    seg_of = np.zeros(n_raw, np.int64)
    seg_of[seg_start[1:]] = 1
    seg_of = np.cumsum(seg_of)
    ff = raw == 0xFF
    dest = (np.arange(n_raw) + np.concatenate([[0], np.cumsum(ff)[:-1]])
            + 2 * seg_of)
    out = np.zeros(n_raw + int(ff.sum()) + 2 * (len(seg_start) - 1),
                   np.uint8)
    out[dest] = raw
    at = dest[seg_start[1:]]
    out[at - 2] = 0xFF
    out[at - 1] = 0xD0 + np.arange(len(at)) % 8
    return Entropy(out.tobytes(), n_symbols, n_raw)


# --- headers and whole frames ---------------------------------------------

def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, 2 + len(payload)) + payload


def header(layout: Layout, quality: int, restart_interval: int) -> bytes:
    """SOI, APP0, DQT (luma, chroma), [DRI], SOF0, DHT (DC luma, DC
    chroma, AC luma, AC chroma), SOS: the golden model's layout."""
    out = [b"\xff\xd8", _segment(0xE0, b"video-coding-tpu")]
    for t, base in enumerate((LUMA_QUANT, CHROMA_QUANT)):
        out.append(_segment(0xDB, bytes([t])
                            + bytes(quality_table(base, quality).tolist())))
    if restart_interval:
        out.append(_segment(0xDD, struct.pack(">H", restart_interval)))
    comps = b"".join(bytes([c + 1, (h << 4) | v, min(c, 1)])
                     for c, (h, v) in enumerate(layout.factors))
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, layout.height,
                                          layout.width, len(layout.factors))
                        + comps))
    for cls, t, (counts, values) in ((0, 0, DC_LUMA), (0, 1, DC_CHROMA),
                                     (1, 0, AC_LUMA), (1, 1, AC_CHROMA)):
        out.append(_segment(0xC4, bytes([(cls << 4) | t, *counts]) + values))
    sel = b"".join(bytes([c + 1, min(c, 1) * 0x11])
                   for c in range(len(layout.factors)))
    out.append(_segment(0xDA, bytes([len(layout.factors)]) + sel
                        + b"\x00\x3f\x00"))
    return b"".join(out)


@dataclasses.dataclass
class Encoded:
    stream: bytes        # the whole JPEG
    header_len: int      # bytes before the entropy-coded data
    coefs: np.ndarray    # (N, 64) zigzag coefficients the stream codes
    symbols: int
    raw_bytes: int


def encode_coefs(coefs: np.ndarray, layout: Layout, quality: int,
                 restart_interval: int) -> Encoded:
    """Coefficients quantised at ``quality`` → a whole JPEG."""
    hdr = header(layout, quality, restart_interval)
    ent = entropy_encode(coefs, layout, restart_interval)
    return Encoded(hdr + ent.body + b"\xff\xd9", len(hdr), coefs,
                   ent.symbols, ent.raw_bytes)


def encode(planes, layout: Layout, quality: int,
           restart_interval: int) -> Encoded:
    """Planes at their actual sizes → a whole baseline JPEG."""
    coefs = quantize(layout.pad(planes), layout, quality)
    return encode_coefs(coefs, layout, quality, restart_interval)


# --- entropy decoding (plain Python; the tests' check of the encoder) -----

def _parse(stream: bytes) -> tuple[dict, int]:
    """Header fields the decoder needs and the offset of the scan data."""
    info = {"dqt": {}, "dht": {}, "dri": 0}
    i = 2
    while True:
        marker = stream[i + 1]
        n = struct.unpack(">H", stream[i + 2:i + 4])[0]
        body = stream[i + 4:i + 2 + n]
        if marker == 0xDB:
            info["dqt"][body[0] & 15] = np.frombuffer(body[1:65], np.uint8)
        elif marker == 0xC4:
            counts = tuple(body[1:17])
            info["dht"][body[0] >> 4, body[0] & 15] = {
                (n_, c): v for v, (c, n_) in
                _codes((counts, body[17:17 + sum(counts)])).items()}
        elif marker == 0xDD:
            info["dri"] = struct.unpack(">H", body)[0]
        elif marker == 0xC0:
            h, w, nc = struct.unpack(">HHB", body[1:6])
            info["size"] = (w, h)
            info["factors"] = tuple((body[7 + 3 * c] >> 4,
                                     body[7 + 3 * c] & 15)
                                    for c in range(nc))
        elif marker == 0xDA:
            return info, i + 2 + n
        i += 2 + n


def decode_coefs(stream: bytes) -> tuple[np.ndarray, Layout]:
    """A baseline JPEG written by ``encode`` → its (N, 64) zigzag
    coefficients and layout, by a plain bit-serial Huffman decode."""
    info, start = _parse(stream)
    layout = Layout(*info["size"], info["factors"])
    data = stream[start:stream.rindex(b"\xff\xd9")]
    segments, cur, i = [], bytearray(), 0
    while i < len(data):
        if data[i] == 0xFF:
            if data[i + 1] == 0x00:
                cur.append(0xFF)
            else:                                          # RSTn
                segments.append(bytes(cur))
                cur = bytearray()
            i += 2
        else:
            cur.append(data[i])
            i += 1
    segments.append(bytes(cur))
    bseg = info["dri"] * layout.blocks_per_mcu or layout.n_blocks
    tset = layout.table_idx().tolist()
    comp = layout.comp_idx().tolist()
    out = np.zeros((layout.n_blocks, 64), np.int64)
    for s, seg in enumerate(segments):
        bits = int.from_bytes(seg, "big")
        total, pos = 8 * len(seg), 0

        def take(n):
            nonlocal pos
            v = (bits >> (total - pos - n)) & ((1 << n) - 1)
            pos += n
            return v

        def symbol(table):
            code = 0
            for n in range(1, 17):
                code = (code << 1) | take(1)
                if (n, code) in table:
                    return table[n, code]
            raise ValueError("no Huffman code")

        def value(size):
            v = take(size)
            return v if size == 0 or v >> (size - 1) else v - (1 << size) + 1

        pred = [0] * len(layout.factors)
        for blk in range(s * bseg, min((s + 1) * bseg, layout.n_blocks)):
            t = tset[blk]
            pred[comp[blk]] += value(symbol(info["dht"][0, t]))
            out[blk, 0] = pred[comp[blk]]
            k = 1
            while k < 64:
                rs = symbol(info["dht"][1, t])
                if rs == 0:
                    break
                k += rs >> 4
                out[blk, k] = value(rs & 15)
                k += 1
    return out, layout
