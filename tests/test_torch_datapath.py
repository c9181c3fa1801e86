"""Port K2/K3 (plain versions, CPU) against the reference Pallas datapath
kernels in interpret mode. Tolerance: exact equality — the codec is
bit-exact by contract."""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import K3_QUANTS, k2_coefs, k2_quant, k3_pixels, k3_quant
from video_coding_tpu.model.zigzag import INVERSE
from video_coding_tpu.ops import chen_jax
from video_coding_tpu.ops import datapath as jdp
from video_coding_tpu_torch.ops import chen, datapath

CSRC = pathlib.Path(__file__).resolve().parent.parent / \
    "video_coding_tpu_torch" / "csrc"


def _inputs(seed: int, n: int, p: int):
    rng = np.random.default_rng(seed)
    coefs = rng.integers(-300, 301, (n, 64)).astype(np.int32)
    coefs[:, 20:] //= 8                       # realistic high-band decay
    quant = rng.integers(1, 256, (p, 64)).astype(np.int32)
    pixels = rng.integers(0, 256, (n, 8, 8)).astype(np.uint8)
    return coefs, quant, pixels


@pytest.mark.parametrize("n,p", [(300, 300), (384, 6)])
def test_decode_datapath_matches_pallas(n, p):
    coefs, quant, _ = _inputs(n + p, n, p)
    qfull = np.tile(quant, (-(-n // p), 1))[:n]
    ref = np.asarray(jdp.decode_datapath_pallas(
        jnp.asarray(coefs), jnp.asarray(qfull), interpret=True))
    got = datapath.decode_datapath(torch.from_numpy(coefs),
                                   torch.from_numpy(quant))
    assert got.dtype == torch.uint8 and got.shape == (n, 8, 8)
    np.testing.assert_array_equal(got.numpy().astype(np.int32), ref)


@pytest.mark.parametrize("n,p", [(300, 300), (384, 6)])
def test_encode_datapath_matches_pallas(n, p):
    _, quant, pixels = _inputs(2 * n + p, n, p)
    qfull = np.tile(quant, (-(-n // p), 1))[:n]
    ref = np.asarray(jdp.encode_datapath_pallas(
        jnp.asarray(pixels.astype(np.int32)), jnp.asarray(qfull),
        interpret=True))
    got = datapath.encode_datapath(torch.from_numpy(pixels),
                                   torch.from_numpy(quant))
    assert got.dtype == torch.int32 and got.shape == (n, 64)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("sign", [1, -1])
def test_decode_worst_case_coefficients(sign):
    """Max-magnitude 12-bit coefficients everywhere — the int32 overflow
    stress case behind the split 181-multiply."""
    coefs = np.full((8, 64), sign * 2047, dtype=np.int32)
    quant = np.full((8, 64), 255, dtype=np.int32)
    ref = np.asarray(jdp.decode_datapath_pallas(
        jnp.asarray(coefs), jnp.asarray(quant), interpret=True))
    got = datapath.decode_datapath(torch.from_numpy(coefs),
                                   torch.from_numpy(quant))
    np.testing.assert_array_equal(got.numpy().astype(np.int32), ref)


@pytest.mark.parametrize("p", ["1", "6", "N"])
@pytest.mark.parametrize("n", [1, 31, 33, 129])
def test_decode_datapath_adversarial_matches_pallas(n, p):
    """K2's plain version on chip_smoke.k2_coefs (zero, DC-only, ±2047,
    ±32767, wrapping 2^20 products, random int32) and k2_quant rows (8-bit,
    4096, 65535) against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(n * 7 + len(p))
    coefs = k2_coefs(n, rng)
    quant = k2_quant(n if p == "N" else int(p), rng)
    qfull = np.tile(quant, (-(-n // len(quant)), 1))[:n]
    ref = np.asarray(jdp.decode_datapath_pallas(
        jnp.asarray(coefs), jnp.asarray(qfull), interpret=True))
    got = datapath.decode_datapath(torch.from_numpy(coefs),
                                   torch.from_numpy(quant))
    np.testing.assert_array_equal(got.numpy().astype(np.int32), ref)


def _idct8(x, row: bool, level: int):
    """One pass of K2's Chen IDCT on a list of 8 values (int64 arrays or
    _Interval): the kernel's operations, with ``level`` added to the
    column pass's DC term (the folded +128)."""
    mul = (lambda a: _Interval((181 * a.lo + 128) >> 8,
                               (181 * a.hi + 128) >> 8)) \
        if isinstance(x[0], _Interval) else (lambda a: (181 * a + 128) >> 8)
    if row:
        x0, x1 = 2048 * x[0] + _const(x, 128), 2048 * x[4]
    else:
        x0, x1 = 256 * x[0] + _const(x, 8192 + level), 256 * x[4]
    x2, x3, x4, x5, x6, x7 = x[6], x[2], x[1], x[7], x[5], x[3]
    r, s = (0, 0) if row else (4, 3)
    x8 = W7 * (x4 + x5) + _const(x, r)
    x4, x5 = (x8 + (W1 - W7) * x4) >> s, (x8 - (W1 + W7) * x5) >> s
    x8 = W3 * (x6 + x7) + _const(x, r)
    x6, x7 = (x8 - (W3 - W5) * x6) >> s, (x8 - (W3 + W5) * x7) >> s
    x8, x0 = x0 + x1, x0 - x1
    x1 = W6 * (x3 + x2) + _const(x, r)
    x2, x3 = (x1 - (W2 + W6) * x2) >> s, (x1 + (W2 - W6) * x3) >> s
    x1, x4, x6, x5 = x4 + x6, x4 - x6, x5 + x7, x5 - x7
    x7, x8, x3, x0 = x8 + x3, x8 - x3, x0 + x2, x0 - x2
    x2, x4 = mul(x4 + x5), mul(x4 - x5)
    return [x7 + x1, x3 + x2, x0 + x4, x8 + x6, x8 - x6, x0 - x4, x3 - x2,
            x7 - x1]


def _const(x, c: int):
    return _Interval(c, c) if isinstance(x[0], _Interval) else c


W1, W2, W3, W5, W6, W7 = 2841, 2676, 2408, 1609, 1108, 565


def test_idct_column_sums_leave_room_for_the_level_shift():
    """Interval arithmetic through K2's two passes for every 12-bit input:
    the column pass's sums, with the folded +128 << 14, stay below 2^30,
    so adding the level shift before the >> 14 wraps nothing and equals
    adding 128 after it."""
    x = _Interval(-2048, 2047)
    rows = [v >> 8 for v in _idct8([x] * 8, True, 0)]
    sums = _idct8(rows, False, 128 << 14)
    assert max(max(-v.lo, v.hi) for v in sums) < 1 << 30


def _k2_model(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """K2's arithmetic in numpy: the wrapping int32 product and 12-bit
    clamp, the compile-time dezigzag, both passes with the level shift
    folded into the column pass, the clip to [0, 255]."""
    n = len(coefs)
    q = np.tile(quant, (-(-n // len(quant)), 1))[:n]
    deq = (coefs.astype(np.int64) * q).astype(np.uint64).astype(np.uint32)
    deq = np.clip(deq.astype(np.int32), -2048, 2047).astype(np.int64)
    v = np.zeros((n, 64), np.int64)
    v[:, np.asarray(INVERSE)] = deq
    rows = [[r >> 8 for r in _idct8([v[:, r * 8 + c] for c in range(8)],
                                    True, 0)] for r in range(8)]
    cols = [[s >> 14 for s in _idct8([rows[r][c] for r in range(8)], False,
                                     128 << 14)] for c in range(8)]
    px = np.stack([cols[c][r] for r in range(8) for c in range(8)], 1)
    return np.clip(px, 0, 255).reshape(n, 8, 8)


@pytest.mark.parametrize("n,p", [(33, 1), (31, 6), (129, 129)])
def test_k2_arithmetic_matches_plain(n, p):
    rng = np.random.default_rng(n + p)
    coefs, quant = k2_coefs(n, rng), k2_quant(p, rng)
    ref = datapath.decode_datapath_plain(torch.from_numpy(coefs),
                                         torch.from_numpy(quant)).numpy()
    np.testing.assert_array_equal(_k2_model(coefs, quant), ref)


def test_mul181_shift8_exact_over_int32():
    rng = np.random.default_rng(7)
    a = np.concatenate([rng.integers(-2**27, 2**27, 4096),
                        [0, 1, -1, 2**27 - 1, -2**27]]).astype(np.int32)
    got = chen._mul181_shift8(torch.from_numpy(a)).numpy()
    ref = np.asarray(chen_jax._mul181_shift8(jnp.asarray(a)))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, (181 * a.astype(np.int64) + 128) >> 8)


def _k3_constant(name: str) -> int:
    text = (CSRC / "encode_datapath.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_reciprocal_quotient_exact():
    """K3's quotient, in exactly the kernel's operations: m = (2^32 - 1) //
    4q + 1 in uint32, then the high word of n * m, equals n // 4q for every
    dividend n < 2^17 and every q in 1..kRecipQuant."""
    n = np.arange(1 << 17, dtype=np.uint64)
    for q in range(1, _k3_constant("kRecipQuant") + 1):
        d = 4 * q
        m = np.uint64(np.uint32(0xFFFFFFFF // d + 1))
        assert np.array_equal((n * m) >> np.uint64(32), n // np.uint64(d)), q


class _Interval:
    """Integer range [lo, hi] through the fDCT pass's operations."""

    def __init__(self, lo: int, hi: int):
        self.lo, self.hi = lo, hi

    def __add__(self, o):
        return _Interval(self.lo + o.lo, self.hi + o.hi)

    def __sub__(self, o):
        return _Interval(self.lo - o.hi, self.hi - o.lo)

    def __rmul__(self, k: int):
        assert k >= 0
        return _Interval(k * self.lo, k * self.hi)

    def __rshift__(self, s: int):
        return _Interval(self.lo >> s, self.hi >> s)


def test_fdct_range_fits_the_quotient_proof():
    """Interval arithmetic through both Chen passes: |f| < 2^13 for every
    8-bit block, so K3's dividend |f| + 2q stays below 2^17 for every q
    with a reciprocal."""
    x = _Interval(-128, 127)
    cols = [chen._fdct_pass([x] * 8) for _ in range(8)]
    out = [chen._fdct_pass([cols[c][u] for c in range(8)]) for u in range(8)]
    bound = max(max(-v.lo, v.hi) for row in out for v in row)
    assert bound < 1 << 13
    assert bound + 2 * _k3_constant("kRecipQuant") < 1 << 17


def _fdct8(v, bias: int):
    """K3's pass on a list of 8 int64 arrays; ``bias`` joins the DC sum."""
    a0, c3 = v[0] + v[7], v[0] - v[7]
    a1, c2 = v[1] + v[6], v[1] - v[6]
    a2, c1 = v[2] + v[5], v[2] - v[5]
    a3, c0 = v[3] + v[4], v[3] - v[4]
    b0, b1, b2, b3 = a0 + a3, a1 + a2, a1 - a2, a0 - a3
    o0 = (362 * (b0 + b1 + bias)) >> 9
    o4 = (362 * (b0 - b1)) >> 9
    o2 = (196 * b2 + 473 * b3) >> 9
    o6 = (196 * b3 - 473 * b2) >> 9
    b0, b1 = (362 * (c2 - c1)) >> 9, (362 * (c2 + c1)) >> 9
    a0, a1, a2, a3 = c0 + b0, c0 - b0, c3 - b1, c3 + b1
    return [o0, (100 * a0 + 502 * a3) >> 9, o2, (426 * a2 - 284 * a1) >> 9,
            o4, (426 * a1 + 284 * a2) >> 9, o6, (100 * a3 - 502 * a0) >> 9]


def _k3_model(pixels: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """K3's arithmetic in numpy: unshifted pixels, the -128 level shift
    as -1024 on the first pass's DC sums, the reciprocal quotient for q in
    1..kRecipQuant and the division past it."""
    n = len(pixels)
    px = pixels.reshape(n, 64).astype(np.int64)
    rows = [[px[:, r * 8 + c] for c in range(8)] for r in range(8)]
    cols = [_fdct8([rows[r][c] for r in range(8)], -1024) for c in range(8)]
    f = np.stack([v for r in range(8)
                  for v in _fdct8([cols[c][r] for c in range(8)], 0)], 1)
    fzz = f[:, np.asarray(INVERSE)]
    q = np.tile(quant, (-(-n // len(quant)), 1))[:n].astype(np.int64)
    a = np.abs(fzz) + 2 * q
    recip = 0xFFFFFFFF // np.maximum(4 * q, 1) + 1
    t = np.where(q <= _k3_constant("kRecipQuant"), (a * recip) >> 32,
                 a // (4 * q))
    return np.where(fzz < 0, -t, t)


@pytest.mark.parametrize("kind", K3_QUANTS)
@pytest.mark.parametrize("n,p", [(33, 1), (31, 6), (200, 200)])
def test_k3_arithmetic_matches_plain(n, p, kind):
    """The kernel's rearranged arithmetic equals the plain version on the
    adversarial blocks (all-0, all-255, ±128 checkerboards) and on quant
    rows of 1, 255, random 8-bit and past the reciprocal table."""
    rng = np.random.default_rng(n * p)
    pixels = k3_pixels(n, rng)
    quant = k3_quant(kind, p, rng)
    ref = datapath.encode_datapath_plain(torch.from_numpy(pixels),
                                         torch.from_numpy(quant)).numpy()
    np.testing.assert_array_equal(_k3_model(pixels, quant), ref)


def test_chen_transforms_match_reference():
    rng = np.random.default_rng(3)
    blocks = rng.integers(-2048, 2048, (64, 8, 8)).astype(np.int32)
    tile = jnp.asarray(blocks.transpose(1, 2, 0))
    inv = np.asarray(chen_jax.chen_inverse(tile)).transpose(2, 0, 1)
    fwd = np.asarray(chen_jax.chen_forward(tile // 16)).transpose(2, 0, 1)
    np.testing.assert_array_equal(
        chen.chen_inverse(torch.from_numpy(blocks)).numpy(), inv)
    np.testing.assert_array_equal(
        chen.chen_forward(torch.from_numpy(blocks // 16)).numpy(), fwd)


@pytest.mark.parametrize("src", ["decode_datapath.cu", "encode_datapath.cu"])
def test_kernel_zigzag_table_matches_model(src):
    """The CUDA kernels carry their own zigzag table; it must be the
    model's (natural index of each zigzag position)."""
    text = (CSRC / src).read_text()
    body = re.search(r"kInverse\[64\]\s*=\s*\{([^}]*)\}", text).group(1)
    table = [int(x) for x in body.replace("\n", " ").split(",") if x.strip()]
    assert table == np.asarray(INVERSE).tolist()


def test_wrappers_reject_bad_inputs():
    coefs = torch.zeros((4, 64), dtype=torch.int64)
    with pytest.raises(TypeError):
        datapath.decode_datapath(coefs, torch.ones((1, 64), dtype=torch.int32))
    with pytest.raises(ValueError):
        datapath.encode_datapath(torch.zeros((4, 8, 8), dtype=torch.uint8),
                                 torch.ones((1, 63), dtype=torch.int32))
