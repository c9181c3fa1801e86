"""The benchmark's reference codec: its streams decode back to the
coefficients it coded, its bytes repeat for a seed, its tables and
transforms are the golden model's (checked on known values), and the
float32 control differs from it."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import harness
from portbench.frames import synth_frames
from portbench.reference import baseline_jpeg as bj
from portbench.tests.helpers import tiny_cell

LAYOUT = bj.Layout(256, 128)


@pytest.fixture(scope="module")
def frames():
    return synth_frames(2, 2**33 + 17, LAYOUT.width, LAYOUT.height)


@pytest.mark.parametrize("quality,ri", [(90, 0), (90, 1), (95, 16),
                                        (75, 3)])
def test_stream_round_trips(frames, quality, ri):
    enc = bj.encode(frames[0], LAYOUT, quality, ri)
    coefs, layout = bj.decode_coefs(enc.stream)
    assert layout == LAYOUT
    assert np.array_equal(coefs, enc.coefs)
    planes = bj.reconstruct(coefs, LAYOUT, quality)
    y = planes[0][:LAYOUT.height, :LAYOUT.width].astype(np.float64)
    mse = np.mean((y - frames[0][0]) ** 2)
    assert 10 * np.log10(255 ** 2 / mse) > 30
    assert enc.stream.count(b"\xff\xd0") + enc.stream.count(b"\xff\xd7") \
        <= (LAYOUT.n_blocks // 6 if ri else 0)


def test_sources_repeat_for_a_seed():
    cell = tiny_cell("decode-4k-tworow-q90")
    with harness.workers(cell) as pool:
        _, a = harness.make_sources(cell, 2**35 + 1, pool)
        _, b = harness.make_sources(cell, 2**35 + 1, pool)
        _, c = harness.make_sources(cell, 2**35 + 2, pool)
    assert [s.encoded.stream for s in a] == [s.encoded.stream for s in b]
    assert a[0].encoded.stream != c[0].encoded.stream
    assert len({s.encoded.stream for s in a}) == len(a)


def test_tables_and_zigzag():
    assert bj.ZIGZAG[:8].tolist() == [0, 1, 8, 16, 9, 2, 3, 10]
    assert sorted(bj.ZIGZAG.tolist()) == list(range(64))
    assert np.array_equal(bj.quality_table(bj.LUMA_QUANT, 50),
                          bj.LUMA_QUANT)
    assert bj.quality_table(bj.LUMA_QUANT, 90)[:4].tolist() == [3, 2, 2, 3]
    assert bj.quality_table(bj.CHROMA_QUANT, 100).max() == 1
    codes = bj._codes(bj.DC_LUMA)
    assert codes[0] == (0b00, 2) and codes[11] == (0b111111110, 9)
    assert bj._codes(bj.AC_LUMA)[0x00] == (0b1010, 4)       # EOB
    assert bj._codes(bj.AC_LUMA)[0xF0] == (0b11111111001, 11)  # ZRL


def test_chen_transforms_on_known_blocks():
    dc = np.zeros((1, 8, 8), np.int64)
    dc[0, 0, 0] = 80
    assert np.all(bj.chen_inverse(dc) == 10)
    flat = np.full((1, 8, 8), 37, np.int64)
    f = bj.chen_forward(flat)
    assert f[0, 0, 0] == 37 * 8 * 4 - 2 and np.count_nonzero(f) == 1


def test_header_layout(frames):
    enc = bj.encode(frames[0], LAYOUT, 75, 2)
    hdr = enc.stream[:enc.header_len]
    markers = [hdr[i + 1] for i in range(len(hdr) - 1)
               if hdr[i] == 0xFF and hdr[i + 1] not in (0x00, 0xFF)]
    assert markers[:2] == [0xD8, 0xE0] and b"video-coding-tpu" in hdr
    assert markers.count(0xDB) == 2 and markers.count(0xC4) == 4
    assert 0xDD in markers and markers[-1] == 0xDA


def test_float32_control_differs(frames):
    enc = bj.encode(frames[0], LAYOUT, 90, 1)
    a = bj.reconstruct(enc.coefs, LAYOUT, 90)
    b = bj.reconstruct(enc.coefs, LAYOUT, 90, dct="float32")
    assert any(not np.array_equal(x, y) for x, y in zip(a, b))
    assert max(np.abs(x.astype(int) - y).max() for x, y in zip(a, b)) <= 2
