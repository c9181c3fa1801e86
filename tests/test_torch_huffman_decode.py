"""Port K1 (plain version, CPU) against the reference lanes-major Pallas
Huffman decode kernel (decode_flat_pallas_t) in interpret mode, on
64x48 restart-interval-1 streams from the reference model encoder and on
a corrupt/truncated stream. Tolerance: exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_coding_tpu.entropy import pallas_decode, tpu_decode
from video_coding_tpu.entropy import scan as jscan
from video_coding_tpu.runtime import engine
from video_coding_tpu_torch.entropy import huffman_decode

from _torch_fixtures import encode, header_payload, synth_frame


def _lane_inputs(sub: str, q: int, seed: int):
    stream = encode(sub, synth_frame(sub, 64, 48, seed), q, 1)
    header, payload = header_payload(stream)
    dec = engine.JpegDecoderSession(header)
    flat, lens64 = jscan.destuff_flat(payload)
    segb = dec._expected_seg_blocks(len(lens64))
    return dec, dec._flat_lane_inputs(flat, lens64, segb)


def _both(dec, flat_p, starts, lens, segb, L):
    B = dec.blocks_per_segment
    C = len(dec.components)
    sched = dec.comp_idx[:B].astype(np.int32)
    tabs = tpu_decode.range_tables(dec.tables)
    ref = np.asarray(pallas_decode.decode_flat_pallas_t(
        jnp.asarray(flat_p), jnp.asarray(starts), jnp.asarray(lens),
        jnp.asarray(segb), jnp.asarray(sched), *map(jnp.asarray, tabs),
        L=L, blocks_per_segment=B, n_components=C, interpret=True))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got = huffman_decode.decode_flat(
        t(flat_p), t(starts), t(lens), t(segb), t(sched), *map(t, tabs),
        blocks_per_segment=B, n_components=C).numpy()
    return got, ref


@pytest.mark.parametrize("sub,q", [("420", 75), ("444", 50)])
def test_decode_flat_matches_pallas(sub, q):
    dec, (flat_p, starts, lens, segb, _inv, L, _M) = _lane_inputs(
        sub, q, seed=5)
    got, ref = _both(dec, flat_p, starts, lens, segb, L)
    assert got.shape == ref.shape == (len(starts), dec.blocks_per_segment,
                                      64)
    np.testing.assert_array_equal(got, ref)
    assert np.abs(got).sum() > 0


def test_decode_flat_corrupt_truncated_terminates_and_matches():
    """Random bytes in place of entropy data and segments cut short:
    both decoders still terminate (step cap / zero fill past the length)
    and agree bit for bit."""
    dec, (flat_p, starts, lens, segb, _inv, L, _M) = _lane_inputs(
        "420", 75, seed=9)
    rng = np.random.default_rng(9)
    bad = flat_p.copy()
    n = int(lens.sum())
    bad[:n] = rng.integers(0, 256, n).astype(np.uint8)
    cut = (lens // 2).astype(np.int32)
    got, ref = _both(dec, bad, starts, cut, segb, L)
    np.testing.assert_array_equal(got, ref)
    assert np.abs(got).max() <= 32767


def test_decode_flat_rejects_bad_inputs():
    i32 = torch.zeros(2, dtype=torch.int32)
    tab = torch.zeros((6, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        huffman_decode.decode_flat(
            torch.zeros(8, dtype=torch.int64), i32, i32, i32,
            torch.zeros(6, dtype=torch.int32), tab, tab, tab,
            torch.zeros(128, dtype=torch.int32), blocks_per_segment=6,
            n_components=3)
