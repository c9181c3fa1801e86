"""Port K4 (plain version, CPU) + wire assembly against the reference fused
Pallas entropy encoder (encode_segments_fused, interpret mode) followed
by assemble_stream_device_packed. Tolerance: exact equality of wire
bytes, segment lengths and the overflow flag."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_coding_tpu.entropy import pallas_encode, tpu_encode
from video_coding_tpu.model import encoder as menc
from video_coding_tpu.runtime import engine
from video_coding_tpu_torch.entropy import huffman_encode
from video_coding_tpu_torch.entropy.assemble import assemble_frames

from _torch_fixtures import ENCODERS, synth_frame

W, H, Q, RI = 64, 48, 75, 1


def _segments():
    """Quantized blocks of a 64x48 frame from the reference model, cut
    into restart segments, plus the reference session's tables."""
    frame = synth_frame("420", W, H, seed=21)
    params = ENCODERS["420"][2](W, H, Q)
    enc = menc.Encoder(params, restart_interval=RI)
    enc.load_frame(frame)
    qc = enc.quantized_blocks().astype(np.int32)
    jenc = engine.JpegEncoderSession(params, restart_interval=RI)
    B = jenc.blocks_per_segment
    S = qc.shape[0] // B
    tabs = tpu_encode.device_encoder_tables(jenc.tables)
    stream = menc.encode_420(frame, Q, restart_interval=RI)
    return qc.reshape(S, B * 64), jenc, tabs, stream


def _reference(qc_seg, jenc, tabs, msb):
    B = jenc.blocks_per_segment
    S = qc_seg.shape[0]
    dctab = ((tabs[0] << 5) | tabs[1]).reshape(-1, 1)
    actab = ((tabs[2] << 5) | tabs[3]).reshape(-1, 1)
    m_out = msb + msb // 4 + 8
    words, lens, ovf = pallas_encode.encode_segments_fused(
        jnp.asarray(qc_seg), jnp.ones((S, B), jnp.int32),
        jnp.asarray(dctab), jnp.asarray(actab),
        comp_sched=tuple(int(x) for x in jenc.comp_idx[:B]), m_out=m_out,
        interpret=True, raw_words=True)
    cap = S * m_out + 2 * S
    buf, total = tpu_encode.assemble_stream_device_packed(
        words, lens, cap=cap)
    return np.asarray(buf), int(total), np.asarray(lens), bool(ovf), m_out


def _port(qc_seg, jenc, tabs, m_out):
    B = jenc.blocks_per_segment
    S = qc_seg.shape[0]
    dctab, actab = huffman_encode.packed_tables(*tabs)
    out, lens, ovf = huffman_encode.encode_segments(
        torch.from_numpy(qc_seg), torch.ones((S, B), dtype=torch.uint8),
        torch.from_numpy(jenc.comp_idx[:B].astype(np.int32)),
        torch.from_numpy(dctab), torch.from_numpy(actab), m_out=m_out)
    bufs, totals = assemble_frames(out, lens, frames=1, n_seg=S,
                                   cap=S * m_out + 2 * S)
    return bufs[0].numpy(), int(totals[0]), lens.numpy(), bool(ovf)


def test_encode_segments_and_assembly_match_pallas():
    qc_seg, jenc, tabs, stream = _segments()
    msb = jenc.blocks_per_segment * 24 + 64
    rbuf, rtotal, rlens, rovf, m_out = _reference(qc_seg, jenc, tabs, msb)
    pbuf, ptotal, plens, povf = _port(qc_seg, jenc, tabs, m_out)
    assert not rovf and not povf
    np.testing.assert_array_equal(plens, rlens)
    assert ptotal == rtotal
    np.testing.assert_array_equal(pbuf[:ptotal], rbuf[:rtotal])
    # and the wire body is the model encoder's, between header and EOI
    hdr = len(jenc._header_bytes)
    assert pbuf[:ptotal].tobytes() == stream[hdr:-2]


def test_encode_segments_overflow_matches_pallas():
    """A tiny per-segment budget overflows in both; lengths still agree
    (they count the bytes the segment needed)."""
    qc_seg, jenc, tabs, _ = _segments()
    rbuf, rtotal, rlens, rovf, m_out = _reference(qc_seg, jenc, tabs, 8)
    pbuf, ptotal, plens, povf = _port(qc_seg, jenc, tabs, m_out)
    assert rovf and povf
    np.testing.assert_array_equal(plens, rlens)


def test_valid_mask_blocks_emit_nothing():
    """valid == 0 blocks emit no bits and leave the predictors alone: a
    segment with its last block masked equals the segment cut short."""
    qc_seg, jenc, tabs, _ = _segments()
    B = jenc.blocks_per_segment
    dctab, actab = map(torch.from_numpy, huffman_encode.packed_tables(*tabs))
    sched = torch.from_numpy(jenc.comp_idx[:B].astype(np.int32))
    qc = torch.from_numpy(qc_seg[:4])
    valid = torch.ones((4, B), dtype=torch.uint8)
    valid[:, -1] = 0
    out_m, lens_m, _ = huffman_encode.encode_segments(
        qc, valid, sched, dctab, actab, m_out=400)
    qc_cut = qc.clone().view(4, B, 64)
    qc_cut[:, -1] = 0
    # a zero block still emits DC + EOB, so compare against B-1 blocks
    out_c, lens_c, _ = huffman_encode.encode_segments(
        qc_cut[:, :-1].reshape(4, -1).contiguous(),
        torch.ones((4, B - 1), dtype=torch.uint8), sched[:-1].contiguous(),
        dctab, actab, m_out=400)
    assert torch.equal(lens_m, lens_c)
    assert torch.equal(out_m, out_c)


def test_device_encoder_tables_match_reference():
    _, jenc, tabs, _ = _segments()
    from video_coding_tpu_torch.entropy.tables import EncoderTables
    mine = huffman_encode.device_encoder_tables(EncoderTables(
        jenc.tables.dc_bits, jenc.tables.dc_len, jenc.tables.ac_bits,
        jenc.tables.ac_len))
    for a, b in zip(mine, tabs):
        np.testing.assert_array_equal(a, b)
    bad = EncoderTables(jenc.tables.dc_bits, np.where(
        jenc.tables.dc_len > 0, 1, 0).astype(np.uint8), jenc.tables.ac_bits,
        jenc.tables.ac_len)
    with pytest.raises(ValueError):
        huffman_encode.device_encoder_tables(bad)
