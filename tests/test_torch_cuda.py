"""K1-K4 CUDA kernels against their plain versions on the card, and the
transcode on the card against the same session on the CPU. Marked
``cuda``: they skip without a GPU (run them on one with
``python -m pytest -m cuda tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from video_coding_tpu_torch.common.bitstream import BitReader
from video_coding_tpu_torch.entropy import huffman_decode, huffman_encode
from video_coding_tpu_torch.entropy.scan import _destuff_parts
from video_coding_tpu_torch.model.header import Header, Parameters
from video_coding_tpu_torch.ops import datapath
from video_coding_tpu_torch.runtime.engine import (JpegEncoderSession,
                                                   JpegTranscodeSession)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


def _streams(gpu, n=3, w=256, h=128):
    rng = np.random.default_rng(0)
    frames = [(rng.integers(0, 256, (h, w), dtype=np.uint8),
               rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
               rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
              for _ in range(n)]
    enc = JpegEncoderSession(Parameters.c420(w, h, 80), 1, device=gpu)
    streams = enc.encode_device_batch(frames)
    bits = BitReader(streams[0])
    header = Header.decode(bits)
    return header, [s[bits.bit_pos >> 3:] for s in streams]


def test_kernels_match_plain_versions(gpu):
    header, payloads = _streams(gpu)
    t = JpegTranscodeSession(header, quality=75, restart_interval=1,
                             device=gpu)
    dec, enc = t.decoder, t.encoder
    parts, lens_parts = _destuff_parts(payloads, dec.n_segments)
    flat = np.concatenate(parts)
    starts, lens, segb, _inv = dec._flat_lane_inputs(
        np.concatenate(lens_parts),
        np.tile(dec._expected_seg_blocks(dec.n_segments), len(payloads)))
    args = [torch.from_numpy(a).to(gpu) for a in (flat, starts, lens, segb)]
    st = dec.state
    kw = dict(blocks_per_segment=dec.blocks_per_segment,
              n_components=len(dec.components))
    k1 = (*args, dec._comp_sched, st.lo, st.hi, st.offset, st.values)
    coefs = huffman_decode.decode_flat(*k1, **kw)
    assert torch.equal(coefs, huffman_decode.decode_flat_plain(*k1, **kw))
    pool = coefs.view(-1, 64)
    px = datapath.decode_datapath(pool, dec._quant_seg)
    assert torch.equal(px, datapath.decode_datapath_plain(pool,
                                                          dec._quant_seg))
    qc = datapath.encode_datapath(px, enc.state.quant[:6].contiguous())
    assert torch.equal(qc, datapath.encode_datapath_plain(
        px, enc.state.quant[:6].contiguous()))
    qc_seg = qc.view(-1, enc.blocks_per_segment * 64)
    valid = torch.ones((qc_seg.shape[0], enc.blocks_per_segment),
                       dtype=torch.uint8, device=gpu)
    for m_out in (40, 400):       # overflowing and fitting budgets
        k4 = (qc_seg, valid, enc._comp_sched, enc.state.dctab,
              enc.state.actab)
        got = huffman_encode.encode_segments(*k4, m_out=m_out)
        ref = huffman_encode.encode_segments_plain(*k4, m_out=m_out)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


def test_transcode_on_card_matches_cpu(gpu):
    header, payloads = _streams(gpu)
    outs = JpegTranscodeSession(header, 70, 2, device=gpu) \
        .transcode_batch(payloads)
    ref = JpegTranscodeSession(header, 70, 2, device="cpu") \
        .transcode_batch(payloads)
    assert outs == ref
