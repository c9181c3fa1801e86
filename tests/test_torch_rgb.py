"""The port's decode-for-training path on the CPU: ``decode_device_rgb``,
``decode_device_rgb_batch`` and ``JpegRgbDataset`` against the JAX
package's session and dataset, on 4:2:0, 4:2:2, 4:4:0 and 4:4:4 streams
of even and odd sizes, restart intervals 0, 1 and 2. Tolerance: exact
equality.

Where luma is odd in a subsampled direction the JAX package's RGB tail
raises (it crops chroma to the rounded-down size, so its upsampled chroma
is one short); there the reference is the JAX package's own pieces — its
session's planes, chroma cropped to T.81's rounded-up size and upsampled
by its ``ops/color.py``, and its jitted ``yuv444_to_rgb``."""

import jax

import numpy as np
import pytest
import torch

from video_coding_tpu.common.bitstream import BitReader as RefBitReader
from video_coding_tpu.model.decoder import Header as RefHeader
from video_coding_tpu.ops import color as jcolor
from video_coding_tpu.runtime import engine as jengine
from video_coding_tpu.runtime.dataset import JpegRgbDataset as RefDataset
from video_coding_tpu_torch.common.bitstream import BitReader
from video_coding_tpu_torch.model.header import DecodeError, Header
from video_coding_tpu_torch.runtime.dataset import JpegRgbDataset
from video_coding_tpu_torch.runtime.engine import JpegDecoderSession
from video_coding_tpu_torch.tools import mjpeg

from _torch_fixtures import (encode, encode_monochrome, synth_frame,
                             synth_plane)

CASES = [("420", 64, 48, 0), ("420", 61, 45, 1), ("420", 61, 45, 0),
         ("422", 64, 32, 2), ("422", 45, 61, 1), ("440", 48, 64, 1),
         ("440", 61, 45, 2), ("444", 40, 24, 1), ("444", 61, 45, 0),
         ("420", 17, 9, 2)]


def _sessions(stream):
    """(port session on the CPU, JAX session, payload)."""
    bits = BitReader(stream)
    header = Header.decode(bits)
    rbits = RefBitReader(stream)
    ref = jengine.JpegDecoderSession(RefHeader.decode(rbits))
    return (JpegDecoderSession(header, device="cpu"), ref,
            stream[bits.bit_pos >> 3:])


def _jax_rgb(ref, payloads):
    """(F, H, W, 3) RGB of the JAX session: its RGB entry point, or, where
    that raises (luma odd in a subsampled direction, where the JAX tail
    crops chroma to the rounded-down size), its pieces on chroma cropped to
    T.81's rounded-up size."""
    comps = ref.components
    yh, yw = comps[0].actual_height, comps[0].actual_width
    sh = (comps[0].component.horizontal_sampling_factor
          // comps[1].component.horizontal_sampling_factor)
    sv = (comps[0].component.vertical_sampling_factor
          // comps[1].component.vertical_sampling_factor)
    if (sv * comps[1].actual_height >= yh
            and sh * comps[1].actual_width >= yw):
        return np.asarray(ref.decode_device_rgb_batch(payloads))
    with pytest.raises(TypeError):
        ref.decode_device_rgb(payloads[0])
    up = {(2, 2): jcolor.upsample_hv2, (2, 1): jcolor.upsample_h2,
          (1, 2): jcolor.upsample_v2}[(sh, sv)]
    out = []
    for p in payloads:
        y, u, v = (np.asarray(x) for x in ref.decode_device_e2e(p))
        u, v = (np.asarray(up(c[:-(-yh // sv), :-(-yw // sh)]))[:yh, :yw]
                for c in (u, v))
        out.append(np.asarray(jax.jit(jcolor.yuv444_to_rgb)(
            y[:yh, :yw], u, v)))
    return np.stack(out)


@pytest.mark.parametrize("sub,w,h,ri", CASES)
def test_decode_device_rgb_matches_jax(sub, w, h, ri):
    stream = encode(sub, synth_frame(sub, w, h, w + h + ri), 80, ri)
    port, ref, payload = _sessions(stream)
    want = _jax_rgb(ref, [payload])[0]
    got = port.decode_device_rgb(payload)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert got.shape == (h, w, 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sub,w,h,ri", CASES[:6])
def test_decode_device_rgb_batch_matches_jax(sub, w, h, ri):
    """Three different frames in one batch: equal to the JAX batch and to
    each frame's single-frame RGB."""
    streams = [encode(sub, synth_frame(sub, w, h, s), 75, ri)
               for s in range(3)]
    port, ref, p0 = _sessions(streams[0])
    hdr_len = len(streams[0]) - len(p0)   # the frames share headers
    payloads = [s[hdr_len:] for s in streams]
    want = _jax_rgb(ref, payloads)
    got = port.decode_device_rgb_batch(payloads)
    assert got.shape == (3, h, w, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    for i, p in enumerate(payloads):
        np.testing.assert_array_equal(got[i].numpy(),
                                      port.decode_device_rgb(p).numpy())


def test_rgb_needs_three_components():
    stream = encode_monochrome(synth_plane(32, 16, 3), 75, 1)
    port, ref, payload = _sessions(stream)
    with pytest.raises(DecodeError, match="3-component"):
        port.decode_device_rgb(payload)
    with pytest.raises(DecodeError, match="3-component"):
        port.decode_device_rgb_batch([payload])
    with pytest.raises(Exception, match="3-component"):
        ref.decode_device_rgb(payload)
    with pytest.raises(DecodeError):
        JpegRgbDataset([stream], device="cpu")


@pytest.fixture(scope="module")
def stream10():
    """An MJPEG stream of 10 distinct 4:2:0 frames of 48x32, ri=2."""
    return mjpeg.join_stream([encode("420", synth_frame("420", 48, 32, s),
                                     75, 2) for s in range(10)])


def test_dataset_batches_match_jax_dataset(stream10):
    ds = JpegRgbDataset(stream10, batch_size=4, prefetch=2, device="cpu")
    assert len(ds) == 3 and ds.frame_shape == (32, 48, 3)
    batches = list(ds)
    assert [tuple(b.shape) for b in batches] == [(4, 32, 48, 3),
                                                 (4, 32, 48, 3),
                                                 (2, 32, 48, 3)]
    assert all(b.dtype == torch.uint8 and b.device.type == "cpu"
               for b in batches)
    ref = list(RefDataset(stream10, batch_size=4, prefetch=2))
    for b, r in zip(batches, ref):
        np.testing.assert_array_equal(b.numpy(), np.asarray(r))
    np.testing.assert_array_equal(
        batches[0][1].numpy(),
        ds.session.decode_device_rgb(ds.payloads[1]).numpy())


def test_dataset_list_input_drop_remainder_and_session(stream10):
    frames = mjpeg.split_stream(stream10)
    ds = JpegRgbDataset(frames, batch_size=4, drop_remainder=True,
                        device="cpu")
    assert len(ds) == 2
    assert [b.shape[0] for b in ds] == [4, 4]
    ds6 = JpegRgbDataset(frames, batch_size=6, drop_remainder=True,
                         session=ds.session)
    assert ds6.session is ds.session and len(ds6) == 1
    (b,) = list(ds6)
    np.testing.assert_array_equal(b.numpy(),
                                  torch.cat(list(ds)[:2])[:6].numpy())
    with pytest.raises(ValueError, match="no frames"):
        JpegRgbDataset(b"", device="cpu")


def test_dataset_sharding_is_not_ported(stream10):
    """Only a rank mesh (``DeviceMesh``) shards the port's dataset; any
    other sharding object (the JAX package takes a ``jax.sharding``) is
    refused. The mesh is tested in tests/test_torch_parallel.py."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        JpegRgbDataset(stream10, batch_size=8, sharding=object(),
                       device="cpu")
