"""The dispatch-wide destuff (``entropy.scan.destuff_dispatch``) on the
CPU: one flat buffer a thread reuses, frame i in a slot from the sum of
the input lengths before it, on the standing pool. Held against the
per-frame ``destuff_flat`` joined end to end, which it replaces: the same
bytes at every lane's start and length, the same lengths, the same
errors; zeros between frames and after the last even where an earlier,
larger dispatch left other bytes; one ``destuff_flat`` call a frame; the
``decode.destuff_pool`` counters; and the sessions' pipelined decode and
transcode equal to one dispatch at a time. Tolerance: exact equality."""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from video_coding_tpu_torch.common.bitstream import BitReader
from video_coding_tpu_torch.entropy import scan
from video_coding_tpu_torch.model.header import DecodeError, Header
from video_coding_tpu_torch.runtime import trace
from video_coding_tpu_torch.runtime.engine import (JpegDecoderSession,
                                                   JpegTranscodeSession)

from _torch_fixtures import encode, synth_frame


def _entropy(seed: int, n_seg: int, seg_len: int, tail: bytes = b"",
             stuffed: bool = True) -> bytes:
    """An entropy stream of ``n_seg`` segments of about ``seg_len`` bytes:
    every 0xFE of random bytes becomes a stuffed 0xFF00 (none is drawn
    unless ``stuffed``), the segments joined by RST0-7 (some after a
    fill byte), then ``tail``."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(max(1, seg_len // 2), seg_len * 3 // 2 + 1, n_seg)
    body = rng.integers(0, 255 if stuffed else 254, int(lens.sum()),
                        dtype=np.uint8).tobytes()
    cuts = np.concatenate([[0], np.cumsum(lens)]).tolist()
    fills = rng.random(n_seg) < 0.05
    out = []
    for s in range(n_seg):
        if s:
            out.append(b"\xff\xff" if fills[s] else b"\xff")
            out.append(bytes((0xD0 + ((s - 1) & 7),)))
        out.append(body[cuts[s]:cuts[s + 1]].replace(b"\xfe", b"\xff\x00"))
    return b"".join(out) + tail


# (frames, segments a frame, mean segment bytes, bytes after the scan)
CASES = {
    "ri1-1080p": (16, 8160, 60, b""),          # a restart every 4:2:0 MCU
    "dri480-4k": (4, 68, 26000, b""),          # two MCU rows a segment
    "ri0-indexed": (3, 1, 5000, b""),          # one segment a frame
    "one-frame": (1, 40, 300, b""),
    "ragged-chunk": (3, 1, 200, b""),          # after a dispatch of 8
    "other-marker": (5, 30, 100, b"\xff\xd9\xff\xd0junk\xff\x00"),
}


def _joined(streams: list) -> tuple[np.ndarray, np.ndarray]:
    """The replaced path: each frame by ``destuff_flat``, the frames end
    to end → (flat bytes, per-lane lengths)."""
    parts = [scan.destuff_flat(s) for s in streams]
    return (np.concatenate([p for p, _ in parts]),
            np.concatenate([n for _, n in parts]))


def _lane_bytes(d: scan.Destuffed) -> np.ndarray:
    """Every lane's bytes of a dispatch, in lane order, end to end."""
    starts, lens = d.starts.reshape(-1), d.lens.reshape(-1)
    packed = np.cumsum(lens) - lens
    idx = np.repeat(starts - packed, lens) + np.arange(int(lens.sum()))
    return d.flat[idx]


def _assert_zero_outside_lanes(d: scan.Destuffed) -> None:
    live = np.zeros(len(d.flat), bool)
    ends = d.bases + d.lens.sum(axis=1)
    for b, e in zip(d.bases.tolist(), ends.tolist()):
        live[b:e] = True
    assert not d.flat[~live].any()
    assert len(d.flat) % 16 == 0 and len(d.flat) - int(ends[-1]) >= 8


@pytest.mark.parametrize("case", list(CASES))
def test_dispatch_destuff_matches_per_frame_destuff_joined(case):
    """Equal lane bytes and lengths to the joined per-frame destuff; the
    slots start at the input offsets; zeros between and after the frames,
    also where the previous dispatch on this thread was larger (the
    ragged chunk follows one of 8 frames with other bytes, and its frames
    destuff to their full length, so the guard bytes lie past the last
    slot)."""
    F, n_seg, seg_len, tail = CASES[case]
    ragged = case == "ragged-chunk"
    streams = [_entropy(1000 * i + F, n_seg, seg_len, tail,
                        stuffed=not ragged) for i in range(min(F, 4))]
    streams = [streams[i % len(streams)] for i in range(F)]
    if ragged:
        big = [_entropy(77 + i, n_seg, 4 * seg_len) for i in range(8)]
        scan.destuff_dispatch(big, n_seg)
    d = scan.destuff_dispatch(streams, n_seg)
    flat, lens = _joined(streams)
    np.testing.assert_array_equal(d.lens.reshape(-1), lens)
    np.testing.assert_array_equal(_lane_bytes(d), flat)
    np.testing.assert_array_equal(
        d.bases, np.cumsum([0] + [len(s) for s in streams[:-1]]))
    np.testing.assert_array_equal(d.starts[:, 0], d.bases)
    _assert_zero_outside_lanes(d)


@pytest.mark.parametrize("delta", [-1, 1])
def test_dispatch_destuff_refuses_another_segment_count(delta):
    """A frame with one segment more or fewer than the session's count
    raises DecodeError, as the per-frame path did, and the next dispatch
    on the thread is whole."""
    good = [_entropy(5, 50, 80), _entropy(6, 50, 80)]
    with pytest.raises(DecodeError, match="restart segment count"):
        scan.destuff_dispatch([good[0], _entropy(7, 50 + delta, 80)], 50)
    d = scan.destuff_dispatch(good, 50)
    np.testing.assert_array_equal(_lane_bytes(d), _joined(good)[0])


def test_destuff_flat_out_writes_the_slot_and_allocates_for_nothing_else():
    """``destuff_flat(out=(flat, ends))``: both tiers write the bytes at
    the slot's start, zero the rest of it, give the segment ends, and
    return views; without ``out`` the arrays are the caller's own."""
    data = _entropy(9, 12, 40, b"\xff\xd9tail")
    want, lens = scan.destuff_flat(data)
    for use_native in (None, False):
        flat = np.full(len(data) + 5, 0xAB, np.uint8)
        ends = np.full(12, -1, np.int64)
        got, got_ends = scan.destuff_flat(data, use_native,
                                          out=(flat, ends))
        assert np.shares_memory(got, flat) and np.shares_memory(got_ends,
                                                                ends)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_ends, np.cumsum(lens))
        assert not flat[len(want):].any()
        with pytest.raises(ValueError, match="restart segments"):
            scan.destuff_flat(data, use_native, out=(flat, ends[:11]))
        with pytest.raises(ValueError, match="out buffer"):
            scan.destuff_flat(data, use_native,
                              out=(flat[:len(data) - 1], ends))
    again, _ = scan.destuff_flat(data)
    assert not np.shares_memory(again, want)


def _session(sub, w, h, q, ri, n=6, **kw):
    streams = [encode(sub, synth_frame(sub, w, h, seed), q, ri)
               for seed in range(n)]
    bits = BitReader(streams[0])
    header = Header.decode(bits)
    return header, [s[bits.bit_pos >> 3:] for s in streams]


def test_destuff_flat_is_called_once_a_frame_when_wrapped(monkeypatch):
    """A wrapper set on ``scan.destuff_flat`` the way the benchmark's
    span patch sets it sees each frame of a dispatch once, on the
    restart route and on the restart-free indexed route."""
    calls = []
    inner = scan.destuff_flat

    def wrapped(*a, **k):
        calls.append(len(a[0]))
        return inner(*a, **k)

    monkeypatch.setattr(scan, "destuff_flat", wrapped)
    for ri in (2, 0):
        header, payloads = _session("420", 128, 64, 80, ri, n=5)
        sess = JpegDecoderSession(header, device="cpu")
        calls.clear()
        sess.decode_device_batch(payloads)
        assert sorted(calls) == sorted(map(len, payloads))


def test_destuff_pool_reports_buffer_and_growth():
    """``decode.destuff_pool``: ``grown`` 1 on a new thread's first
    dispatch, 0 on a second of the same size and on a smaller one, 1 on
    a larger; ``buffer_bytes`` the capacity, never less than the data."""
    a = [_entropy(20 + i, 30, 90) for i in range(4)]
    b = [_entropy(30 + i, 30, 900) for i in range(4)]
    out = []

    def run():
        with trace.recording() as rec:
            for batch in (a, a, a[:2], b):
                scan.destuff_dispatch(batch, 30)
        out.extend(s.attrs for s in rec.spans
                   if s.name == "decode.destuff_pool")

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert [s["grown"] for s in out] == [1, 0, 0, 1]
    assert [s["frames"] for s in out] == [4, 4, 2, 4]
    assert out[0]["buffer_bytes"] == out[1]["buffer_bytes"] >= sum(map(len, a))
    assert out[3]["buffer_bytes"] >= sum(map(len, b))


def test_dispatch_buffers_are_the_calling_threads_own():
    """More threads than cores destuff different dispatches at once with
    a short switch interval: every result equals its own joined
    per-frame destuff (a buffer shared across threads would mix them)."""
    n = max(12, 2 * (os.cpu_count() or 1))
    batches = [[_entropy(100 * k + i, 40, 60 + 20 * k % 400)
                for i in range(3)] for k in range(n)]
    wants = [_joined(b)[0] for b in batches]
    bad = []

    def run(k):
        for _ in range(5):
            d = scan.destuff_dispatch(batches[k], 40)
            if not np.array_equal(_lane_bytes(d), wants[k]):
                bad.append(k)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(k,)) for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert bad == []


@pytest.mark.parametrize("ri", [1, 0])
def test_pipelined_decode_equals_one_dispatch_at_a_time(ri):
    """A depth-2 ``decode_device_batch_iter`` over 7 chunks (a ragged
    last one), each chunk other frames than the one before, gives the
    planes of one dispatch at a time: no buffer is reused while a
    dispatch still reads it. ri=0 takes the indexed route."""
    header, payloads = _session("420", 128, 64, 85, ri, n=6)
    order = [i % 6 for i in range(0, 5 * 13, 5)]
    sess = JpegDecoderSession(header, device="cpu")
    chunks = [order[i:i + 2] for i in range(0, len(order), 2)]
    assert len(chunks) == 7 and len(chunks[-1]) == 1
    want = [sess.decode_device_batch_stacked([payloads[i] for i in c])
            for c in chunks]
    got = list(sess.decode_device_batch_iter(
        (payloads[i] for i in order), batch=2, depth=2))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a, b)


def test_pipelined_transcode_equals_one_dispatch_at_a_time():
    """A depth-2 ``transcode_batch_iter`` over 5 chunks gives the bytes
    of one ``transcode_batch`` at a time."""
    header, payloads = _session("420", 96, 48, 90, 1, n=5)
    t = JpegTranscodeSession(header, quality=75, restart_interval=1,
                             device="cpu")
    order = [0, 3, 1, 4, 2, 2, 0, 4, 1]
    want = [o for i in range(0, len(order), 2)
            for o in t.transcode_batch([payloads[j]
                                        for j in order[i:i + 2]])]
    got = list(t.transcode_batch_iter((payloads[i] for i in order),
                                      batch=2, depth=2))
    assert got == want
