"""The port's ``runtime/trace.py`` on the CPU: every ``DecodeTrace`` stage
against the JAX package's ``pipeline_trace`` on seeded and extreme
coefficients, ``recon`` against the port's decode datapath (K2's plain
version), ``profile`` writing a Chrome trace with the program's spans on
its clock, and the span recorder: off it reads no clock; on, nesting,
work handed to other threads, the cap and the decode path's span tree
with its counts. Tolerance: exact equality (0.1 ms for the clocks).
``pipeline_trace`` runs on the card unless asked for the CPU, as the
other entry points do."""

import collections
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from video_coding_tpu.runtime.trace import pipeline_trace as jax_trace
from video_coding_tpu_torch.common.bitstream import BitReader
from video_coding_tpu_torch.entropy import scan
from video_coding_tpu_torch.entropy.decode_tables import (auto_strategy,
                                                          flat_words_route)
from video_coding_tpu_torch.model.header import Header
from video_coding_tpu_torch.ops import datapath
from video_coding_tpu_torch.runtime import engine, trace

from _torch_fixtures import encode, synth_frame

FIELDS = ["coefs_zigzag", "dequant_zigzag", "dequant_natural",
          "after_row_pass", "after_col_pass", "clipped", "recon"]


def _inputs(case: str, n: int = 40):
    rng = np.random.default_rng(len(case) + n)
    if case == "seeded":
        coefs = rng.integers(-200, 200, (n, 64)) * (rng.random((n, 64)) < .3)
        quant = rng.integers(1, 100, (n, 64))
    elif case == "extreme_2047":
        coefs = rng.choice([-2047, 2047, 0], (n, 64))
        quant = rng.integers(1, 256, (n, 64))
    elif case == "extreme_32767_q255":
        coefs = rng.choice([-32767, 32767], (n, 64))
        quant = np.full((n, 64), 255)
    else:  # one quant row for every block
        coefs = rng.integers(-1024, 1024, (n, 64))
        quant = rng.integers(1, 256, 64)
    return coefs.astype(np.int32), quant.astype(np.int32)


CASES = ["seeded", "extreme_2047", "extreme_32767_q255", "one_quant_row"]


@pytest.mark.parametrize("case", CASES)
def test_pipeline_trace_matches_jax(case):
    coefs, quant = _inputs(case)
    got = trace.pipeline_trace(coefs, quant, device="cpu")
    want = jax_trace(coefs, quant)
    for name in FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_pipeline_trace_recon_is_the_datapath(case):
    coefs, quant = _inputs(case)
    q = np.broadcast_to(quant, coefs.shape).copy()
    pix = datapath.decode_datapath(torch.from_numpy(coefs),
                                   torch.from_numpy(q))
    np.testing.assert_array_equal(
        trace.pipeline_trace(coefs, quant, device="cpu").recon,
                                  pix.numpy().astype(np.int32))


def test_profile_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "prof"
    with trace.profile(str(log_dir)) as prof:
        trace.pipeline_trace(*_inputs("seeded", 8), device="cpu")
    assert prof is not None
    (name,) = os.listdir(log_dir)
    data = json.loads((log_dir / name).read_text())
    assert data["traceEvents"]


def test_pipeline_trace_defaults_to_the_card():
    """No device means the card: without one it raises rather than fall
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the default without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trace.pipeline_trace(*_inputs("seeded", 4))


# -- the span recorder ---------------------------------------------------------

def test_off_the_recorder_reads_no_clock(monkeypatch):
    """Off, ``span`` is the shared no-op and nothing reads the clock or
    records; the same calls on read it (the stub is the one used)."""
    reads = []

    def clock():
        reads.append(1)
        return len(reads)

    monkeypatch.setattr(time, "perf_counter_ns", clock)
    assert trace.span("a", n=1) is trace.span("b")
    with trace.span("a", n=1):
        trace.attrs(m=2)
    fn = trace.queued("pipeline.queue", lambda x: x + 1, dispatch=0)
    assert fn(1) == 2 and trace.carry(len)("ab") == 2
    assert reads == []
    with trace.recording() as rec:
        with trace.span("a"):
            pass
    assert reads and [s.name for s in rec.spans] == ["a"]


def test_nesting_gives_parents_and_one_dispatch():
    with trace.recording() as rec:
        with trace.span("outer", frames=2):
            with trace.span("inner") as inner:
                trace.attrs(lanes=3)
            with trace.span("sibling"):
                pass
        with trace.span("next"):
            pass
    by = {s.name: s for s in rec.spans}
    assert inner is not None and by["inner"].attrs == {"lanes": 3}
    assert by["outer"].parent is None and by["outer"].attrs == {"frames": 2}
    assert by["inner"].parent == by["sibling"].parent == by["outer"].id
    assert by["inner"].dispatch == by["outer"].dispatch
    assert by["next"].dispatch != by["outer"].dispatch
    assert by["outer"].start_ns <= by["inner"].start_ns \
        <= by["inner"].end_ns <= by["sibling"].start_ns \
        <= by["outer"].end_ns
    assert len({s.id for s in rec.spans}) == 4 and rec.dropped == 0


def test_work_handed_to_a_pool_keeps_parent_and_dispatch():
    def work(i):
        with trace.span("work", i=i):
            return i

    with trace.recording() as rec:
        with trace.span("parent"):
            with ThreadPoolExecutor(max_workers=3) as ex:
                assert list(ex.map(trace.carry(work), range(6))) == \
                    list(range(6))
        with ThreadPoolExecutor(max_workers=2) as ex:
            futs = [ex.submit(trace.queued("pipeline.queue", work, dispatch=i),
                              i) for i in range(4)]
            assert [f.result(timeout=30) for f in futs] == list(range(4))
    parent = [s for s in rec.spans if s.name == "parent"][0]
    carried = [s for s in rec.spans if s.name == "work" and s.attrs["i"] < 6
               and s.parent == parent.id]
    assert len(carried) == 6
    assert all(s.dispatch == parent.dispatch for s in carried)
    assert {s.tid for s in carried} - {parent.tid}
    waits = {s.id: s for s in rec.spans if s.name == "pipeline.queue"}
    assert sorted(w.attrs["dispatch"] for w in waits.values()) == [0, 1, 2, 3]
    assert len({w.dispatch for w in waits.values()} | {parent.dispatch}) == 5
    handed = [s for s in rec.spans if s.name == "work"
              and s.parent in waits]
    assert len(handed) == 4
    for s in handed:
        w = waits[s.parent]
        assert s.dispatch == w.dispatch and s.attrs["i"] == \
            w.attrs["dispatch"]
        assert w.end_ns <= s.start_ns and w.tid != s.tid


def test_the_cap_counts_dropped_spans(monkeypatch):
    monkeypatch.setattr(trace, "CAP", 5)
    with trace.recording() as rec:
        for _ in range(12):
            with trace.span("x"):
                pass
    assert len(rec.spans) == 5 and rec.dropped == 7
    trace.start()
    with pytest.raises(RuntimeError, match="already on"):
        trace.start()
    assert trace.stop().spans == []
    with pytest.raises(RuntimeError, match="not on"):
        trace.stop()


def _dispatch_streams(n=8):
    streams = [encode("420", synth_frame("420", 256, 128, seed), 75, 4)
               for seed in range(n)]
    bits = BitReader(streams[0])
    header = Header.decode(bits)
    return header, [s[bits.bit_pos >> 3:] for s in streams]


def test_decode_iter_records_each_dispatch_tree():
    """256x128 4:2:0, a restart every 4 MCUs, 4 frames a dispatch: each
    dispatch is pipeline.queue -> decode.dispatch -> {decode.destuff_pool
    -> 4 decode.destuff, decode.lane_prep, uploads, two decode.launch}
    with the counts of what ran; the planes are those of an unrecorded
    run."""
    header, payloads = _dispatch_streams()
    sess = engine.JpegDecoderSession(header, device="cpu")
    with trace.recording() as rec:
        got = list(sess.decode_device_batch_iter(iter(payloads), batch=4,
                                                 depth=2))
    want = list(sess.decode_device_batch_iter(iter(payloads), batch=4))
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a, b)
    kids = collections.defaultdict(list)
    for s in rec.spans:
        kids[s.parent].append(s)
    roots = sorted(kids[None], key=lambda s: s.attrs["dispatch"])
    assert [r.name for r in roots] == ["pipeline.queue"] * 2
    assert [r.attrs for r in roots] == [{"dispatch": 0}, {"dispatch": 1}]
    B = sess.blocks_per_segment
    for k, root in enumerate(roots):
        frames = payloads[4 * k:4 * k + 4]
        (disp,) = kids[root.id]
        assert disp.name == "decode.dispatch" and disp.tid != root.tid
        assert disp.attrs == {"frames": 4,
                              "bytes_in": sum(map(len, frames))}
        names = collections.Counter(s.name for s in kids[disp.id])
        assert names["decode.destuff_pool"] == 1
        assert names["decode.lane_prep"] == 1
        assert names["decode.launch"] == 2 and names["upload"] >= 4
        assert set(names) == {"decode.destuff_pool", "decode.lane_prep",
                              "upload", "decode.launch"}
        by = {s.name: s for s in kids[disp.id]}
        destuffs = kids[by["decode.destuff_pool"].id]
        assert [s.name for s in destuffs] == ["decode.destuff"] * 4
        lens = [scan.destuff_flat(f)[1] for f in frames]
        assert sorted((s.attrs["bytes_in"], s.attrs["segments"])
                      for s in destuffs) == sorted(
            (len(f), len(n)) for f, n in zip(frames, lens))
        prep = by["decode.lane_prep"]
        S = sum(len(n) for n in lens)
        L = prep.attrs["lane_len"]
        assert prep.attrs["lanes"] == S
        assert prep.attrs["lane_bytes"] == sum(int(n.sum()) for n in lens)
        assert L == engine._lane_bucket(max(int(n.max()) for n in lens), 6)
        launches = sorted((s for s in kids[disp.id]
                           if s.name == "decode.launch"),
                          key=lambda s: s.start_ns)
        route = ("flat" if flat_words_route(S, L, B, "auto")
                 else auto_strategy(S, L, B))
        assert [s.attrs for s in launches] == [
            {"stage": "huffman", "route": route}, {"stage": "tail"}]
        for s in rec.spans:
            if s.dispatch == disp.dispatch:
                assert s.start_ns <= s.end_ns
        assert all(s.dispatch == root.dispatch for s in kids[disp.id])
        assert all(s.attrs["bytes"] > 0 for s in kids[disp.id]
                   if s.name == "upload")


def test_profile_writes_the_program_spans_on_its_clock(tmp_path):
    """The worker threads' spans land in the profiler's Chrome trace on
    their own threads, and a main-thread span around a torch op encloses
    the op's ``aten::`` event to within 0.1 ms on the trace's clock."""
    def work(i):
        with trace.span("test.worker", i=i):
            return torch.ones(8).sum()

    a = torch.ones(256, 256)
    with trace.profile(str(tmp_path)):
        with ThreadPoolExecutor(max_workers=2) as ex:
            list(ex.map(trace.carry(work), range(4)))
        with trace.span("test.main"):
            torch.mm(a, a)
    (name,) = os.listdir(tmp_path)
    events = json.loads((tmp_path / name).read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "vct.span"]
    workers = [e for e in spans if e["name"] == "test.worker"]
    (main,) = [e for e in spans if e["name"] == "test.main"]
    assert len(workers) == 4 and all(e["tid"] != main["tid"]
                                     for e in workers)
    assert sorted(e["args"]["i"] for e in workers) == [0, 1, 2, 3]
    (mm,) = [e for e in events if e.get("name") == "aten::mm"]
    assert main["ts"] <= mm["ts"] + 100
    assert main["ts"] + main["dur"] >= mm["ts"] + mm["dur"] - 100
    assert abs(main["ts"] - mm["ts"]) < 1000
    with trace.recording():                      # profile turned it off
        pass


# -- the encoder's spans ---------------------------------------------------------

ENCODE_SPANS = {"encode.dispatch", "encode.launch", "encode.fetch",
                "encode.wire"}


def _transcode_session(w=176, h=144, n=4):
    """q90 streams with a restart every MCU and the session that
    re-encodes them at q75 with a restart every MCU (9 x 11 MCUs: 99
    segments a frame)."""
    streams = [encode("420", synth_frame("420", w, h, 7 + seed), 90, 1)
               for seed in range(n)]
    bits = BitReader(streams[0])
    header = Header.decode(bits)
    sess = engine.JpegTranscodeSession(header, quality=75,
                                       restart_interval=1, device="cpu")
    return sess, [s[bits.bit_pos >> 3:] for s in streams]


def _count_launches(monkeypatch, enc) -> list:
    """The budget of every ladder launch of ``enc``, in order."""
    budgets, pack = [], enc._pack_graph

    def counted(qc_seg, f, msb, first=0):
        budgets.append(msb)
        return pack(qc_seg, f, msb, first)
    monkeypatch.setattr(enc, "_pack_graph", counted)
    return budgets


def _check_encode_tree(spans, dispatch, frames, outs, budgets, enc):
    """The encoder's spans of one dispatch: one ``encode.dispatch`` over a
    datapath launch, a pack launch and a fetch of the lengths a rung, one
    fetch of the bodies, and the wire join, all in the dispatch."""
    mine = [s for s in spans if s.dispatch == dispatch]
    (disp,) = [s for s in mine if s.name == "encode.dispatch"]
    assert disp.attrs == {"frames": frames, "rungs": len(budgets),
                          "bytes_out": sum(map(len, outs))}
    kids = sorted((s for s in mine if s.parent == disp.id),
                  key=lambda s: s.start_ns)
    names = [s.name for s in kids]
    assert names == (["encode.launch"]
                     + ["encode.launch", "encode.fetch"] * len(budgets)
                     + ["encode.fetch", "encode.wire"])
    assert kids[0].attrs == {"stage": "datapath"}
    S = frames * -(-enc.n_blocks // enc.blocks_per_segment)
    packs = [s for s in kids if s.name == "encode.launch"][1:]
    assert [s.attrs for s in packs] == [
        {"stage": "pack", "route": enc._pack_route(S, b), "segments": S,
         "budget": b} for b in budgets]
    fetches = [s for s in kids if s.name == "encode.fetch"]
    last = len(budgets) - 1
    assert [s.attrs["rung"] for s in fetches] == list(range(len(budgets))) \
        + [last]
    assert [s.attrs["overflow"] for s in fetches] == [1] * last + [0, 0]
    assert fetches[0].attrs["bytes"] == 8 * (frames + 2)
    assert fetches[-1].attrs["bytes"] >= frames * max(
        len(o) for o in outs) - frames * (len(enc._header_bytes) + 2)
    assert kids[-1].attrs == {}
    for s in kids:
        assert s.tid == disp.tid
        assert disp.start_ns <= s.start_ns <= s.end_ns <= disp.end_ns
    return disp


def test_transcode_batch_iter_records_the_encoder_after_the_decoder(
        monkeypatch):
    """Each chunk: pipeline.queue -> decode.dispatch, then the pad clean
    (a datapath ``encode.launch``), then encode.dispatch, each beside the
    last (not inside it) on the same worker, every encoder span in the
    chunk's dispatch; the bytes are those of an unrecorded run."""
    sess, payloads = _transcode_session()
    want = sess.transcode_batch(payloads[:2]) \
        + sess.transcode_batch(payloads[2:])
    budgets = _count_launches(monkeypatch, sess.encoder)
    with trace.recording() as rec:
        got = list(sess.transcode_batch_iter(iter(payloads), batch=2,
                                             depth=2))
    assert got == want and len(budgets) == 2
    queues = sorted((s for s in rec.spans if s.name == "pipeline.queue"),
                    key=lambda s: s.attrs["dispatch"])
    assert [q.attrs for q in queues] == [{"dispatch": 0}, {"dispatch": 1}]
    for k, q in enumerate(queues):
        (dec,) = [s for s in rec.spans if s.name == "decode.dispatch"
                  and s.dispatch == q.dispatch]
        disp = _check_encode_tree(rec.spans, q.dispatch, 2,
                                  got[2 * k:2 * k + 2], budgets[k:k + 1],
                                  sess.encoder)
        (clean,) = [s for s in rec.spans if s.dispatch == q.dispatch
                    and s.name in ENCODE_SPANS and s.parent == q.id
                    and s is not disp]
        assert clean.name == "encode.launch"
        assert clean.attrs == {"stage": "datapath"}
        assert dec.parent == clean.parent == disp.parent == q.id
        assert dec.end_ns <= clean.start_ns <= clean.end_ns <= disp.start_ns
        assert dec.tid == clean.tid == disp.tid
    for s in rec.spans:
        if s.name in ENCODE_SPANS:
            assert s.dispatch in {q.dispatch for q in queues}


def test_encode_device_batch_records_each_ladder_rung(monkeypatch):
    """A locked budget too small for the frames: the first rung
    overflows, the second fits; the dispatch counts two rungs, two pack
    launches and three fetches."""
    sess, payloads = _transcode_session()
    stacks = sess.decoder.decode_device_batch_stacked(payloads[:2])
    frames = [[p[f].numpy() for p in stacks] for f in range(2)]
    enc = engine.JpegEncoderSession(sess.encoder.params, 1, device="cpu",
                                    device_pack="pallas")
    want = enc.encode_device_batch(frames)
    enc._seg_budget = 16
    budgets = _count_launches(monkeypatch, enc)
    with trace.recording() as rec:
        assert enc.encode_device_batch(frames) == want
    assert budgets == [16, enc.blocks_per_segment * 24 + 64]
    (disp,) = [s for s in rec.spans if s.name == "encode.dispatch"]
    assert disp.parent is None
    _check_encode_tree(rec.spans, disp.dispatch, 2, want, budgets, enc)
    # the frames' uploads come before the dispatch, each on its own
    assert {s.name for s in rec.spans} == ENCODE_SPANS | {"upload"}
    assert all(s.dispatch == disp.dispatch for s in rec.spans
               if s.name in ENCODE_SPANS)


def test_the_encoder_records_nothing_while_the_recorder_is_off(
        monkeypatch):
    made = []

    class Counted(trace._Span):
        def __init__(self, *a):
            made.append(a[1])
            super().__init__(*a)
    monkeypatch.setattr(trace, "_Span", Counted)
    sess, payloads = _transcode_session(n=2)
    out = sess.transcode_batch(payloads)
    assert made == []
    with trace.recording() as rec:
        assert sess.transcode_batch(payloads) == out
    assert ENCODE_SPANS <= set(made) and len(made) == len(rec.spans)
