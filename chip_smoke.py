"""GPU smoke run of the PyTorch/CUDA port on one card, at full width:

- the batched fused JPEG → JPEG transcode of 1080p 4:2:0 streams (q75,
  restart interval 1, 16 frames a dispatch) through the hand-written CUDA
  kernels K1-K4;
- the device decode service on four kinds of 1080p 4:2:0 q90 stream:
    A  restart-free, 16 frames: host index scan, K1 with start-state hooks;
    B  one MCU row a segment (ri=120), 16 frames: K6, the streamed decode;
    C  ri=1, one frame, device_huffman="pallas": K5 on the padded matrix;
    D  ri=1, 16 frames, decode_gather="dma": K7, the staged decode.

    python3 chip_smoke.py

Phases (any failure ends the run with a nonzero exit):
  1. card      — name and power limit (nvidia-smi);
  2. build     — nvcc builds K1-K7 from video_coding_tpu_torch/csrc;
  3. sources   — 16 synthetic 1080p frames encoded on the card at q90 with
                 ri=1, ri=0 and ri=120; one frame of each decoded back and
                 checked by PSNR;
  4. kernels   — K1-K4 against their plain PyTorch versions on the card at
                 the transcode's shapes (exact equality), timed with CUDA
                 events beside their bounds;
  5. transcode — transcode_batch (q75, ri=1, F=16) with the launch counts
                 reset just before and read just after; bytes equal to the
                 same session on the CPU for 2 frames; every output parses;
                 transcode_batch_iter MPix/s as the median of 3 windows;
                 one dispatch under the profiler;
  6. paths     — each of A-D through its session's entry point with the
                 launch counts reset before and read after (the path must
                 launch its kernel); planes equal to the same session on
                 the CPU, and equal across the four routes;
  7. decode kernels — K1 with hooks, K5, K6, K7 on the arguments the paths
                 gave them, against their plain versions (exact), K7 also
                 against K1; timed beside their bounds;
  8. rates     — frames a second of decode_device_batch_iter on A and B
                 (median of 3 windows) and the host index scan's time;
  9. a JSON line of per-kernel numbers;
 10. a last JSON line {"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the reference package. Needs one
CUDA card; exits nonzero without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

FRAMES = 16
WIDTH, HEIGHT = 1920, 1080
SEED = 1234
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
INT32_OPS_PER_S = 67e12        # 32-bit non-tensor peak (the float32 figure)


def log(msg: str) -> None:
    print(msg, flush=True)


def synth_frames(n: int, seed: int):
    """n distinct 1080p 4:2:0 frames: gradients, sinusoidal texture,
    hard-edged rectangles and sensor-like noise (uint8 y, u, v)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:HEIGHT, 0:WIDTH].astype(np.float32)
    cy, cx = np.mgrid[0:HEIGHT // 2, 0:WIDTH // 2].astype(np.float32)
    frames = []
    for t in range(n):
        y = (90 * xx / WIDTH + 60 * yy / HEIGHT + 40
             + 30 * np.sin(2 * np.pi * (xx + 7 * t) / 97)
             * np.cos(2 * np.pi * yy / 61))
        for _ in range(24):
            x0, y0 = rng.integers(0, WIDTH - 64), rng.integers(0, HEIGHT - 64)
            w, h = rng.integers(16, 400), rng.integers(16, 300)
            y[y0:y0 + h, x0:x0 + w] = rng.integers(0, 256)
        y += rng.normal(0, 3, y.shape)
        u = 128 + 50 * np.sin(2 * np.pi * (cx + 5 * t) / 300) \
            + rng.normal(0, 2, cx.shape)
        v = 128 + 50 * np.cos(2 * np.pi * cy / 200) \
            + rng.normal(0, 2, cy.shape)
        frames.append(tuple(np.clip(p, 0, 255).astype(np.uint8)
                            for p in (y, u, v)))
    return frames


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))


def time_ms(fn, reps: int) -> float:
    """Median CUDA-event time of fn() in ms, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def symbol_count(coefs: torch.Tensor) -> int:
    """Huffman symbols of (N, 64) zigzag blocks: DC + one per nonzero AC
    + one ZRL per 16 zeros before a nonzero + EOB unless position 63 is
    nonzero."""
    ac = coefs[:, 1:] != 0
    pos = torch.arange(1, 64, device=coefs.device)
    nz_pos = torch.where(ac, pos, 0)
    prev = torch.cummax(nz_pos, dim=1).values
    prev = torch.cat([torch.zeros_like(prev[:, :1]), prev[:, :-1]], dim=1)
    run = torch.where(ac, pos - prev - 1, 0)
    zrl = (run // 16).sum()
    eob = (coefs[:, 63] == 0).sum()
    return int(coefs.shape[0] + ac.sum() + zrl + eob)


class Spy:
    """Stands in for a kernel wrapper in its module for one call: keeps the
    arguments the caller gave it, and passes attribute reads and writes
    (the launch counts) through to the wrapper."""

    def __init__(self, fn):
        object.__setattr__(self, "fn", fn)
        object.__setattr__(self, "args", None)

    def __call__(self, *a, **k):
        object.__setattr__(self, "args", (a, k))
        return self.fn(*a, **k)

    def __getattr__(self, name):
        return getattr(self.fn, name)

    def __setattr__(self, name, value):
        setattr(self.fn, name, value)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2

    from video_coding_tpu_torch import kernels
    from video_coding_tpu_torch.common.bitstream import BitReader
    from video_coding_tpu_torch.entropy import huffman_decode as k1
    from video_coding_tpu_torch.entropy import scan as hscan
    from video_coding_tpu_torch.entropy import huffman_encode as k4
    from video_coding_tpu_torch.entropy.scan import _destuff_parts
    from video_coding_tpu_torch.model.header import Header, Parameters
    from video_coding_tpu_torch.ops import datapath
    from video_coding_tpu_torch.runtime.engine import (JpegDecoderSession,
                                                       JpegEncoderSession,
                                                       JpegTranscodeSession)

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device {kind}, count {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    lib = kernels.build()
    kernels.load()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {lib.name}")
    for line in (kernels.BUILD_DIR / "build.log").read_text().splitlines():
        if "registers" in line or line.startswith("=="):
            log("  " + line.strip())

    # 3. source streams
    t0 = time.perf_counter()
    frames = synth_frames(FRAMES, SEED)
    src_enc = JpegEncoderSession(Parameters.c420(WIDTH, HEIGHT, 90),
                                 restart_interval=1)
    streams = src_enc.encode_device_batch(frames)
    bits = BitReader(streams[0])
    header = Header.decode(bits)
    hdr_len = bits.bit_pos >> 3
    payloads = [s[hdr_len:] for s in streams]
    sizes = [len(s) for s in streams]
    log(f"sources: {FRAMES} frames q90 ri=1, {min(sizes)}..{max(sizes)} "
        f"bytes, {time.perf_counter() - t0:.1f} s")
    # the same frames restart-free (path A) and one MCU row a segment (B)
    sources = {"ri=1": (header, payloads)}
    for ri in (0, WIDTH // 16):
        t0 = time.perf_counter()
        enc_ri = JpegEncoderSession(Parameters.c420(WIDTH, HEIGHT, 90),
                                    restart_interval=ri)
        ss = enc_ri.encode_device_batch(frames)
        bits = BitReader(ss[0])
        hdr_ri = Header.decode(bits)
        sources[f"ri={ri}"] = (hdr_ri, [x[bits.bit_pos >> 3:] for x in ss])
        log(f"sources: {FRAMES} frames q90 ri={ri}, {min(map(len, ss))}.."
            f"{max(map(len, ss))} bytes, {time.perf_counter() - t0:.1f} s")
    for tag, (hdr_s, pl_s) in sources.items():
        got = JpegDecoderSession(hdr_s).decode_device(pl_s[0])
        for name, g, ref in zip("yuv", got, frames[0]):
            db = psnr(g, ref)
            log(f"sources {tag}: {name} PSNR {db:.2f} dB")
            if g.shape != ref.shape or db <= 30.0:
                raise RuntimeError(f"source {tag} decode PSNR {db:.2f} dB "
                                   "<= 30 dB")

    # 4. kernels against their plain versions at the main path's shapes
    trans = JpegTranscodeSession(header, quality=75, restart_interval=1)
    trans.transcode_batch(payloads)      # warm + lock the budget ladder
    dec, enc = trans.decoder, trans.encoder
    dev = dec.device
    B = dec.blocks_per_segment
    C = len(dec.components)
    parts, lens_parts = _destuff_parts(payloads, dec.n_segments)
    flat = np.concatenate(parts)
    starts, lens, segb, inv_perm = dec._flat_lane_inputs(
        np.concatenate(lens_parts),
        np.tile(dec._expected_seg_blocks(dec.n_segments), FRAMES))
    up = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
          for a in (flat, starts, lens, segb)]
    st = dec.state
    k1_args = (*up, dec._comp_sched, st.lo, st.hi, st.offset, st.values)
    k1_kw = dict(blocks_per_segment=B, n_components=C)
    rows = []

    def compare(name, a, b) -> int:
        """Max |kernel - plain|; the kernels are exact, so anything but 0
        fails the run."""
        err = int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
        if a.shape != b.shape or err != 0:
            raise RuntimeError(f"{name}: kernel differs from its plain "
                               f"version (max abs err {err})")
        return err

    coefs = k1.decode_flat(*k1_args, **k1_kw)
    coefs_p = k1.decode_flat_plain(*k1_args, **k1_kw)
    torch.cuda.synchronize()
    err = {"K1": compare("K1", coefs, coefs_p)}
    S = coefs.shape[0]
    n_sym = symbol_count(coefs.view(-1, 64))
    k1_bytes = (flat.size + 3 * 4 * S + st.values.numel() * 4
                + 3 * st.lo.numel() * 4 + coefs.numel() * 4)
    rows.append(("K1", "video_coding_tpu_torch/csrc/huffman_decode.cu",
                 "video_coding_tpu/entropy/pallas_decode.py:838",
                 lambda: k1.decode_flat(*k1_args, **k1_kw),
                 lambda: k1.decode_flat_plain(*k1_args, **k1_kw),
                 k1_bytes, 40.0 * n_sym))

    pool = coefs.view(-1, 64)
    qseg = dec._quant_seg
    pix = datapath.decode_datapath(pool, qseg)
    err["K2"] = compare("K2", pix,
                        datapath.decode_datapath_plain(pool, qseg))
    N2 = pool.shape[0]
    rows.append(("K2", "video_coding_tpu_torch/csrc/decode_datapath.cu",
                 "video_coding_tpu/ops/datapath.py:143",
                 lambda: datapath.decode_datapath(pool, qseg),
                 lambda: datapath.decode_datapath_plain(pool, qseg),
                 N2 * 64 * 4 + qseg.numel() * 4 + N2 * 64, 1200.0 * N2))

    stacks = dec._decode_tail_pool(pool, torch.from_numpy(inv_perm).to(
        dev).to(torch.int64), FRAMES)
    px = enc._gather_blocks(trans._clean_planes(stacks))
    qe = enc.state.quant
    qc = datapath.encode_datapath(px, qe)
    err["K3"] = compare("K3", qc, datapath.encode_datapath_plain(px, qe))
    N3 = px.shape[0]
    rows.append(("K3", "video_coding_tpu_torch/csrc/encode_datapath.cu",
                 "video_coding_tpu/ops/datapath.py:169",
                 lambda: datapath.encode_datapath(px, qe),
                 lambda: datapath.encode_datapath_plain(px, qe),
                 N3 * 64 + qe.numel() * 4 + N3 * 64 * 4, 1100.0 * N3))

    qc_seg = enc._pad_segments(qc, FRAMES)
    valid = enc._valid_batch(FRAMES)
    m_out = k4.m_out_for(enc._enc_budget_ladder()[0])
    k4_args = (qc_seg, valid, enc._comp_sched, enc.state.dctab,
               enc.state.actab)
    out, lens4, ovf = k4.encode_segments(*k4_args, m_out=m_out)
    out_p, lens_p, ovf_p = k4.encode_segments_plain(*k4_args, m_out=m_out)
    err["K4"] = max(compare("K4 bytes", out, out_p),
                    compare("K4 lens", lens4, lens_p),
                    compare("K4 overflow", ovf, ovf_p))
    if bool(ovf):
        raise RuntimeError("K4 overflowed at the locked budget")
    n_sym4 = symbol_count(qc)
    S4 = qc_seg.shape[0]
    k4_bytes = (qc_seg.numel() * 4 + valid.numel()
                + (enc.state.dctab.numel() + enc.state.actab.numel()) * 4
                + int(lens4.sum()) + S4 * 4)
    rows.append(("K4", "video_coding_tpu_torch/csrc/huffman_encode.cu",
                 "video_coding_tpu/entropy/pallas_encode.py:502",
                 lambda: k4.encode_segments(*k4_args, m_out=m_out),
                 lambda: k4.encode_segments_plain(*k4_args, m_out=m_out),
                 k4_bytes, 30.0 * n_sym4))

    timed = []

    def time_rows(rows, plain_reps):
        for name, src, replaces, fn, plain, nbytes, nops in rows:
            ms = time_ms(fn, 20)
            plain_ms = time_ms(plain, plain_reps)
            bms, by = bound_ms(nbytes, nops)
            log(f"{name}: {ms:.4f} ms kernel, {plain_ms:.3f} ms plain, "
                f"bound {bms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, "
                f"{nops / 1e9:.3f} G int ops) — {bms / ms:.1%} of bound")
            timed.append((name, src, replaces, ms, plain_ms, bms, by))

    time_rows(rows, 3)

    # 5. end to end
    counters = {"K1": (k1.decode_flat, "launches"),
                "K1+hooks": (k1.decode_flat, "hook_launches"),
                "K2": (datapath.decode_datapath, "launches"),
                "K3": (datapath.encode_datapath, "launches"),
                "K4": (k4.encode_segments, "launches"),
                "K5": (k1.decode_segments, "launches"),
                "K6": (k1.decode_segments_streamed, "launches"),
                "K7": (k1.decode_flat_staged, "launches")}

    def counted(call, must_launch):
        """Run ``call`` with every launch count set to 0 just before and
        read just after; the kernels in ``must_launch`` must have run."""
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        out = call()
        torch.cuda.synchronize()
        seen = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
        missing = [k for k in must_launch if seen[k] == 0]
        if missing:
            raise RuntimeError(f"path did not launch {missing}: {seen}")
        return out, seen

    outs, seen = counted(lambda: trans.transcode_batch(payloads),
                         ("K1", "K2", "K3", "K4"))
    launches = {k: seen[k] for k in ("K1", "K2", "K3", "K4")}
    log(f"main path launches (one transcode_batch, F={FRAMES}): {launches}")
    for o in outs:
        hdr = Header.decode(BitReader(o))
        if hdr.frame is None or (hdr.frame.width, hdr.frame.height) != \
                (WIDTH, HEIGHT) or o[-2:] != b"\xff\xd9":
            raise RuntimeError("transcoded stream does not parse")
    t0 = time.perf_counter()
    cpu = JpegTranscodeSession(header, quality=75, restart_interval=1,
                               device="cpu")
    ref = cpu.transcode_batch(payloads[:2])
    if outs[:2] != ref:
        raise RuntimeError("GPU transcode bytes differ from the CPU path")
    log(f"end to end: 2 frames byte-identical to device='cpu' "
        f"({time.perf_counter() - t0:.1f} s on the CPU); outputs "
        f"{min(map(len, outs))}..{max(map(len, outs))} bytes")

    def window() -> float:
        n = 2 * FRAMES
        t = time.perf_counter()
        for _ in trans.transcode_batch_iter(payloads * 2, batch=FRAMES,
                                            depth=2):
            pass
        return (time.perf_counter() - t) / n

    windows = sorted(window() for _ in range(3))
    mpix = [WIDTH * HEIGHT / w / 1e6 for w in windows]
    log(f"transcode_batch_iter {WIDTH}x{HEIGHT} q75 ri=1 F={FRAMES}: median "
        f"{mpix[1]:.2f} MPix/s (windows {', '.join(f'{m:.2f}' for m in mpix)}"
        f"; {windows[1] * 1e3:.2f} ms/frame) on {smi}")

    # where the time goes: host destuff alone, then one dispatch under
    # torch.profiler (device busy = sum of CUDA kernel and copy spans; one
    # stream, so they do not overlap)
    t0 = time.perf_counter()
    _destuff_parts(payloads, dec.n_segments)
    destuff_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trans.transcode_batch(payloads)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, float] = {}
    for e in prof.events():
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            key = e.name.replace("(anonymous namespace)::", "") \
                .split("(")[0][:48]
            by_name[key] = by_name.get(key, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    log(f"breakdown: one transcode_batch (F={FRAMES}) {wall_ms:.2f} ms wall "
        f"under the profiler, device busy {busy_ms:.3f} ms "
        f"({1 - busy_ms / wall_ms:.1%} idle); host destuff of the "
        f"{FRAMES} frames alone {destuff_ms:.2f} ms")
    for key, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"  device {ms:8.3f} ms  {key}")


    # 6. the decode paths A-D through the sessions' entry points. A spy on
    # each path's wrapper keeps the arguments the session gave the kernel,
    # for phase 7.
    hdr_a, pay_a = sources["ri=0"]
    hdr_b, pay_b = sources[f"ri={WIDTH // 16}"]
    paths = {
        # tag: (kernel, wrapper, session keywords, header, payloads of the
        #       counted call, frames of the CPU reference)
        "A": ("K1+hooks", "decode_flat", {}, hdr_a, pay_a, 1),
        "B": ("K6", "decode_segments_streamed", {}, hdr_b, pay_b, 1),
        "C": ("K5", "decode_segments", {"device_huffman": "pallas"}, header,
              payloads[:1], 1),
        "D": ("K7", "decode_flat_staged", {"decode_gather": "dma"}, header,
              payloads, 2),
    }
    captured, sessions, frame0 = {}, {}, {}
    for tag, (kname, wname, kw, hdr_p, pay_p, n_cpu) in paths.items():
        sess = sessions[tag] = JpegDecoderSession(hdr_p, **kw)
        wrapper = getattr(k1, wname)
        spy = Spy(wrapper)
        setattr(k1, wname, spy)
        try:
            t0 = time.perf_counter()
            if tag == "C":        # the single-frame entry point
                call = lambda: [sess.decode_device_e2e(pay_p[0])]  # noqa
            else:
                call = lambda: sess.decode_device_batch(pay_p)  # noqa: E731
            got, seen = counted(call, (kname, "K2"))
            wall = time.perf_counter() - t0
        finally:
            setattr(k1, wname, wrapper)
        launches[kname] = seen[kname]
        a, k = captured[kname] = spy.args
        # a[-6] is seg_blocks in both argument layouts
        log(f"path {tag}: {len(pay_p)} frame(s), {a[-6].shape[0]} lanes of "
            f"{k['blocks_per_segment']} blocks, launches {seen}, "
            f"{wall:.2f} s wall")
        if tag == "A" and not (k["init_bitpos"] is not None
                               and k["init_dc"] is not None):
            raise RuntimeError("path A ran without the start-state hooks")
        t0 = time.perf_counter()
        cpu_sess = JpegDecoderSession(hdr_p, device="cpu", **kw)
        ref = cpu_sess.decode_device_batch(pay_p[:n_cpu])
        for f in range(n_cpu):
            for g, r in zip(got[f], ref[f]):
                if not torch.equal(g.cpu(), r):
                    raise RuntimeError(f"path {tag}: planes differ from "
                                       "the same session on the CPU")
        log(f"path {tag}: {n_cpu} frame(s) equal to device='cpu' "
            f"({time.perf_counter() - t0:.1f} s on the CPU)")
        frame0[tag] = got[0]
    for tag in "BCD":
        for g, r in zip(frame0[tag], frame0["A"]):
            if not torch.equal(g, r):
                raise RuntimeError(f"routes A and {tag} decode different "
                                   "planes for the same picture")
    log("paths: the four routes decode equal planes for frame 0")

    # 7. the decode kernels on the paths' arguments
    def table_bytes(a):
        return sum(t.numel() * 4 for t in a[-5:])     # sched + range tables

    rows = []
    for kname, wname, source, replaces in (
            ("K1+hooks", "decode_flat", "huffman_decode.cu", 838),
            ("K5", "decode_segments", "huffman_decode_padded.cu", 261),
            ("K6", "decode_segments_streamed", "huffman_decode_streamed.cu",
             1104),
            ("K7", "decode_flat_staged", "huffman_decode_staged.cu", 733)):
        a, k = captured[kname]
        fn, plain = getattr(k1, wname), getattr(k1, wname + "_plain")
        out = fn(*a, **k)
        err[kname] = compare(kname, out, plain(*a, **k))
        if kname == "K7":
            k_k1 = {x: v for x, v in k.items() if x != "L"}
            compare("K7 against K1", out, k1.decode_flat(*a, **k_k1))
            ms_k1 = time_ms(lambda: k1.decode_flat(*a, **k_k1), 20)
            log(f"K1 on K7's arguments: {ms_k1:.4f} ms")
        n_sym = symbol_count(out.view(-1, 64))
        nbytes = (sum(t.numel() * t.element_size() for t in a[:-5])
                  + table_bytes(a) + out.numel() * 4
                  + sum(v.numel() * 4 for v in k.values()
                        if isinstance(v, torch.Tensor)))
        rows.append((kname, f"video_coding_tpu_torch/csrc/{source}",
                     f"video_coding_tpu/entropy/pallas_decode.py:{replaces}",
                     lambda fn=fn, a=a, k=k: fn(*a, **k),
                     lambda plain=plain, a=a, k=k: plain(*a, **k),
                     nbytes, 40.0 * n_sym))
        del out
    time_rows(rows, 1)

    # 8. rates of the pipelined decode on A and B, and the host index scan
    def fps(sess, pay, n):
        def window():
            t = time.perf_counter()
            for _ in sess.decode_device_batch_iter(
                    (pay * (n // len(pay) + 1))[:n], batch=FRAMES, depth=2):
                pass
            torch.cuda.synchronize()
            return n / (time.perf_counter() - t)
        return sorted(window() for _ in range(3))

    for tag, pay, n in (("A", pay_a, FRAMES), ("B", pay_b, 2 * FRAMES)):
        w = fps(sessions[tag], pay, n)
        log(f"decode_device_batch_iter path {tag} {WIDTH}x{HEIGHT} q90 "
            f"F={FRAMES}: median {w[1]:.2f} frames/s (windows "
            f"{', '.join(f'{x:.2f}' for x in w)}; {n} frames a window) "
            f"on {smi}")
    dec_a = sessions["A"]
    flat_a, _lens = hscan.destuff_flat(pay_a[0])
    t0 = time.perf_counter()
    hscan.index_scan(flat_a, dec_a.comp_idx, dec_a._index_stride(),
                     dec_a.tables)
    scan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dec_a.decode_device_batch(pay_a)
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    log(f"index_scan of one {WIDTH}x{HEIGHT} q90 frame alone: "
        f"{scan_s * 1e3:.1f} ms on the host; one path A dispatch of "
        f"{FRAMES} frames: {wall_a:.2f} s wall on {smi}")

    # 9. kernels line, 10. last line
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name],
         "max_abs_err": err[name],
         "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
         "library_ms": None}
        for name, src, replaces, ms, plain_ms, bms, by in timed]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
