"""GPU smoke run of the PyTorch/CUDA port on one card, at full width:

- the batched fused JPEG → JPEG transcode of 1080p 4:2:0 streams (q75,
  restart interval 1, 16 frames a dispatch) through the hand-written CUDA
  kernels K1-K4;
- the device decode service on four kinds of 1080p 4:2:0 q90 stream:
    A  restart-free, 16 frames: the host engine's index scan, K1 with
       start-state hooks;
    B  one MCU row a segment (ri=120), 16 frames: K6, the streamed decode;
    C  ri=1, one frame, device_huffman="pallas": K5 on the padded matrix;
    D  ri=1, 16 frames, decode_gather="dma": K7, the staged decode;
- the encoder session's split entropy path (segments of more than 32
  blocks):
    E  16 Frames, q75, ri=8 (48 blocks a segment) through
       encode_device_batch: K3, symbol construction with K9, the packer K8;
    F  the ri=1 sources transcoded to ri=8: K1 → K2 → K3 → K9 → K8;
  and the session's host-entropy route, encode(), on one frame;
- the decoder session's host-entropy half and the transcode's host route:
    G  decode() by the host decoder (the host entropy engine) with a
       dense or sparse coefficient upload, then K2; entropy="tpu" (the
       padded matrix decoded on the card: K1, K6 or K5 by stream shape,
       or K5 asked for), decode_batch, decode_iter, resync, decode_jpeg;
    H  transcode_batch with entropy_out="host": K1 → K2 → K3, the
       download, the host coder (the engine);
- the decode-for-training path:
    I  decode_device_rgb(_batch): K1 → K2 → the RGB tail (chroma
       upsampling and color conversion in plain torch) on the card, and
       JpegRgbDataset and the mjpeg helpers over it;
- the multi-device layer and the entry points:
    J  a one-rank NCCL group and a (1, 1) codec mesh: the sessions' mesh=
       (decode K1 → K2, encode K3 → K4 or K9 → K8, transcode), the
       dataset's sharding, the sharded datapaths (K2, K3),
       sharded_decode_e2e (K5 → K2) and mjpeg_codec_step (K3, K9, K2);
    K  the five CLIs' main(argv) on a 1080p frame: model_cli,
       simulate_cli, generate_cli (PTX and SASS), oyuv, dct_tool;
- the host entropy engine (the C++ library built with g++ from
  video_coding_tpu_torch/csrc/host_entropy.cpp, which the host halves of
  the paths above run) against the port's pure Python / numpy tier;
- the configurations the JAX package takes beyond 4:2:0 at q75-q90:
    L  4:2:2, 4:4:0 (the presets' layouts and libjpeg's), 4:4:4 and
       monochrome at ri=1, 0 and one MCU row, the K4/K8 boundary, q=1 and
       q=100, and three libjpeg-turbo streams (tests/data/torch_foreign)
       through every route;
- frames past 1080p:
    M  3840x2160, 3996x2160 and 7680x4800 (4:2:0 and 4:4:4) through the
       transcode, decode, RGB and encode entry points, long lanes in
       each branch of the long-lane kernels (K6 staged, K6 reading global
       memory, K5 with many CTAs, unstaged, no lane buffer, K5 a CTA a
       row, staged).

    python3 chip_smoke.py

Phases (any failure ends the run with a nonzero exit):
  1. card      — name and power limit (nvidia-smi);
  2. build     — nvcc builds K1-K9 and the decode lookup table (LUT) from
                 video_coding_tpu_torch/csrc, and g++ the host entropy
                 engine from csrc/host_entropy.cpp (build seconds each);
  3. sources   — 16 synthetic 1080p frames encoded on the card at q90 with
                 ri=1, ri=0 and ri=120; one frame of each decoded back and
                 checked by PSNR;
  4. kernels   — K1-K4 and the LUT against their plain PyTorch versions on
                 the card at the transcode's shapes (exact equality), timed
                 with CUDA events beside their bounds; the LUT's share of
                 entries that go to level 2 or to the range match; K2 on
                 adversarial blocks (k2_coefs: zero, DC only, ±2047,
                 ±32767, wrapping 2^20 products, random int32; k2_quant
                 rows with 4096 and 65535) at N = 1, 31, 33, 127, 129 and
                 the dispatch's N + 1, quant periods 1, 6, 720 and N, and
                 refusing views off a 16-byte boundary; K3 on
                 adversarial blocks (k3_pixels: all-0, all-255, ±128
                 checkerboards) at N = 1, 31, 33 and the dispatch's N + 1,
                 quant periods 1, 6 and N, quant rows of 1, 255, random and
                 past its reciprocal table, and refusing unaligned views;
                 K4 on adversarial segments (k4_segments) at the main
                 path's and path E's lane shapes and at 1, 31 and 33 lanes,
                 C = 1, 3 and 4, m_out one below, at and one above the
                 longest segment, refusing an unaligned int32 view;
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
                 against K1; timed beside their bounds; K6's sync rounds,
                 subsequences, threads and phase cycles; K1 (both forms),
                 K6 and the lookup table against their plain versions on
                 adversarial inputs (random bytes, all-zero and all-0xFF
                 rows, one symbol a block, a schedule with no short
                 period, short rows, seg_blocks 0 and B, malformed range
                 tables); K7 against its plain version and K1 on random
                 lanes of up to 1,500 bytes (many halves of its ring), an
                 all-0xFF lane, one symbol a block, with and without hooks,
                 real and malformed tables; K6 at two subsequence lengths;
                 K5 at path C's shape on k5_rows (random rows without
                 guard bytes at L = 64, 131, 2048 and path C's L, cut
                 rows, long codes, all-zero and all-0xFF rows, one symbol a
                 block, a climbing DC) with path C's and a luma-only
                 schedule, real and malformed tables, a view one byte off
                 a word; K5 and the lookup table alone under the profiler;
                 K5's host path a call and its card time a call back to
                 back; path C's longest lane in symbols;
  8. rates     — frames a second of decode_device_batch_iter on A and B
                 (median of 3 windows), one path B dispatch under the
                 profiler, and the host engine's index scan time;
  9. path E    — one warming dispatch, then encode_device_batch with the
                 counts reset before and read after: K3, K9 and K8 once
                 each, K4 never; bytes equal to the same session on the CPU
                 (2 frames), to device_pack="xla" and to K4 called on the
                 same coefficients; every stream decodes on the card
                 (PSNR); frames/s as the median of 3 windows; one dispatch
                 under the profiler, with K8 alone in it;
 10. path F    — transcode_batch to ri=8 with the counts reset and read:
                 K1, K2, K3, K9, K8; bytes equal to the CPU session's for 2
                 frames; transcode_batch_iter MPix/s beside phase 5's;
 11. host route — encode() of one frame with entropy="native", "python"
                 and "tpu", coef_transfer="sparse" and "dense": path E's
                 bytes; the host coders' times (the engine; pure Python:
                 seconds a frame);
 12. encode kernels — K8 and K9 on the arguments path E gave them, against
                 their plain versions (exact), K9 also beside table[idx];
                 the share of K8's slots that hold bits; K8's bound
                 counts the bytes that data needs (every input read once
                 printed beside it); K8 on every case of k8_slots
                 (lane counts off a CTA's, K = 1 and odd K, dense 0xFF,
                 33..59-bit slots and 32/33/59 at chunk edges, 0xFF runs
                 across chunks, lanes that end mid-byte) at three budgets;
                 symbol construction, the gather packer and K4 on the same
                 coefficients timed for the breakdown;
 13. paths G, H — decode() of frame 0 (ri=1) with entropy="native" and
                 coef_transfer "dense" and "sparse" (K2 once, no Huffman
                 kernel; equal to decode_device() and to device='cpu';
                 the host decoder's ms and the upload + K2 ms);
                 entropy="tpu" with device_huffman="auto" on ri=1 (K1),
                 ri=120 (K6) and ri=0 (K5, one lane) and "pallas" on ri=1
                 (K5): the kernel and K2 once each, no plain loop, planes
                 equal to decode_device(), the kernel and K2 held against
                 their plain versions on the path's arguments (K5's one
                 ri=0 lane against the host decoder's coefficients); "lut"
                 and "range" (plain loops) timed once; decode_batch of the
                 16 ri=1 frames (entropy="tpu", frames/s, median of 3) and
                 of 2 (entropy="native"), decode_iter over 4, all equal to
                 decode_device_batch; resync on three damaged copies of
                 frame 0 (segment 100 set to 0xFF, RST marker 200 removed,
                 the stream cut at 60%), each decoded once on the card and
                 held against the CPU session's planes from the same
                 coefficients and the damaged segments it must report; a
                 strict decode() raising SegmentDecodeError; decode_jpeg of
                 the whole file; transcode_batch with entropy_out="host"
                 on 2 frames (K1, K2, K3, no K4; the device route's bytes;
                 ms a frame) and transcode_iter over 4;
 14. path I    — decode_device_rgb_batch of the 16 ri=1 frames with the
                 counts reset before and read after (K1, K2 and the LUT
                 once each, no plain loop); (16, 1080, 1920, 3) uint8 on
                 the card, frames 0-1 equal to device='cpu', equal to
                 yuv444_to_rgb of the upsampled planes of
                 decode_device_batch_stacked; frames/s and MPix/s (median
                 of 3 windows); one dispatch under the profiler split into
                 K1, K2, LUT, copies and torch ops; the RGB tail alone
                 timed beside its bound; decode_device_rgb of frame 0; one
                 1080p frame each of 4:2:2, 4:4:0, 4:4:4 and a 1919x1079
                 4:2:0 frame encoded on the card, decode_device_rgb equal
                 to device='cpu'; JpegRgbDataset over the MJPEG stream of
                 the 16 sources (batch_size=8, prefetch=2: two batches,
                 equal to the batch decode, frames/s; batch_size=6 with
                 drop_remainder: two; a sharding other than a mesh
                 raises); mjpeg.encode_stream
                 of 2 frames (the sources' bytes) and decode_stream of them
                 through an entropy="tpu" session (equal to decode_device);
 15. path J    — a one-rank NCCL process group and codec_mesh(1) on the
                 phase 3 sources, each call with the counts reset before
                 and read after, held against its unsharded counterpart
                 and timed beside it (wall ms, median of 3):
                 decode_device_batch_stacked of the 16 frames (K1, LUT,
                 K2) and decode_device of frame 0; encode_device_batch of
                 the 16 frames at q90 ri=1 (K3, K4: the sources' bytes)
                 and q75 ri=8 (K3, K9, K8); transcode_batch (q75 ri=1);
                 JpegRgbDataset(sharding=mesh) against sharding=None;
                 sharded_decode_datapath / sharded_encode_datapath on the
                 783,360 blocks against K2 / K3; sharded_decode_e2e on
                 frame 0's 8,160 segments (K5, K2) against decode_device's
                 planes; mjpeg_codec_step on the luma blocks (16, 32640,
                 8, 8): K3 and K2 exact, rates equal to
                 segment_coded_bits, PSNR within 1e-3 dB of float64
                 numpy; the process group destroyed at the end;
 16. path K    — each CLI's main(argv) in-process on frame 0 written as
                 its ri=1 JPEG and as raw YUV: model_cli decode (header,
                 log, frame with --engine model and torch: equal files)
                 and encode (log, frame: --engine torch, --engine model
                 and the source's bytes equal); every simulate subcommand
                 exits 0 with its verdict (inspect --block 0 --stages);
                 generate of the four artifacts (PTX with .target sm_90a
                 and each kernel's .entry, then --compiled SASS); oyuv
                 compare and convert; dct both; the card subcommands'
                 launch counts; wall seconds each;
 17. host engine — its ABI and build seconds; on the phase 3 sources
                 (16 frames, and the ri=0 copies for the index scan) every
                 entry point held exactly against use_native=False:
                 destuff_flat, destuff_segments_with_markers and
                 pack_lanes_sorted on all frames, index_scan, decode_scan
                 and encode_scan / encode_scan_stream (int32 and int16,
                 assembled by vct_assemble_stream) with the Python tier on
                 frame 0, destuff_and_decode_scan against decode_scan,
                 decode_scan_resync on phase 13's three damaged copies;
                 the re-encoded bodies equal to the sources; ms a frame of
                 each tier beside nvidia-smi's name and power limit and the
                 host's lscpu model name and os.cpu_count();
 18. path L    — at each sampling of L_SAMPLINGS, 4 synthetic 1080p frames
                 (phase 3's luma, chroma at the sampling's size) encoded on
                 the card at q90 with ri=1, 0 and one MCU row, each
                 decoded back (PSNR); then, each call with the counts
                 reset before and read after (its kernels must launch, no
                 plain loop may) and every frame held against the
                 host-entropy route (decode(entropy="native"), the
                 engine's encode and transcode bytes): decode_device_batch
                 at ri=1 (K1), ri=0 (the index scan, K1 with hooks) and
                 one MCU row (K6, which auto_strategy must pick at each
                 sampling), decode_gather="dma" at ri=1 and 0 (K7),
                 decode_device with device_huffman="pallas" (K5),
                 encode_device_batch at the K4/K8 boundary (B <= 32: K4;
                 B = 33..40: K9 + K8), transcode_batch to q75 ri=1 (K4)
                 and to B > 32 (K9 + K8), decode_device_rgb_batch (three
                 components; the transcode refuses one); q=1 and q=100 at
                 4:2:0 and 4:4:4 (4 frames) through encode_device_batch
                 and the transcode, with the budget ladder's rungs
                 printed; the three libjpeg-turbo
                 streams of tests/data/torch_foreign through
                 decode_device_batch, decode_device, decode_device_rgb,
                 decode_jpeg and transcode_batch. For each configuration a
                 dispatch of frame 0 equal to the same session on the CPU
                 (the CPU sessions run in worker processes after the
                 card's work), each kernel it launched equal to its plain
                 version on the card on the arguments it got (K4's, K6's
                 and K8's plain loops, launch-bound on the card, run on
                 the CPU: the CPU session's calls on equal arguments);
                 the rate (median of 3 windows of 4 frames) and each
                 kernel's time at the 4-frame call's arguments (CUDA
                 events, median of 20) beside its bound; the phase's
                 seconds;
 19. path M    — frames past 1080p (M_SIZES): 4 frames of 3840x2160 and
                 of 3996x2160 (a partial MCU column) and 2 of 7680x4800
                 4:2:0 and 4:4:4 from the phase 3 generator, made by a
                 worker process during phases 2-18; sources encoded at
                 q90 with ri=1, 0 and one MCU row (4K also q95, two MCU
                 rows and 15 MCUs), each decoded back (PSNR);
                 each call with the counts reset before and read after
                 (its kernels must launch, no plain loop may) and every
                 frame held against the host-entropy route: at 4K
                 transcode_batch_iter to q75 ri=1 (K1-K4),
                 decode_device_batch at ri=1 (K1), ri=0 (K1 with hooks)
                 and one MCU row (q90: K6 with its rows staged; q95: K5
                 a CTA a row, staged), two MCU rows (the benchmark cell's
                 272 lanes of 2,880 blocks: K5 a CTA a row, staged) and
                 15 MCUs with device_huffman="pallas" (K5, many CTAs,
                 unstaged, no lane buffer), decode_gather="dma"
                 (K7), decode_device_e2e with device_huffman="pallas" (K5),
                 decode_device_rgb_batch, decode_scan_tpu of frame 0's
                 one-row segments (K6 reading global memory: L is not a
                 power of two there), encode_device_batch q75 ri=8 (K3,
                 K9, K8); at 3996x2160 the transcode, ri=1, ri=0 and RGB;
                 at 7680x4800 the transcode, ri=0, one MCU row (K5 a
                 CTA a row),
                 decode_scan_tpu (K6 from global memory) and ri=8 (K9 +
                 K8 at 4:2:0, K4 at 4:4:4's B = 24). Each long lane's L,
                 branch (M_BANDS: each must be reached) and kernel are
                 printed; K2, K3 and K9 are held whole against their plain
                 versions on the card, the serial loops of K1 and K4-K8
                 on a seeded subset of each call's lanes on the CPU, frame
                 0 of each size against the golden model's decode (worker
                 processes); kernel times beside their bounds, ms a frame,
                 frames/s and MPix/s (median of 3 dispatches) beside
                 phases 5, 8 and 9's 1080p rates, the budget ladder's
                 rung, K6's sync rounds; the phase's seconds;
 20. a JSON line of per-kernel numbers (with each kernel's launches on the
     own paths A-K, and its path L and path M times by configuration under
     "path_L" and "path_M");
 21. a last JSON line {"ok": true, "device": {...}}.

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
# 32-bit integer issue rate: 64 lanes an SM a clock x 132 SMs x 1.98 GHz
INT32_OPS_PER_S = 16.7e12


def log(msg: str) -> None:
    print(msg, flush=True)


def synth_frames(n: int, seed: int, width: int | None = None,
                 height: int | None = None):
    """n distinct 4:2:0 frames of width x height (WIDTH x HEIGHT, 1080p,
    by default): gradients, sinusoidal texture, hard-edged rectangles and
    sensor-like noise (uint8 y, u, v)."""
    W, H = width or WIDTH, height or HEIGHT
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    cy, cx = np.mgrid[0:H // 2, 0:W // 2].astype(np.float32)
    frames = []
    for t in range(n):
        y = (90 * xx / W + 60 * yy / H + 40
             + 30 * np.sin(2 * np.pi * (xx + 7 * t) / 97)
             * np.cos(2 * np.pi * yy / 61))
        for _ in range(24):
            x0, y0 = rng.integers(0, W - 64), rng.integers(0, H - 64)
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


def sm_clock() -> str:
    """The card's SM clock and its maximum, as nvidia-smi reads them now
    (a short kernel's time follows the clock the card is at)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def block_symbols(coefs: torch.Tensor) -> torch.Tensor:
    """Huffman symbols of each (N, 64) zigzag block: DC + one per nonzero
    AC + one ZRL per 16 zeros before a nonzero + EOB unless position 63 is
    nonzero."""
    ac = coefs[:, 1:] != 0
    pos = torch.arange(1, 64, device=coefs.device)
    nz_pos = torch.where(ac, pos, 0)
    prev = torch.cummax(nz_pos, dim=1).values
    prev = torch.cat([torch.zeros_like(prev[:, :1]), prev[:, :-1]], dim=1)
    run = torch.where(ac, pos - prev - 1, 0)
    return 1 + ac.sum(1) + (run // 16).sum(1) + (coefs[:, 63] == 0)


def symbol_count(coefs: torch.Tensor) -> int:
    """Huffman symbols of (N, 64) zigzag blocks."""
    return int(block_symbols(coefs).sum())


class Spy:
    """Stands in for a kernel wrapper in its module for one call: keeps the
    arguments the caller gave it and the result, and passes attribute
    reads and writes (the launch counts) through to the wrapper."""

    def __init__(self, fn):
        object.__setattr__(self, "fn", fn)
        object.__setattr__(self, "args", None)
        object.__setattr__(self, "out", None)

    def __call__(self, *a, **k):
        object.__setattr__(self, "args", (a, k))
        object.__setattr__(self, "out", self.fn(*a, **k))
        return self.out

    def __getattr__(self, name):
        return getattr(self.fn, name)

    def __setattr__(self, name, value):
        setattr(self.fn, name, value)


def malformed_tables(dev, seed: int):
    """Range tables no DHT produces: overlapping and inverted ranges,
    negative offsets, codes up to 136 bits long."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 1 << 16, (6, 16)).astype(np.int32)
    hi = (lo + rng.integers(-500, 9000, (6, 16))).astype(np.int32)
    off = rng.integers(-50, 400, (6, 16)).astype(np.int32)
    values = rng.integers(0, 1000, 384).astype(np.int32)
    return tuple(torch.from_numpy(a).to(dev) for a in (lo, hi, off, values))


def huffman_code(lut, value) -> str:
    """The code of ``value`` in a session's decode table, as a bit
    string."""
    idx = next(i for i in range(1 << lut.max_bits)
               if lut.lengths[i] and lut.data[i] == value)
    k = int(lut.lengths[idx])
    return format(idx >> (lut.max_bits - k), f"0{k}b")


def one_symbol_blocks(dec, n: int) -> np.ndarray:
    """A luma segment of n all-zero blocks: DC category 0 and EOB, block
    after block (one symbol a block past the DC)."""
    luma = dec.components[0]
    bits = (huffman_code(luma.dc_tab, 0) + huffman_code(luma.ac_tab, 0)) * n
    bits += "1" * (-len(bits) % 8)
    return np.frombuffer(int(bits, 2).to_bytes(len(bits) // 8, "big"),
                         np.uint8)


def k3_pixels(n: int, rng) -> np.ndarray:
    """(n, 8, 8) uint8 blocks for K3: all-0, all-255 and the two ±128
    checkerboards (the largest |f|), then random pixels, in turn."""
    px = rng.integers(0, 256, (n, 8, 8), dtype=np.uint8)
    board = ((np.arange(8)[:, None] + np.arange(8)) % 2 * 255).astype(
        np.uint8)
    for i, blk in enumerate((0, 255, board, 255 - board)):
        px[i::5] = blk
    return px


def k2_coefs(n: int, rng) -> np.ndarray:
    """(n, 64) int32 zigzag blocks for K2, in turn: all-zero; DC only
    (+2047, -2047); ±2047 everywhere; ±32767 everywhere (int16 extremes:
    the product with any quant above 1 saturates the 12-bit clamp); 2^20
    everywhere and ±(2^20 + 1) alternating (products with 4096 wrap in
    int32, to 0 and to ±4096); random int32 (arbitrary wraps); then
    random blocks of ±1024 with a decaying high band."""
    c = rng.integers(-1024, 1025, (n, 64)).astype(np.int32)
    c[:, 20:] //= 8
    alt = np.where(np.arange(64) % 2, -1, 1).astype(np.int64)
    dc_only = np.zeros(64, np.int32)
    dc_only[0] = 2047
    kinds = [np.zeros(64, np.int32), dc_only, -dc_only,
             np.full(64, 2047, np.int32), np.full(64, -2047, np.int32),
             np.full(64, 32767, np.int32), np.full(64, -32767, np.int32),
             np.full(64, 1 << 20, np.int32),
             (alt * ((1 << 20) + 1)).astype(np.int32)]
    for i, blk in enumerate(kinds):
        c[i::len(kinds) + 2] = blk
    wild = slice(len(kinds), None, len(kinds) + 2)
    c[wild] = rng.integers(-2**31, 2**31, c[wild].shape, dtype=np.int64)
    return c


def k2_quant(p: int, rng) -> np.ndarray:
    """(p, 64) int32 quant rows for K2: random 8-bit values with every
    row holding 4096 (whose products with 2^20 wrap) and 65535 (the
    16-bit DQT maximum) at fixed positions."""
    q = rng.integers(1, 256, (p, 64)).astype(np.int32)
    q[:, 3::7] = 4096
    q[:, 5::11] = 65535
    return q


# K3's quant kinds: all 1 and all 255 (the extremes of 8-bit tables),
# random 8-bit rows, and rows past the reciprocal table (its division path)
K3_QUANTS = ("1", "255", "random", "wide")


def k3_quant(kind: str, p: int, rng) -> np.ndarray:
    """(p, 64) int32 quant rows of one of K3_QUANTS."""
    if kind in ("1", "255"):
        return np.full((p, 64), int(kind), np.int32)
    q = rng.integers(1, 256 if kind == "random" else 70000, (p, 64))
    if kind == "wide":
        q[:, :4] = (1024, 1025, 4096, 65535)
    return q.astype(np.int32)


def k4_blocks(rng) -> np.ndarray:
    """(n, 64) int32 zigzag blocks at K4's edges: all-zero (EOB only) and
    all 63 AC nonzero (no EOB); 15, 16, 17, 31, 32 and 48 zeros before a
    nonzero, in each half of the block and across the halves; long
    trailing zero runs; AC values of ±1023, ±1024 and ±2047 (saturated
    size 11) at runs 0, 14 and 15; blocks dense in 0xFF bytes. The DC
    values cycle through ±2047 and 0, so same-component neighbours differ
    by ±2047 and ±4094."""
    blocks = [np.zeros(64, np.int32),
              rng.integers(1, 60, 64) * rng.choice([-1, 1], 64)]

    def put(at: dict):
        b = np.zeros(64, np.int32)
        b[list(at)] = list(at.values())
        blocks.append(b)

    for run in (15, 16, 17, 31, 32, 48):
        put({1 + run: -3})
        put({1: 1, 2 + run: 5})
        put({40: 2, min(41 + run, 63): -7})
        put({20: 1, min(21 + run, 63): 4})
    put({1: 9})
    put({63: -4})
    put({5: 3, 20: 1})
    for v in (1023, -1023, 1024, -1024, 2047, -2047):
        for run in (0, 14, 15):
            put({1 + run: v})
            put({33: 1, 34 + run: v})
            put({30: -1, 31 + run: v})
    put({16: 1023, 32: 1023, 48: 1023, 63: 1023})
    blocks.append(np.full(64, 1023, np.int32))
    blocks.append(np.full(64, -1024, np.int32))
    out = np.stack(blocks).astype(np.int32)
    out[:, 0] = np.resize([2047, -2047, 2047, 0, -2047], len(out))
    return out


def k4_segments(S: int, B: int, C: int, rng, clamp: bool = True):
    """(qc_seg (S, B·64) int32, valid (S, B) uint8, comp_sched (B,) int32)
    built from k4_blocks: every block of the pool once, then random ones;
    about one block in eight invalid, mid-segment too; a 4:2:0-like
    schedule for C = 3, else round robin, with entries below 0 and past
    C - 1 (which clamp) when ``clamp``."""
    pool = k4_blocks(rng)
    n = S * B
    order = np.concatenate([np.arange(len(pool)),
                            rng.integers(0, len(pool), n)])[:n]
    qc = pool[order].reshape(S, B * 64)
    valid = (rng.random((S, B)) > 0.125).astype(np.uint8)
    valid[0] = 1
    base = [0, 0, 0, 0, 1, 2] if C == 3 else list(range(C))
    sched = np.resize(np.asarray(base, np.int32), B)
    if clamp and B > 2:
        sched[1], sched[-1] = -1, C
    return qc, valid, sched


def k4_tables(dctab: torch.Tensor, actab: torch.Tensor, C: int):
    """Packed (dctab, actab) of C components from a 4:2:0 session's three
    (luma, chroma, chroma, then luma again)."""
    comps = [0, 1, 2, 0][:C]
    return (dctab.view(3, 12)[comps].reshape(-1),
            actab.view(3, 176)[comps].reshape(-1))


def k4_bound_bytes(qc_seg, valid, comp_sched, dctab, actab, m_out) -> int:
    """K4's compulsory bytes: the inputs once, the (S, m_out) slot array
    (zero-filled with the segments' bytes) and the lengths once."""
    return (sum(t.numel() * t.element_size()
                for t in (qc_seg, valid, comp_sched, dctab, actab))
            + qc_seg.shape[0] * (m_out + 4))


K8_CASES = ("mixed", "dense 0xFF", "33 to 59", "chunk edges",
            "0xFF across chunks", "mid-byte ends")


def k8_slots(case: str, S: int, K: int, rng):
    """(c_hi, c_lo, c_len (S, K), raw_bytes_len (S,)) int32 slot arrays at
    K8's edges; values are random garbage above each length unless said:
      mixed               lengths 0..59, half empty, every 11th 32, lane 0
                          opens with -3, 64, 60, 59 (clamped); the second
                          half of the lanes all-ones (runs of 0xFF);
      dense 0xFF          all-ones values of 1..59 bits in every slot;
      33 to 59            every slot 33..59 bits;
      chunk edges         32, 33 or 59 bits in the two slots either side of
                          every multiple of 32 slots, after a 3-bit head;
      0xFF across chunks  all-ones bytes either side of every multiple of
                          32 slots after a 0..7-bit head, and one lane
                          all-ones from slot 100 to 160;
      mid-byte ends       lengths 0..13, no pad slot.
    No lane is padded to a byte boundary, so most end mid-byte, and lane 1
    is empty. raw_bytes_len is each lane's whole bytes."""
    c_hi = rng.integers(-2**31, 2**31, (S, K), dtype=np.int64) \
        .astype(np.int32)
    c_lo = rng.integers(-2**31, 2**31, (S, K), dtype=np.int64) \
        .astype(np.int32)
    near = (np.arange(K) + 2) % 32 < 4     # slots 30, 31, 32, 33, 62, ...
    if case == "mixed":
        c_len = rng.integers(0, 60, (S, K))
        c_len[rng.random((S, K)) < 0.5] = 0
        c_len[:, ::11] = 32
        c_len[0, :4] = (-3, 64, 60, 59)[:K]
        c_hi[S // 2:] = -1
        c_lo[S // 2:] = -1
    elif case == "dense 0xFF":
        c_len = rng.integers(1, 60, (S, K))
        c_hi[:], c_lo[:] = -1, -1
    elif case == "33 to 59":
        c_len = rng.integers(33, 60, (S, K))
    elif case == "chunk edges":
        c_len = np.where(near, rng.choice([32, 33, 59], (S, K)), 0)
        c_len[:, 0] = 3
    elif case == "0xFF across chunks":
        c_len = np.where(near, np.full((S, K), 8), 0)
        c_len[:, 0] = rng.integers(0, 8, S)
        c_len[0, 100:160] = 8
        c_hi[:], c_lo[:] = -1, -1
    elif case == "mid-byte ends":
        c_len = rng.integers(0, 14, (S, K))
    else:
        raise ValueError(case)
    c_len = c_len.astype(np.int32)
    if S > 1:
        c_len[1] = 0
    raw = (np.clip(c_len, 0, 59).sum(axis=1) >> 3).astype(np.int32)
    return c_hi, c_lo, c_len, raw


def k8_budgets(raw: np.ndarray):
    """(m_raw, m_out) pairs for k8_slots: one that fits every lane (0xFF
    stuffing at most doubles a lane), one a byte short in m_raw, and one
    m_out that cuts the longest lanes inside a chunk."""
    top = int(raw.max())
    return ((top, 2 * top + 8), (max(top - 1, 0), 2 * top + 8),
            (top, max(1, top // 3 + 5)))


def k8_need_bytes(c_hi, c_lo, c_len, m_out: int) -> int:
    """K8's bytes as this data needs them, as the kernel reads them: c_len
    in full, the 32-byte sectors of c_lo that hold a slot with bits and
    those of c_hi that hold a slot of more than 32 bits (lengths clamped to
    0..59, each array at its own alignment), the lane arrays and the
    output rows once."""
    S, K = c_len.shape
    n = c_len.clamp(0, 59).view(-1)

    def sectors(arr, need):
        idx = torch.nonzero(need).view(-1)
        return int(torch.unique((idx * 4 + arr.data_ptr() % 32) // 32)
                   .numel())

    return (4 * S * K + 32 * sectors(c_lo, n > 0)
            + 32 * sectors(c_hi, n > 32) + S * m_out + 3 * 4 * S + 4)


def k5_rows(dec, S: int, L: int, B: int, rng) -> np.ndarray:
    """(S, L) uint8 rows for K5 that reach past their end: random bytes
    without guard bytes, every third row cut to zeros after L/3, a row of
    mostly 0xFE (long codes), all-zero and all-0xFF rows, one symbol a
    block, and a luma DC that climbs by 2047 a block."""
    rows = rng.integers(0, 255, (S, L)).astype(np.uint8)
    rows[::3, L // 3:] = 0
    rows[2] = np.where(rng.random(L) < .5, 0xFE, rows[2])
    rows[3], rows[4] = 0, 0xFF
    special = {5: one_symbol_blocks(dec, B), 6: dc_ramp_blocks(dec, B)}
    for r, data in special.items():
        if r < S:
            n = min(len(data), L)
            rows[r] = 0
            rows[r, :n] = data[:n]
    return rows


def dc_ramp_blocks(dec, n: int) -> np.ndarray:
    """A luma segment of n blocks, each DC category 11 with eleven 1 bits
    (+2047) and EOB: the DC predictor passes 32767 after 17 blocks."""
    luma = dec.components[0]
    bits = (huffman_code(luma.dc_tab, 11) + "1" * 11
            + huffman_code(luma.ac_tab, 0)) * n
    bits += "1" * (-len(bits) % 8)
    return np.frombuffer(int(bits, 2).to_bytes(len(bits) // 8, "big"),
                         np.uint8)


def adversarial_padded_checks(k1, captured_k5, dec) -> None:
    """Phase 7's edge cases for K5 at path C's shape (its lane count,
    blocks a segment and tables) against its plain version (any difference
    raises): k5_rows at L = 64, 131, 2048 and path C's own L, with path
    C's schedule and a luma-only one, the session's tables and malformed
    ones, on the matrix and on a view of it one byte past a word
    boundary."""
    (segbytes, segb, sched, *tabs), kw = captured_k5
    dev = segbytes.device
    S, L_c = segbytes.shape
    B = kw["blocks_per_segment"]
    rng = np.random.default_rng(SEED)
    bad = malformed_tables(dev, SEED + 1)
    runs = 0
    for L in (64, 131, 2048, L_c):
        rows = torch.from_numpy(k5_rows(dec, S, L, B, rng)).to(dev)
        buf = torch.zeros(S * L + 8, dtype=torch.uint8, device=dev)
        buf[1:1 + S * L] = rows.view(-1)
        for sched_x in (sched, torch.zeros_like(sched)):
            for tab_name, tabs_x in (("real", tabs), ("malformed", bad)):
                ref = k1.decode_segments_plain(rows, segb, sched_x, *tabs_x,
                                               **kw)
                for view in (rows, buf[1:1 + S * L].view(S, L)):
                    got = k1.decode_segments(view, segb, sched_x, *tabs_x,
                                             **kw)
                    if not torch.equal(got, ref):
                        raise RuntimeError(
                            f"K5 differs from its plain version on "
                            f"adversarial rows at L={L} ({tab_name} tables)")
                    runs += 1
    log(f"K5 adversarial rows at path C's shape ({S} lanes of {B} blocks): "
        f"exact in {runs} runs (L = 64, 131, 2048 and {L_c}; path C's and a "
        "luma-only schedule; real and malformed tables; a view one byte "
        "off a word)")


def adversarial_pack_checks(S_e: int, dev) -> None:
    """Phase 12's edge cases for K8 against its plain version (any
    difference raises): every case of k8_slots at path E's lane count and
    301 slots, at 13 lanes of one slot and at 70 lanes of 517, each at the
    three budgets of k8_budgets."""
    from video_coding_tpu_torch.entropy import pack_stuff as k8

    rng = np.random.default_rng(SEED)
    runs = 0
    for S, K in ((S_e, 301), (13, 1), (70, 517)):
        for case in K8_CASES:
            arrays = k8_slots(case, S, K, rng)
            args = [torch.from_numpy(a).to(dev) for a in arrays]
            for m_raw, m_out in k8_budgets(arrays[3]):
                got = k8.pack_stuff(*args, m_raw=m_raw, m_out=m_out)
                ref = k8.pack_stuff_plain(*args, m_raw=m_raw, m_out=m_out)
                if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                    raise RuntimeError(f"K8 differs from its plain version "
                                       f"on {case} slots, S={S}, K={K}, "
                                       f"m_raw={m_raw}, m_out={m_out}")
                runs += 1
    log(f"K8 adversarial slots: exact in {runs} runs ({', '.join(K8_CASES)};"
        f" S x K = {S_e} x 301, 13 x 1, 70 x 517; budgets that fit, a byte "
        "short in m_raw and an m_out cut inside a chunk)")


def adversarial_encode_checks(n_k3: int, k4_args, n_blocks: int) -> None:
    """Phase 4's edge cases for K3 and K4 against their plain versions
    (any difference raises), at full size (K3's n_k3 + 1 blocks, K4's
    main-path and path-E lanes) and at small ones."""
    from video_coding_tpu_torch.entropy import huffman_encode as k4
    from video_coding_tpu_torch.ops import datapath

    dev = k4_args[0].device
    rng = np.random.default_rng(SEED)
    n_max = n_k3 + 1
    pixels = torch.from_numpy(k3_pixels(n_max, rng)).to(dev)
    runs = 0
    for n in (1, 31, 33, n_max):
        for p in sorted({1, 6, n}):
            for kind in K3_QUANTS:
                quant = torch.from_numpy(k3_quant(kind, p, rng)).to(dev)
                got = datapath.encode_datapath(pixels[:n], quant)
                if not torch.equal(got, datapath.encode_datapath_plain(
                        pixels[:n], quant)):
                    raise RuntimeError(f"K3 differs from its plain version "
                                       f"at N={n}, P={p}, quant {kind}")
                runs += 1
    for shift in (1, 8):
        try:
            datapath.encode_datapath(pixels.view(-1)[shift:shift + 64 * 31]
                                     .view(31, 8, 8), quant[:1])
        except ValueError:
            continue
        raise RuntimeError(f"K3 took a view {shift} bytes off 16")
    log(f"K3 adversarial blocks: exact in {runs} runs (N up to {n_max}), "
        "unaligned views refused")
    del pixels

    qc_main, _v, _s, dctab, actab = k4_args
    S_main, B_main = qc_main.shape[0], qc_main.shape[1] // 64
    S_e = -(-n_blocks // 48) * FRAMES
    tabs = {C: k4_tables(dctab, actab, C) for C in (1, 3, 4)}
    for S, B, C in ((S_main, B_main, 3), (S_e, 48, 3), (1, 1, 1),
                    (31, 6, 4), (33, 32, 3), (33, 48, 1)):
        qc, valid, sched = (torch.from_numpy(a).to(dev) for a in k4_segments(
            S, B, C, rng))
        args = (qc, valid, sched, *tabs[C])
        longest = int(k4.encode_segments_plain(*args, m_out=1)[1].max())
        for m_out in (longest - 1, longest, longest + 1):
            got = k4.encode_segments(*args, m_out=m_out)
            ref = k4.encode_segments_plain(*args, m_out=m_out)
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                raise RuntimeError(f"K4 differs from its plain version at "
                                   f"S={S}, B={B}, C={C}, m_out={m_out}")
        log(f"K4 adversarial segments S={S} B={B} C={C}: exact at m_out "
            f"{longest - 1}, {longest} and {longest + 1} (longest segment "
            f"{longest} bytes)")
        del qc, valid, args, got, ref
    qc, valid, sched = (torch.from_numpy(a).to(dev) for a in k4_segments(
        31, 6, 3, rng))
    buf = torch.zeros(qc.numel() + 4, dtype=torch.int32, device=dev)
    buf[1:1 + qc.numel()] = qc.view(-1)
    try:
        k4.encode_segments(buf[1:1 + qc.numel()].view(qc.shape), valid,
                           sched, *tabs[3], m_out=2000)
    except ValueError:
        pass
    else:
        raise RuntimeError("K4 took a view 4 bytes off 16")
    buf[4:] = qc.view(-1)
    args = (buf[4:].view(qc.shape), valid, sched, *tabs[3])
    if not all(torch.equal(a, b) for a, b in zip(
            k4.encode_segments(*args, m_out=2000),
            k4.encode_segments_plain(*args, m_out=2000))):
        raise RuntimeError("K4 differs from its plain version on a view 16 "
                           "bytes on")
    log("K4: a view 4 bytes off a 16-byte boundary refused, one 16 bytes "
        "on exact")


def adversarial_decode_datapath_checks(n_k2: int, dev) -> None:
    """Phase 4's edge cases for K2 against its plain version (any
    difference raises): k2_coefs blocks at N = 1, 31, 33, 127, 129 and the
    dispatch's N + 1, quant periods 1, 6, 720 and N; views off a 16-byte
    boundary refused, one a block on exact."""
    from video_coding_tpu_torch.ops import datapath

    rng = np.random.default_rng(SEED + 2)
    n_max = n_k2 + 1
    coefs = torch.from_numpy(k2_coefs(n_max, rng)).to(dev)
    runs = 0
    for n in (1, 31, 33, 127, 129, n_max):
        for p in sorted({1, 6, 720, n}):
            quant = torch.from_numpy(k2_quant(p, rng)).to(dev)
            got = datapath.decode_datapath(coefs[:n], quant)
            if not torch.equal(got, datapath.decode_datapath_plain(
                    coefs[:n], quant)):
                raise RuntimeError(f"K2 differs from its plain version at "
                                   f"N={n}, P={p}")
            runs += 1
    quant = torch.from_numpy(k2_quant(7, rng)).to(dev)
    flat_c, flat_q = coefs[:32].view(-1), quant.view(-1)
    for name, args in (
            ("coefs", (flat_c[1:1 + 31 * 64].view(31, 64), quant[:6])),
            ("coefs", (flat_c[2:2 + 31 * 64].view(31, 64), quant[:6])),
            ("quant", (coefs[:31], flat_q[1:1 + 6 * 64].view(6, 64)))):
        try:
            datapath.decode_datapath(*args)
        except ValueError:
            continue
        raise RuntimeError(f"K2 took a {name} view off a 16-byte boundary")
    view = (coefs[1:32], quant[1:])
    if not torch.equal(datapath.decode_datapath(*view),
                       datapath.decode_datapath_plain(*view)):
        raise RuntimeError("K2 differs from its plain version on a view a "
                           "block on")
    log(f"K2 adversarial blocks: exact in {runs} runs (N up to {n_max}, "
        "P = 1, 6, 720 and N), views off a 16-byte boundary refused")
    del coefs


def decode_redesign_checks(k1, captured, dec) -> None:
    """Phase 7's look into the redesigned K6, K1 and K7: K6's sync
    statistics on path B, and all three (with the lookup table) against
    their plain versions on adversarial inputs, K7 also against K1. Any
    difference raises."""
    dev = dec.device
    a6, k6 = captured["K6"]
    k1.decode_segments_streamed(*a6, **k6)
    stats = k1.decode_segments_streamed.stats.to(torch.float64).cpu()
    S6 = a6[0].shape[0]
    log(f"K6 on path B: {S6} rows, {int(stats[:, 2].sum())} threads a "
        f"launch ({int(stats[0, 2])} a row), subsequences of "
        f"{k1.STREAMED_SUB_BITS} bits, {int(stats[:, 1].sum())} in all")
    for i, name in enumerate(k1.STREAMED_STATS[:2]):
        log(f"  K6 {name}: mean {float(stats[:, i].mean()):.1f}, max "
            f"{float(stats[:, i].max()):.0f}")

    def same(name, got, ref):
        if not torch.equal(got, ref):
            raise RuntimeError(f"{name}: kernel differs from its plain "
                               "version")

    rng = np.random.default_rng(SEED)
    real = (dec.state.lo, dec.state.hi, dec.state.offset, dec.state.values)
    bad = malformed_tables(dev, SEED)
    same("LUT on malformed tables", k1.decode_lut(*bad),
         k1.decode_lut_plain(*bad))
    # K6: random bytes, all-zero and all-0xFF rows, one symbol a block,
    # short rows; seg_blocks 0 and B; a periodic schedule and one with no
    # short period; real and malformed tables; two subsequence lengths
    S, L, B = 64, 2048, 120
    rows = rng.integers(0, 256, (S, L)).astype(np.uint8)
    rows[1], rows[2] = 0, 0xFF
    rows[3] = 0
    ones = one_symbol_blocks(dec, B)
    rows[3, :len(ones)] = ones
    for s in range(4, S, 2):
        rows[s, rng.integers(0, L):] = 0
    segb = rng.integers(0, B + 1, S).astype(np.int32)
    segb[:6] = (B, B, B, B, 0, B)
    up = (torch.from_numpy(rows).to(dev), torch.from_numpy(segb).to(dev))
    kw = dict(blocks_per_segment=B, n_components=3)
    for sched_name, sched in (
            ("periodic", np.resize(dec.comp_idx[:6], B)),
            ("no short period", rng.integers(0, 3, B))):
        sched = torch.from_numpy(sched.astype(np.int32)).to(dev)
        for tab_name, tabs in (("real", real), ("malformed", bad)):
            ref = k1.decode_segments_streamed_plain(*up, sched, *tabs, **kw)
            for u in (k1.STREAMED_SUB_BITS, 64):
                saved, k1.STREAMED_SUB_BITS = k1.STREAMED_SUB_BITS, u
                try:
                    got = k1.decode_segments_streamed(*up, sched, *tabs,
                                                      **kw)
                finally:
                    k1.STREAMED_SUB_BITS = saved
                same(f"K6 {sched_name} {tab_name} U={u}", got, ref)
                rounds = k1.decode_segments_streamed.stats[:, 0]
                log(f"K6 adversarial rows ({sched_name} schedule, "
                    f"{tab_name} tables, U={u}): exact, sync rounds up to "
                    f"{int(rounds.max())}")
    # K1 with and without hooks: random lanes, some past the buffer
    S, B = 500, 24
    lens = rng.integers(0, 700, S).astype(np.int32)
    starts = rng.integers(0, 4000, S).astype(np.int32)
    flat = rng.integers(0, 256, 4803).astype(np.uint8)
    lens[0] = 4803 - starts[0] + 40
    segb = rng.integers(0, B + 1, S).astype(np.int32)
    segb[:2] = (0, B)
    sched = torch.from_numpy(
        np.resize(dec.comp_idx[:6], B).astype(np.int32)).to(dev)
    up = [torch.from_numpy(x).to(dev) for x in (flat, starts, lens, segb)]
    hooks = dict(
        init_bitpos=torch.from_numpy(
            rng.integers(0, 64, S).astype(np.int32)).to(dev),
        init_dc=torch.from_numpy(
            rng.integers(-40000, 40000, (S, 3)).astype(np.int32)).to(dev))
    for tab_name, tabs in (("real", real), ("malformed", bad)):
        for hook_kw in ({}, hooks):
            kw = dict(blocks_per_segment=B, n_components=3, **hook_kw)
            same(f"K1 {tab_name} hooks={bool(hook_kw)}",
                 k1.decode_flat(*up, sched, *tabs, **kw),
                 k1.decode_flat_plain(*up, sched, *tabs, **kw))
            # a view that starts 1..3 bytes past a word boundary
            for shift in (1, 2, 3):
                view = (up[0][shift:], *up[1:])
                same(f"K1 {tab_name} hooks={bool(hook_kw)} flat[{shift}:]",
                     k1.decode_flat(*view, sched, *tabs, **kw),
                     k1.decode_flat_plain(*view, sched, *tabs, **kw))
    log("K1 (with and without hooks) and the LUT: exact on random lanes, "
        "unaligned views and malformed tables")
    # K7 against its plain version and K1: random lanes of up to 1,500
    # bytes (one past the buffer's end), so each crosses many halves of its
    # ring, an all-0xFF lane and one of one symbol a block
    S, B = 600, 24
    flat = rng.integers(0, 256, 7504).astype(np.uint8)
    lens = rng.integers(0, 1500, S).astype(np.int32)
    starts = rng.integers(0, 6000, S).astype(np.int32)
    ones = one_symbol_blocks(dec, B)
    flat[100:100 + len(ones)] = ones
    starts[1], lens[1] = 100, len(ones)
    flat[2000:2600] = 0xFF
    starts[2], lens[2] = 2000, 600
    lens[0] = flat.size - starts[0] + 40
    segb = rng.integers(0, B + 1, S).astype(np.int32)
    segb[:3] = B
    up = [torch.from_numpy(x).to(dev) for x in (flat, starts, lens, segb)]
    hooks = dict(
        init_bitpos=torch.from_numpy(
            rng.integers(0, 64, S).astype(np.int32)).to(dev),
        init_dc=torch.from_numpy(
            rng.integers(-40000, 40000, (S, 3)).astype(np.int32)).to(dev))
    for tab_name, tabs in (("real", real), ("malformed", bad)):
        for hook_kw in ({}, hooks):
            kw = dict(blocks_per_segment=B, n_components=3, **hook_kw)
            k7 = k1.decode_flat_staged(*up, sched, *tabs, **kw)
            tag = f"K7 {tab_name} hooks={bool(hook_kw)}"
            same(tag, k7, k1.decode_flat_staged_plain(*up, sched, *tabs,
                                                      **kw))
            same(tag + " against K1", k7,
                 k1.decode_flat(*up, sched, *tabs, **kw))
    lut_bad = k1.decode_lut(*bad)[:bad[0].shape[0] << k1.LUT_BITS]
    level1 = lut_bad.to(torch.int32) & 0xFFFF
    log(f"K7 (with and without hooks): exact against its plain version and "
        f"K1 on {S} random lanes of up to 1,500 bytes, an all-0xFF lane and "
        f"one of one symbol a block, with real and malformed tables (these "
        f"send {int(((level1 & 0xC000) == k1.LUT_POOLED).sum())} level-1 "
        f"entries to a level-2 block, "
        f"{int((level1 == k1.LUT_FALLBACK).sum())} to the range match)")


# the plain Huffman loops a session on the card must never call (phase 13)
PLAIN_LOOPS = ("decode_flat_plain", "decode_flat_staged_plain",
               "decode_segments_plain", "decode_segments_streamed_plain",
               "decode_segments_lut_plain")


def counted_without_plain_loops(counted, call, must_launch):
    """counted(), with every plain Huffman loop of the decode module
    replaced by one that counts its calls (a card session must call
    none)."""
    from video_coding_tpu_torch.entropy import huffman_decode as k1

    plain_calls = {}
    saved = {n: getattr(k1, n) for n in PLAIN_LOOPS}
    for n, fn in saved.items():
        def tally(*a, n=n, fn=fn, **k):
            plain_calls[n] = plain_calls.get(n, 0) + 1
            return fn(*a, **k)
        setattr(k1, n, tally)
    try:
        out, seen = counted(call, must_launch)
    finally:
        for n, fn in saved.items():
            setattr(k1, n, fn)
    if plain_calls:
        raise RuntimeError(f"a plain loop ran on the card: {plain_calls}")
    return out, seen


def launch_counter():
    """counted(call, must_launch): run ``call`` with every launch count
    set to 0 just before and read just after; the kernels in
    ``must_launch`` must have run. Returns (call's result, the counts)."""
    from video_coding_tpu_torch.entropy import huffman_decode as k1
    from video_coding_tpu_torch.entropy import huffman_encode as k4
    from video_coding_tpu_torch.entropy import pack_stuff as k8
    from video_coding_tpu_torch.ops import datapath
    from video_coding_tpu_torch.ops import lookup as k9

    counters = {"K1": (k1.decode_flat, "launches"),
                "K1+hooks": (k1.decode_flat, "hook_launches"),
                "K2": (datapath.decode_datapath, "launches"),
                "K3": (datapath.encode_datapath, "launches"),
                "K4": (k4.encode_segments, "launches"),
                "K5": (k1.decode_segments, "launches"),
                "K6": (k1.decode_segments_streamed, "launches"),
                "K7": (k1.decode_flat_staged, "launches"),
                "K8": (k8.pack_stuff, "launches"),
                "K9": (k9.table_lookup, "launches"),
                "LUT": (k1.decode_lut, "launches")}

    def counted(call, must_launch):
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        out = call()
        torch.cuda.synchronize()
        seen = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
        missing = [k for k in must_launch if seen[k] == 0]
        if missing:
            raise RuntimeError(f"path did not launch {missing}: {seen}")
        return out, seen

    return counted


def wall_ms(fn, reps: int) -> float:
    """Median host-clock ms of fn() ended by a synchronize, after one
    warm-up call (for calls that do host work around their launches)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def frames_equal(a, b) -> bool:
    """Two decoded pictures (Frames or lists of Planes) are equal."""
    pa = [a.y, a.u, a.v] if hasattr(a, "y") else a
    pb = [b.y, b.u, b.v] if hasattr(b, "y") else b
    return len(pa) == len(pb) and all(
        x.data.shape == y.data.shape and (x.data == y.data).all()
        for x, y in zip(pa, pb))


def restuffed(segments: list, terminators: list) -> bytes:
    """An entropy body from destuffed segments: 0xFF stuffed, joined with
    RSTn (``terminators[i]`` is segment i's index; None drops the
    marker), closed by EOI."""
    out = bytearray()
    for i, seg in enumerate(segments):
        out += seg.replace(b"\xff", b"\xff\x00")
        if i < len(segments) - 1 and terminators[i] is not None:
            out += bytes((0xFF, 0xD0 + terminators[i]))
    return bytes(out + b"\xff\xd9")


def damaged_copies(payload: bytes) -> dict:
    """Three damaged copies of an ri=1 entropy body, by name: (bytes, a
    test of the damaged segments resync must report). Segment 100 set to
    0xFF, RST marker 200 removed, the stream cut at 60% (100 and 200 at
    1080p, fewer on a small frame)."""
    from video_coding_tpu_torch.entropy import scan as hscan

    segs = hscan.destuff_segments(payload)
    S = len(segs)
    k_bad, k_rst = min(100, S // 3), min(200, S // 2)
    term = [i & 7 for i in range(S - 1)]
    dropped = list(term)
    dropped[k_rst] = None
    cut = payload[:int(0.6 * len(payload))]
    n_whole = len(hscan.destuff_segments(cut)) - 1
    return {
        f"segment {k_bad} set to 0xFF": (
            restuffed(segs[:k_bad] + [b"\xff" * len(segs[k_bad])]
                      + segs[k_bad + 1:], term), lambda d: d == [k_bad]),
        f"RST marker {k_rst} removed": (restuffed(segs, dropped),
                                        lambda d: d == []),
        "cut at 60%": (cut, lambda d: d in (list(range(n_whole, S)),
                                            list(range(n_whole + 1, S)))),
    }


def host_engine_checks(sources, src_enc, smi, build_s: float) -> None:
    """Phase 17: the host entropy engine (``entropy/native.py``, the C++
    library built from ``csrc/host_entropy.cpp``) held exactly against the
    port's pure Python / numpy tier (``use_native=False``) on the phase 3
    sources, every entry point; ms a frame of each tier beside the card
    and the host CPU. The pure Python tier runs on frame 0 only."""
    import os

    from video_coding_tpu_torch.entropy import native
    from video_coding_tpu_torch.entropy import scan as hscan
    from video_coding_tpu_torch.runtime.engine import (JpegDecoderSession,
                                                       _lane_plan)

    t_phase = time.perf_counter()
    log(f"host engine: {native.library_path().name}, ABI "
        f"{native.load().vct_version()}, built by g++ in {build_s:.2f} s "
        "(phase 2)")
    cpu = "unknown"
    for cmd in (["lscpu"], ["cat", "/proc/cpuinfo"]):
        try:
            out = subprocess.run(cmd, capture_output=True, text=True).stdout
        except OSError:
            continue
        names = [line.split(":", 1)[1].strip() for line in out.splitlines()
                 if line.lower().startswith("model name")]
        if names:
            cpu = f"{names[0]} ({cmd[-1]})"
            break
    host = f"host CPU {cpu}, os.cpu_count() {os.cpu_count()}"
    header, payloads = sources["ri=1"]
    F = len(payloads)
    dec = JpegDecoderSession(header)
    ci, B, tabs = dec.comp_idx, dec.blocks_per_segment, dec.tables
    summary = []

    def tiers(name, engine, plain, equal, n_plain=1):
        """engine(i) on every frame, plain(i) on the first n_plain; equal
        results on those, or the run fails. Returns the engine's
        results."""
        t0 = time.perf_counter()
        got = [engine(i) for i in range(F)]
        e_ms = (time.perf_counter() - t0) * 1e3 / F
        t0 = time.perf_counter()
        ref = [plain(i) for i in range(n_plain)]
        p_ms = (time.perf_counter() - t0) * 1e3 / n_plain
        for i in range(n_plain):
            if not equal(got[i], ref[i]):
                raise RuntimeError(f"host engine {name}: frame {i} differs "
                                   "from the Python tier")
        summary.append((name, e_ms, p_ms, n_plain))
        log(f"host engine {name}: {e_ms:.3f} ms a frame ({F} frames), "
            f"Python tier {p_ms:.1f} ms a frame ({n_plain} frame(s)); equal")
        return got

    def arrays_equal(a, b):
        return all(np.array_equal(x, y) for x, y in zip(a, b))

    flats = tiers("destuff_flat",
                  lambda i: hscan.destuff_flat(payloads[i]),
                  lambda i: hscan.destuff_flat(payloads[i], use_native=False),
                  arrays_equal, F)
    segs = tiers("destuff_segments_with_markers",
                 lambda i: hscan.destuff_segments_with_markers(payloads[i]),
                 lambda i: hscan.destuff_segments_with_markers(
                     payloads[i], use_native=False), lambda a, b: a == b)

    def lanes(i, use_native=None):
        flat, lens = flats[i]
        starts = np.zeros_like(lens)
        np.cumsum(lens[:-1], out=starts[1:])
        plan = _lane_plan(starts, lens, dec._expected_seg_blocks(len(lens)),
                          matrix=True)
        return hscan.pack_lanes_sorted(flat, lens, plan.order, plan.L,
                                       starts=starts, use_native=use_native)

    tiers("pack_lanes_sorted", lanes, lambda i: lanes(i, False),
          np.array_equal, F)
    hdr_a, pay_a = sources["ri=0"]
    dec_a = JpegDecoderSession(hdr_a)
    stride = dec_a._index_stride()
    flats_a = [hscan.destuff_flat(p)[0] for p in pay_a]
    tiers("index_scan (ri=0)",
          lambda i: hscan.index_scan(flats_a[i], dec_a.comp_idx, stride,
                                     dec_a.tables),
          lambda i: hscan.index_scan(flats_a[i], dec_a.comp_idx, stride,
                                     dec_a.tables, use_native=False),
          arrays_equal)
    coefs = tiers("decode_scan",
                  lambda i: hscan.decode_scan(segs[i][0], ci, B, tabs),
                  lambda i: hscan.decode_scan(segs[i][0], ci, B, tabs,
                                              use_native=False),
                  np.array_equal)
    t0 = time.perf_counter()
    fused = [hscan.destuff_and_decode_scan(p, ci, B, tabs) for p in payloads]
    e_ms = (time.perf_counter() - t0) * 1e3 / F
    if not arrays_equal(fused, coefs):
        raise RuntimeError("host engine destuff_and_decode_scan differs from "
                           "decode_scan")
    summary.append(("destuff_and_decode_scan", e_ms, None, 0))
    log(f"host engine destuff_and_decode_scan: {e_ms:.3f} ms a frame ({F} "
        "frames), equal to decode_scan (held against the Python tier above)")
    for name, (data, expect) in damaged_copies(payloads[0]).items():
        seg_d, marks = hscan.destuff_segments_with_markers(data)
        if (seg_d, marks) != hscan.destuff_segments_with_markers(
                data, use_native=False):
            raise RuntimeError(f"host engine destuff of {name} differs")
        t0 = time.perf_counter()
        got = hscan.decode_scan_resync(seg_d, ci, B, tabs,
                                       marker_indices=marks)
        e_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ref = hscan.decode_scan_resync(seg_d, ci, B, tabs, use_native=False,
                                       marker_indices=marks)
        p_ms = (time.perf_counter() - t0) * 1e3
        if not (np.array_equal(got[0], ref[0]) and got[1] == ref[1]
                and expect(got[1])):
            raise RuntimeError(f"host engine resync of {name} differs from "
                               "the Python tier")
        summary.append((f"decode_scan_resync ({name})", e_ms, p_ms, 1))
        log(f"host engine decode_scan_resync, {name}: {e_ms:.3f} ms, Python "
            f"tier {p_ms:.1f} ms; {len(got[1])} damaged segments, equal")
    etabs = src_enc.tables
    for dtype in (np.int32, np.int16):
        tag = np.dtype(dtype).name
        tiers(f"encode_scan ({tag})",
              lambda i: hscan.encode_scan(coefs[i].astype(dtype), ci, B,
                                          etabs),
              lambda i: hscan.encode_scan(coefs[i].astype(dtype), ci, B,
                                          etabs, use_native=False),
              lambda a, b: a == b)
        bodies = tiers(
            f"encode_scan_stream ({tag}, with vct_assemble_stream)",
            lambda i: hscan.encode_scan_stream(coefs[i].astype(dtype), ci, B,
                                               etabs),
            lambda i: hscan.encode_scan_stream(coefs[i].astype(dtype), ci, B,
                                               etabs, use_native=False),
            lambda a, b: a == b)
        if any(b + b"\xff\xd9" != p for b, p in zip(bodies, payloads)):
            raise RuntimeError(f"host engine encode_scan_stream ({tag}) of "
                               "the decoded coefficients is not the source "
                               "body")
    log(f"host engine: the {F} re-encoded bodies are the sources' bytes")
    log("host engine summary (ms a frame, engine / Python tier): "
        + "; ".join(f"{n} {e:.3f} / " + ("-" if p is None else f"{p:.1f}")
                    for n, e, p, _k in summary)
        + f" — on {smi}; {host}; phase 17 took "
        f"{time.perf_counter() - t_phase:.1f} s")


def host_entropy_paths(sources, file0, trans, counted, compare, smi,
                       path_launches) -> None:
    """Phase 13: the decoder session's host-entropy half (path G) and the
    transcode's host route (path H) on the phase 3 sources. Any
    difference raises."""
    from video_coding_tpu_torch.common.bitstream import BitReader
    from video_coding_tpu_torch.entropy import huffman_decode as k1
    from video_coding_tpu_torch.entropy import scan as hscan
    from video_coding_tpu_torch.model.header import Header
    from video_coding_tpu_torch.ops import datapath
    from video_coding_tpu_torch.runtime import decode_jpeg
    from video_coding_tpu_torch.runtime.engine import (JpegDecoderSession,
                                                       JpegTranscodeSession)

    t_phase = time.perf_counter()
    header, payloads = sources["ri=1"]
    huffman = ("K1", "K5", "K6", "K7")

    def keep_coefs(sess):
        """Wrap sess.decode_entropy so its results and host ms are kept."""
        kept, orig = [], sess.decode_entropy

        def run(*a, **k):
            t0 = time.perf_counter()
            c = orig(*a, **k)
            kept.append((c, (time.perf_counter() - t0) * 1e3))
            return c

        sess.decode_entropy = run
        return kept

    refs = {tag: JpegDecoderSession(h).decode_device(p[0])
            for tag, (h, p) in sources.items()}

    # G, host decoder: decode() of frame 0 (ri=1), dense and sparse
    coefs1 = None
    for transfer in ("dense", "sparse"):
        sess = JpegDecoderSession(header, entropy="native",
                                  coef_transfer=transfer)
        kept = keep_coefs(sess)
        spy2 = Spy(datapath.decode_datapath)
        datapath.decode_datapath = spy2
        try:
            t0 = time.perf_counter()
            got, seen = counted_without_plain_loops(
                counted, lambda: sess.decode(payloads[0]), ("K2",))
            wall = (time.perf_counter() - t0) * 1e3
        finally:
            datapath.decode_datapath = spy2.fn
        if seen["K2"] != 1 or any(seen[k] for k in huffman + ("LUT",)):
            raise RuntimeError(f"path G host ({transfer}) must launch K2 once "
                               f"and no Huffman decode kernel: {seen}")
        path_launches[f"G host {transfer}"] = seen
        coefs1, host_ms = kept[0]
        if not frames_equal(got, refs["ri=1"]):
            raise RuntimeError(f"decode() ({transfer}) differs from "
                               "decode_device()")
        cpu = JpegDecoderSession(header, device="cpu",
                                 coef_transfer=transfer)
        if not frames_equal(got, cpu._to_frame(
                cpu.decode_planes_device(coefs1))):
            raise RuntimeError(f"decode() ({transfer}) differs from the CPU "
                               "session's")
        a2, kw2 = spy2.args
        compare("K2 on path G", datapath.decode_datapath(*a2, **kw2),
                datapath.decode_datapath_plain(*a2, **kw2))
        up_ms = wall_ms(lambda: sess.decode_planes_device(coefs1), 5)
        log(f"path G host decode ri=1 frame 0, coef_transfer={transfer}: "
            f"launches {seen}; the host decoder {host_ms:.1f} ms a frame "
            f"(the host entropy engine), upload + K2 + plane gather "
            f"{up_ms:.3f} ms (median of 5), decode() {wall:.1f} ms wall; "
            f"equal to "
            f"decode_device() and to device='cpu' on {smi}")

    # G, entropy="tpu": the strategy's kernel and K2 once each, no plain
    # loop; K2 and the kernel held against their plain versions on the
    # arguments the path gave them
    runs = [("ri=1", "auto", "K1", "decode_flat"),
            (f"ri={WIDTH // 16}", "auto", "K6", "decode_segments_streamed"),
            ("ri=0", "auto", "K5", "decode_segments"),
            ("ri=1", "pallas", "K5", "decode_segments")]
    for tag, how, kname, wname in runs:
        hdr_s, pay_s = sources[tag]
        sess = JpegDecoderSession(hdr_s, entropy="tpu", device_huffman=how)
        kept = keep_coefs(sess)
        wrapper = getattr(k1, wname)
        spy, spy2 = Spy(wrapper), Spy(datapath.decode_datapath)
        setattr(k1, wname, spy)
        datapath.decode_datapath = spy2
        try:
            got, seen = counted_without_plain_loops(
                counted, lambda: sess.decode(pay_s[0]), (kname, "K2", "LUT"))
        finally:
            setattr(k1, wname, wrapper)
            datapath.decode_datapath = spy2.fn
        others = [k for k in huffman if k != kname and seen[k]]
        if seen[kname] != 1 or seen["K2"] != 1 or others:
            raise RuntimeError(f"path G tpu {how} {tag}: expected {kname} and "
                               f"K2 once each: {seen}")
        path_launches[f"G tpu {how} {tag}"] = seen
        if not frames_equal(got, refs[tag]):
            raise RuntimeError(f"path G tpu {how} {tag}: planes differ from "
                               "decode_device()")
        a, kw = spy.args
        out = getattr(k1, wname)(*a, **kw)
        if tag == "ri=0":
            # one lane of the whole frame: the plain loop steps once a
            # symbol of it, so the host decoder's coefficients stand in
            t0 = time.perf_counter()
            ref_c = hscan.decode_scan(hscan.destuff_segments(pay_s[0]),
                                      sess.comp_idx, sess.blocks_per_segment,
                                      sess.tables)
            compare(f"{kname} on path G {tag} against the host decoder",
                    out.view(-1, 64)[:sess.n_blocks].cpu(),
                    torch.from_numpy(ref_c))
            note = (f"{kname} equal to the host decoder's coefficients "
                    f"({(time.perf_counter() - t0) * 1e3:.0f} ms)")
        else:
            t0 = time.perf_counter()
            compare(f"{kname} on path G {tag}", out,
                    getattr(k1, wname + "_plain")(*a, **kw))
            note = (f"{kname} equal to its plain version "
                    f"({(time.perf_counter() - t0) * 1e3:.0f} ms)")
        a2, kw2 = spy2.args
        compare("K2 on path G", datapath.decode_datapath(*a2, **kw2),
                datapath.decode_datapath_plain(*a2, **kw2))
        ms = wall_ms(lambda: sess.decode_entropy(pay_s[0]), 3)
        log(f"path G entropy=tpu device_huffman={how} {tag}: {a[-6].shape[0]}"
            f" lanes of {kw['blocks_per_segment']} blocks, launches {seen}; "
            f"decode_entropy {ms:.3f} ms (destuff, pack, upload, decode, "
            f"download; median of 3), first decode() {kept[0][1]:.1f} ms; "
            f"{note}; K2 equal to its plain version; planes equal to "
            f"decode_device() on {smi}")
        del out
    for how in ("lut", "range"):
        sess = JpegDecoderSession(header, entropy="tpu", device_huffman=how)
        t0 = time.perf_counter()
        got = sess.decode(payloads[0])
        ms = (time.perf_counter() - t0) * 1e3
        if not frames_equal(got, refs["ri=1"]):
            raise RuntimeError(f"device_huffman={how}: planes differ")
        log(f"path G entropy=tpu device_huffman={how} ri=1 (a plain PyTorch "
            f"loop on the card): decode() {ms:.1f} ms once; planes equal on "
            f"{smi}")

    # G, batch and iter
    dev_sess = JpegDecoderSession(header)
    dev_ref = [dev_sess._to_frame(p)
               for p in dev_sess.decode_device_batch(payloads)]
    tpu = JpegDecoderSession(header, entropy="tpu")
    got = tpu.decode_batch(payloads)
    if not all(frames_equal(g, r) for g, r in zip(got, dev_ref)):
        raise RuntimeError("decode_batch (tpu) differs from "
                           "decode_device_batch")

    def window() -> float:
        t = time.perf_counter()
        tpu.decode_batch(payloads)
        torch.cuda.synchronize()
        return len(payloads) / (time.perf_counter() - t)

    w = sorted(window() for _ in range(3))
    log(f"decode_batch entropy=tpu {WIDTH}x{HEIGHT} q90 ri=1 "
        f"F={len(payloads)}: median {w[1]:.2f} frames/s (windows "
        f"{', '.join(f'{x:.2f}' for x in w)}); equal to decode_device_batch "
        f"on {smi}")
    t0 = time.perf_counter()
    got = JpegDecoderSession(header, entropy="native").decode_batch(
        payloads[:2])
    if not all(frames_equal(g, r) for g, r in zip(got, dev_ref)):
        raise RuntimeError("decode_batch (native) differs")
    log(f"decode_batch entropy=native, 2 frames: equal, "
        f"{time.perf_counter() - t0:.1f} s")
    order = [3, 0, 2, 1]
    got = list(tpu.decode_iter([payloads[i] for i in order], depth=2))
    if len(got) != 4 or not all(frames_equal(g, dev_ref[i])
                                for g, i in zip(got, order)):
        raise RuntimeError("decode_iter: frames out of order or unequal")
    log("decode_iter over 4 frames: in order and equal")

    # G, resync on three damaged copies of frame 0 (ri=1): decoded once on
    # the card; the CPU session's planes from the same coefficients
    copies = damaged_copies(payloads[0])
    gpu = JpegDecoderSession(header)
    cpu = JpegDecoderSession(header, device="cpu")
    for name, (data, expect) in copies.items():
        kept = keep_coefs(gpu)
        t0 = time.perf_counter()
        got = gpu.decode(data, resync=True)
        ms = (time.perf_counter() - t0) * 1e3
        damaged = gpu.last_damaged_segments
        if not expect(damaged):
            raise RuntimeError(f"resync {name}: damaged segments {damaged}")
        if not frames_equal(got, cpu._to_frame(
                cpu.decode_planes_device(kept[0][0]))):
            raise RuntimeError(f"resync {name}: planes differ from the CPU "
                               "session's")
        shown = damaged if len(damaged) <= 4 else \
            f"{damaged[0]}..{damaged[-1]} ({len(damaged)})"
        log(f"path G resync, {name}: damaged segments {shown}, "
            f"{ms:.0f} ms; planes equal to device='cpu'")
    try:
        gpu.decode(next(iter(copies.values()))[0])    # segment set to 0xFF
    except hscan.SegmentDecodeError as e:
        log(f"strict decode() of the damaged copy raised: {e}")
    else:
        raise RuntimeError("strict decode() of a damaged stream did not raise")
    t0 = time.perf_counter()
    whole = decode_jpeg(file0)
    if not frames_equal(whole, refs["ri=1"]):
        raise RuntimeError("decode_jpeg differs from decode()")
    log(f"decode_jpeg of the whole ri=1 file: equal to decode(), "
        f"{time.perf_counter() - t0:.1f} s")

    # H: the transcode's host route
    host = JpegTranscodeSession(header, quality=75, restart_interval=1,
                                entropy_out="host")
    t0 = time.perf_counter()
    outs, seen = counted(lambda: host.transcode_batch(payloads[:2]),
                         ("K1", "K2", "K3", "LUT"))
    ms = (time.perf_counter() - t0) * 1e3 / 2
    if seen["K4"]:
        raise RuntimeError(f"path H launched K4: {seen}")
    path_launches["H"] = seen
    if outs != trans.transcode_batch(payloads[:2]):
        raise RuntimeError("path H bytes differ from the device route's")
    for o in outs:
        if Header.decode(BitReader(o)).frame is None:
            raise RuntimeError("path H output does not parse")
    log(f"path H transcode_batch entropy_out=host, 2 frames q75 ri=1: "
        f"launches {seen}; the device route's bytes; {ms:.1f} ms a frame "
        f"(host coder: the host entropy engine) on {smi}")
    order = [1, 0, 3, 2]
    got = list(host.transcode_iter([payloads[i] for i in order], depth=2))
    ref = trans.transcode_batch(payloads[:4])
    if got != [ref[i] for i in order]:
        raise RuntimeError("transcode_iter differs from transcode_batch")
    log(f"transcode_iter over 4 frames (host route): equal to "
        f"transcode_batch; phase 13 took {time.perf_counter() - t_phase:.1f} "
        f"s")


def rgb_training_path(sources, frames, streams, counted, smi,
                      path_launches, device_profile) -> None:
    """Phase 14: the decode-for-training path (path I) on the phase 3
    sources: decode_device_rgb(_batch), the other samplings and an odd
    size, JpegRgbDataset over an MJPEG stream, and the mjpeg helpers. Any
    difference raises."""
    from video_coding_tpu_torch.common.bitstream import BitReader
    from video_coding_tpu_torch.common.frame import ChromaSubsampling, Frame
    from video_coding_tpu_torch.common.plane import Plane
    from video_coding_tpu_torch.model.header import Header, Parameters
    from video_coding_tpu_torch.ops import color
    from video_coding_tpu_torch.runtime.dataset import JpegRgbDataset
    from video_coding_tpu_torch.runtime.engine import (JpegDecoderSession,
                                                       JpegEncoderSession)
    from video_coding_tpu_torch.tools import mjpeg

    t_phase = time.perf_counter()
    header, payloads = sources["ri=1"]
    F = len(payloads)
    sess = JpegDecoderSession(header)
    sess.decode_device_rgb_batch(payloads[:2])         # warm
    rgb, seen = counted_without_plain_loops(
        counted, lambda: sess.decode_device_rgb_batch(payloads),
        ("K1", "K2", "LUT"))
    others = [k for k in ("K1+hooks", "K3", "K4", "K5", "K6", "K7", "K8",
                          "K9") if seen[k]]
    if seen["K1"] != 1 or seen["K2"] != 1 or seen["LUT"] != 1 or others:
        raise RuntimeError(f"path I must launch K1, K2 and the LUT once "
                           f"each and nothing else: {seen}")
    path_launches["I"] = seen
    if (rgb.device.type != sess.device.type or rgb.dtype != torch.uint8
            or tuple(rgb.shape) != (F, HEIGHT, WIDTH, 3)):
        raise RuntimeError(f"path I gave {rgb.dtype} {tuple(rgb.shape)} on "
                           f"{rgb.device}")
    t0 = time.perf_counter()
    cpu_rgb = JpegDecoderSession(header, device="cpu") \
        .decode_device_rgb_batch(payloads[:2])
    if not torch.equal(rgb[:2].cpu(), cpu_rgb):
        raise RuntimeError("path I RGB differs from the CPU session's")
    cpu_s = time.perf_counter() - t0
    planes = sess.decode_device_batch_stacked(payloads)
    comps = sess.components
    y = planes[0][:, :HEIGHT, :WIDTH]
    ch = [color.upsample_hv2(p[:, :c.actual_height, :c.actual_width])
          for p, c in zip(planes[1:], comps[1:])]
    if not torch.equal(rgb, color.yuv444_to_rgb(y, *ch)):
        raise RuntimeError("path I RGB differs from yuv444_to_rgb of the "
                           "upsampled planes of decode_device_batch_stacked")
    src = [torch.from_numpy(a).to(sess.device) for a in frames[0]]
    src_rgb = color.yuv420_to_rgb(*src)
    db = psnr(rgb[0].cpu().numpy(), src_rgb.cpu().numpy())
    if db <= 30.0:
        raise RuntimeError(f"path I frame 0 RGB PSNR {db:.2f} dB <= 30 dB")
    if not torch.equal(sess.decode_device_rgb(payloads[0]), rgb[0]):
        raise RuntimeError("decode_device_rgb differs from frame 0 of the "
                           "batch")
    log(f"path I decode_device_rgb_batch {WIDTH}x{HEIGHT} q90 ri=1 F={F}: "
        f"launches {seen}; (F, H, W, 3) uint8 on the card; frames 0-1 equal "
        f"to device='cpu' ({cpu_s:.1f} s on the CPU); equal to "
        f"yuv444_to_rgb of the upsampled stacked planes; frame 0 "
        f"{db:.2f} dB against the source's RGB; decode_device_rgb of frame "
        f"0 equal to the batch's")

    def window() -> float:
        t = time.perf_counter()
        for _ in range(2):
            sess.decode_device_rgb_batch(payloads)
        torch.cuda.synchronize()
        return 2 * F / (time.perf_counter() - t)

    fps = sorted(window() for _ in range(3))
    mpix = [f * WIDTH * HEIGHT / 1e6 for f in fps]
    log(f"path I decode_device_rgb_batch: median {fps[1]:.2f} frames/s, "
        f"{mpix[1]:.2f} MPix/s (windows of 2 dispatches: "
        f"{', '.join(f'{x:.2f}' for x in fps)} frames/s) on {smi}")

    # where the device time goes: one dispatch, then the tail alone. The
    # profiler has dropped the first part of a window's events (no copy,
    # K1, K2 or LUT in it): up to three profiles until one holds them
    def part_of(key: str) -> str:
        return ("K1" if "huffman_decode_kernel" in key else
                "K2" if "decode_datapath_kernel" in key else
                "LUT" if "lut_level" in key else
                "copies" if key.startswith(("Memcpy", "Memset")) else
                "torch ops")

    for attempt in range(1, 4):
        wall, by_name = device_profile(
            lambda: sess.decode_device_rgb_batch(payloads))
        held = {part_of(k) for k in by_name}
        if {"K1", "K2", "LUT", "copies"} <= held:
            break
    parts = dict.fromkeys(("K1", "K2", "LUT", "copies", "torch ops"), 0.0)
    for key, (ms, _n) in by_name.items():
        parts[part_of(key)] += ms
    busy = sum(parts.values())
    log(f"breakdown: one decode_device_rgb_batch (F={F}) {wall:.2f} ms wall "
        f"under the profiler (profile {attempt} of at most 3), device busy "
        f"{busy:.3f} ms ({1 - busy / wall:.1%} idle): "
        + ", ".join(f"{k} {v:.3f} ms" if k in held else
                    f"{k} not measured (no such event in the profile)"
                    for k, v in parts.items()))
    for key, (ms, _n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:10]:
        log(f"  device {ms:8.3f} ms  {key}")
    tail_ms = time_ms(lambda: sess._rgb_tail(planes), 10)
    tail_busy = sum(v[0] for v in device_profile(
        lambda: sess._rgb_tail(planes))[1].values())
    tail_bytes = F * (sum(c.actual_height * c.actual_width for c in comps)
                      + HEIGHT * WIDTH * 3)
    bms, by = bound_ms(tail_bytes, 0.0)
    log(f"RGB tail (plain torch, not a kernel): {tail_ms:.4f} ms (CUDA "
        f"events, median of 10), {tail_busy:.4f} ms of device time in its "
        f"own profile; bound {bms:.4f} ms ({by}: each Y/U/V sample read "
        f"once and each RGB byte written once, {tail_bytes / 1e6:.1f} MB) — "
        f"{bms / tail_ms:.1%} of bound")

    # the other samplings and an odd size, encoded on the card
    y0, u0, v0 = frames[0]
    variants = {
        "4:2:2": ("c422", WIDTH, HEIGHT,
                  (y0, u0.repeat(2, axis=0), v0.repeat(2, axis=0))),
        "4:4:0": ("c440", WIDTH, HEIGHT,
                  (y0, u0.repeat(2, axis=1), v0.repeat(2, axis=1))),
        "4:4:4": ("c444", WIDTH, HEIGHT,
                  (y0, u0.repeat(2, axis=0).repeat(2, axis=1),
                   v0.repeat(2, axis=0).repeat(2, axis=1))),
        "4:2:0, odd size,": ("c420", WIDTH - 1, HEIGHT - 1,
                             (y0[:-1, :-1], u0[:-1, :-1], v0[:-1, :-1])),
    }
    for name, (maker, w, h, src) in variants.items():
        enc = JpegEncoderSession(getattr(Parameters, maker)(w, h, 90), 1)
        stream = enc.encode_device_batch([src])[0]
        bits = BitReader(stream)
        hdr = Header.decode(bits)
        pay = stream[bits.bit_pos >> 3:]
        got = JpegDecoderSession(hdr).decode_device_rgb(pay)
        t0 = time.perf_counter()
        ref = JpegDecoderSession(hdr, device="cpu").decode_device_rgb(pay)
        if tuple(got.shape) != (h, w, 3) or not torch.equal(got.cpu(), ref):
            raise RuntimeError(f"path I {name}: RGB differs from the CPU "
                               "session's")
        log(f"path I {name} {w}x{h}: decode_device_rgb equal to device='cpu'"
            f" ({time.perf_counter() - t0:.1f} s on the CPU)")

    # JpegRgbDataset over an MJPEG stream of the 16 sources
    stream = mjpeg.join_stream(streams)
    ds = JpegRgbDataset(stream, batch_size=8, prefetch=2)
    batches = list(ds)
    if (len(ds) != 2 or len(batches) != 2
            or ds.frame_shape != (HEIGHT, WIDTH, 3)
            or any(tuple(b.shape) != (8, HEIGHT, WIDTH, 3)
                   or b.device.type != sess.device.type for b in batches)):
        raise RuntimeError("JpegRgbDataset batches: "
                           f"{[tuple(b.shape) for b in batches]}")
    if not (torch.equal(batches[0], rgb[:8])
            and torch.equal(batches[1], rgb[8:])):
        raise RuntimeError("JpegRgbDataset differs from "
                           "decode_device_rgb_batch")

    def ds_window() -> float:
        t = time.perf_counter()
        for _ in ds:
            pass
        torch.cuda.synchronize()
        return F / (time.perf_counter() - t)

    ds_fps = sorted(ds_window() for _ in range(3))
    drop = JpegRgbDataset(stream, batch_size=6, drop_remainder=True,
                          session=ds.session)
    if [b.shape[0] for b in drop] != [6, 6]:
        raise RuntimeError("drop_remainder with batch_size=6 must give two "
                           "batches")
    try:
        JpegRgbDataset(stream, sharding=object())
    except TypeError:
        pass
    else:
        raise RuntimeError("JpegRgbDataset(sharding=<not a mesh>) did not "
                           "raise")
    log(f"JpegRgbDataset over the {F}-frame MJPEG stream, batch_size=8, "
        f"prefetch=2: 2 batches of (8, {HEIGHT}, {WIDTH}, 3) on the card, "
        f"equal to decode_device_rgb_batch; median {ds_fps[1]:.2f} frames/s "
        f"(windows {', '.join(f'{x:.2f}' for x in ds_fps)}); batch_size=6 "
        f"drop_remainder: 2 batches; a sharding other than a mesh raises "
        f"TypeError (path J runs sharding=mesh)")

    # mjpeg: encode_stream (the host coder: the engine) of 2 frames, and
    # decode_stream of them through an entropy="tpu" session
    t0 = time.perf_counter()
    two = [Frame(Plane(data=y), Plane(data=u), Plane(data=v),
                 ChromaSubsampling.C420) for y, u, v in frames[:2]]
    enc_stream = mjpeg.encode_stream(two, quality=90, restart_interval=1)
    if enc_stream != mjpeg.join_stream(streams[:2]):
        raise RuntimeError("mjpeg.encode_stream differs from the sources' "
                           "bytes")
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = mjpeg.decode_stream(
        enc_stream, session=JpegDecoderSession(header, entropy="tpu"))
    dec_s = time.perf_counter() - t0
    if len(got) != 2 or not all(frames_equal(g, sess.decode_device(p))
                                for g, p in zip(got, payloads)):
        raise RuntimeError("mjpeg.decode_stream differs from decode_device")
    log(f"mjpeg: encode_stream of 2 frames q90 ri=1 (host coder) equal to "
        f"the sources' bytes, {enc_s:.1f} s; decode_stream with "
        f"entropy='tpu' equal to decode_device frame by frame, {dec_s:.2f} "
        f"s; phase 14 took {time.perf_counter() - t_phase:.1f} s")


def _add_seen(total: dict, seen: dict) -> None:
    for k, v in seen.items():
        total[k] = total.get(k, 0) + v


def multi_device_path(sources, frames, streams, counted, smi,
                      path_launches) -> None:
    """Phase 15: path J, the multi-device layer on a one-rank NCCL group
    and a (1, 1) codec mesh: the sessions' mesh=, the dataset's sharding
    and the sharded pipelines on the phase 3 sources, each equal to its
    unsharded counterpart and timed beside it. More than one rank is
    proven only on the CPU with gloo (one card here). Any difference
    raises; the process group is destroyed at the end."""
    import socket

    import torch.distributed as dist

    from video_coding_tpu_torch.entropy import gather_pack
    from video_coding_tpu_torch.entropy.decode_tables import pack_segments
    from video_coding_tpu_torch.entropy.scan import (destuff_dispatch,
                                                     destuff_segments)
    from video_coding_tpu_torch.model.header import Parameters
    from video_coding_tpu_torch.ops import datapath
    from video_coding_tpu_torch.parallel import (codec_mesh,
                                                 mjpeg_codec_step,
                                                 sharded_decode_datapath,
                                                 sharded_decode_e2e,
                                                 sharded_encode_datapath)
    from video_coding_tpu_torch.entropy.huffman_encode import packed_tables
    from video_coding_tpu_torch.parallel.pipeline import _luma_rate_tables
    from video_coding_tpu_torch.runtime.dataset import JpegRgbDataset
    from video_coding_tpu_torch.runtime.engine import (
        JpegDecoderSession, JpegEncoderSession, JpegTranscodeSession,
        _blocks_from_plane, _plane_from_blocks)
    from video_coding_tpu_torch.tools import mjpeg

    t_phase = time.perf_counter()
    header, payloads = sources["ri=1"]
    F = len(payloads)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    seen_j: dict = {}
    times = []

    def run(name, call, must, plain_call=None):
        """The mesh call with the counts reset and read, then it and its
        unsharded counterpart timed (wall ms, median of 3 after a
        warm-up)."""
        out, seen = counted_without_plain_loops(counted, call, must)
        _add_seen(seen_j, seen)
        ms = wall_ms(call, 3)
        plain_ms = wall_ms(plain_call, 3) if plain_call else None
        times.append((name, ms, plain_ms))
        log(f"path J {name}: mesh {ms:.2f} ms, unsharded "
            + (f"{plain_ms:.2f} ms" if plain_call else "-")
            + f" (wall, median of 3); launches "
            f"{ {k: v for k, v in seen.items() if v} }")
        return out, seen

    try:
        mesh = codec_mesh(1)
        if tuple(mesh.shape) != (1, 1):
            raise RuntimeError(f"codec_mesh(1) gave {mesh}")
        dec = JpegDecoderSession(header)
        mdec = JpegDecoderSession(header, mesh=mesh)
        mdec.decode_device_batch_stacked(payloads[:2])          # warm
        planes, _ = run("decode_device_batch_stacked F=16",
                     lambda: mdec.decode_device_batch_stacked(payloads),
                     ("K1", "K2", "LUT"),
                     lambda: dec.decode_device_batch_stacked(payloads))
        ref_planes = dec.decode_device_batch_stacked(payloads)
        for p, r in zip(planes, ref_planes):
            if not torch.equal(p.to_local(), r) or \
                    tuple(p.shape) != tuple(r.shape):
                raise RuntimeError("mesh decode_device_batch_stacked differs "
                                   "from the unsharded session")
        got, _ = run("decode_device frame 0",
                  lambda: mdec.decode_device(payloads[0]),
                  ("K1", "K2", "LUT"),
                  lambda: dec.decode_device(payloads[0]))
        if not frames_equal(got, dec.decode_device(payloads[0])):
            raise RuntimeError("mesh decode_device differs")

        for ri, q, must in ((1, 90, ("K3", "K4")),
                            (8, 75, ("K3", "K8", "K9"))):
            p = Parameters.c420(WIDTH, HEIGHT, q)
            enc = JpegEncoderSession(p, ri)
            menc = JpegEncoderSession(p, ri, mesh=mesh)
            menc.encode_device_batch(frames[:2])                  # warm
            out, seen = run(f"encode_device_batch F=16 q{q} ri={ri}",
                            lambda menc=menc: menc.encode_device_batch(
                                frames),
                            must,
                            lambda enc=enc: enc.encode_device_batch(frames))
            ref = streams if ri == 1 else enc.encode_device_batch(frames)
            if out != ref:
                raise RuntimeError(f"mesh encode ri={ri} bytes differ")
            if seen["K8"] if ri == 1 else seen["K4"]:
                raise RuntimeError(f"the ri={ri} mesh encode took the other "
                                   f"packer: {seen}")

        trans = JpegTranscodeSession(header, quality=75, restart_interval=1)
        mtrans = JpegTranscodeSession(header, quality=75, restart_interval=1,
                                      mesh=mesh)
        mtrans.transcode_batch(payloads[:2])                      # warm
        out, _ = run("transcode_batch F=16 q75 ri=1",
                  lambda: mtrans.transcode_batch(payloads),
                  ("K1", "K2", "K3", "K4", "LUT"),
                  lambda: trans.transcode_batch(payloads))
        if out != trans.transcode_batch(payloads):
            raise RuntimeError("mesh transcode bytes differ")

        stream = mjpeg.join_stream(streams)
        plain_ds = JpegRgbDataset(stream, batch_size=8)
        mesh_ds = JpegRgbDataset(stream, batch_size=8, sharding=mesh)
        batches, _ = run("JpegRgbDataset 2 batches of 8",
                      lambda: list(mesh_ds), ("K1", "K2", "LUT"),
                      lambda: list(plain_ds))
        ref = list(plain_ds)
        if len(batches) != 2 or not all(
                torch.equal(b.to_local(), r) and tuple(b.shape)
                == tuple(r.shape) for b, r in zip(batches, ref)):
            raise RuntimeError("JpegRgbDataset(sharding=mesh) differs from "
                               "sharding=None")

        # the sharded datapaths on the 16 frames' blocks
        coefs, _inv = dec._decode_coefs_pool(
            destuff_dispatch(payloads, dec.n_segments))
        coefs = coefs.view(-1, 64)
        N = coefs.shape[0]
        qdec = dec._quant_seg.repeat(N // dec.blocks_per_segment, 1)
        px, _ = run(f"sharded_decode_datapath N={N}",
                 lambda: sharded_decode_datapath(mesh, coefs, qdec),
                 ("K2",), lambda: datapath.decode_datapath(coefs, qdec))
        ref_px = datapath.decode_datapath(coefs, qdec)
        if not torch.equal(px.to_local(), ref_px):
            raise RuntimeError("sharded_decode_datapath differs from K2")
        enc = JpegEncoderSession(Parameters.c420(WIDTH, HEIGHT, 75), 1)
        qenc = enc.state.quant.repeat(N // enc.n_blocks, 1)
        qc, _ = run(f"sharded_encode_datapath N={N}",
                 lambda: sharded_encode_datapath(mesh, ref_px, qenc),
                 ("K3",), lambda: datapath.encode_datapath(ref_px, qenc))
        if not torch.equal(qc.to_local(),
                           datapath.encode_datapath(ref_px, qenc)):
            raise RuntimeError("sharded_encode_datapath differs from K3")

        # sharded_decode_e2e on frame 0's segments (K5, K2)
        segbytes, _lens = pack_segments(destuff_segments(payloads[0]))
        B = dec.blocks_per_segment
        S = segbytes.shape[0]
        e2e_args = (mesh, segbytes, np.full(S, B, np.int32),
                    dec.comp_idx[:B], dec.tables, dec.quant[:B], B)
        px0, _ = run(f"sharded_decode_e2e S={S}",
                     lambda: sharded_decode_e2e(*e2e_args), ("K5", "K2"),
                     lambda: dec.decode_device_e2e(payloads[0]))
        blocks = px0.to_local().reshape(-1, 8, 8)
        for (idx, nby, nbx), ref in zip(dec.state.plane_idx,
                                        dec.decode_device_e2e(payloads[0])):
            if not torch.equal(
                    _plane_from_blocks(blocks[idx][None], nby, nbx)[0], ref):
                raise RuntimeError("sharded_decode_e2e differs from "
                                   "decode_device")

        # mjpeg_codec_step on the 16 frames' luma
        luma = _blocks_from_plane(ref_planes[0], *dec.plane_geom[0][1:])
        qluma = enc.state.quant[:1].repeat(luma.shape[1], 1)   # luma rows
        (qcs, recon, rates, db), _ = run(
            f"mjpeg_codec_step {tuple(luma.shape)}",
            lambda: mjpeg_codec_step(mesh, luma, qluma), ("K3", "K2", "K9"))
        flat_px = luma.reshape(-1, 8, 8)
        qc_ref = datapath.encode_datapath(flat_px, qluma)
        if not (torch.equal(qcs.to_local().reshape(-1, 64), qc_ref)
                and torch.equal(recon.to_local().reshape(-1, 8, 8),
                                datapath.decode_datapath(qc_ref, qluma))):
            raise RuntimeError("mjpeg_codec_step differs from K3 / K2")
        n_blk = qc_ref.shape[0]
        dev = qc_ref.device
        seg_bits = gather_pack.segment_coded_bits(
            qc_ref, torch.zeros(n_blk, dtype=torch.int32, device=dev),
            torch.full((1,), -1, dtype=torch.int32, device=dev),
            *(torch.from_numpy(t).to(dev) for t in
              packed_tables(*_luma_rate_tables())),
            blocks_per_segment=1).view(F, -1).sum(1, dtype=torch.int32)
        if not torch.equal(rates, seg_bits):
            raise RuntimeError("mjpeg_codec_step rates differ from "
                               "segment_coded_bits")
        a = flat_px.cpu().numpy().astype(np.float64)
        b = recon.to_local().cpu().numpy().reshape(a.shape)
        want = 10 * np.log10(255.0 ** 2 / np.mean((a - b) ** 2))
        if abs(float(db) - want) > 1e-3:
            raise RuntimeError(f"mjpeg_codec_step PSNR {float(db)} dB, "
                               f"float64 numpy {want} dB")
        log(f"path J mjpeg_codec_step: rates equal to segment_coded_bits "
            f"({int(rates.sum())} bits in all), PSNR {float(db):.6f} dB "
            f"against float64 numpy {want:.6f} dB")
    finally:
        dist.destroy_process_group()
    path_launches["J"] = seen_j
    log(f"path J on {smi}: " + "; ".join(
        f"{n} {ms:.2f} / " + (f"{pms:.2f}" if pms else "-") + " ms"
        for n, ms, pms in times)
        + f" (mesh / unsharded); phase 15 took "
        f"{time.perf_counter() - t_phase:.1f} s")


def cli_paths(frames, streams, counted, smi, path_launches) -> None:
    """Phase 16: path K, each CLI's main(argv) in-process on files written
    from the sources (one 1080p frame as its ri=1 JPEG and as raw YUV);
    the card subcommands' launch counts read; wall seconds each. Any
    failure raises."""
    import contextlib
    import io
    import pathlib
    from concurrent.futures import ThreadPoolExecutor

    from video_coding_tpu_torch import kernels
    from video_coding_tpu_torch.cli import (dct_tool, generate_cli,
                                            model_cli, oyuv, simulate_cli)

    t_phase = time.perf_counter()
    d = pathlib.Path(kernels.BUILD_DIR).parent / "chip_smoke_cli"
    d.mkdir(parents=True, exist_ok=True)
    jpg = d / "frame0.jpg"
    jpg.write_bytes(streams[0])
    raw = d / "frame0.yuv"
    raw.write_bytes(b"".join(p.tobytes() for p in frames[0]))
    size = f"{WIDTH}x{HEIGHT}"
    seen_k: dict = {}
    secs = []

    def cli(name, main, argv, must=()):
        """main(argv) with its output kept: (exit code, stdout)."""
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc, seen = counted(lambda: main([str(a) for a in argv]), must)
        secs.append((name, time.perf_counter() - t0))
        _add_seen(seen_k, seen)
        if rc != 0:
            raise RuntimeError(f"path K {name} exited {rc}:\n"
                               f"{buf.getvalue()[-2000:]}")
        return buf.getvalue()

    out_model = d / "model.yuv"
    out_torch = d / "torch.yuv"
    cli("model decode frame --engine model", model_cli.main,
        ["decode", "frame", jpg, out_model])
    cli("model decode frame --engine torch", model_cli.main,
        ["--engine", "torch", "decode", "frame", jpg, out_torch], ("K2",))
    if out_torch.read_bytes() != out_model.read_bytes():
        raise RuntimeError("model_cli decode: --engine torch differs from "
                           "--engine model")
    cli("model decode header", model_cli.main, ["decode", "header", jpg])
    cli("model decode log", model_cli.main,
        ["decode", "log", jpg, "--num-blocks", "4"])
    enc_args = ["--size", size, "--quality", "90", "--restart-interval", "1"]
    jm, jt = d / "model.jpg", d / "torch.jpg"
    cli("model encode frame --engine model", model_cli.main,
        ["encode", "frame", raw, jm] + enc_args)
    cli("model encode frame --engine torch", model_cli.main,
        ["--engine", "torch", "encode", "frame", raw, jt] + enc_args,
        ("K3",))
    if not jt.read_bytes() == jm.read_bytes() == streams[0]:
        raise RuntimeError("model_cli encode: --engine torch, --engine "
                           "model and the golden model's bytes differ")
    cli("model encode log", model_cli.main,
        ["encode", "log", raw, "--size", size, "--num-blocks", "2",
         "--verbose"])

    for name, argv, must, verdict in (
            ("decoder", ["decoder", jpg], ("K1", "K2", "LUT"), "PASS"),
            ("decoder-accelerator", ["decoder-accelerator", jpg], ("K2",),
             "PASS"),
            ("codeblock", ["codeblock", jpg, "--entropy", "tpu"],
             ("K1", "LUT"), "0 mismatched"),
            ("encoder-accelerator",
             ["encoder-accelerator", raw] + enc_args, ("K3",),
             "byte-identical"),
            ("filter-stuffed-bytes", ["filter-stuffed-bytes", jpg], (),
             "100/100 match"),
            ("inspect", ["inspect", jpg, "--block", "0", "--stages"],
             ("K2",), "identical coefficients")):
        out = cli(f"simulate {name}", simulate_cli.main, argv, must)
        if verdict not in out:
            raise RuntimeError(f"simulate {name}: no '{verdict}' in\n"
                               f"{out[-2000:]}")

    # nvcc -ptx of the five sources at once, then the four artifacts
    t0 = time.perf_counter()
    srcs = sorted({src for parts in generate_cli.ARTIFACTS.values()
                   for src, _k in parts})
    with ThreadPoolExecutor(len(srcs)) as ex:
        list(ex.map(kernels.ptx, srcs))
    log(f"path K: nvcc -ptx of {len(srcs)} sources in parallel, "
        f"{time.perf_counter() - t0:.1f} s")
    for art, parts in generate_cli.ARTIFACTS.items():
        for flag in ([], ["--compiled"]):
            out = cli(f"generate {art} {' '.join(flag)}".strip(),
                      generate_cli.main, [art] + flag)
            need = [k for _s, k in parts]
            if not flag:
                need += [".target sm_90a", ".entry"]
            missing = [k for k in need if k not in out]
            if missing:
                raise RuntimeError(f"generate {art} {flag}: {missing} "
                                   "missing")
            if art == "codec-step" and "('data', 'seg')" not in out:
                raise RuntimeError("generate codec-step printed no mesh")

    out = cli("oyuv compare", oyuv.main,
              ["compare", "psnr", "y", raw, out_torch, "--size", size])
    if not out.startswith("0: "):
        raise RuntimeError(f"oyuv compare: {out[-500:]}")
    conv = d / "frame0.444"
    cli("oyuv convert", oyuv.main,
        ["convert", raw, conv, "--size", size, "--in-format", "420",
         "--out-format", "444"])
    if conv.stat().st_size != WIDTH * HEIGHT * 3:
        raise RuntimeError("oyuv convert: wrong 4:4:4 size")
    out = cli("dct both", dct_tool.main, ["both", "--count", "1000"])
    if "max_err=" not in out:
        raise RuntimeError(f"dct: {out}")
    path_launches["K"] = seen_k
    log(f"path K on {smi}: " + "; ".join(f"{n} {s:.2f} s" for n, s in secs)
        + f"; launches {({k: v for k, v in seen_k.items() if v})}; phase 16 "
        f"took {time.perf_counter() - t_phase:.1f} s")


# path L (phase 18): the samplings, restart intervals, quality extremes and
# foreign streams the JAX package takes, at 1080p
L_FRAMES = 4
# sampling → (Y, Cb, Cr) sampling factors as Parameters.yuv takes them
# (h, v each), or None for Parameters.monochrome; "h2v1" and "h1v2" are
# libjpeg's layouts of 4:2:2 and 4:4:0 (an MCU of 4 blocks where the
# presets' has 8)
L_SAMPLINGS = {
    "4:2:2": (2, 2, 1, 2, 1, 2),            # Parameters.c422
    "4:2:2 h2v1": (2, 1, 1, 1, 1, 1),
    "4:4:0": (2, 2, 2, 1, 2, 1),            # Parameters.c440
    "4:4:0 h1v2": (1, 2, 1, 1, 1, 1),
    "4:4:4": (1, 1, 1, 1, 1, 1),            # Parameters.c444
    "mono": None,                           # Parameters.monochrome
}
# libjpeg-turbo streams (tests/data/torch_foreign/make_foreign.py) → the
# Huffman kernel their batch decode must launch
FOREIGN_DIR = "tests/data/torch_foreign"
L_FOREIGN = {"webcam_422_q75_opt.jpg": "K1+hooks",
             "rows_420_q90_rst_row.jpg": "K6",
             "blocks_444_q85_rst1.jpg": "K1"}


def sampled_frames(frames, chroma_shape, seed: int):
    """The frames' luma with chroma at ``chroma_shape`` (rows, columns):
    their 4:2:0 chroma repeated up to it plus fresh sensor-like noise from
    ``seed``; luma alone (a 1-tuple) for None."""
    rng = np.random.default_rng(seed)
    out = []
    for y, u, v in frames:
        if chroma_shape is None:
            out.append((y,))
            continue
        ry, rx = chroma_shape[0] // u.shape[0], chroma_shape[1] // u.shape[1]
        out.append((y,) + tuple(
            np.clip(p.repeat(ry, 0).repeat(rx, 1)
                    + rng.normal(0, 2, chroma_shape), 0, 255)
            .astype(np.uint8) for p in (u, v)))
    return out


def split_stream(stream: bytes):
    """(Header, entropy payload) of a JPEG byte stream."""
    from video_coding_tpu_torch.common.bitstream import BitReader
    from video_coding_tpu_torch.model.header import Header

    bits = BitReader(stream)
    header = Header.decode(bits)
    return header, stream[bits.bit_pos >> 3:]


def kernel_sites() -> dict:
    """Kernel → (module, wrapper attribute, plain version): where the
    sessions look each kernel's wrapper up (K4 by its name in the engine,
    K9 in the symbol builder)."""
    from video_coding_tpu_torch.entropy import huffman_decode as k1
    from video_coding_tpu_torch.entropy import huffman_encode as k4
    from video_coding_tpu_torch.entropy import pack_stuff as k8
    from video_coding_tpu_torch.entropy import symbols
    from video_coding_tpu_torch.ops import datapath
    from video_coding_tpu_torch.ops import lookup as k9
    from video_coding_tpu_torch.runtime import engine

    return {
        "K1": (k1, "decode_flat", k1.decode_flat_plain),
        "K5": (k1, "decode_segments", k1.decode_segments_plain),
        "K6": (k1, "decode_segments_streamed",
               k1.decode_segments_streamed_plain),
        "K7": (k1, "decode_flat_staged", k1.decode_flat_staged_plain),
        "K2": (datapath, "decode_datapath", datapath.decode_datapath_plain),
        "K3": (datapath, "encode_datapath", datapath.encode_datapath_plain),
        "K4": (engine, "encode_segments", k4.encode_segments_plain),
        "K8": (k8, "pack_stuff", k8.pack_stuff_plain),
        "K9": (symbols, "table_lookup", k9.table_lookup_plain),
    }


def spied(sites: dict, call, sync: bool = True):
    """call() with a Spy on every kernel site: (its result, {kernel: the
    Spy of the kernels it called}); ``sync`` waits for the card."""
    spies = {name: Spy(getattr(mod, attr))
             for name, (mod, attr, _plain) in sites.items()}
    for name, (mod, attr, _plain) in sites.items():
        setattr(mod, attr, spies[name])
    try:
        out = call()
        if sync:
            torch.cuda.synchronize()
    finally:
        for name, (mod, attr, _plain) in sites.items():
            setattr(mod, attr, spies[name].fn)
    return out, {n: s for n, s in spies.items() if s.args is not None}


def kernel_work(name: str, a, k, out) -> tuple[float, float]:
    """(bytes, int32 operations) of one kernel call, as phases 4, 7 and 12
    count them: each input read once and each output written once (K4 and
    K8: the bytes their reads need); 40 operations a symbol decoded, 30 a
    symbol encoded, 1200 / 1100 a block through K2 / K3, K8's per slot and
    byte, K9's 2 an element."""
    if name in ("K1", "K5", "K6", "K7"):
        tensors = [t for t in list(a[:-5]) + list(k.values())
                   if isinstance(t, torch.Tensor)]
        return (sum(t.numel() * t.element_size() for t in tensors)
                + sum(t.numel() * 4 for t in a[-5:]) + out.numel() * 4,
                40.0 * symbol_count(out.view(-1, 64)))
    if name in ("K2", "K3"):
        n = a[0].shape[0]
        return (n * 64 * 5 + a[1].numel() * 4,
                (1200.0 if name == "K2" else 1100.0) * n)
    if name == "K4":
        real = a[0].view(-1, 64)[a[1].view(-1).bool()]
        return k4_bound_bytes(*a, k["m_out"]), 30.0 * symbol_count(real)
    if name == "K8":
        S, K = a[2].shape
        return (k8_need_bytes(*a[:3], k["m_out"]),
                4.0 * S * K + 16.0 * int((a[2] > 0).sum())
                + 6.0 * int(out[1].sum()))
    n = a[1].numel()                                        # K9
    return 8 * n + 4 * a[0].numel(), 2.0 * n


def same(a, b) -> bool:
    """Equal results: bytes, tensors (any device), numpy arrays, Frames,
    Planes and sequences of them."""
    from video_coding_tpu_torch.common.plane import Plane

    if isinstance(a, (bytes, bytearray)):
        return a == b
    if hasattr(a, "y"):
        a, b = [a.y, a.u, a.v], [b.y, b.u, b.v]
    if isinstance(a, Plane):
        a, b = a.data, b.data
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    if isinstance(b, torch.Tensor):
        b = b.cpu().numpy()
    return a.shape == b.shape and bool((a == b).all())


def cropped(dec, planes) -> list:
    """Decoded (MCU-padded) plane tensors of one frame → numpy arrays cut
    to the frame's actual size."""
    return [p.cpu().numpy()[:c.actual_height, :c.actual_width]
            for c, p in zip(dec.components, planes)]


# kernels whose plain loops are launch-bound on the card (K4 2.5-4.5 s a
# frame at B = 32, K8 1.5-4 s, K6 ~1.5 ms a step): path L holds them
# against their plain versions on the CPU, on the card's arguments
CPU_PLAIN = ("K4", "K6", "K8")


def cpu_reference(job):
    """Run in a worker process: one frame through a session on the CPU
    (every kernel's plain version), or one plain version. ``job`` is
    (kind, what makes it, method, its argument): kind "decoder" (stream
    bytes to parse, keywords), "encoder" (Parameters, restart interval,
    locked segment budget), "transcode" (stream bytes, quality, restart
    interval, locked segment budget), or "plain" (kernel name, arguments,
    keywords). Returns (the result,
    {kernel of CPU_PLAIN: (its arguments, its result)} as the session
    called them)."""
    from video_coding_tpu_torch.entropy import huffman_decode as k1
    from video_coding_tpu_torch.entropy import huffman_encode as k4
    from video_coding_tpu_torch.entropy import pack_stuff as k8
    from video_coding_tpu_torch.runtime import engine
    from video_coding_tpu_torch.runtime.engine import (JpegDecoderSession,
                                                       JpegEncoderSession,
                                                       JpegTranscodeSession)

    torch.set_num_threads(1)
    kind, make, method, arg = job
    sites = {"K4": (engine, "encode_segments", k4.encode_segments_plain),
             "K6": (k1, "decode_segments_streamed",
                    k1.decode_segments_streamed_plain),
             "K8": (k8, "pack_stuff", k8.pack_stuff_plain)}
    if kind == "plain":
        return sites[make][2](*method, **arg), {}
    if kind == "decoder":
        sess = JpegDecoderSession(split_stream(make[0])[0], device="cpu",
                                  **make[1])
    elif kind == "encoder":
        sess = JpegEncoderSession(make[0], make[1], device="cpu")
        sess._seg_budget = make[2]
    else:
        sess = JpegTranscodeSession(split_stream(make[0])[0],
                                    quality=make[1], restart_interval=make[2],
                                    device="cpu")
        sess.encoder._seg_budget = make[3]
    out, spies = spied(sites, lambda: getattr(sess, method)(arg),
                       sync=False)
    return out, {n: (sp.args, sp.out) for n, sp in spies.items()}


def to_cpu(x):
    """A result with every tensor in it moved to the host."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, (list, tuple)):
        return type(x)(to_cpu(v) for v in x)
    return x


def record_ladder(enc) -> list:
    """Record (budget, overflowed) of each launch of the encoder session's
    budget ladder in the returned list."""
    rungs, pack = [], enc._pack_graph

    def recorded(qc_seg, f, msb, first=0):
        r = pack(qc_seg, f, msb, first)
        rungs.append((msb, bool(r[3])))
        return r
    enc._pack_graph = recorded
    return rungs


def ladder_note(tag, rungs, enc) -> None:
    """Print the budget ladder of the session's first call."""
    first = rungs[:[o for _, o in rungs].index(False) + 1]
    log(f"{tag}: the first call tried {[b for b, _ in first]} bytes a "
        f"segment, {len(first) - 1} launch(es) overflowed before rung "
        f"{len(first)} held (rung 1 = B*24+64 = "
        f"{enc.blocks_per_segment * 24 + 64}); budget locked at "
        f"{enc._seg_budget}"
        + ("; rung 1 did NOT overflow at q=100"
           if "q100" in tag and len(first) == 1 else ""))


def planes_of(frame) -> list:
    """A decoded Frame's (or list of Planes') arrays."""
    return [p.data for p in ([frame.y, frame.u, frame.v]
                             if hasattr(frame, "y") else frame)]


def configuration_space_path(frames, counted, smi) -> dict:
    """Phase 18 (path L): every route at the samplings, restart intervals,
    quality extremes and foreign streams the JAX package takes, at 1080p.
    For each configuration: the entry point's call of L_FRAMES with the
    launch counts reset before and read after (the kernels named must
    launch, no plain loop may), every frame equal to the host-entropy
    route; a dispatch of frame 0 with every kernel it launched held
    against its plain version on the card on the arguments it got (K4,
    K6 and K8, whose plain loops are launch-bound on the card, on the CPU:
    CPU_PLAIN), and its result held against the same session on the CPU;
    the rate (median of 3 windows of L_FRAMES) and each kernel's time at
    that call's arguments beside its bound. The CPU sessions run
    after the card's work, in worker processes, so they do not load the
    host while rates are taken. Returns {kernel: {configuration:
    numbers}} for the kernels line."""
    import multiprocessing
    import os
    import pathlib
    from concurrent.futures import ProcessPoolExecutor

    from video_coding_tpu_torch.entropy import huffman_decode as k1
    from video_coding_tpu_torch.model.header import DecodeError, Parameters
    from video_coding_tpu_torch.runtime.engine import (JpegDecoderSession,
                                                       JpegEncoderSession,
                                                       JpegTranscodeSession,
                                                       decode_jpeg)

    t_phase = time.perf_counter()
    sites = kernel_sites()
    per_config: dict = {}
    rates = []
    # (configuration, CPU job or None, the card's frame-0 result,
    # {CPU_PLAIN kernel: (arguments, keywords, result) on the card})
    pending = []

    def exercise(tag, call, must, ref, view=lambda out: out, one=None,
                 cpu=None, unit="frames/s", per_call=L_FRAMES):
        """One configuration (see the docstring): ``call`` is the entry
        point's call (``per_call`` frames), ``view`` maps its result to
        ``ref``'s form, ``one`` is the dispatch of frame 0 and ``cpu`` the
        same session's CPU job for it (a function returning
        cpu_reference's job, called after frame 0's dispatch). Returns the
        launch counts."""
        t_all = time.perf_counter()
        out, seen = counted_without_plain_loops(
            counted, lambda: spied(sites, call), must)
        out, spies = out
        if not same(view(out), ref):
            raise RuntimeError(f"path L {tag}: differs from the host-entropy "
                               "route")
        notes = []
        for name, spy in spies.items():
            a, k = spy.args
            key = "K1+hooks" if name == "K1" and \
                k.get("init_bitpos") is not None else name
            ms = time_ms(lambda fn=spy.fn, a=a, k=k: fn(*a, **k), 20)
            bms, by = bound_ms(*kernel_work(name, a, k, spy.out))
            per_config.setdefault(key, {})[tag] = {
                "ms": ms, "bound_ms": bms, "bound_by": by,
                "launches": seen[key]}
            notes.append(f"{key} {ms:.4f} ms (bound {bms:.4f}, {by}, "
                         f"{bms / ms:.1%})")
            st = getattr(spy.fn, "stats", None) if name == "K6" else None
            if st is not None:
                # STREAMED_STATS of the last timed call, a row each
                st = st.to(torch.float64)
                rounds, subs = st[:, 0], st[:, 1]
                notes.append(f"K6 sync rounds mean "
                             f"{float(rounds.mean()):.2f} max "
                             f"{float(rounds.max()):.0f}, "
                             f"{float(subs.mean()):.1f} subsequences a row")
        del spies, out
        t_one = time.perf_counter()
        deferred = {}   # CPU_PLAIN kernel → (arguments, keywords, result)
        if one is not None:
            got1, spies1 = spied(sites, one)
            for name, spy in spies1.items():
                a, k = spy.args
                if name in CPU_PLAIN:
                    deferred[name] = (to_cpu(list(a)), k, to_cpu(spy.out))
                    continue
                plain = sites[name][2](*a, **k)
                got = spy.out if isinstance(spy.out, tuple) else (spy.out,)
                plain = plain if isinstance(plain, tuple) else (plain,)
                if not all(torch.equal(x, y) for x, y in zip(got, plain)):
                    raise RuntimeError(f"path L {tag}: {name} differs from "
                                       "its plain version on the session's "
                                       "arguments")
            del spies1
            if cpu is not None or deferred:
                pending.append((tag, cpu and cpu(), to_cpu(got1),
                                deferred))
        t_rate = time.perf_counter()
        windows = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(L_FRAMES // per_call):
                call()
            torch.cuda.synchronize()
            windows.append(time.perf_counter() - t0)
        windows.sort()
        rate = (L_FRAMES / windows[1] if unit == "frames/s"
                else L_FRAMES * WIDTH * HEIGHT / windows[1] / 1e6)
        rates.append((tag, rate, unit))
        log(f"path L {tag}: launches "
            f"{ {n: v for n, v in seen.items() if v} }, every frame equal to "
            f"the host-entropy route; each kernel of frame 0's dispatch "
            f"equal to its plain version on the card"
            + (f" ({', '.join(deferred)} on the CPU, below)" if deferred
               else "")
            + f"; {rate:.2f} {unit} (median of 3 windows of {L_FRAMES} "
            f"frames); {'; '.join(notes)} on {smi}; "
            f"{time.perf_counter() - t_all:.1f} s (plain checks "
            f"{t_rate - t_one:.1f})")
        return seen

    def cpu_checks():
        """The CPU jobs of every configuration, in worker processes: each
        session's result equal to the card's frame 0, and K4, K6 and K8
        equal to their plain versions on the card's arguments (the CPU
        session's calls, or the plain version alone)."""
        t0 = time.perf_counter()
        workers = max(1, min(7, os.cpu_count() - 1))
        jobs, owners = [], []
        for i, (_tag, job, _got, deferred) in enumerate(pending):
            if job is not None:
                jobs.append(job)
                owners.append((i, None))
                continue
            for name, (a, k, _out) in deferred.items():
                jobs.append(("plain", name, a, k))
                owners.append((i, name))
        with ProcessPoolExecutor(
                max_workers=workers,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            results = list(pool.map(cpu_reference, jobs))
        n_plain = 0
        for (i, name), (ref, called) in zip(owners, results):
            tag, job, got1, deferred = pending[i]
            if name is not None:
                called = {name: ((deferred[name][0], deferred[name][1]),
                                 ref)}
            elif not same(got1, ref):
                raise RuntimeError(f"path L {tag}: frame 0 differs from the "
                                   "same session on the CPU")
            for kname, (a, k, out) in deferred.items():
                if kname not in called:
                    continue
                (ca, ck), cout = called[kname]
                if ck != k or not same(list(ca), a):
                    raise RuntimeError(f"path L {tag}: the CPU session gave "
                                       f"{kname} other arguments")
                if not same(out, cout):
                    raise RuntimeError(f"path L {tag}: {kname} differs from "
                                       "its plain version")
                n_plain += 1
            missing = [n for n in deferred if n not in called and (
                name is None or n == name)]
            if missing:
                raise RuntimeError(f"path L {tag}: the CPU session did not "
                                   f"call {missing}")
        n_cpu = sum(job is not None for _, job, _, _ in pending)
        log(f"path L: frame 0 of {n_cpu} configurations equal to the same "
            f"sessions on the CPU; "
            f"{n_plain} calls of K4, K6 and K8 equal to their plain versions "
            f"(on the CPU) on the card's arguments; {workers} worker "
            f"processes, {time.perf_counter() - t0:.1f} s")

    def lut_row(tag, dec):
        st = dec.state
        tabs = (st.lo, st.hi, st.offset, st.values)
        lut = k1.decode_lut(*tabs)
        if not torch.equal(lut, k1.decode_lut_plain(*tabs)):
            raise RuntimeError(f"path L {tag}: the LUT differs from its plain "
                               "version")
        T = st.lo.shape[0]
        ms = time_ms(lambda: k1.decode_lut(*tabs), 20)
        bms, by = bound_ms(sum(t.numel() * 4 for t in tabs)
                           + lut.numel() * 2, T * 65536 * 3 * 16.0)
        per_config.setdefault("LUT", {})[tag] = {
            "ms": ms, "bound_ms": bms, "bound_by": by, "launches": 1}

    def host_decode(hdr, pays):
        return [planes_of(f) for f in JpegDecoderSession(
            hdr, entropy="native").decode_batch(pays)]

    def source(params, ri, fr):
        """(stream, header, payloads, host-route planes) of the frames
        encoded on the card."""
        streams = JpegEncoderSession(params, ri).encode_device_batch(fr)
        hdr, _ = split_stream(streams[0])
        pays = [split_stream(x)[1] for x in streams]
        return streams[0], hdr, pays, host_decode(hdr, pays)

    def decode_routes(tag, src, kernel, **kw):
        """decode_device_batch of a source's frames through ``kernel``."""
        stream, hdr, pays, ref = src
        dec = JpegDecoderSession(hdr, **kw)
        return dec, exercise(
            tag, lambda: dec.decode_device_batch(pays),
            (kernel, "K2", "LUT"), ref,
            view=lambda out: [cropped(dec, p) for p in out],
            one=lambda: dec.decode_device_batch(pays[:1]),
            cpu=None if kw else lambda: ("decoder", (stream, {}),
                                         "decode_device_batch", pays[:1]))

    def encode_route(tag, params, ri, fr, kernels):
        enc = JpegEncoderSession(params, ri)
        rungs = record_ladder(enc)
        host = JpegEncoderSession(params, ri,
                                  entropy="native").encode_batch(fr)
        exercise(f"{tag} ri={ri} B={enc.blocks_per_segment}",
                 lambda: enc.encode_device_batch(fr), kernels, host,
                 one=lambda: enc.encode_device_batch(fr[:1]),
                 cpu=lambda: ("encoder", (params, ri, enc._seg_budget),
                              "encode_device_batch", fr[:1]))
        return host, rungs, enc

    def transcode_route(tag, stream, pays, q, ri, kernels):
        hdr = split_stream(stream)[0]
        trans = JpegTranscodeSession(hdr, quality=q, restart_interval=ri)
        rungs = record_ladder(trans.encoder)
        host = JpegTranscodeSession(hdr, quality=q, restart_interval=ri,
                                    entropy_out="host").transcode_batch(pays)
        exercise(tag, lambda: trans.transcode_batch(pays), kernels, host,
                 one=lambda: trans.transcode_batch(pays[:1]),
                 cpu=lambda: ("transcode", (stream, q, ri,
                                            trans.encoder._seg_budget),
                              "transcode_batch", pays[:1]), unit="MPix/s")
        return rungs, trans

    # the samplings: sources, then every route
    for i_s, (s_name, scales) in enumerate(L_SAMPLINGS.items()):
        t_s = time.perf_counter()
        if scales is None:
            def params(q):
                return Parameters.monochrome(WIDTH, HEIGHT, q)
            chroma, mcu, mcu_w = None, 1, 8
        else:
            def params(q, scales=scales):
                return Parameters.yuv(WIDTH, HEIGHT, q, scales)
            hmax, vmax = max(scales[0::2]), max(scales[1::2])
            chroma = (HEIGHT * scales[3] // vmax, WIDTH * scales[2] // hmax)
            mcu = scales[0] * scales[1] + 2 * scales[2] * scales[3]
            mcu_w = 8 * hmax
        # libjpeg's layouts: the decode and encode routes (their routes
        # beyond those run at the presets' layouts of the same sampling)
        every_route = "h" not in s_name
        fr = sampled_frames(frames[:L_FRAMES], chroma, SEED + i_s)
        row = WIDTH // mcu_w
        ri_fused = 32 // mcu
        ri_split = ri_fused + 1
        srcs = {ri: source(params(90), ri, fr) for ri in (1, 0, row)}
        got = JpegDecoderSession(srcs[1][1]).decode_device(srcs[1][2][0])
        worst = min(psnr(g, r) for g, r in zip(planes_of(got), fr[0]))
        if worst <= 30.0:
            raise RuntimeError(f"path L {s_name}: source decode PSNR "
                               f"{worst:.2f} dB <= 30 dB")
        dec1 = JpegDecoderSession(srcs[1][1])
        log(f"path L {s_name}: {L_FRAMES} frames {WIDTH}x{HEIGHT} q90 at "
            f"ri=1, 0 and {row} (one MCU row), {dec1.n_blocks} blocks a "
            f"frame, {mcu} a MCU, {dec1.n_segments} segments at ri=1, "
            f"B={row * mcu} at ri={row}, frame 0 at ri=1 {worst:.2f} dB "
            f"(lowest plane PSNR); {time.perf_counter() - t_s:.1f} s")
        lut_row(s_name, dec1)
        decode_routes(f"{s_name} ri=1 decode_device_batch", srcs[1], "K1")
        decode_routes(f"{s_name} ri=0 decode_device_batch", srcs[0],
                      "K1+hooks")
        # one MCU row a segment: auto_strategy's kernel must be K6
        dec, _seen = decode_routes(f"{s_name} ri={row} decode_device_batch",
                                   srcs[row], "K6")
        log(f"path L {s_name} ri={row} (one MCU row, B="
            f"{dec.blocks_per_segment}, {dec.n_segments * L_FRAMES} lanes, "
            f"{dec.n_segments} a frame): auto_strategy picked K6")
        if every_route:
            for ri in (1, 0):
                decode_routes(f"{s_name} ri={ri} decode_device_batch dma",
                              srcs[ri], "K7", decode_gather="dma")
            _stream, hdr, pays, ref = srcs[1]
            dec = JpegDecoderSession(hdr, device_huffman="pallas")
            exercise(f"{s_name} ri=1 decode_device pallas",
                     lambda: dec.decode_device(pays[0]),
                     ("K5", "K2", "LUT"), ref[0], view=planes_of,
                     one=lambda: dec.decode_device(pays[0]), per_call=1)
        # encode at the K4/K8 boundary: B = 32 or less, and more
        for ri, kernels in ((ri_fused, ("K3", "K4")),
                            (ri_split, ("K3", "K9", "K8"))):
            encode_route(f"{s_name} encode_device_batch q75", params(75), ri,
                         fr, kernels)
        stream, hdr, pays, ref = srcs[1]
        if scales is None:
            try:
                JpegTranscodeSession(hdr, quality=75, restart_interval=1)
            except DecodeError as e:
                log(f"path L {s_name}: the transcode refuses one component "
                    f"({e}), as the JAX package's does")
            else:
                raise RuntimeError("path L: the transcode took a "
                                   "monochrome stream")
        elif every_route:
            for ri, kernels in ((1, ("K1", "K2", "K3", "K4")),
                                (ri_split, ("K1", "K2", "K3", "K9", "K8"))):
                transcode_route(f"{s_name} transcode_batch ri=1 -> q75 "
                                f"ri={ri}", stream, pays, 75, ri, kernels)
            dec = JpegDecoderSession(hdr)
            rgb_ref = torch.stack([dec._rgb_tail([torch.from_numpy(p).to(
                dec.device) for p in f]) for f in ref])
            exercise(f"{s_name} ri=1 decode_device_rgb_batch",
                     lambda: dec.decode_device_rgb_batch(pays),
                     ("K1", "K2", "LUT"), rgb_ref,
                     one=lambda: dec.decode_device_rgb_batch(pays[:1]))
        log(f"path L {s_name}: {time.perf_counter() - t_s:.1f} s")

    # quality extremes: q=1 and q=100 at 4:2:0 and 4:4:4, 4 frames
    t_q = time.perf_counter()
    for s_name, scales, ri_split in (
            ("4:2:0", (2, 2, 1, 1, 1, 1), 8),
            ("4:4:4", (1, 1, 1, 1, 1, 1), 11)):
        fr = (frames[:4] if s_name == "4:2:0" else
              sampled_frames(frames[:4], (HEIGHT, WIDTH), SEED))
        stream, _hdr, pays, _ref = source(
            Parameters.yuv(WIDTH, HEIGHT, 90, scales), 1, fr)
        for q in (1, 100):
            params = Parameters.yuv(WIDTH, HEIGHT, q, scales)
            for ri, kernels in ((1, ("K3", "K4")),
                                (ri_split, ("K3", "K9", "K8"))):
                tag = f"{s_name} encode_device_batch q{q}"
                _host, rungs, enc = encode_route(tag, params, ri, fr,
                                                 kernels)
                ladder_note(f"path L {tag} ri={ri}", rungs, enc)
            tag = f"{s_name} transcode_batch q90 -> q{q} ri=1"
            rungs, trans = transcode_route(tag, stream, pays, q, 1,
                                           ("K1", "K2", "K3", "K4"))
            ladder_note(f"path L {tag}", rungs, trans.encoder)
    log(f"path L quality extremes: {time.perf_counter() - t_q:.1f} s")

    # foreign streams written by libjpeg-turbo
    t_f = time.perf_counter()
    for name, kernel in L_FOREIGN.items():
        data = (pathlib.Path(FOREIGN_DIR) / name).read_bytes()
        hdr, pay = split_stream(data)
        pays = [pay] * L_FRAMES
        ref = host_decode(hdr, pays[:1]) * L_FRAMES
        dec, _seen = decode_routes(f"foreign {name} decode_device_batch",
                                   (data, hdr, pays, ref), kernel)
        exercise(f"foreign {name} decode_device",
                 lambda: dec.decode_device(pay), (kernel, "K2", "LUT"),
                 ref[0], view=planes_of, one=lambda: dec.decode_device(pay),
                 per_call=1)
        rgb_ref = dec._rgb_tail([torch.from_numpy(p).to(dec.device)
                                 for p in ref[0]])
        exercise(f"foreign {name} decode_device_rgb",
                 lambda: dec.decode_device_rgb(pay), (kernel, "K2", "LUT"),
                 rgb_ref, one=lambda: dec.decode_device_rgb(pay),
                 per_call=1)
        if not same(planes_of(decode_jpeg(data)), ref[0]):
            raise RuntimeError(f"path L foreign {name}: decode_jpeg differs "
                               "from the host-entropy route")
        transcode_route(f"foreign {name} transcode_batch -> q75 ri=1", data,
                        pays, 75, 1, (kernel, "K2", "K3", "K4"))
        log(f"path L foreign {name}: {len(data)} bytes, "
            f"{dec.n_segments} segment(s) of {dec.blocks_per_segment} "
            f"blocks; decode_jpeg equal to the host-entropy route")
    log(f"path L foreign streams: {time.perf_counter() - t_f:.1f} s")

    cpu_checks()
    log("path L rates on " + smi + ": " + "; ".join(
        f"{tag} {rate:.2f} {unit}" for tag, rate, unit in rates))
    log(f"path L: {len(rates)} configurations; phase 18 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return per_config


# path M (phase 19): frames past 1080p — name: (width, height, frames a
# dispatch); stdsizes' "4k", "dc4k1" (249.75 MCUs wide) and "whuxga"
M_SIZES = {"4k": (3840, 2160, 4), "dc4k1": (3996, 2160, 4),
           "whuxga": (7680, 4800, 2)}
# the launch-bound plain loops path M holds on a subset of a call's lanes,
# on the CPU: the longest lane, the first and last M_EDGE and M_SAMPLE
# drawn with a seed
M_LANE_PLAIN = ("K1", "K4", "K5", "K6", "K7", "K8")
M_EDGE, M_SAMPLE = 64, 256
# the branches of the long-lane kernels path M must reach
M_BANDS = ("K6 staged", "K6 from global memory",
           "K5 many CTAs, unstaged, no lane buffer",
           "K5 a CTA a row, staged")


def m_frames(out_dir: str, sizes: dict) -> dict:
    """Run in a worker process: path M's frames — the phase 3 generator at
    each size of ``sizes`` (M_SIZES), seed SEED, and the whuxga frames'
    4:4:4 form (sampled_frames) — written as .npz files under
    ``out_dir``. Returns {size: (path of its frames, path of their 4:4:4
    form or None)}."""
    import pathlib

    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, (w, h, n) in sizes.items():
        frames = synth_frames(n, SEED, w, h)
        forms = [frames] + ([sampled_frames(frames, (h, w), SEED)]
                            if name == "whuxga" else [])
        paths[name] = [None, None]
        for i, fr in enumerate(forms):
            paths[name][i] = str(out / f"{name}_{i}.npz")
            np.savez(paths[name][i], *[p for f in fr for p in f])
    return paths


def load_frames(path) -> list:
    """m_frames' frames from one of its files: (y, u, v) tuples."""
    if path is None:
        return None
    with np.load(path) as z:
        planes = [z[f"arr_{i}"] for i in range(len(z.files))]
    return [tuple(planes[i:i + 3]) for i in range(0, len(planes), 3)]


def golden_planes(stream: bytes) -> list:
    """Run in a worker process: the golden model's decode of a JPEG
    stream (pure Python and numpy), as cropped planes."""
    from video_coding_tpu_torch.model.decoder import decode_a_frame

    f = decode_a_frame(stream)
    return [f.y.data, f.u.data, f.v.data]


def branch_constants() -> dict:
    """K5's and K6's compile-time branch constants, read from their
    sources: K6 stages rows of up to kRowStage bytes in shared memory; K5's
    "lane" regime stages a CTA's kWarps * kLanesPerWarp rows up to
    kStageBytes and keeps its blocks in shared memory up to kLaneBufBytes.
    (Whether K5's "row" regime staged a row its stats say.)"""
    import re

    from video_coding_tpu_torch import kernels

    def read(source, names):
        text = (kernels.CSRC / source).read_text()
        return {n: int(re.search(rf"constexpr int {n} = (\d+);", text)
                       .group(1)) for n in names}

    c = read("huffman_decode_streamed.cu", ("kRowStage",))
    c.update(read("huffman_decode_padded.cu",
                  ("kWarps", "kLanesPerWarp", "kStageBytes",
                   "kLaneBufBytes")))
    c["kLanes"] = c["kWarps"] * c["kLanesPerWarp"]
    return c


def lane_band(name: str, S: int, L: int, B: int, consts: dict,
              row_stats=None) -> str:
    """The branch of K6 or K5 that an (S, L) matrix of B-block lanes
    takes (csrc/huffman_decode_streamed.cu, huffman_decode_padded.cu).
    ``row_stats`` is what a K5 call left in decode_segments.stats: None
    after a "lane" launch, else the "row" launch's (S, K5_ROW_STATS), whose
    "staged" column says whether the kernel read its rows from shared
    memory."""
    from video_coding_tpu_torch.entropy.decode_tables import max_win_bs
    from video_coding_tpu_torch.entropy.huffman_decode import K5_ROW_STATS

    if name == "K6":
        if L <= consts["kRowStage"]:
            return M_BANDS[0]
        return M_BANDS[1] + ("" if max_win_bs(L) else
                             ", past the max_win_bs limit")
    if row_stats is not None:
        staged = set(row_stats[:, K5_ROW_STATS.index("staged")].tolist())
        if staged == {1}:
            return M_BANDS[3]
        if staged == {0}:
            return "K5 a CTA a row, from global memory"
        raise RuntimeError(f"K5's rows of one launch staged {staged}")
    lanes = consts["kLanes"]
    staged = 4 * ((lanes * L + 6) // 4 + 2) <= consts["kStageBytes"]
    lane_buf = lanes * (2 * (B * 64 + 2) + 4 * B) <= consts["kLaneBufBytes"]
    if -(-S // lanes) > 1 and not staged and not lane_buf:
        return M_BANDS[2]
    return (f"K5 {-(-S // lanes)} CTA(s), "
            f"{'staged' if staged else 'unstaged'}, "
            f"{'lane buffer' if lane_buf else 'no lane buffer'}")


def lane_subset(name: str, a, k, out, seed: int):
    """One kernel call cut to a subset of its lanes for its plain version
    on the CPU: the longest lane, the first and last M_EDGE, and M_SAMPLE
    drawn from ``seed``. Returns (lanes, arguments, keywords, the
    kernel's result on those lanes), all on the host."""
    if name in ("K1", "K7"):
        rows, length = a[1].shape[0], a[2]
    elif name in ("K5", "K6"):
        nz = (a[0] != 0).to(torch.int8)
        rows = a[0].shape[0]
        length = a[0].shape[1] - nz.flip(1).argmax(1)     # last nonzero
    elif name == "K4":
        rows, length = a[0].shape[0], out[1]
    else:                                                  # K8
        rows, length = a[2].shape[0], out[1]
    rng = np.random.default_rng(seed)
    lanes = np.unique(np.concatenate([
        [int(torch.argmax(length))], np.arange(min(M_EDGE, rows)),
        np.arange(max(rows - M_EDGE, 0), rows),
        rng.choice(rows, min(rows, M_SAMPLE), replace=False)]))
    sel = torch.from_numpy(lanes).to(length.device)
    per_lane = {"K1": (1, 2, 3), "K7": (1, 2, 3), "K5": (0, 1),
                "K6": (0, 1), "K4": (0, 1), "K8": (0, 1, 2, 3)}[name]
    args = [x[sel] if i in per_lane else x for i, x in enumerate(a)]
    kw = {n: (v[sel] if isinstance(v, torch.Tensor) else v)
          for n, v in k.items()}
    got = (out[sel] if isinstance(out, torch.Tensor)
           else (out[0][sel], out[1][sel], out[2]))
    return lanes, to_cpu(args), {n: to_cpu(v) for n, v in kw.items()}, \
        to_cpu(got)


def lane_plain(job):
    """Run in a worker process: a kernel's plain version on a subset of a
    call's lanes (lane_subset) against the kernel's result on them.
    Returns (equal, seconds)."""
    from video_coding_tpu_torch.entropy import huffman_decode as k1
    from video_coding_tpu_torch.entropy import huffman_encode as k4
    from video_coding_tpu_torch.entropy import pack_stuff as k8

    torch.set_num_threads(1)
    name, args, kw, got = job
    plain = {"K1": k1.decode_flat_plain, "K7": k1.decode_flat_staged_plain,
             "K5": k1.decode_segments_plain,
             "K6": k1.decode_segments_streamed_plain,
             "K4": k4.encode_segments_plain, "K8": k8.pack_stuff_plain}[name]
    t0 = time.perf_counter()
    ref = plain(*args, **kw)
    if isinstance(got, torch.Tensor):
        ok = torch.equal(got, ref)
    else:        # (bytes, lengths, overflow): the kernel's flag covers
        ok = (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
              and bool(ref[2]) <= bool(got[2]))    # every lane, not these
    return ok, time.perf_counter() - t0


def large_frame_path(counted, smi, rates_1080: dict, m_made) -> dict:
    """Phase 19 (path M): frames past 1080p — stdsizes' 4k (3840x2160),
    dc4k1 (3996x2160, a partial MCU column) and whuxga (7680x4800, 4:2:0
    and 4:4:4) — through the entry points, at one MCU row a segment
    across the branches of the long-lane kernels (M_BANDS). Each
    call runs with the launch counts reset before and read after (its
    kernels must launch, no plain loop may) and every frame is held
    against the host-entropy route (decode_batch / decode_entropy with
    the engine, encode_batch, transcode_batch with entropy_out="host");
    each kernel it launched against its plain version on the arguments
    it got: K2, K3 and K9 whole on the card, the launch-bound loops
    (M_LANE_PLAIN) on a subset of the lanes on the CPU; frame 0 of each
    size against the golden model (model/), on the CPU. Kernels are timed
    on the call's arguments beside their bounds, the call's wall time
    (median of 3) gives frames/s and MPix/s. The frames come from
    ``m_made`` (m_frames' future); the CPU checks run in worker
    processes. Returns {kernel: {configuration: numbers}} for the kernels
    line."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor
    from types import SimpleNamespace

    from video_coding_tpu_torch.entropy import huffman_decode as k1
    from video_coding_tpu_torch.entropy.decode_tables import auto_strategy
    from video_coding_tpu_torch.entropy.scan import destuff_segments
    from video_coding_tpu_torch.model.header import Parameters
    from video_coding_tpu_torch.runtime.engine import (JpegDecoderSession,
                                                       JpegEncoderSession,
                                                       JpegTranscodeSession)

    t_phase = time.perf_counter()
    sites = kernel_sites()
    consts = branch_constants()
    per_config: dict = {}
    rates, lane_jobs, golden, bands = [], [], [], {}
    workers = max(1, min(7, os.cpu_count() - 1))
    pool = ProcessPoolExecutor(
        max_workers=workers, mp_context=multiprocessing.get_context("spawn"))

    def exercise(tag, call, must, ref, view, size, n_frames, band=None,
                 rate=None):
        """One configuration (see the docstring); ``band`` is the branch
        its K5 or K6 launch must take, ``rate`` a call that times the
        entry point (default: the call itself, median of 3)."""
        t_all = time.perf_counter()
        rows0 = k1.decode_segments.row_launches
        (out, spies), seen = counted_without_plain_loops(
            counted, lambda: spied(sites, call), must)
        row_calls = k1.decode_segments.row_launches - rows0
        if not same(view(out), ref):
            raise RuntimeError(f"path M {tag}: differs from the "
                               "host-entropy route")
        del out
        notes = []
        for name, spy in spies.items():
            a, k = spy.args
            key = "K1+hooks" if name == "K1" and \
                k.get("init_bitpos") is not None else name
            if name in M_LANE_PLAIN:
                lanes, *job = lane_subset(name, a, k, spy.out,
                                          SEED + len(lane_jobs))
                lane_jobs.append((tag, key, len(lanes), (name, *job)))
            else:
                plain = sites[name][2](*a, **k)
                if not torch.equal(spy.out, plain):
                    raise RuntimeError(f"path M {tag}: {name} differs from "
                                       "its plain version on the session's "
                                       "arguments")
                del plain
            fn = (lambda fn=spy.fn, a=a, k=k: fn(*a, **k))
            ms = time_ms(fn, 20 if time_ms(fn, 1) < 5 else 5)
            bms, by = bound_ms(*kernel_work(name, a, k, spy.out))
            per_config.setdefault(key, {})[tag] = {
                "ms": ms, "bound_ms": bms, "bound_by": by,
                "launches": seen[key]}
            notes.append(f"{key} {ms:.4f} ms (bound {bms:.4f}, {by}, "
                         f"{bms / ms:.1%})")
            if name in ("K5", "K6"):
                S, L = a[0].shape
                B = k["blocks_per_segment"]
                row_stats = spy.fn.stats.cpu() if name == "K5" and \
                    spy.fn.stats is not None else None
                got = lane_band(name, S, L, B, consts, row_stats)
                if name == "K5" and row_calls != (
                        seen["K5"] if row_stats is not None else 0):
                    raise RuntimeError(
                        f"path M {tag}: {row_calls} 'row' launch(es) of "
                        f"{seen['K5']} K5 launch(es) in band '{got}'")
                last = int((a[0] != 0).to(torch.int8).flip(1).argmax(1)
                           .min())
                notes.append(f"{name} on ({S}, {L}) lanes of {B} blocks, "
                             f"the longest {L - last} bytes: {got}; auto "
                             f"picks {auto_strategy(S, L, B)}")
                if band is not None and got != band:
                    raise RuntimeError(f"path M {tag}: {name} took '{got}', "
                                       f"not '{band}'")
                bands.setdefault(got, []).append((tag, L))
            if name == "K6":
                st = spy.fn.stats.to(torch.float64)
                notes.append(f"K6 sync rounds mean "
                             f"{float(st[:, 0].mean()):.2f} max "
                             f"{float(st[:, 0].max()):.0f}, "
                             f"{float(st[:, 1].mean()):.1f} subsequences "
                             f"a row")
        del spies
        t_rate = time.perf_counter()
        if rate is None:
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            wall = sorted(walls)[1] / n_frames
        else:
            wall = rate()
        w, h, _ = M_SIZES[size.split()[0]]
        rates.append((tag, 1 / wall, w * h / wall / 1e6))
        log(f"path M {tag}: launches "
            f"{ {n: v for n, v in seen.items() if v} }, every frame equal "
            f"to the host-entropy route; {wall * 1e3:.2f} ms a frame, "
            f"{1 / wall:.2f} frames/s, {w * h / wall / 1e6:.1f} MPix/s "
            f"(median of 3 dispatches of {n_frames}); "
            f"{'; '.join(notes)} on {smi}; {time.perf_counter() - t_all:.1f}"
            f" s (rate {time.perf_counter() - t_rate:.1f})")

    def source(size, make, q, ri, frames, device_route=True):
        """The frames encoded (encode_device_batch, or the session's host
        route where the device packer would be the gather packer: ri=0
        and one MCU row), their first decode session and the host-entropy
        route's planes; frame 0's PSNR must pass 30 dB."""
        t0 = time.perf_counter()
        w, h, _ = M_SIZES[size.split()[0]]
        enc = JpegEncoderSession(make(w, h, q), ri)
        streams = (enc.encode_device_batch(frames) if device_route
                   else enc.encode_batch(frames))
        hdr, _ = split_stream(streams[0])
        pays = [split_stream(x)[1] for x in streams]
        dec = JpegDecoderSession(hdr)
        ref = [planes_of(f) for f in dec.decode_batch(pays)]
        worst = min(psnr(g, r) for g, r in zip(ref[0], frames[0]))
        if worst <= 30.0:
            raise RuntimeError(f"path M {size}: source decode PSNR "
                               f"{worst:.2f} dB <= 30 dB")
        segs = destuff_segments(pays[0])
        log(f"path M {size} source q{q} ri={ri}: "
            f"{len(frames)} frames, {min(map(len, streams))}.."
            f"{max(map(len, streams))} bytes, {dec.n_blocks} blocks and "
            f"{dec.n_segments} segment(s) of {dec.blocks_per_segment} "
            f"blocks a frame, frame 0's longest segment "
            f"{max(map(len, segs))} bytes, {worst:.2f} dB (lowest plane "
            f"PSNR); {time.perf_counter() - t0:.1f} s")
        return SimpleNamespace(stream=streams[0], hdr=hdr, pays=pays,
                               ref=ref, dec=dec)

    def host_transcode(trans, pays):
        """transcode_batch of the same session with entropy_out="host":
        K3's coefficients coded by the host entropy engine."""
        trans.entropy_out = "host"
        try:
            return trans.transcode_batch(pays)
        finally:
            trans.entropy_out = "device"

    def iter_rate(trans, pays, n):
        """Seconds a frame of transcode_batch_iter (n frames a chunk, two
        in flight) over 2n frames, median of 3 windows."""
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in trans.transcode_batch_iter(pays * 2, batch=n, depth=2):
                pass
            walls.append((time.perf_counter() - t0) / (2 * n))
        return sorted(walls)[1]

    def transcode(tag, size, src, n, iterated=False):
        trans = JpegTranscodeSession(src.hdr, quality=75, restart_interval=1)
        rungs = record_ladder(trans.encoder)
        host = host_transcode(trans, src.pays)
        exercise(f"{tag} transcode_batch{'_iter' if iterated else ''} "
                 f"ri=1 -> q75 ri=1", lambda: trans.transcode_batch(src.pays),
                 ("K1", "K2", "K3", "K4", "LUT"), host, lambda o: o, size, n,
                 rate=(lambda: iter_rate(trans, src.pays, n)) if iterated
                 else None)
        ladder_note(f"path M {tag} transcode", rungs, trans.encoder)

    def decode(tag, size, src, kernel, n, dec=None, band=None):
        dec = dec or src.dec
        exercise(tag, lambda: dec.decode_device_batch(src.pays),
                 (kernel, "K2", "LUT"), src.ref,
                 lambda out: [cropped(dec, p) for p in out], size, n,
                 band=band)

    def scan_tpu(tag, size, src, band):
        """decode_scan_tpu ("auto") of frame 0's segments: a lane matrix
        L = the longest segment + 4 bytes wide, not a power of two."""
        segs = destuff_segments(src.pays[0])
        d = src.dec
        exercise(f"{tag} decode_scan_tpu frame 0",
                 lambda: k1.decode_scan_tpu(segs, d.comp_idx,
                                            d.blocks_per_segment, d.tables),
                 ("K6", "LUT"), d.decode_entropy(src.pays[0]), lambda o: o,
                 size, 1, band=band)

    def rgb(tag, size, src, n):
        dec = src.dec
        ref = torch.stack([dec._rgb_tail([torch.from_numpy(p).to(dec.device)
                                          for p in f]) for f in src.ref])
        exercise(f"{tag} decode_device_rgb_batch ri=1",
                 lambda: dec.decode_device_rgb_batch(src.pays),
                 ("K1", "K2", "LUT"), ref, lambda o: o, size, n)

    def encode(tag, size, make, frames, n):
        w, h, _ = M_SIZES[size]
        enc = JpegEncoderSession(make(w, h, 75), 8)
        rungs = record_ladder(enc)
        host = enc.encode_batch(frames)
        kernels = (("K3", "K4") if enc.blocks_per_segment <= 32
                   else ("K3", "K9", "K8"))
        exercise(f"{tag} encode_device_batch q75 ri=8 "
                 f"B={enc.blocks_per_segment}",
                 lambda: enc.encode_device_batch(frames), kernels, host,
                 lambda o: o, size, n)
        ladder_note(f"path M {tag} encode", rungs, enc)

    try:
        # the frames, made by a worker process while the other phases ran
        t0 = time.perf_counter()
        gen = {name: tuple(map(load_frames, paths))
               for name, paths in m_made.result().items()}
        log(f"path M: {', '.join(f'{len(g[0])} {n}' for n, g in gen.items())}"
            f" frames (and the whuxga frames as 4:4:4) made in a worker "
            f"process during phases 2-18; waited for and loaded in "
            f"{time.perf_counter() - t0:.1f} s")

        # 4k 3840x2160 4:2:0, 4 frames a dispatch
        fr = gen.pop("4k")[0]
        w, h, n = M_SIZES["4k"]
        c420 = Parameters.c420
        s1 = source("4k", c420, 90, 1, fr)
        golden.append(("4k", pool.submit(golden_planes, s1.stream),
                       s1.ref[0]))
        transcode("4k", "4k", s1, n, iterated=True)
        decode("4k ri=1 decode_device_batch", "4k", s1, "K1", n)
        decode("4k ri=1 decode_device_batch dma", "4k", s1, "K7", n,
               dec=JpegDecoderSession(s1.hdr, decode_gather="dma"))
        pal = JpegDecoderSession(s1.hdr, device_huffman="pallas")
        exercise("4k ri=1 decode_device_e2e frame 0 pallas",
                 lambda: pal.decode_device_e2e(s1.pays[0]),
                 ("K5", "K2", "LUT"), s1.ref[0],
                 lambda out: cropped(pal, out), "4k", 1)
        rgb("4k", "4k", s1, n)
        s0 = source("4k", c420, 90, 0, fr, device_route=False)
        decode("4k ri=0 decode_device_batch", "4k", s0, "K1+hooks", n)
        row = w // 16
        for q, kernel, band in ((90, "K6", M_BANDS[0]),
                                (95, "K5", M_BANDS[3])):
            sr = source("4k", c420, q, row, fr, device_route=False)
            decode(f"4k q{q} ri={row} decode_device_batch", "4k", sr,
                   kernel, n, band=band)
            if q == 95:
                scan_tpu(f"4k q95 ri={row}", "4k", sr, M_BANDS[1])
        # the benchmark cell's shape: two MCU rows a segment, 272 lanes of
        # 2,880 blocks at L = 32,768 (K5 a CTA a row); and lanes of 15
        # MCUs (~1 KB, 8,640 a dispatch) that K5 takes a thread a row
        sr = source("4k", c420, 90, 2 * row, fr, device_route=False)
        decode(f"4k q90 ri={2 * row} decode_device_batch", "4k", sr, "K5",
               n, band=M_BANDS[3])
        sr = source("4k", c420, 90, row // 16, fr, device_route=False)
        decode(f"4k q90 ri={row // 16} decode_device_batch pallas", "4k",
               sr, "K5", n,
               dec=JpegDecoderSession(sr.hdr, device_huffman="pallas"),
               band=M_BANDS[2])
        encode("4k", "4k", c420, fr, n)
        del s1, s0, sr, pal, fr

        # dc4k1 3996x2160 4:2:0 (249.75 MCUs wide), 4 frames a dispatch
        fr = gen.pop("dc4k1")[0]
        n = M_SIZES["dc4k1"][2]
        s1 = source("dc4k1", c420, 90, 1, fr)
        golden.append(("dc4k1", pool.submit(golden_planes, s1.stream),
                       s1.ref[0]))
        transcode("dc4k1", "dc4k1", s1, n)
        decode("dc4k1 ri=1 decode_device_batch", "dc4k1", s1, "K1", n)
        rgb("dc4k1", "dc4k1", s1, n)
        s0 = source("dc4k1", c420, 90, 0, fr, device_route=False)
        decode("dc4k1 ri=0 decode_device_batch", "dc4k1", s0, "K1+hooks", n)
        del s1, s0, fr

        # whuxga 7680x4800 4:2:0 and 4:4:4, 2 frames a dispatch
        fr420, fr444 = gen.pop("whuxga")
        w, h, n = M_SIZES["whuxga"]
        for sampling, fr, make, mcu_w in (
                ("4:2:0", fr420, c420, 16),
                ("4:4:4", fr444, Parameters.c444, 8)):
            tag = f"whuxga {sampling}"
            s1 = source(tag, make, 90, 1, fr)
            transcode(tag, "whuxga", s1, n)
            del s1
            s0 = source(tag, make, 90, 0, fr, device_route=False)
            decode(f"{tag} ri=0 decode_device_batch", "whuxga", s0,
                   "K1+hooks", n)
            del s0
            row = w // mcu_w
            sr = source(tag, make, 90, row, fr, device_route=False)
            if sampling == "4:2:0":
                golden.append(("whuxga", pool.submit(golden_planes,
                                                     sr.stream), sr.ref[0]))
            decode(f"{tag} ri={row} decode_device_batch", "whuxga", sr,
                   "K5", n, band=M_BANDS[3])
            scan_tpu(f"{tag} ri={row}", "whuxga", sr, M_BANDS[1])
            del sr
            encode(tag, "whuxga", make, fr, n)
        del fr420, fr444, fr
        t_card = time.perf_counter() - t_phase

        # the CPU checks: the plain loops on their lane subsets, the golden
        # model's decodes
        t0 = time.perf_counter()
        # the longest lanes first: a plain loop's steps follow them
        lane_jobs.sort(key=lambda j: -j[3][2].get("blocks_per_segment", 0))
        futs = [(tag, key, n_lanes, pool.submit(lane_plain, job))
                for tag, key, n_lanes, job in lane_jobs]
        lane_jobs.clear()
        slowest = 0.0
        for tag, key, n_lanes, fut in futs:
            ok, secs = fut.result()
            slowest = max(slowest, secs)
            if not ok:
                raise RuntimeError(f"path M {tag}: {key} differs from its "
                                   f"plain version on {n_lanes} of its lanes")
        for size, fut, ref in golden:
            if not same(fut.result(), ref):
                raise RuntimeError(f"path M {size}: frame 0 differs from the "
                                   "golden model's decode")
        log(f"path M: {len(futs)} kernel calls equal to their plain versions "
            f"on subsets of their lanes (the longest, the first and last "
            f"{M_EDGE}, {M_SAMPLE} drawn; on the CPU, slowest "
            f"{slowest:.1f} s); frame 0 of {', '.join(g[0] for g in golden)} "
            f"equal to the golden model's decode; {workers} worker "
            f"processes, {time.perf_counter() - t0:.1f} s after the card's "
            f"{t_card:.1f} s")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    missing = [b for b in M_BANDS if b not in bands]
    if missing:
        raise RuntimeError(f"path M reached no configuration in {missing}")
    log("path M bands: " + "; ".join(
        f"{b}: {', '.join(f'{t} (L={L})' for t, L in v)}"
        for b, v in bands.items()))
    log("path M rates on " + smi + ": " + "; ".join(
        f"{tag} {fps:.2f} frames/s, {mpix:.1f} MPix/s"
        for tag, fps, mpix in rates) + "; beside 1080p in this run: "
        + ", ".join(f"{k} {v:.2f}" for k, v in rates_1080.items()))
    log(f"path M: {len(rates)} configurations; phase 19 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return per_config


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from video_coding_tpu_torch import kernels

    # path M's frames (~0.5 GB) are made meanwhile by one worker process,
    # which writes them under build/: sent back through the pool they would
    # be unpickled in this process while later phases time their calls
    with ProcessPoolExecutor(
            max_workers=1,
            mp_context=multiprocessing.get_context("spawn")) as maker:
        return run_phases(maker.submit(
            m_frames, str(kernels.BUILD_DIR.parent / "path_m"), M_SIZES))


def run_phases(m_made) -> int:
    """Phases 1-21 (the module docstring); ``m_made`` is the future of
    path M's frames (m_frames)."""
    from video_coding_tpu_torch import kernels
    from video_coding_tpu_torch.common.bitstream import BitReader
    from video_coding_tpu_torch.common.frame import ChromaSubsampling, Frame
    from video_coding_tpu_torch.common.plane import Plane
    from video_coding_tpu_torch.entropy import gather_pack, symbols
    from video_coding_tpu_torch.entropy import huffman_decode as k1
    from video_coding_tpu_torch.entropy import native
    from video_coding_tpu_torch.entropy import scan as hscan
    from video_coding_tpu_torch.entropy import huffman_encode as k4
    from video_coding_tpu_torch.entropy import pack_stuff as k8
    from video_coding_tpu_torch.entropy.scan import destuff_dispatch
    from video_coding_tpu_torch.model.header import Header, Parameters
    from video_coding_tpu_torch.ops import datapath
    from video_coding_tpu_torch.ops import lookup as k9
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
    t0 = time.perf_counter()
    host_lib = native.build()
    native.load()
    host_build_s = time.perf_counter() - t0
    log(f"build: host entropy engine (g++) {host_build_s:.2f} s -> "
        f"{host_lib.name}")

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
        if not isinstance(got, Frame):
            raise RuntimeError(f"source {tag}: decode_device gave "
                               f"{type(got).__name__}, not a Frame")
        for name, ref in zip("yuv", frames[0]):
            g = getattr(got, name).data
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
    d = destuff_dispatch(payloads, dec.n_segments)
    lane_bytes = int(d.lens.sum())
    plan = dec._segment_plan(d)
    up = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
          for a in (d.flat, plan.starts, plan.lens, plan.blocks)]
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
    k1_bytes = (lane_bytes + 3 * 4 * S + st.values.numel() * 4
                + 3 * st.lo.numel() * 4 + coefs.numel() * 4)
    rows.append(("K1", "video_coding_tpu_torch/csrc/huffman_decode.cu",
                 "video_coding_tpu/entropy/pallas_decode.py:838",
                 lambda: k1.decode_flat(*k1_args, **k1_kw),
                 lambda: k1.decode_flat_plain(*k1_args, **k1_kw),
                 k1_bytes, 40.0 * n_sym))

    tabs = (st.lo, st.hi, st.offset, st.values)
    lut = k1.decode_lut(*tabs)
    err["LUT"] = compare("LUT", lut, k1.decode_lut_plain(*tabs))
    T = st.lo.shape[0]
    level1 = lut[:T << k1.LUT_BITS].to(torch.int32) & 0xFFFF
    n_pooled = int(((level1 & 0xC000) == k1.LUT_POOLED).sum())
    n_fallback = int((level1 == k1.LUT_FALLBACK).sum())
    log(f"LUT: {T} rows of {1 << k1.LUT_BITS}; {n_pooled} entries "
        f"({n_pooled / level1.numel():.2%}) go to a level-2 block, "
        f"{n_fallback} to the range match")
    rows.append(("LUT", "video_coding_tpu_torch/csrc/huffman_lut.cu",
                 "video_coding_tpu/entropy/pallas_decode.py:378",
                 lambda: k1.decode_lut(*tabs),
                 lambda: k1.decode_lut_plain(*tabs),
                 sum(t.numel() * 4 for t in tabs) + lut.numel() * 2,
                 T * 65536 * 3 * 16.0))

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
    adversarial_decode_datapath_checks(N2, dev)

    stacks = dec._decode_tail_pool(pool, torch.from_numpy(plan.inv_perm).to(
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
    k4_bytes = k4_bound_bytes(*k4_args, m_out)
    adversarial_encode_checks(N3, k4_args, enc.n_blocks)
    rows.append(("K4", "video_coding_tpu_torch/csrc/huffman_encode.cu",
                 "video_coding_tpu/entropy/pallas_encode.py:502",
                 lambda: k4.encode_segments(*k4_args, m_out=m_out),
                 lambda: k4.encode_segments_plain(*k4_args, m_out=m_out),
                 k4_bytes, 30.0 * n_sym4))

    timed = []

    def time_rows(rows, plain_reps):
        """Each row: name, source, replaced kernel, kernel call, plain
        call, bytes, operations and, where one PyTorch call computes the
        same function, that call."""
        for name, src, replaces, fn, plain, nbytes, nops, *lib in rows:
            ms = time_ms(fn, 20)
            plain_ms = time_ms(plain, plain_reps)
            lib_ms = time_ms(lib[0], 20) if lib else None
            bms, by = bound_ms(nbytes, nops)
            log(f"{name}: {ms:.4f} ms kernel, {plain_ms:.3f} ms plain, "
                + (f"{lib_ms:.4f} ms library call, " if lib else "")
                + f"bound {bms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, "
                f"{nops / 1e9:.3f} G int ops) — {bms / ms:.1%} of bound")
            timed.append((name, src, replaces, ms, plain_ms, bms, by,
                          lib_ms))

    time_rows(rows, 3)

    # 5. end to end
    counted = launch_counter()
    outs, seen = counted(lambda: trans.transcode_batch(payloads),
                         ("K1", "K2", "K3", "K4", "LUT"))
    launches = {k: seen[k] for k in ("K1", "K2", "K3", "K4", "LUT")}
    # the launch counts of every own path's counted run, for the kernels
    # line
    path_launches = {}
    log(f"main path launches (one transcode_batch, F={FRAMES}): {launches}")

    def parses(o: bytes) -> None:
        hdr = Header.decode(BitReader(o))
        if hdr.frame is None or (hdr.frame.width, hdr.frame.height) != \
                (WIDTH, HEIGHT) or o[-2:] != b"\xff\xd9":
            raise RuntimeError("encoded stream does not parse")

    for o in outs:
        parses(o)
    t0 = time.perf_counter()
    cpu = JpegTranscodeSession(header, quality=75, restart_interval=1,
                               device="cpu")
    ref = cpu.transcode_batch(payloads[:2])
    if outs[:2] != ref:
        raise RuntimeError("GPU transcode bytes differ from the CPU path")
    log(f"end to end: 2 frames byte-identical to device='cpu' "
        f"({time.perf_counter() - t0:.1f} s on the CPU); outputs "
        f"{min(map(len, outs))}..{max(map(len, outs))} bytes")

    def window(session) -> float:
        n = 2 * FRAMES
        t = time.perf_counter()
        for _ in session.transcode_batch_iter(payloads * 2, batch=FRAMES,
                                            depth=2):
            pass
        return (time.perf_counter() - t) / n

    def transcode_rate(session):
        windows = sorted(window(session) for _ in range(3))
        return windows, [WIDTH * HEIGHT / w / 1e6 for w in windows]

    windows, mpix = transcode_rate(trans)
    # the 1080p rates path M's stand beside
    rates_1080 = {"transcode_batch_iter MPix/s": mpix[1]}
    log(f"transcode_batch_iter {WIDTH}x{HEIGHT} q75 ri=1 F={FRAMES}: median "
        f"{mpix[1]:.2f} MPix/s (windows {', '.join(f'{m:.2f}' for m in mpix)}"
        f"; {windows[1] * 1e3:.2f} ms/frame) on {smi}")

    # where the time goes: host destuff alone, then one dispatch under
    # torch.profiler (device busy = sum of CUDA kernel and copy spans; one
    # stream, so they do not overlap)
    t0 = time.perf_counter()
    destuff_dispatch(payloads, dec.n_segments)
    destuff_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_profile(call):
        """One call under torch.profiler: (wall ms, {kernel or copy name:
        [device ms, count]})."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # the profiler's raw activity list: every kernel and copy on the
        # card, whether or not it was matched to a host-side op
        by_name: dict[str, list] = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                key = e.name().replace("(anonymous namespace)::", "") \
                    .split("(")[0][:48]
                slot = by_name.setdefault(key, [0.0, 0])
                slot[0] += e.duration_ns() / 1e6
                slot[1] += 1
        return wall_ms, by_name

    def launch_ms(by_name, *kernel_names):
        """Mean device ms a launch of each named kernel, summed over the
        names; None when the profile holds one of them not at all (the
        profiler has been seen to return no events)."""
        total = 0.0
        for n in kernel_names:
            hits = [v for k, v in by_name.items() if n in k]
            if not hits:
                return None
            total += sum(v[0] for v in hits) / sum(v[1] for v in hits)
        return total

    def alone_ms(call, *kernel_names):
        """launch_ms of the kernels in a profile of call, the profile taken
        up to three times until it shows them; None if it never does."""
        for _ in range(3):
            ms = launch_ms(device_profile(call)[1], *kernel_names)
            if ms is not None:
                return ms
        return None

    def fmt_ms(ms) -> str:
        return "not measured (the profile held no such kernel)" \
            if ms is None else f"{ms:.4f} ms"

    def breakdown(label, call, note=""):
        wall_ms, by_name = device_profile(call)
        busy_ms = sum(v[0] for v in by_name.values())
        log(f"breakdown: one {label} (F={FRAMES}) {wall_ms:.2f} ms wall "
            f"under the profiler, device busy {busy_ms:.3f} ms "
            f"({1 - busy_ms / wall_ms:.1%} idle){note}")
        for key, (ms, _n) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:10]:
            log(f"  device {ms:8.3f} ms  {key}")
        return by_name

    breakdown("transcode_batch", lambda: trans.transcode_batch(payloads),
              f"; host destuff of the {FRAMES} frames alone "
              f"{destuff_ms:.2f} ms")

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
            got, seen = counted(call, (kname, "K2") + (
                ("LUT",) if kname in ("K1+hooks", "K5", "K6", "K7")
                else ()))
            wall = time.perf_counter() - t0
        finally:
            setattr(k1, wname, wrapper)
        launches[kname] = seen[kname]
        path_launches[tag] = seen
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
            compare("K7 against K1", out, k1.decode_flat(*a, **k))
            ms_k1 = time_ms(lambda: k1.decode_flat(*a, **k), 20)
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
    decode_redesign_checks(k1, captured, dec)
    adversarial_padded_checks(k1, captured["K5"], dec)
    # K5 alone under the profiler, and path C's lanes in symbols
    a5, kw5 = captured["K5"]
    S5 = a5[0].shape[0]
    per_block = block_symbols(k1.decode_segments(*a5, **kw5).view(-1, 64))
    per_block = per_block.view(S5, -1)
    decoded = torch.arange(per_block.shape[1], device=dev)[None] < \
        a5[1].to(torch.int64)[:, None]
    lane_sym = torch.where(decoded, per_block, 0).sum(1)
    def k5_calls():
        for _ in range(5):
            k1.decode_segments(*a5, **kw5)

    def k5_host_ms(n=50):
        """Host ms a K5 call (checks, allocations, launches, no wait for
        the card), and the card's ms a call when the calls run back to
        back, from the same n calls."""
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        t0 = time.perf_counter()
        for _ in range(n):
            k1.decode_segments(*a5, **kw5)
        host = (time.perf_counter() - t0) * 1e3 / n
        e.record()
        e.synchronize()
        return host, s.elapsed_time(e) / n

    rows0 = k1.decode_segments.row_launches
    k5_calls()
    k5_host, k5_pipe = k5_host_ms()
    log(f"K5 on path C, 50 calls back to back: the wrapper's host path "
        f"{k5_host:.4f} ms a call, the card {k5_pipe:.4f} ms a call")
    regime5 = k1.k5_regime(S5, a5[0].shape[1], kw5["blocks_per_segment"])
    if regime5 != "lane" or k1.decode_segments.stats is not None or \
            k1.decode_segments.row_launches != rows0:
        raise RuntimeError(f"K5 took its '{regime5}' regime at path C's "
                           "shape, not 'lane'")
    log(f"K5 on path C ('lane' regime): {S5} lanes of {a5[0].shape[1]} "
        f"bytes, longest lane "
        f"{int(lane_sym.max())} symbols (mean "
        f"{float(lane_sym.double().mean()):.1f}); under the profiler (5 "
        f"calls) the kernel alone "
        f"{fmt_ms(alone_ms(k5_calls, 'huffman_decode_padded_kernel'))}, the "
        f"lookup table "
        f"{fmt_ms(alone_ms(k5_calls, 'lut_level1', 'lut_level2'))} a call "
        f"(SM clock just after: {sm_clock()}) on {smi}")

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
        rates_1080[f"path {tag} frames/s"] = w[1]
        log(f"decode_device_batch_iter path {tag} {WIDTH}x{HEIGHT} q90 "
            f"F={FRAMES}: median {w[1]:.2f} frames/s (windows "
            f"{', '.join(f'{x:.2f}' for x in w)}; {n} frames a window) "
            f"on {smi}")
    t0 = time.perf_counter()
    destuff_dispatch(pay_b, sessions["B"].n_segments)
    breakdown("decode_device_batch (path B)",
              lambda: sessions["B"].decode_device_batch(pay_b),
              f"; host destuff of the {FRAMES} frames alone "
              f"{(time.perf_counter() - t0) * 1e3:.2f} ms")
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
        f"{scan_s * 1e3:.1f} ms on the host (the engine); one path A "
        f"dispatch of {FRAMES} frames: {wall_a:.2f} s wall on {smi}")

    # 9. path E: the encoder session's split entropy path. Spies keep the
    # arguments the session gave K9 and K8, for phase 12.
    RI_E = 8
    frame_objs = [Frame(Plane(data=y), Plane(data=u), Plane(data=v),
                        ChromaSubsampling.C420) for y, u, v in frames]
    params_e = Parameters.c420(WIDTH, HEIGHT, 75)
    enc_e = JpegEncoderSession(params_e, restart_interval=RI_E)
    t0 = time.perf_counter()
    enc_e.encode_device_batch(frame_objs)      # warm + lock the ladder
    log(f"path E: warming dispatch {time.perf_counter() - t0:.2f} s, segment "
        f"budget locked at {enc_e._seg_budget} bytes")
    spy8, spy9 = Spy(k8.pack_stuff), Spy(symbols.table_lookup)
    k8.pack_stuff, symbols.table_lookup = spy8, spy9
    try:
        outs_e, seen = counted(
            lambda: enc_e.encode_device_batch(frame_objs),
            ("K3", "K9", "K8"))
    finally:
        k8.pack_stuff, symbols.table_lookup = spy8.fn, spy9.fn
    if (seen["K3"], seen["K9"], seen["K8"], seen["K4"]) != (1, 1, 1, 0):
        raise RuntimeError("path E must launch K3, K9 and K8 once each and "
                           f"K4 never: {seen}")
    launches.update(K8=seen["K8"], K9=seen["K9"])
    path_launches["E"] = seen
    (a8, kw8), (a9, _kw9) = spy8.args, spy9.args
    S_e, K_e = a8[2].shape
    log(f"path E: {FRAMES} Frames q75 ri={RI_E}, {S_e} lanes of "
        f"{enc_e.blocks_per_segment} blocks, {K_e} slots a lane, m_out "
        f"{kw8['m_out']}, launches {seen}; outputs "
        f"{min(map(len, outs_e))}..{max(map(len, outs_e))} bytes")
    t0 = time.perf_counter()
    ref = JpegEncoderSession(params_e, RI_E, device="cpu") \
        .encode_device_batch(frame_objs[:2])
    if outs_e[:2] != ref:
        raise RuntimeError("path E bytes differ from the CPU session's")
    log(f"path E: 2 frames byte-identical to device='cpu' "
        f"({time.perf_counter() - t0:.1f} s on the CPU)")
    if JpegEncoderSession(params_e, RI_E, device_pack="xla") \
            .encode_device_batch(frame_objs) != outs_e:
        raise RuntimeError("path E bytes differ from device_pack='xla'")
    # K4 on the same coefficients (its contract has no 32-block cap)
    qc_e = enc_e._encode_qc_batch(enc_e._stack_frames(frame_objs))
    qc_seg_e = enc_e._pad_segments(qc_e, FRAMES)
    out8, lens8, ovf8 = k8.pack_stuff(*a8, **kw8)
    st_e = enc_e.state
    k4_e = (qc_seg_e, enc_e._valid_batch(FRAMES), enc_e._comp_sched,
            st_e.dctab, st_e.actab)
    out4, lens4e, ovf4 = k4.encode_segments(*k4_e, m_out=kw8["m_out"])
    compare("K8 bytes against K4", out8, out4)
    compare("K8 lens against K4", lens8, lens4e)
    if bool(ovf8) or bool(ovf4):
        raise RuntimeError("path E overflowed at the locked budget")
    log("path E: bytes equal to device_pack='xla' and to K4 called on "
        "the same coefficients (whole output array)")
    del out4, lens4e
    bits = BitReader(outs_e[0])
    hdr_e = Header.decode(bits)
    hdr_len_e = bits.bit_pos >> 3
    dec_e = JpegDecoderSession(hdr_e)
    worst = 99.0
    for o, src in zip(outs_e, frames):
        parses(o)
        got = dec_e.decode_device(o[hdr_len_e:])
        for g, r in zip((got.y.data, got.u.data, got.v.data), src):
            if g.shape != r.shape:
                raise RuntimeError("path E: decoded plane shape differs")
            worst = min(worst, psnr(g, r))
    log(f"path E: {FRAMES} streams parse and decode on the card, lowest "
        f"plane PSNR {worst:.2f} dB")
    if worst <= 30.0:
        raise RuntimeError(f"path E decode PSNR {worst:.2f} dB <= 30 dB")

    def enc_window() -> float:
        t = time.perf_counter()
        for _ in range(2):
            enc_e.encode_device_batch(frame_objs)
        return 2 * FRAMES / (time.perf_counter() - t)

    w = sorted(enc_window() for _ in range(3))
    rates_1080["path E frames/s"] = w[1]
    log(f"encode_device_batch path E {WIDTH}x{HEIGHT} q75 ri={RI_E} "
        f"F={FRAMES}: median {w[1]:.2f} frames/s (windows "
        f"{', '.join(f'{x:.2f}' for x in w)}) on {smi}")
    by_name = breakdown("encode_device_batch (path E)",
                        lambda: enc_e.encode_device_batch(frame_objs))
    log(f"  K8 alone in this dispatch: "
        f"{fmt_ms(launch_ms(by_name, 'pack_stuff_kernel'))} (SM clock just "
        f"after: {sm_clock()}) on {smi}")

    # 10. path F: the ri=1 sources transcoded to ri=8
    trans_f = JpegTranscodeSession(header, quality=75, restart_interval=RI_E)
    trans_f.transcode_batch(payloads)          # warm + lock the ladder
    outs_f, seen = counted(lambda: trans_f.transcode_batch(payloads),
                           ("K1", "K2", "K3", "K9", "K8", "LUT"))
    if seen["K4"]:
        raise RuntimeError(f"path F launched K4: {seen}")
    path_launches["F"] = seen
    log(f"path F: transcode_batch ri=1 -> ri={RI_E}, launches {seen}; "
        f"outputs {min(map(len, outs_f))}..{max(map(len, outs_f))} bytes")
    for o in outs_f:
        parses(o)
    t0 = time.perf_counter()
    ref = JpegTranscodeSession(header, quality=75, restart_interval=RI_E,
                               device="cpu").transcode_batch(payloads[:2])
    if outs_f[:2] != ref:
        raise RuntimeError("path F bytes differ from the CPU session's")
    log(f"path F: 2 frames byte-identical to device='cpu' "
        f"({time.perf_counter() - t0:.1f} s on the CPU)")
    windows_f, mpix_f = transcode_rate(trans_f)
    log(f"transcode_batch_iter path F {WIDTH}x{HEIGHT} q75 ri=1 -> "
        f"ri={RI_E} F={FRAMES}: median {mpix_f[1]:.2f} MPix/s (windows "
        f"{', '.join(f'{m:.2f}' for m in mpix_f)}; "
        f"{windows_f[1] * 1e3:.2f} ms/frame) beside {mpix[1]:.2f} MPix/s "
        f"for ri=1 -> ri=1 in this run, on {smi}")
    breakdown("transcode_batch (path F)",
              lambda: trans_f.transcode_batch(payloads))

    # 11. the host-entropy route on one frame: the host entropy engine,
    # the pure Python coder (seconds a 1080p frame) and the gather packer
    for entropy in ("native", "python", "tpu"):
        for transfer in ("sparse", "dense"):
            host = JpegEncoderSession(params_e, RI_E, entropy=entropy,
                                      coef_transfer=transfer)
            t0 = time.perf_counter()
            got = host.encode(frame_objs[0])
            ms = (time.perf_counter() - t0) * 1e3
            if got != outs_e[0]:
                raise RuntimeError(f"encode() entropy={entropy} coef_transfer"
                                   f"={transfer} differs from path E's bytes")
            log(f"host route: encode() entropy={entropy} coef_transfer="
                f"{transfer}: path E's bytes, {ms:.1f} ms a frame (first "
                f"call) on {smi}")

    # 12. K8 and K9 on path E's arguments
    out8_p, lens8_p, ovf8_p = k8.pack_stuff_plain(*a8, **kw8)
    err["K8"] = max(compare("K8 bytes", out8, out8_p),
                    compare("K8 lens", lens8, lens8_p),
                    compare("K8 overflow", ovf8, ovf8_p))
    n_slots = int((a8[2] > 0).sum())
    n_hi = int((a8[2] > 32).sum())
    k8_bytes = 3 * 4 * S_e * K_e + 4 * S_e + out8.numel() + 4 * S_e + 4
    k8_ops = 4.0 * S_e * K_e + 16.0 * n_slots + 6.0 * int(lens8.sum())
    need_bytes = k8_need_bytes(*a8[:3], kw8["m_out"])
    contract_ms, contract_by = bound_ms(k8_bytes, k8_ops)
    log(f"K8 input: {n_slots} of {S_e * K_e} slots hold bits "
        f"({n_slots / (S_e * K_e):.1%}), {n_hi} more than 32; "
        f"{int(lens8.sum())} bytes out, longest lane {int(lens8.max())}; "
        f"every input read once would be {contract_ms:.4f} ms "
        f"({contract_by}: {k8_bytes / 1e6:.1f} MB); K8's bound below counts "
        f"the bytes this data needs (c_len, the c_lo sectors with bits, the "
        f"c_hi sectors with more than 32, the output): "
        f"{need_bytes / 1e6:.1f} MB")
    del out8_p, lens8_p
    adversarial_pack_checks(S_e, dev)
    got9 = k9.table_lookup(*a9)
    err["K9"] = compare("K9", got9, k9.table_lookup_plain(*a9))
    compare("K9 against table[idx]", got9, a9[0][a9[1]])
    n9 = a9[1].numel()
    del got9
    rows = [
        ("K8", "video_coding_tpu_torch/csrc/pack_stuff.cu",
         "video_coding_tpu/entropy/pallas_encode.py:275",
         lambda: k8.pack_stuff(*a8, **kw8),
         lambda: k8.pack_stuff_plain(*a8, **kw8), need_bytes, k8_ops),
        ("K9", "video_coding_tpu_torch/csrc/table_lookup.cu",
         "video_coding_tpu/ops/lookup.py:55",
         lambda: k9.table_lookup(*a9),
         lambda: k9.table_lookup_plain(*a9),
         8 * n9 + 4 * a9[0].numel(), 2.0 * n9,
         lambda: a9[0][a9[1]])]
    time_rows(rows, 1)
    ms8 = next(row[3] for row in timed if row[0] == "K8")
    log(f"K8: {contract_ms / ms8:.1%} of the every-input-once time "
        f"({contract_ms:.4f} ms) as timed")
    sym_args = (qc_seg_e.view(-1, 64), enc_e._comp_sched.repeat(S_e),
                st_e.prev_same_comp, st_e.dctab, st_e.actab)
    B_e = enc_e.blocks_per_segment
    ms_sym = time_ms(lambda: symbols.segment_slots(*sym_args, B_e, None), 5)
    ms_gather = time_ms(lambda: gather_pack.encode_segments_device(
        *sym_args, blocks_per_segment=B_e, max_seg_bytes=kw8["m_raw"]), 3)
    ms_split = time_ms(lambda: k8.encode_segments_split(
        *sym_args, blocks_per_segment=B_e, max_seg_bytes=kw8["m_raw"]), 5)
    ms_k4 = time_ms(lambda: k4.encode_segments(*k4_e, m_out=kw8["m_out"]),
                    20)
    bms4, by4 = bound_ms(k4_bound_bytes(*k4_e, kw8["m_out"]),
                         30.0 * symbol_count(qc_e))
    log(f"path E's entropy encode as torch ops ({S_e} lanes): symbol "
        f"construction (with K9) {ms_sym:.3f} ms; split route (symbols + pad "
        f"slot + K8) {ms_split:.3f} ms; gather packer (symbols + gathers) "
        f"{ms_gather:.3f} ms; K4 on the same coefficients {ms_k4:.4f} ms, "
        f"bound {bms4:.4f} ms ({by4}) — {bms4 / ms_k4:.1%} of bound")

    # 13. paths G and H: the decoder session's host-entropy half and the
    # transcode's host route
    host_entropy_paths(sources, streams[0], trans, counted, compare, smi,
                       path_launches)

    # 14. path I: the decode-for-training path
    rgb_training_path(sources, frames, streams, counted, smi, path_launches,
                      device_profile)

    # 15. path J: the multi-device layer on a one-rank mesh
    multi_device_path(sources, frames, streams, counted, smi, path_launches)

    # 16. path K: the CLIs
    cli_paths(frames, streams, counted, smi, path_launches)

    # 17. the host entropy engine against its Python tier
    host_engine_checks(sources, src_enc, smi, host_build_s)

    # 18. path L: the other samplings, quality extremes, foreign streams
    per_config = configuration_space_path(frames, counted, smi)

    # 19. path M: frames past 1080p
    per_config_m = large_frame_path(counted, smi, rates_1080, m_made)

    # 20. kernels line, 21. last line
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name],
         "max_abs_err": err[name],
         "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
         "library_ms": lib_ms,
         "own_paths": {tag: seen[name] for tag, seen in path_launches.items()
                       if seen[name]},
         "path_L": per_config.get(name, {}),
         "path_M": per_config_m.get(name, {})}
        for name, src, replaces, ms, plain_ms, bms, by, lib_ms in timed]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
