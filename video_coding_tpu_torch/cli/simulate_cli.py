"""simulate: run accelerated paths in lockstep against the golden model.

Capability parity with reference jpeg/bin/simulate.ml (:4-135), whose
subcommands run RTL simulations block-locked against the software model.
Here the "simulation" is the real accelerated implementation (the CUDA
kernels on the card, or their plain versions with ``--device cpu``),
compared bit-for-bit:

- ``decoder``             — full accelerated decode vs model (per-plane
                            max diff, optional YUV output, tolerance flag)
- ``decoder-accelerator`` — host-entropy + device-datapath split
                            (the Decoder_accelerator analog)
- ``codeblock``           — entropy tier only: device (K1, K6 or K5 by
                            stream shape) or host Huffman decode vs model
                            coefficients for N blocks
- ``encoder-accelerator`` — accelerated encode vs model bytes
- ``filter-stuffed-bytes``— the host entropy engine's destuffer vs the
                            model extractor on a real stream, and vs the
                            Python tier on randomized buffers (host only:
                            no ``--device``)
- ``inspect``             — per-block model vs accelerated stages (K2 for
                            the accelerated reconstruction)
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..common.bitstream import BitReader
from ..model import decoder as mdec


def _load(path: str):
    data = open(path, "rb").read()
    bits = BitReader(data)
    header = mdec.Header.decode(bits)
    return data, header, data[bits.bit_pos >> 3:]


def _compare_frames(a, b, tolerance: int) -> int:
    worst = 0
    for p in "yuv":
        d = int(np.abs(getattr(a, p).data.astype(int)
                       - getattr(b, p).data.astype(int)).max())
        print(f"plane {p}: max diff {d}")
        worst = max(worst, d)
    if worst > tolerance:
        print(f"FAIL: diff {worst} > tolerance {tolerance}")
        return 1
    print("PASS")
    return 0


def cmd_decoder(args) -> int:
    from ..runtime.engine import JpegDecoderSession

    data, header, payload = _load(args.input)
    model = mdec.decode_a_frame(data)
    sess = JpegDecoderSession(header, entropy=args.entropy,
                              device=args.device)
    out = (sess.decode_device(payload) if args.fused
           else sess.decode(payload))
    if args.yuv:
        with open(args.yuv, "wb") as f:
            out.output(f)
    return _compare_frames(out, model, args.error_tolerance)


def cmd_decoder_accelerator(args) -> int:
    args.fused = False
    return cmd_decoder(args)


def cmd_codeblock(args) -> int:
    from ..entropy.huffman_decode import decode_scan_tpu
    from ..entropy.scan import decode_scan
    from ..entropy.tables import pack_decoder_tables

    data, header, _ = _load(args.input)
    bits = BitReader(data)
    dec = mdec.Decoder(mdec.Header.decode(bits), bits)
    golden = dec.decode_entropy()
    tables = pack_decoder_tables([c.dc_tab for c in dec.components],
                                 [c.ac_tab for c in dec.components])
    comp_idx = np.array([s[0] for s in dec.block_schedule()], dtype=np.int32)
    bps = (dec.restart_interval or 0) * sum(
        c.component.horizontal_sampling_factor
        * c.component.vertical_sampling_factor for c in dec.components)
    bps = bps or len(comp_idx)
    if args.entropy == "tpu":
        coefs = decode_scan_tpu(dec.entropy_segments, comp_idx, bps, tables,
                                "auto", device=args.device)
    else:
        coefs = decode_scan(dec.entropy_segments, comp_idx, bps, tables)
    n = args.blocks or len(coefs)
    bad = np.nonzero((coefs[:n] != golden[:n]).any(axis=1))[0]
    print(f"{n} blocks compared, {len(bad)} mismatched")
    for b in bad[:8]:
        print(f"block {b}: accel {coefs[b][:8]} model {golden[b][:8]}")
    return 1 if len(bad) else 0


def cmd_encoder_accelerator(args) -> int:
    from ..common.frame import ChromaSubsampling, Frame
    from ..common.size import Size
    from ..model import encoder as menc
    from ..runtime.engine import encode_jpeg

    size = Size.of_string(args.size)
    chroma = {"420": ChromaSubsampling.C420, "422": ChromaSubsampling.C422,
              "440": ChromaSubsampling.C440,
              "444": ChromaSubsampling.C444}[args.chroma]
    frame = Frame.create(chroma, size.width, size.height)
    with open(args.input, "rb") as f:
        frame.input(f)
    model_fn = {"420": menc.encode_420, "422": menc.encode_422,
                "440": menc.encode_440,
                "444": menc.encode_444}[args.chroma]
    model = model_fn(frame, args.quality,
                     restart_interval=args.restart_interval)
    accel = encode_jpeg(frame, args.quality, chroma,
                        restart_interval=args.restart_interval,
                        device=args.device)
    print(f"model {len(model)} bytes, accelerated {len(accel)} bytes")
    if accel == model:
        print("PASS: byte-identical")
        return 0
    print("FAIL: streams differ")
    return 1


def cmd_inspect(args) -> int:
    """Interactive per-block pipeline inspector — the analog of the
    reference's interactive waveform viewer (simulate.ml:11,
    Hardcaml_waveterm_interactive): step block by block through the
    decode pipeline with the model and the accelerated tier side by
    side (zigzag coefficients → dequant → IDCT → reconstruction as 8x8
    hex grids), jumping straight to mismatches.

    Commands on stdin: n(ext) / p(rev) / g <idx> / d (next differing
    block) / q(uit). One-shot with --block; scriptable when piped."""
    import torch

    from ..model.util import coef_block_to_string, pixel_block_to_string
    from ..model.zigzag import INVERSE as ZIGZAG_INVERSE
    from ..model.dct import chen_inverse_8x8
    from ..ops import datapath
    from ..runtime.engine import JpegDecoderSession

    data, header, payload = _load(args.input)
    bits = BitReader(data)
    dec = mdec.Decoder(mdec.Header.decode(bits), bits)
    sched = dec.block_schedule()
    golden = dec.decode_entropy()
    sess = JpegDecoderSession(header, entropy=args.entropy,
                              coef_transfer="dense", device=args.device)
    accel = np.asarray(sess.decode_entropy(payload))
    accel_pix = datapath.decode_datapath(
        torch.from_numpy(accel.astype(np.int32)).to(sess.device),
        sess.state.quant).cpu().numpy()
    n = len(sched)
    differs = (accel != golden).any(axis=1)

    def model_stages(i):
        ci, _x, _y = sched[i]
        q = dec.components[ci].quant_table
        dq_zz = np.clip(golden[i].astype(np.int64) * q, -2048, 2047)
        dq = np.zeros(64, np.int64)
        dq[ZIGZAG_INVERSE] = dq_zz
        idct = chen_inverse_8x8(dq.reshape(8, 8)).reshape(64)
        recon = (np.clip(idct, -128, 127) + 128).astype(np.uint8)
        return dq, idct, recon

    def show(i):
        ci, x, y = sched[i]
        mark = "  << DIFFERS" if differs[i] else ""
        print(f"block {i}/{n - 1}  component {ci}  plane pos "
              f"({x},{y}){mark}")
        print("model zigzag coefficients:")
        print(coef_block_to_string(golden[i]))
        if differs[i]:
            print(f"accelerated ({args.entropy}) zigzag coefficients:")
            print(coef_block_to_string(accel[i]))
        else:
            print(f"accelerated ({args.entropy}): identical coefficients")
        if args.stages:
            dq, idct, recon = model_stages(i)
            print("dequantized (natural order):")
            print(coef_block_to_string(dq))
            print("idct:")
            print(coef_block_to_string(idct))
            print("reconstruction:")
            print(pixel_block_to_string(recon))
            if not np.array_equal(accel_pix[i].reshape(64), recon):
                print("accelerated reconstruction (DIFFERS):")
                print(pixel_block_to_string(accel_pix[i].reshape(64)))

    print(f"{n} blocks, {int(differs.sum())} differ between model and "
          f"the '{args.entropy}' tier")
    if args.block is not None:
        show(args.block)
        return 1 if differs[args.block] else 0
    i = 0
    show(i)
    while True:
        try:
            cmd = input("inspect> ").strip().split()
        except EOFError:
            break
        if not cmd:
            continue
        if cmd[0] in ("q", "quit"):
            break
        if cmd[0] in ("n", "next"):
            i = min(i + 1, n - 1)
        elif cmd[0] in ("p", "prev"):
            i = max(i - 1, 0)
        elif cmd[0] == "g" and len(cmd) > 1:
            i = min(max(int(cmd[1]), 0), n - 1)
        elif cmd[0] in ("d", "diff"):
            nxt = np.nonzero(differs[i + 1:])[0]
            if len(nxt) == 0:
                print("no differing block after this one")
                continue
            i = i + 1 + int(nxt[0])
        else:
            print("commands: n / p / g <idx> / d / q")
            continue
        show(i)
    return 0


def cmd_filter_stuffed_bytes(args) -> int:
    from ..entropy.scan import destuff_segments

    data, header, payload = _load(args.input)
    bits = BitReader(data)
    mdec.Header.decode(bits)
    model_segments = mdec.extract_entropy_segments(bits)
    native_segments = destuff_segments(payload, use_native=True)
    ok = native_segments == model_segments
    print(f"{len(model_segments)} segments, native == model: {ok}")
    rng = np.random.default_rng(args.seed)
    fails = 0
    for _ in range(args.count):
        buf = rng.integers(0, 256, rng.integers(1, 512),
                           dtype=np.uint8).tobytes()
        a = destuff_segments(buf, use_native=True)
        b = destuff_segments(buf, use_native=False)
        fails += a != b
    print(f"randomized buffers: {args.count - fails}/{args.count} match")
    return 0 if ok and not fails else 1


def _device_arg(p) -> None:
    p.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="device of the accelerated tier (default: the "
                        "card)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vct-torch-simulate",
        description="lockstep accelerated-vs-model comparisons")
    sub = p.add_subparsers(dest="command", required=True)

    for name, fn, fused in (("decoder", cmd_decoder, True),
                            ("decoder-accelerator",
                             cmd_decoder_accelerator, False)):
        d = sub.add_parser(name)
        d.add_argument("input")
        d.add_argument("--yuv", default=None, help="write decoded YUV here")
        d.add_argument("--error-tolerance", type=int, default=0)
        d.add_argument("--entropy", choices=["native", "python", "tpu"],
                       default="native")
        _device_arg(d)
        d.set_defaults(fn=fn, fused=fused)

    c = sub.add_parser("codeblock")
    c.add_argument("input")
    c.add_argument("--blocks", type=int, default=None)
    c.add_argument("--entropy", choices=["native", "tpu"], default="tpu")
    _device_arg(c)
    c.set_defaults(fn=cmd_codeblock)

    e = sub.add_parser("encoder-accelerator")
    e.add_argument("input")
    e.add_argument("--size", required=True)
    e.add_argument("--quality", type=int, default=75)
    e.add_argument("--chroma", choices=["420", "422", "440", "444"], default="420")
    e.add_argument("--restart-interval", type=int, default=0)
    _device_arg(e)
    e.set_defaults(fn=cmd_encoder_accelerator)

    f = sub.add_parser("filter-stuffed-bytes")
    f.add_argument("input")
    f.add_argument("--count", type=int, default=100)
    f.add_argument("--seed", type=int, default=0)
    f.set_defaults(fn=cmd_filter_stuffed_bytes)

    i = sub.add_parser("inspect", help="interactive per-block pipeline "
                       "inspector (model vs accelerated tier)")
    i.add_argument("input")
    i.add_argument("--block", type=int, default=None,
                   help="show one block and exit (exit code 1 if the "
                        "tiers differ on it)")
    i.add_argument("--stages", action="store_true",
                   help="also dump dequant/idct/reconstruction stages")
    i.add_argument("--entropy", choices=["native", "python", "tpu"],
                   default="native")
    _device_arg(i)
    i.set_defaults(fn=cmd_inspect)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
