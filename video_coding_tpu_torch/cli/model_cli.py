"""Codec CLI: encode/decode/inspect baseline JPEG.

Capability parity with reference jpeg/bin/model.ml:
- ``decode frame``  — JPEG → raw planar YUV
- ``decode header`` — parsed header dump
- ``decode log``    — per-block pipeline state dump (coefs/dequant/idct/
  recon as 8x8 hex grids, util.ml style)
- ``encode frame``  — raw YUV → JPEG (quality, chroma, size flags)
- ``encode log``    — per-block encode pipeline dump (``--verbose`` adds
  reconstruction error)

Extensions: ``--engine torch`` (the sessions — CUDA kernels on the card,
or their plain versions with ``--device cpu`` — instead of the golden
model), ``--restart-interval N`` on encode.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..common.bitstream import BitReader
from ..common.frame import ChromaSubsampling, Frame
from ..common.size import Size
from ..model import decoder as mdec
from ..model import encoder as menc
from ..model.util import coef_block_to_string, pixel_block_to_string


def cmd_decode_frame(args) -> int:
    data = open(args.input, "rb").read()
    resync = getattr(args, "resync", False)
    if args.engine == "torch":
        from ..runtime.engine import decode_jpeg
        frame = decode_jpeg(data, resync=resync, device=args.device)
    elif resync:
        bits = BitReader(data)
        header = mdec.Header.decode(bits)
        if (header.frame is not None and header.scan is not None
                and len(header.scan.scan_components)
                < len(header.frame.components)):
            dec = mdec.MultiScanDecoder(header, bits)
        else:
            dec = mdec.Decoder(header, bits)
        dec.decode(resync=True)
        if dec.damaged_segments:
            print(f"concealed {len(dec.damaged_segments)} damaged restart "
                  f"segment(s): {dec.damaged_segments}", file=sys.stderr)
        frame = dec.get_yuv_frame()
    else:
        frame = mdec.decode_a_frame(data)
    with open(args.output, "wb") as f:
        frame.output(f)
    return 0


def cmd_decode_header(args) -> int:
    bits = BitReader(open(args.input, "rb").read())
    header = mdec.Header.decode(bits)
    print(header.frame)
    for q in header.quant_tables:
        print(f"DQT id={q.table_identifier} precision={q.element_precision}")
        print(" ", q.elements)
    for h in header.huffman_tables:
        cls = "DC" if h.table_class == 0 else "AC"
        print(f"DHT {cls} id={h.destination_identifier} "
              f"codes={sum(h.lengths)}")
    if header.restart_interval:
        print(f"DRI interval={header.restart_interval.restart_interval}")
    print(header.scan)
    return 0


def cmd_decode_log(args) -> int:
    bits = BitReader(open(args.input, "rb").read())
    header = mdec.Header.decode(bits)
    dec = mdec.Decoder(header, bits)
    for i, comp in enumerate(dec.decode_blocks_seq()):
        if args.num_blocks is not None and i >= args.num_blocks:
            break
        print(f"block {i}: component={comp.component.identifier} "
              f"x={comp.x} y={comp.y} dc_pred={comp.dc_pred}")
        print("coefs:")
        print(coef_block_to_string(comp.coefs))
        print("dequant:")
        print(coef_block_to_string(comp.dequant))
        print("idct:")
        print(coef_block_to_string(comp.idct))
        print("recon:")
        print(pixel_block_to_string(comp.recon))
    return 0


_CHROMA = {"420": ChromaSubsampling.C420,
           "422": ChromaSubsampling.C422,
           "440": ChromaSubsampling.C440,
           "444": ChromaSubsampling.C444}


def _read_frame(args) -> Frame:
    size = Size.of_string(args.size)
    frame = Frame.create(_CHROMA[args.chroma], size.width, size.height)
    with open(args.input, "rb") as f:
        frame.input(f)
    return frame


def cmd_encode_frame(args) -> int:
    frame = _read_frame(args)
    if args.engine == "torch":
        from ..runtime.engine import encode_jpeg
        data = encode_jpeg(frame, args.quality, _CHROMA[args.chroma],
                           restart_interval=args.restart_interval,
                           device=args.device)
    else:
        fn = {"420": menc.encode_420, "422": menc.encode_422,
              "444": menc.encode_444}[args.chroma]
        data = fn(frame, args.quality,
                  restart_interval=args.restart_interval)
    with open(args.output, "wb") as f:
        f.write(data)
    return 0


def cmd_encode_log(args) -> int:
    frame = _read_frame(args)
    params_fn = {"420": menc.Parameters.c420, "422": menc.Parameters.c422,
                 "444": menc.Parameters.c444}[args.chroma]
    enc = menc.Encoder(params_fn(frame.width, frame.height, args.quality),
                       compute_reconstruction_error=args.verbose)
    enc.load_frame(frame)
    sched = enc.block_schedule()
    qall = enc.quantized_blocks()
    n = args.num_blocks if args.num_blocks is not None else len(sched)
    for i, (si, x, y) in enumerate(sched[:n]):
        print(f"block {i}: scan={si} x={x} y={y}")
        pix = enc.scans[si].plane.data[y:y + 8, x:x + 8]
        print("input:")
        print(pixel_block_to_string(pix))
        print("quant (zigzag):")
        print(coef_block_to_string(qall[i]))
        if args.verbose:
            from ..model.zigzag import INVERSE
            from ..model.dct import chen_inverse_8x8
            deq = np.zeros(64, dtype=np.int64)
            deq[INVERSE] = (qall[i].astype(np.int64)
                            * enc.scans[si].quant_table)
            recon = np.clip(chen_inverse_8x8(deq.reshape(8, 8)) + 128,
                            0, 255)
            err = np.abs(recon - pix.astype(np.int64))
            print("recon:")
            print(pixel_block_to_string(recon.reshape(64)))
            print(f"error: max={err.max()} total={err.sum()}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vct-torch-model",
        description="baseline JPEG codec (PyTorch and CUDA)")
    p.add_argument("--engine", choices=["model", "torch"], default="model",
                   help="golden software model or the sessions")
    p.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="device of --engine torch (default: the card)")
    sub = p.add_subparsers(dest="command", required=True)

    dec = sub.add_parser("decode", help="decode a JPEG")
    dsub = dec.add_subparsers(dest="subcommand", required=True)
    d_frame = dsub.add_parser("frame")
    d_frame.add_argument("input")
    d_frame.add_argument("output")
    d_frame.add_argument("--resync", action="store_true",
                         help="conceal damaged restart segments instead "
                              "of failing (error-resilient decode)")
    d_frame.set_defaults(fn=cmd_decode_frame)
    d_header = dsub.add_parser("header")
    d_header.add_argument("input")
    d_header.set_defaults(fn=cmd_decode_header)
    d_log = dsub.add_parser("log")
    d_log.add_argument("input")
    d_log.add_argument("--num-blocks", type=int, default=None)
    d_log.set_defaults(fn=cmd_decode_log)

    enc = sub.add_parser("encode", help="encode raw YUV to JPEG")
    esub = enc.add_subparsers(dest="subcommand", required=True)
    for name, fn in (("frame", cmd_encode_frame), ("log", cmd_encode_log)):
        e = esub.add_parser(name)
        e.add_argument("input")
        if name == "frame":
            e.add_argument("output")
        e.add_argument("--size", required=True, help="WxH or named size")
        e.add_argument("--quality", type=int, default=75)
        e.add_argument("--chroma", choices=["420", "422", "440", "444"],
                       default="420")
        e.add_argument("--restart-interval", type=int, default=0)
        e.add_argument("--num-blocks", type=int, default=None)
        e.add_argument("--verbose", action="store_true")
        e.set_defaults(fn=fn)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
