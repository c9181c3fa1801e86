"""oyuv: play / convert / compare raw YUV files.

Capability parity with reference tools/bin/oyuv.ml (:22-27) and the
command groups in ocompare.ml:111-145, oconv.ml:111-145, oplay.ml:361-590.
"""

from __future__ import annotations

import argparse
import sys

from ..common.size import Offset, Range, Size
from ..tools import compare as ocompare
from ..tools import convert as oconv
from ..tools import play as oplay
from ..tools.yuv_format import YuvFormat


def cmd_compare(args) -> int:
    size = Size.of_string(args.size)
    fmt1 = YuvFormat.of_string(args.format)
    fmt2 = YuvFormat.of_string(args.format2 or args.format)
    with open(args.file1, "rb") as f1, open(args.file2, "rb") as f2:
        frame = 0
        while True:
            buf1 = fmt1.create(size)
            buf2 = fmt2.create(size)
            try:
                fmt1.input(f1, buf1)
                fmt2.input(f2, buf2)
            except Exception:
                break
            a = fmt1.to_444(buf1) if args.plane == "yuv-444" else buf1
            b = fmt2.to_444(buf2) if args.plane == "yuv-444" else buf2
            which = "yuv" if args.plane == "yuv-444" else args.plane
            result = ocompare.compare_yuv(args.metric, which, a, b)
            if isinstance(result, dict):
                vals = " ".join(
                    f"{v:.3f}" if isinstance(v, float) else str(v)
                    for v in result.values())
            else:
                vals = (f"{result:.3f}" if isinstance(result, float)
                        else str(result))
            print(f"{frame}: {vals}")
            frame += 1
            if args.frames is not None and frame >= args.frames:
                break
    return 0


def cmd_convert(args) -> int:
    size = Size.of_string(args.size)
    in_fmt = YuvFormat.of_string(args.in_format)
    out_fmt = YuvFormat.of_string(args.out_format)
    frame_range = Range.of_string(args.range) if args.range else None
    offset = Offset.of_string(args.offset) if args.offset else None
    out_size = Size.of_string(args.out_size) if args.out_size else None
    fin = oconv.open_in(args.input)
    fout = oconv.open_out(args.output)
    n = oconv.convert_stream(fin, fout, size, in_fmt, out_fmt,
                             frame_range, offset, out_size)
    print(f"converted {n} frames", file=sys.stderr)
    return 0


def cmd_play(args) -> int:
    size = Size.of_string(args.size)
    fmt = YuvFormat.of_string(args.format)
    transform = None
    if args.isolate:
        transform = lambda y: oplay.isolate_plane(y, args.isolate)
    elif args.grid:
        transform = oplay.grid_overlay
    elif args.diff:
        # diff vs a reference file (oplay.ml ±diff visualization)
        ref_file = open(args.diff, "rb")
        ref_iter = oplay.iter_frames(ref_file, size, fmt)

        def transform(yuv):
            try:
                ref = next(ref_iter)
            except StopIteration:
                return yuv
            if args.diff_exact:
                return oplay.highlight_exact_diff(yuv, ref)
            return oplay.diff_frames(yuv, ref, scale=args.diff_scale)
    try:
        if args.out_dir:
            raise RuntimeError("headless requested")
        n = oplay.play_sdl(args.input, size, fmt, fps=args.fps,
                           transform=transform)
    except RuntimeError:
        out = args.out_dir or "oyuv_frames"
        n = oplay.play_headless(args.input, size, fmt, out,
                                max_frames=args.frames or 16,
                                transform=transform)
        print(f"no display: wrote {n} frames to {out}/", file=sys.stderr)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="oyuv-torch", description="YUV tools")
    sub = p.add_subparsers(dest="command", required=True)

    c = sub.add_parser("compare", help="compare two YUV files")
    c.add_argument("metric", choices=sorted(ocompare.METRICS))
    c.add_argument("plane", choices=["y", "u", "v", "yuv", "yuv-444"])
    c.add_argument("file1")
    c.add_argument("file2")
    c.add_argument("--size", required=True)
    c.add_argument("--format", default="420")
    c.add_argument("--format2", default=None)
    c.add_argument("--frames", type=int, default=None)
    c.set_defaults(fn=cmd_compare)

    v = sub.add_parser("convert", help="convert between YUV formats")
    v.add_argument("input", help="input file or -")
    v.add_argument("output", help="output file or -")
    v.add_argument("--size", required=True)
    v.add_argument("--in-format", required=True)
    v.add_argument("--out-format", required=True)
    v.add_argument("--range", default=None, help="frame range start-end")
    v.add_argument("--offset", default=None, help="crop offset x,y")
    v.add_argument("--out-size", default=None, help="crop size WxH")
    v.set_defaults(fn=cmd_convert)

    pl = sub.add_parser("play", help="play a YUV file")
    pl.add_argument("input")
    pl.add_argument("--size", required=True)
    pl.add_argument("--format", default="420")
    pl.add_argument("--fps", type=float, default=25.0)
    pl.add_argument("--frames", type=int, default=None)
    pl.add_argument("--out-dir", default=None,
                    help="headless: write PNG frames here")
    pl.add_argument("--isolate", choices=["y", "u", "v"], default=None)
    pl.add_argument("--grid", action="store_true")
    pl.add_argument("--diff", default=None,
                    help="visualize signed difference vs this YUV file")
    pl.add_argument("--diff-scale", type=int, default=1)
    pl.add_argument("--diff-exact", action="store_true",
                    help="highlight exact differing samples instead")
    pl.set_defaults(fn=cmd_play)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
