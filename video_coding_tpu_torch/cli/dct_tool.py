"""dct: fixed-point vs floating-point DCT accuracy evaluation.

Capability parity with reference jpeg/bin/dct.ml (:82-298): ``forward``,
``inverse`` and ``both`` evaluate a chosen (rom_prec, transpose_prec)
fixed-point transform against the float reference over random blocks;
``search`` sweeps rom precisions and transpose precisions reporting the
error surface — the tool the reference used to pick its hardware widths.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..model import dct


def _random_pixel_blocks(count: int, rng) -> np.ndarray:
    return rng.integers(-128, 128, size=(count, 8, 8)).astype(np.int64)


def _random_coef_blocks(count: int, rng) -> np.ndarray:
    return rng.integers(-2048, 2048, size=(count, 8, 8)).astype(np.int64)


def eval_forward(rom_prec, transpose_prec, count, rng):
    blocks = _random_pixel_blocks(count, rng)
    errs = []
    for b in blocks:
        fixed = dct.fixed_forward_transform(b, rom_prec, transpose_prec)
        ref = dct.FloatDct.forward(b)
        errs.append(np.abs(fixed - np.round(ref)).max())
    return int(np.max(errs)), float(np.mean(errs))


def eval_inverse(rom_prec, transpose_prec, count, rng):
    blocks = _random_coef_blocks(count, rng)
    errs = []
    for b in blocks:
        fixed = dct.fixed_inverse_transform(b, rom_prec, transpose_prec)
        ref = dct.FloatDct.inverse(b)
        errs.append(np.abs(fixed - np.round(ref)).max())
    return int(np.max(errs)), float(np.mean(errs))


def eval_both(rom_prec, transpose_prec, count, rng):
    """Round trip: pixels → fixed forward → fixed inverse → pixels."""
    blocks = _random_pixel_blocks(count, rng)
    errs = []
    for b in blocks:
        fwd = dct.fixed_forward_transform(b, rom_prec, transpose_prec)
        back = dct.fixed_inverse_transform(fwd, rom_prec, transpose_prec)
        errs.append(np.abs(back - b).max())
    return int(np.max(errs)), float(np.mean(errs))


EVALS = {"forward": eval_forward, "inverse": eval_inverse, "both": eval_both}


def cmd_eval(args) -> int:
    rng = np.random.default_rng(args.seed)
    mx, mean = EVALS[args.mode](args.rom_prec, args.transpose_prec,
                                args.count, rng)
    print(f"{args.mode} rom_prec={args.rom_prec} "
          f"transpose_prec={args.transpose_prec} count={args.count}: "
          f"max_err={mx} mean_err={mean:.4f}")
    return 0


def cmd_search(args) -> int:
    """Sweep rom precisions x transpose precisions (dct.ml search
    :242-281)."""
    rng = np.random.default_rng(args.seed)
    print("rom  transpose  max_err  mean_err")
    for rom in range(args.rom_min, args.rom_max + 1):
        for tp in range(args.transpose_min, args.transpose_max + 1):
            mx, mean = EVALS[args.mode](rom, tp, args.count, rng)
            print(f"{rom:3d}  {tp:9d}  {mx:7d}  {mean:8.4f}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="vct-torch-dct", description="fixed-point DCT accuracy evaluation")
    sub = p.add_subparsers(dest="command", required=True)
    for name in ("forward", "inverse", "both"):
        e = sub.add_parser(name)
        e.add_argument("--rom-prec", type=int, default=12)
        e.add_argument("--transpose-prec", type=int, default=2)
        e.add_argument("--count", type=int, default=1000)
        e.add_argument("--seed", type=int, default=0)
        e.set_defaults(fn=cmd_eval, mode=name)
    s = sub.add_parser("search")
    s.add_argument("--mode", choices=["forward", "inverse", "both"],
                   default="both")
    s.add_argument("--rom-min", type=int, default=8)
    s.add_argument("--rom-max", type=int, default=16)
    s.add_argument("--transpose-min", type=int, default=0)
    s.add_argument("--transpose-max", type=int, default=5)
    s.add_argument("--count", type=int, default=100)
    s.add_argument("--seed", type=int, default=0)
    s.set_defaults(fn=cmd_search)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
