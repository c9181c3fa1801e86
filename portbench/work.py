"""Work of each stage of the port, counted from the cell's inputs, and the
least time the card could take for it: a frozen copy of the smoke run's
``kernel_work`` and ``bound_ms`` arithmetic, per stage rather than per
kernel call.

Bytes: each input byte read once, each output byte written once. Integer
operations: 40 a Huffman symbol decoded and 1,200 a block through the
decode datapath (K2) — assumed counts, not measured ones. The same counts hold
whatever kernel implements the stage.
"""

from __future__ import annotations

COEF_BYTES = 4          # an int32 coefficient


def least_s(n_bytes: float, n_ops: float, peaks: dict) -> float:
    """The larger of the bytes over the memory rate and the operations
    over the int32 issue rate."""
    return max(n_bytes / peaks["hbm_bytes_per_s"],
               n_ops / peaks["int32_ops_per_s"])


def huffman_decode(source, layout) -> tuple[float, float]:
    """One frame's entropy bytes in, its coefficients out; 40 operations
    a symbol."""
    return (source.encoded.raw_bytes + layout.n_blocks * 64 * COEF_BYTES,
            40.0 * source.encoded.symbols)


def decode_datapath(layout) -> tuple[float, float]:
    """K2: coefficients in, 8-bit pixels out; 1,200 operations a block."""
    n = layout.n_blocks
    return n * 64 * (COEF_BYTES + 1), 1200.0 * n


def roofline_pct(per_frame: list, frames: int, kernel_s: float,
                 peaks: dict) -> float | None:
    """Share of its roofline that a stage reached: the least time for
    ``frames`` frames of the mean per-frame work (bytes, operations) of
    each of the stage's kernels, over the kernels' device time."""
    if not frames or kernel_s <= 0 or peaks is None:
        return None
    least = sum(least_s(b, o, peaks) for b, o in per_frame) * frames
    return 100.0 * least / kernel_s
