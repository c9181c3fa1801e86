"""Debug pretty-printers: 64-element arrays rendered as 8x8 hex grids
(coefficients with 3 hex digits, pixels with 2), for logs and
expect-style tests."""

from __future__ import annotations

import numpy as np


def _grid(block, digits: int) -> str:
    a = np.asarray(block).reshape(8, 8)
    lines = []
    for row in a:
        lines.append(" ".join(
            format(int(v) & ((1 << (4 * digits)) - 1), f"0{digits}x")
            for v in row))
    return "\n".join(lines)


def coef_block_to_string(block) -> str:
    """8x8 grid of 3-hex-digit (12-bit wrapped) coefficients."""
    return _grid(block, 3)


def pixel_block_to_string(block) -> str:
    """8x8 grid of 2-hex-digit pixel values."""
    return _grid(block, 2)
