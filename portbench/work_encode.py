"""Work of the encoder's stages, counted from the cell's outputs, for the
roofline shares of the re-encode cells: the encoder's counterpart of
``work.py``, on its ``least_s`` and ``roofline_pct``.

Bytes: each input byte read once, each output byte written once. Integer
operations: 30 a Huffman symbol encoded and 1,100 a block through the
encode datapath (K3) — assumed counts, not measured ones. The same counts
hold whatever kernel implements the stage (K4 fused, or K9 and K8).
"""

from __future__ import annotations

from portbench.work import COEF_BYTES


def huffman_encode(out, layout) -> tuple[float, float]:
    """One frame's int32 coefficients in, the entropy bytes of its output
    (``out``: the reference's ``Encoded``) out; 30 operations a symbol."""
    return (layout.n_blocks * 64 * COEF_BYTES + out.raw_bytes,
            30.0 * out.symbols)


def encode_datapath(layout) -> tuple[float, float]:
    """K3: 8-bit pixels in, int32 coefficients out; 1,100 operations a
    block."""
    n = layout.n_blocks
    return n * 64 * (1 + COEF_BYTES), 1100.0 * n
