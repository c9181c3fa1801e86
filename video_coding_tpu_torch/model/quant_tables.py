"""Default quantization tables and libjpeg-style quality scaling.

Capability parity with reference jpeg/model/src/quant_tables.ml.

NOTE (load-bearing convention): the reference stores the ITU-T T.81 Annex K
table *values* row-major but indexes the array by **zigzag position**
throughout the codec (the DQT segment carries elements in zigzag order, and
encoder/decoder both use ``table[zigzag_index]``; see quant_tables.ml:3-139,
encoder.ml:103-108, decoder.ml:142-149). We reproduce that exact convention
so bitstreams and PSNR goldens match.
"""

import numpy as np

# ITU-T T.81 Annex K Table K.1 (luminance), row-major values, interpreted by
# this codec as zigzag-ordered (see module docstring).
LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99,
], dtype=np.int32)

# Annex K Table K.2 (chrominance).
CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
], dtype=np.int32)


def scale(table: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg-style quality scaling (quant_tables.ml:141-147).

    s = 5000/q for q<50 else 200-2q;  d' = clip((d*s+50)/100, 1, 255).
    """
    q = min(max(int(quality), 1), 100)
    s = 5000 // q if q < 50 else 200 - 2 * q
    d = (table * s + 50) // 100
    return np.clip(d, 1, 255).astype(np.int32)
