"""8x8 zigzag permutation tables, generated from the scan definition.

Capability parity with reference jpeg/model/src/zigzag.ml:
``INVERSE[i]`` is the natural (raster) index of the i-th coefficient in
zigzag scan order; ``FORWARD`` is the inverse permutation (zigzag position
of each natural index).
"""

import numpy as np


def _zigzag_order() -> list[int]:
    """Natural indices visited in zigzag order (ITU-T T.81 Figure 5)."""
    order = []
    x = y = 0
    up = True  # moving up-right when True, down-left when False
    for _ in range(64):
        order.append(y * 8 + x)
        if up:
            if x == 7:
                y += 1
                up = False
            elif y == 0:
                x += 1
                up = False
            else:
                x += 1
                y -= 1
        else:
            if y == 7:
                x += 1
                up = True
            elif x == 0:
                y += 1
                up = True
            else:
                x -= 1
                y += 1
    return order


INVERSE = np.array(_zigzag_order(), dtype=np.int32)
FORWARD = np.argsort(INVERSE).astype(np.int32)

assert INVERSE[:8].tolist() == [0, 1, 8, 16, 9, 2, 3, 10]
assert FORWARD[:8].tolist() == [0, 1, 5, 6, 14, 15, 27, 28]
