"""Remake the three foreign JPEG streams of this folder: 1920x1080 frames
of seeded smooth synthetic RGB (gradients, low-frequency waves, soft
discs and faint noise) written by libjpeg-turbo through PIL, as cameras
and image tools write them:

- ``webcam_422_q75_opt.jpg``: 4:2:2 (Y 2x1, chroma 1x1), q75, optimized
  Huffman tables, no restart interval (a USB webcam's MJPEG frame);
- ``rows_420_q90_rst_row.jpg``: 4:2:0, q90, a restart marker every MCU row;
- ``blocks_444_q85_rst1.jpg``: 4:4:4, q85, a restart marker every MCU.

    python tests/data/torch_foreign/make_foreign.py [OUT_DIR]

The files are committed (the GPU machine has no PIL); another PIL or
libjpeg-turbo version may write other bytes. ``rgb_frame`` also makes the
small frames of ``tests/test_torch_configs.py``.
"""

from __future__ import annotations

import io
import pathlib
import sys

import numpy as np

WIDTH, HEIGHT = 1920, 1080
SEED = 1234

# file name → PIL save options
STREAMS = {
    "webcam_422_q75_opt.jpg": dict(subsampling="4:2:2", quality=75,
                                   optimize=True),
    "rows_420_q90_rst_row.jpg": dict(subsampling="4:2:0", quality=90,
                                     restart_marker_rows=1),
    "blocks_444_q85_rst1.jpg": dict(subsampling="4:4:4", quality=85,
                                    restart_marker_blocks=1),
}


def rgb_frame(w: int, h: int, seed: int) -> np.ndarray:
    """(h, w, 3) uint8 smooth synthetic RGB from ``seed``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    out = np.empty((h, w, 3))
    for c in range(3):
        fx, fy = rng.uniform(0.5, 3.0, 2) * 2 * np.pi
        out[..., c] = (60 + 120 * (xx / w) * rng.uniform(0.3, 1.0)
                       + 80 * (yy / h) * rng.uniform(0.3, 1.0)
                       + 30 * np.sin(fx * xx / w + rng.uniform(0, 6))
                       * np.cos(fy * yy / h))
    for _ in range(12):
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        r = rng.uniform(0.03, 0.2) * min(w, h)
        disc = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * r * r))
        out += disc[..., None] * rng.uniform(-70, 70, 3)
    out += rng.normal(0, 1.5, out.shape)
    return np.clip(out, 0, 255).astype(np.uint8)


def jpeg_bytes(rgb: np.ndarray, **options) -> bytes:
    """``rgb`` written by libjpeg-turbo through PIL with ``options``."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", **options)
    return buf.getvalue()


def main(argv: list[str]) -> int:
    out = pathlib.Path(argv[0]) if argv else pathlib.Path(__file__).parent
    rgb = rgb_frame(WIDTH, HEIGHT, SEED)
    for name, options in STREAMS.items():
        data = jpeg_bytes(rgb, **options)
        (out / name).write_bytes(data)
        print(f"{name}: {len(data)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
