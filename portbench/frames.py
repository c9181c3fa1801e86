"""Synthetic camera frames from a seed: a frozen copy of the smoke run's
generator (gradients, sinusoidal texture, hard-edged rectangles and
sensor-like noise), at any width and height."""

from __future__ import annotations

import numpy as np


def synth_frames(n: int, seed: int, width: int, height: int,
                 chroma: tuple | None = None) -> list:
    """n distinct frames of width x height: (y, u, v) uint8 planes, chroma
    (height, width) ``chroma`` (4:2:0's, half rounded up, by default)."""
    W, H = width, height
    ch, cw = chroma or (-(-H // 2), -(-W // 2))
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    cy, cx = np.mgrid[0:ch, 0:cw].astype(np.float32)
    frames = []
    for t in range(n):
        y = (90 * xx / W + 60 * yy / H + 40
             + 30 * np.sin(2 * np.pi * (xx + 7 * t) / 97)
             * np.cos(2 * np.pi * yy / 61))
        for _ in range(24):
            x0, y0 = rng.integers(0, W - 64), rng.integers(0, H - 64)
            w, h = rng.integers(16, 400), rng.integers(16, 300)
            y[y0:y0 + h, x0:x0 + w] = rng.integers(0, 256)
        y += rng.normal(0, 3, y.shape)
        u = 128 + 50 * np.sin(2 * np.pi * (cx + 5 * t) / 300) \
            + rng.normal(0, 2, cx.shape)
        v = 128 + 50 * np.cos(2 * np.pi * cy / 200) \
            + rng.normal(0, 2, cy.shape)
        frames.append(tuple(np.clip(p, 0, 255).astype(np.uint8)
                            for p in (y, u, v)))
    return frames
