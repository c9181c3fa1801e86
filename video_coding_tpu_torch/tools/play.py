"""YUV player: pygame/SDL when a display is available (or
``SDL_VIDEODRIVER=dummy``), otherwise a headless mode that renders frames
to PNG files, so playback stays scriptable. The visualization transforms
(plane isolation, difference against another file, grid overlay) are
array ops shared by both front-ends. PIL and pygame are imported only by
the front-end that needs them.
"""

from __future__ import annotations

import os

import numpy as np

from ..common.plane import EndOfImage
from ..common.size import Size
from .yuv import Yuv
from .yuv_format import YuvFormat


# --------------------------------------------------------------------------
# visualization transforms
# --------------------------------------------------------------------------

def isolate_plane(yuv: Yuv, which: str) -> Yuv:
    """Show a single plane as grayscale (plane isolation): the
    selected plane becomes luma (at its own resolution) with neutral
    chroma."""
    from ..common.plane import Plane

    src = getattr(yuv, which)
    neutral = np.full_like(src.data, 128)
    return Yuv(Plane(data=src.data.copy()), Plane(data=neutral.copy()),
               Plane(data=neutral.copy()))


def diff_frames(a: Yuv, b: Yuv, scale: int = 1) -> Yuv:
    """Signed difference visualization: 128 + (a-b)*scale, clipped."""
    def d(pa, pb):
        out = pa.copy()
        out.data = np.clip(
            128 + (pa.data.astype(np.int32) - pb.data.astype(np.int32))
            * scale, 0, 255).astype(np.uint8)
        return out

    return Yuv(d(a.y, b.y), d(a.u, b.u), d(a.v, b.v))


def highlight_exact_diff(a: Yuv, b: Yuv) -> Yuv:
    """White where any sample differs, black elsewhere (luma only)."""
    out = Yuv.create_444(a.y.width, a.y.height) if a.is_444() else \
        Yuv(a.y.copy(), a.u.copy(), a.v.copy())
    mask = (a.y.data != b.y.data)
    out.y.data = np.where(mask, 255, 0).astype(np.uint8)
    out.u.data[...] = 128
    out.v.data[...] = 128
    return out


def grid_overlay(yuv: Yuv, step: int = 16) -> Yuv:
    """Burn a step x step grid into luma (16x16 grid overlay)."""
    out = Yuv(yuv.y.copy(), yuv.u.copy(), yuv.v.copy())
    out.y.data[::step, :] = 255
    out.y.data[:, ::step] = 255
    return out


def yuv444_to_rgb(yuv: Yuv) -> np.ndarray:
    """BT.601 full-range YUV→RGB for display."""
    y = yuv.y.data.astype(np.float32)
    u = yuv.u.data.astype(np.float32) - 128.0
    v = yuv.v.data.astype(np.float32) - 128.0
    r = y + 1.402 * v
    g = y - 0.344136 * u - 0.714136 * v
    b = y + 1.772 * u
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


# --------------------------------------------------------------------------
# playback front-ends
# --------------------------------------------------------------------------

def iter_frames(f, size: Size, fmt: YuvFormat):
    buf = fmt.create(size)
    while True:
        try:
            fmt.input(f, buf)
        except EndOfImage:
            return
        yield fmt.to_444(buf)


def play_headless(path: str, size: Size, fmt: YuvFormat, out_dir: str,
                  max_frames: int = 16, transform=None) -> int:
    """Render frames to PNGs in out_dir; returns frame count."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    n = 0
    with open(path, "rb") as f:
        for yuv in iter_frames(f, size, fmt):
            if transform is not None:
                yuv = transform(yuv)
            rgb = yuv444_to_rgb(yuv)
            Image.fromarray(rgb).save(
                os.path.join(out_dir, f"frame_{n:05d}.png"))
            n += 1
            if n >= max_frames:
                break
    return n


def play_sdl(path: str, size: Size, fmt: YuvFormat, fps: float = 25.0,
             transform=None, stop_after: int | None = None) -> int:
    """Interactive playback via pygame (space=pause, ./,=step, q=quit).

    Raises RuntimeError when no display/pygame is available — callers fall
    back to play_headless. SDL_VIDEODRIVER=dummy is accepted (headless
    CI drives the full interactive loop that way); ``stop_after`` bounds
    the frames shown for such scripted runs."""
    try:
        import pygame
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("pygame not available") from e
    if (not os.environ.get("DISPLAY") and os.name != "nt"
            and os.environ.get("SDL_VIDEODRIVER") != "dummy"):
        raise RuntimeError("no display available")

    pygame.init()
    screen = pygame.display.set_mode((size.width, size.height))
    clock = pygame.time.Clock()
    frames = []
    with open(path, "rb") as f:
        frames = list(iter_frames(f, size, fmt))
    idx, playing, n_shown = 0, True, 0
    try:
        while True:
            for event in pygame.event.get():
                if event.type == pygame.QUIT:
                    return n_shown
                if event.type == pygame.KEYDOWN:
                    if event.key == pygame.K_q:
                        return n_shown
                    if event.key == pygame.K_SPACE:
                        playing = not playing
                    if event.key == pygame.K_PERIOD:
                        idx = min(idx + 1, len(frames) - 1)
                    if event.key == pygame.K_COMMA:
                        idx = max(idx - 1, 0)
            yuv = frames[idx]
            if transform is not None:
                yuv = transform(yuv)
            rgb = yuv444_to_rgb(yuv)
            surf = pygame.surfarray.make_surface(rgb.swapaxes(0, 1))
            screen.blit(surf, (0, 0))
            pygame.display.flip()
            n_shown += 1
            if stop_after is not None and n_shown >= stop_after:
                return n_shown
            if playing:
                idx = (idx + 1) % len(frames)
            clock.tick(fps)
    finally:
        pygame.quit()
