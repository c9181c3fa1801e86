"""The re-encode benchmark's reference (``portbench/reference/
mjpeg_transcode.py``: the benchmark's NumPy codec, no PyTorch) on the
CPU: byte-identical with the benchmark's NumPy codec's decode and
re-encode, the port's ``JpegTranscodeSession`` byte-identical with it at
q90 ri=1 → q75 ri=1, and nothing of JAX or either package loaded by it.
Tolerance: exact equality of whole streams."""

import json
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402
from portbench.frames import synth_frames  # noqa: E402

from video_coding_tpu_torch.common.bitstream import BitReader  # noqa: E402
from video_coding_tpu_torch.model.header import Header  # noqa: E402
from video_coding_tpu_torch.runtime.engine import (  # noqa: E402
    JpegTranscodeSession)

REFERENCE = ROOT / "portbench" / "reference"
BJ = harness.load_module(REFERENCE / "baseline_jpeg.py", "baseline_jpeg")
MT = harness.load_module(REFERENCE / "mjpeg_transcode.py", "mjpeg_transcode")
Q_IN, Q_OUT, RI = 90, 75, 1


def _frame(width: int, height: int, seed: int):
    """Seeded 4:2:0 planes at any size: the benchmark's generator where it
    can draw the frame (more than 64 pixels each way), else gradients,
    texture and noise."""
    layout = BJ.Layout(width, height)
    if width > 64 and height > 64:
        return synth_frames(1, seed, width, height, layout.actual(1))[0]
    rng = np.random.default_rng(seed)
    out = []
    for h, w in (layout.actual(c) for c in range(3)):
        yy, xx = np.mgrid[0:h, 0:w]
        p = 128 + 60 * np.sin(xx / 5.0 + seed) * np.cos(yy / 3.0) + xx
        out.append(np.clip(p + rng.normal(0, 6, p.shape), 0, 255)
                   .astype(np.uint8))
    return tuple(out)


def _source(width: int, height: int, seed: int):
    layout = BJ.Layout(width, height)
    return layout, BJ.encode(_frame(width, height, seed), layout, Q_IN, RI)


@pytest.mark.parametrize("size", [(64, 48), (1920, 1080)])
def test_reference_is_the_numpy_codec_re_encode(size):
    layout, src = _source(*size, seed=2**35 + 1)
    got = MT.transcode(src.stream, Q_IN, Q_OUT, RI)
    want = BJ.encode(BJ.reconstruct(src.coefs, layout, Q_IN), layout,
                     Q_OUT, RI)
    assert got.stream == want.stream
    assert (got.symbols, got.raw_bytes) == (want.symbols, want.raw_bytes)
    assert np.array_equal(got.coefs, want.coefs)


@pytest.mark.parametrize("seed", [3, 2**31 + 5, 2**33 + 7])
@pytest.mark.parametrize("size", [(64, 48), (176, 144)])
def test_port_transcode_is_the_reference(size, seed):
    """3x4 and 9x11 MCUs: odd counts, and at 64x48 a frame whose padded
    luma is the frame (the pad clean only cuts chroma's MCU rows)."""
    _layout, src = _source(*size, seed=seed)
    bits = BitReader(src.stream)
    header = Header.decode(bits)
    session = JpegTranscodeSession(header, quality=Q_OUT,
                                   restart_interval=RI, device="cpu")
    got = session.transcode_batch([src.stream[bits.bit_pos >> 3:]] * 2)
    want = MT.transcode(src.stream, Q_IN, Q_OUT, RI).stream
    assert got == [want, want]


def test_reference_loads_nothing_of_jax_or_either_package():
    child = textwrap.dedent(f"""
        import json, pathlib, sys
        sys.modules["jax"] = None          # any `import jax` now fails
        sys.path.insert(0, {str(ROOT)!r})
        from portbench import harness
        ref = pathlib.Path({str(REFERENCE)!r})
        bj = harness.load_module(ref / "baseline_jpeg.py", "baseline_jpeg")
        mt = harness.load_module(ref / "mjpeg_transcode.py", "mjpeg")
        import numpy as np
        layout = bj.Layout(32, 16)
        planes = [np.full(layout.actual(c), 40 * c + 30, np.uint8)
                  for c in range(3)]
        src = bj.encode(planes, layout, 90, 1)
        out = mt.transcode(src.stream, 90, 75, 1)
        out_f = mt.transcode(src.stream, 90, 75, 1, dct="float32")
        tops = sorted({{m.split(".")[0] for m, mod in sys.modules.items()
                       if mod is not None}})
        print(json.dumps([out.stream[:2].hex(), out_f.stream[-2:].hex(),
                          tops]))
    """)
    run = subprocess.run([sys.executable, "-c", child], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert run.returncode == 0, run.stderr[-2000:]
    soi, eoi, tops = json.loads(run.stdout.strip().splitlines()[-1])
    assert (soi, eoi) == ("ffd8", "ffd9")
    assert not set(tops) & {"jax", "jaxlib", "video_coding_tpu",
                            "video_coding_tpu_torch", "torch"}
