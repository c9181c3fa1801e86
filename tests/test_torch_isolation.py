"""The port imports neither JAX nor the reference package, and never
falls back to the CPU on its own."""

import subprocess
import sys
import textwrap

import pytest
import torch

from video_coding_tpu_torch.runtime import engine

_CHILD = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None          # any `import jax` now fails
    import numpy as np
    from video_coding_tpu_torch.common.bitstream import BitReader
    from video_coding_tpu_torch.model.header import Header, Parameters
    from video_coding_tpu_torch.runtime.engine import (
        JpegDecoderSession, JpegEncoderSession, JpegTranscodeSession)

    rng = np.random.default_rng(0)
    planes = (rng.integers(0, 256, (48, 64), dtype=np.uint8),
              rng.integers(0, 256, (24, 32), dtype=np.uint8),
              rng.integers(0, 256, (24, 32), dtype=np.uint8))
    enc = JpegEncoderSession(Parameters.c420(64, 48, 80), 1, device="cpu")
    stream = enc.encode_device_batch([planes])[0]
    bits = BitReader(stream)
    header = Header.decode(bits)
    t = JpegTranscodeSession(header, quality=60, restart_interval=2,
                             device="cpu")
    out = t.transcode(stream[bits.bit_pos >> 3:])
    assert out[:2] == b"\\xff\\xd8" and out[-2:] == b"\\xff\\xd9"
    # the decode service on a restart-free stream (index scan + K1 with
    # hooks), then K7's, K5's and the plain strategy's routes
    yy, xx = np.mgrid[0:96, 0:128]
    big = ((xx + 2 * yy).astype(np.uint8), (xx[::2, ::2] // 2 + 90)
           .astype(np.uint8), (yy[::2, ::2] + 60).astype(np.uint8))
    free = JpegEncoderSession(Parameters.c420(128, 96, 80), 0,
                              device="cpu").encode_device_batch([big])[0]
    bits = BitReader(free)
    fh = Header.decode(bits)
    fp = free[bits.bit_pos >> 3:]
    ref = JpegDecoderSession(fh, device="cpu").decode_device(fp)
    for kw in ({"decode_gather": "dma"}, {"device_huffman": "pallas"},
               {"device_huffman": "range"}):
        dec = JpegDecoderSession(fh, device="cpu", **kw)
        got = dec.decode_device_batch([fp, fp])[1]
        assert all((a == b).all() for a, b in zip(dec._to_frame(got), ref))
    assert ref[0].shape == (96, 128)
    leaked = sorted(m for m in sys.modules
                    if m == "video_coding_tpu"
                    or m.startswith("video_coding_tpu."))
    print("LEAKED", leaked)
    print("JAX", [m for m in sys.modules if m.split(".")[0] == "jax"
                  and sys.modules[m] is not None])
""")


def test_port_runs_without_jax_or_reference_package():
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent
    r = subprocess.run([sys.executable, "-c", _CHILD], cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "LEAKED []" in r.stdout
    assert "JAX []" in r.stdout


def test_sessions_without_device_raise_when_no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.resolve_device()
    from video_coding_tpu_torch.model.header import Parameters

    with pytest.raises(RuntimeError):
        engine.JpegEncoderSession(Parameters.c420(16, 16, 75), 1)
    with pytest.raises(RuntimeError):
        engine.resolve_device("cuda")
    assert engine.resolve_device("cpu") == torch.device("cpu")
