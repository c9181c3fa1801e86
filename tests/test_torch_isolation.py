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
    import torch
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
        frame_got = dec._to_frame(got)
        assert all((getattr(frame_got, c).data == getattr(ref, c).data).all()
                   for c in "yuv")
    assert type(ref).__name__ == "Frame" and ref.y.data.shape == (96, 128)
    # the encoder's split path and host routes: symbols (K9), the packer
    # (K8), the gather packer, the host coder, the sparse transfer, Frames
    from video_coding_tpu_torch.common import frame, plane, size
    from video_coding_tpu_torch.entropy import (gather_pack, pack_stuff,
                                                symbols)
    from video_coding_tpu_torch.ops import lookup, sparse
    from video_coding_tpu_torch.runtime.engine import encode_jpeg
    fr = frame.Frame(*(plane.Plane(data=p) for p in big),
                     frame.ChromaSubsampling.C420)
    assert (fr.width, fr.height) == (128, 96)
    assert size.Size(128, 96).width == 128
    outs = {JpegEncoderSession(Parameters.c420(128, 96, 80), 6, device="cpu",
                               device_pack=pack, entropy=ent,
                               coef_transfer=tr)
            for pack, ent, tr in (("pallas", "python", "dense"),
                                  ("xla", "tpu", "sparse"))}
    streams = {e.encode_device(fr) for e in outs} | {e.encode(fr)
                                                     for e in outs}
    streams.add(encode_jpeg(fr, 80, restart_interval=6, device="cpu"))
    assert len(streams) == 1
    # the host-entropy half: host decoder, resync, the "lut" loop, sparse
    # upload, decode_jpeg, the transcode's host route
    from video_coding_tpu_torch.model import dct, decoder
    from video_coding_tpu_torch.runtime import decode_jpeg
    rs = JpegEncoderSession(Parameters.c420(128, 96, 80), 2,
                            device="cpu").encode(fr)
    bits = BitReader(rs)
    rh = Header.decode(bits)
    rp = rs[bits.bit_pos >> 3:]
    host = JpegDecoderSession(rh, device="cpu", coef_transfer="sparse")
    lutd = JpegDecoderSession(rh, device="cpu", entropy="tpu",
                              device_huffman="lut")
    got = [host.decode(rp), lutd.decode_batch([rp])[0],
           decode_jpeg(rs, device="cpu"),
           decode_jpeg(rs[:-40] + b"\\xff\\xd9", resync=True, device="cpu")]
    assert all((g.y.data == got[0].y.data).all() for g in got[1:3])
    assert got[3].y.data.shape == (96, 128)
    assert (JpegTranscodeSession(rh, 60, 1, device="cpu",
                                 entropy_out="host").transcode(rp)
            == JpegTranscodeSession(rh, 60, 1, device="cpu").transcode(rp))
    # the decode-for-training path, the golden model, the tools, tracing
    import os
    import tempfile
    from video_coding_tpu_torch import tools
    from video_coding_tpu_torch.model import encoder, util
    from video_coding_tpu_torch.ops import color
    from video_coding_tpu_torch.runtime import trace
    from video_coding_tpu_torch.runtime.dataset import JpegRgbDataset
    from video_coding_tpu_torch.tools import mjpeg, play
    golden = encoder.encode_420(fr, 80, restart_interval=2)
    assert golden == rs
    bits = BitReader(golden)
    dec_g = decoder.Decoder(Header.decode(bits), bits)
    dec_g.decode()
    assert (dec_g.get_yuv_frame().y.data == got[0].y.data).all()
    assert (decoder.decode_a_frame(golden).u.data == got[0].u.data).all()
    stream = mjpeg.join_stream([golden] * 3)
    rgb = host.decode_device_rgb_batch([rp] * 3)
    assert rgb.shape == (3, 96, 128, 3) and rgb.dtype == torch.uint8
    assert (rgb[1] == host.decode_device_rgb(rp)).all()
    batches = list(JpegRgbDataset(stream, batch_size=2, device="cpu"))
    assert [tuple(b.shape) for b in batches] == [(2, 96, 128, 3),
                                                 (1, 96, 128, 3)]
    assert (batches[1][0] == rgb[0]).all()
    assert len(mjpeg.decode_stream(stream, device="cpu")) == 3
    assert mjpeg.encode_stream([fr], 80, 2, device="cpu") == golden
    up = color.upsample_hv2(torch.from_numpy(big[1]))
    assert up.shape == (96, 128)
    yuv = tools.Yuv(*(plane.Plane(data=p) for p in
                      (big[0], up.to(torch.uint8).numpy(), big[0])))
    assert tools.compare.psnr(yuv.y, yuv.y) == float("inf")
    assert tools.planar_444.to_420(yuv).u.data.shape == (48, 64)
    assert play.yuv444_to_rgb(yuv).shape == (96, 128, 3)
    assert util.pixel_block_to_string(range(64)).startswith("00 01")
    tr = trace.pipeline_trace(np.ones((2, 64), np.int32),
                              np.full(64, 4, np.int32), device="cpu")
    assert tr.recon.shape == (2, 8, 8)
    with tempfile.TemporaryDirectory() as d:
        with trace.profile(d):
            color.yuv420_to_rgb(torch.from_numpy(big[0]),
                                torch.from_numpy(big[1]),
                                torch.from_numpy(big[2]))
        assert os.listdir(d)
    # the multi-device layer and the CLIs
    from video_coding_tpu_torch import parallel
    from video_coding_tpu_torch.cli import (dct_tool, generate_cli, model_cli,
                                            oyuv, simulate_cli)
    from video_coding_tpu_torch.parallel import mesh, multihost, pipeline
    assert len(parallel.__all__) == 12
    assert dct_tool.main(["both", "--count", "3"]) == 0
    with tempfile.TemporaryDirectory() as d:
        jpg = os.path.join(d, "f.jpg")
        with open(jpg, "wb") as f:
            f.write(golden)
        assert simulate_cli.main(["codeblock", jpg, "--device", "cpu"]) == 0
        assert model_cli.main(["--engine", "torch", "--device", "cpu",
                               "decode", "frame", jpg,
                               os.path.join(d, "f.yuv")]) == 0
    # the host entropy engine: the port's own library, built from its own
    # source under build/torch_kernels/, never the JAX package's native/
    import pathlib
    from video_coding_tpu_torch.entropy import native, scan
    lib = native.load()
    lib_path = pathlib.Path(lib._name).resolve()
    assert lib_path.parent.parts[-2:] == ("build", "torch_kernels")
    assert "native" not in lib_path.parts and lib.vct_version() == 7
    segs = scan.destuff_segments(rp)
    coefs = scan.decode_scan(segs, host.comp_idx, host.blocks_per_segment,
                             host.tables, use_native=True)
    assert (coefs == scan.decode_scan(segs, host.comp_idx,
                                      host.blocks_per_segment, host.tables,
                                      use_native=False)).all()
    print("ENGINE", lib_path)
    for mod in (frame, plane, size, gather_pack, pack_stuff, symbols, lookup,
                sparse, dct, decoder, encoder, util, color, trace, mjpeg,
                play, tools.yuv_format, tools.convert, tools.packed_422,
                mesh, multihost, pipeline, generate_cli, oyuv):
        assert mod.__name__ in sys.modules
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
    engine_lib = pathlib.Path(r.stdout.split("ENGINE ")[1].split()[0])
    assert engine_lib.parent == root / "build" / "torch_kernels"
    assert not engine_lib.is_relative_to(root / "native")


def test_port_sources_name_neither_jax_nor_reference_package():
    """No module of the port, and not the smoke script, has an import of
    jax or of the reference package."""
    import pathlib
    import re

    root = pathlib.Path(__file__).resolve().parent.parent
    files = sorted((root / "video_coding_tpu_torch").rglob("*.py")) \
        + [root / "chip_smoke.py"]
    names = {f.relative_to(root).as_posix() for f in files}
    for mod in ("ops/lookup.py", "ops/sparse.py", "entropy/pack_stuff.py",
                "entropy/gather_pack.py", "entropy/symbols.py",
                "common/frame.py", "common/plane.py", "common/size.py",
                "model/dct.py", "model/decoder.py", "model/encoder.py",
                "model/util.py", "ops/color.py", "runtime/dataset.py",
                "runtime/trace.py", "tools/__init__.py", "tools/compare.py",
                "tools/convert.py", "tools/mjpeg.py", "tools/packed_422.py",
                "tools/planar_444.py", "tools/play.py", "tools/yuv.py",
                "tools/yuv_format.py", "device.py", "parallel/__init__.py",
                "parallel/mesh.py", "parallel/pipeline.py",
                "parallel/multihost.py", "cli/__init__.py", "cli/model_cli.py",
                "entropy/native.py", "entropy/scan.py",
                "cli/simulate_cli.py", "cli/generate_cli.py", "cli/oyuv.py",
                "cli/dct_tool.py"):
        assert f"video_coding_tpu_torch/{mod}" in names
    pat = re.compile(r"^\s*(from|import)\s+(jax|video_coding_tpu)(\.|\s|$)",
                     re.M)
    for f in files:
        assert not pat.search(f.read_text()), f


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


def test_encode_scan_tpu_defaults_to_the_card(monkeypatch):
    """The gather packer's one-shot coder runs on the card unless asked for
    the CPU, as its JAX counterpart runs on the default accelerator."""
    import numpy as np

    from video_coding_tpu_torch.entropy import gather_pack
    from video_coding_tpu_torch.entropy.tables import pack_encoder_tables
    from video_coding_tpu_torch.model.header import Parameters

    p = Parameters.c420(16, 16, 75)
    tabs = pack_encoder_tables([p.dc_huffman_tables[0].data],
                               [p.ac_huffman_tables[0].data])
    q = np.zeros((4, 64), np.int32)
    ci = np.zeros(4, np.int32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gather_pack.encode_scan_tpu(q, ci, 1, tabs)
    assert len(gather_pack.encode_scan_tpu(q, ci, 1, tabs,
                                           device="cpu")) == 4
