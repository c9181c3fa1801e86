"""The port's five CLIs against the JAX package's, in-process on the CPU:
each ``main(argv)`` from both packages on the same synthetic files gives
the same output files and the same verdict lines (the port with
``--device cpu``: the kernels' plain versions)."""

import io
import pathlib
import shutil

import numpy as np
import pytest

from _torch_fixtures import encode, synth_frame
from video_coding_tpu.cli import dct_tool as j_dct
from video_coding_tpu.cli import generate_cli as j_generate
from video_coding_tpu.cli import model_cli as j_model
from video_coding_tpu.cli import oyuv as j_oyuv
from video_coding_tpu.cli import simulate_cli as j_simulate
from video_coding_tpu_torch import kernels
from video_coding_tpu_torch.cli import dct_tool as t_dct
from video_coding_tpu_torch.cli import generate_cli as t_generate
from video_coding_tpu_torch.cli import model_cli as t_model
from video_coding_tpu_torch.cli import oyuv as t_oyuv
from video_coding_tpu_torch.cli import simulate_cli as t_simulate

W, H = 64, 48


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Raw 4:2:0 and 4:2:2 frames and JPEGs of the 4:2:0 one (ri=1, ri=2
    and restart-free), written once."""
    d = tmp_path_factory.mktemp("cli")
    out = {}
    for sub in ("420", "422"):
        frame = synth_frame(sub, W, H, seed=int(sub))
        out[f"raw{sub}"] = d / f"in{sub}.yuv"
        with open(out[f"raw{sub}"], "wb") as f:
            frame.output(f)
        if sub == "420":
            for ri in (1, 2, 0):
                out[f"jpg{ri}"] = d / f"ri{ri}.jpg"
                out[f"jpg{ri}"].write_bytes(encode(sub, frame, 75, ri))
    two = d / "two420.yuv"
    two.write_bytes(out["raw420"].read_bytes() * 2)
    out["raw420x2"] = two
    raw = np.frombuffer(two.read_bytes(), np.uint8)
    noise = np.random.default_rng(3).integers(-4, 5, raw.shape)
    out["noisy420x2"] = d / "noisy420.yuv"
    out["noisy420x2"].write_bytes(
        np.clip(raw + noise, 0, 255).astype(np.uint8).tobytes())
    return out


def _run(main, argv, capsys, stdin: str | None = None, monkeypatch=None):
    if stdin is not None:
        monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
    rc = main([str(a) for a in argv])
    cap = capsys.readouterr()
    return rc, cap.out


def _both(j_main, t_main, argv, capsys, device_at=None, **kw):
    """(JAX rc, stdout), (port rc, stdout): the port gets ``--device cpu``
    after argv[:device_at] (at the end when None)."""
    j = _run(j_main, argv, capsys, **kw)
    at = len(argv) if device_at is None else device_at
    t = _run(t_main, argv[:at] + ["--device", "cpu"] + argv[at:], capsys,
             **kw)
    return j, t


@pytest.mark.parametrize("ri", [1, 2, 0])
@pytest.mark.parametrize("resync", [False, True])
def test_model_cli_decode_frame(files, tmp_path, capsys, ri, resync):
    flag = ["--resync"] if resync else []
    outs = {}
    for name, main, engine in (("jax", j_model.main, "model"),
                               ("model", t_model.main, "model"),
                               ("torch", t_model.main, "torch")):
        outs[name] = tmp_path / f"{name}.yuv"
        argv = ["--engine", engine]
        if engine == "torch":
            argv += ["--device", "cpu"]
        rc, _ = _run(main, argv + ["decode", "frame", files[f"jpg{ri}"],
                                   outs[name]] + flag, capsys)
        assert rc == 0
    ref = outs["jax"].read_bytes()
    assert len(ref) == W * H * 3 // 2
    assert outs["model"].read_bytes() == ref
    assert outs["torch"].read_bytes() == ref


@pytest.mark.parametrize("cmd", [["decode", "header"],
                                 ["decode", "log", "--num-blocks", "3"]])
def test_model_cli_decode_text(files, capsys, cmd):
    argv = cmd[:2] + [files["jpg1"]] + cmd[2:]
    j = _run(j_model.main, argv, capsys)
    t = _run(t_model.main, argv, capsys)
    assert j == t and j[0] == 0 and j[1]


@pytest.mark.parametrize("engine", ["model", "torch"])
@pytest.mark.parametrize("chroma,ri", [("420", 1), ("420", 0), ("422", 2)])
def test_model_cli_encode_frame(files, tmp_path, capsys, engine, chroma,
                                ri):
    args = ["--size", f"{W}x{H}", "--quality", "80", "--chroma", chroma,
            "--restart-interval", str(ri)]
    ref = tmp_path / "jax.jpg"
    got = tmp_path / "port.jpg"
    assert _run(j_model.main, ["encode", "frame", files[f"raw{chroma}"], ref]
                + args, capsys)[0] == 0
    argv = ["--engine", engine] + (["--device", "cpu"] if engine == "torch"
                                   else [])
    assert _run(t_model.main, argv + ["encode", "frame",
                                      files[f"raw{chroma}"], got] + args,
                capsys)[0] == 0
    assert got.read_bytes() == ref.read_bytes()


def test_model_cli_encode_log(files, capsys):
    argv = ["encode", "log", files["raw420"], "--size", f"{W}x{H}",
            "--num-blocks", "2", "--verbose"]
    j = _run(j_model.main, argv, capsys)
    t = _run(t_model.main, argv, capsys)
    assert j == t and "error:" in t[1]


@pytest.mark.parametrize("cmd", ["decoder", "decoder-accelerator"])
@pytest.mark.parametrize("entropy", ["native", "tpu"])
def test_simulate_decoder(files, tmp_path, capsys, cmd, entropy):
    j_yuv, t_yuv = tmp_path / "j.yuv", tmp_path / "t.yuv"
    j = _run(j_simulate.main, [cmd, files["jpg1"], "--yuv", j_yuv,
                               "--entropy", entropy], capsys)
    t = _run(t_simulate.main, [cmd, files["jpg1"], "--yuv", t_yuv,
                               "--entropy", entropy, "--device", "cpu"],
             capsys)
    assert j == t and t[0] == 0 and "PASS" in t[1]
    assert t_yuv.read_bytes() == j_yuv.read_bytes()


@pytest.mark.parametrize("entropy", ["tpu", "native"])
@pytest.mark.parametrize("ri", [1, 0])
def test_simulate_codeblock(files, capsys, entropy, ri):
    j, t = _both(j_simulate.main, t_simulate.main,
                 ["codeblock", files[f"jpg{ri}"], "--entropy", entropy],
                 capsys)
    assert j == t and t[0] == 0 and "0 mismatched" in t[1]


@pytest.mark.parametrize("chroma,ri", [("420", 2), ("422", 0)])
def test_simulate_encoder_accelerator(files, capsys, chroma, ri):
    j, t = _both(j_simulate.main, t_simulate.main,
                 ["encoder-accelerator", files[f"raw{chroma}"], "--size",
                  f"{W}x{H}", "--chroma", chroma, "--restart-interval", ri],
                 capsys)
    assert j == t and t[0] == 0 and "byte-identical" in t[1]


def test_simulate_filter_stuffed_bytes(files, capsys):
    # host-only in the port: no --device, as in the JAX package
    argv = ["filter-stuffed-bytes", files["jpg1"], "--count", "40"]
    j, t = (_run(main, argv, capsys)
            for main in (j_simulate.main, t_simulate.main))
    with pytest.raises(SystemExit):
        _run(t_simulate.main, argv + ["--device", "cpu"], capsys)
    # both compare their C++ engine's destuffer with the model extractor
    # and with their Python tier
    assert t == j
    assert t[0] == 0 and "native == model: True" in t[1]
    assert "40/40 match" in t[1]


def test_simulate_inspect(files, capsys, monkeypatch):
    j, t = _both(j_simulate.main, t_simulate.main,
                 ["inspect", files["jpg1"], "--block", "2", "--stages"],
                 capsys)
    assert j == t and t[0] == 0 and "reconstruction:" in t[1]
    j, t = _both(j_simulate.main, t_simulate.main,
                 ["inspect", files["jpg1"]], capsys,
                 stdin="n\ng 5\nd\nq\n", monkeypatch=monkeypatch)
    assert j == t and "block 5/" in t[1] and "no differing block" in t[1]


@pytest.mark.parametrize("argv", [
    ["compare", "max-difference", "yuv"],
    ["compare", "psnr", "y"],
    ["compare", "mse", "yuv-444"]])
def test_oyuv_compare(files, capsys, argv):
    args = argv + [files["raw420x2"], files["noisy420x2"], "--size",
                   f"{W}x{H}", "--format", "420"]
    j = _run(j_oyuv.main, args, capsys)
    t = _run(t_oyuv.main, args, capsys)
    assert j == t and t[1].count("\n") == 2


@pytest.mark.parametrize("src,fin,fout", [("raw420", "420", "444"),
                                          ("raw422", "422", "yuy2"),
                                          ("raw420x2", "420", "422")])
def test_oyuv_convert(files, tmp_path, capsys, src, fin, fout):
    outs = []
    for name, main in (("j", j_oyuv.main), ("t", t_oyuv.main)):
        out = tmp_path / f"{name}.out"
        assert _run(main, ["convert", files[src], out, "--size", f"{W}x{H}",
                           "--in-format", fin, "--out-format", fout],
                    capsys)[0] == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and outs[0]


def test_oyuv_play_headless(files, tmp_path, capsys):
    dirs = []
    for name, main in (("j", j_oyuv.main), ("t", t_oyuv.main)):
        d = tmp_path / name
        assert _run(main, ["play", files["raw420x2"], "--size", f"{W}x{H}",
                           "--out-dir", d, "--grid"], capsys)[0] == 0
        dirs.append({p.name: p.read_bytes() for p in sorted(d.iterdir())})
    assert dirs[0] == dirs[1] and len(dirs[0]) == 2


@pytest.mark.parametrize("argv", [
    ["forward", "--count", "30"], ["inverse", "--count", "30"],
    ["both", "--count", "30", "--rom-prec", "10"],
    ["search", "--rom-min", "10", "--rom-max", "11", "--transpose-min", "1",
     "--transpose-max", "2", "--count", "10"]])
def test_dct_tool(capsys, argv):
    j = _run(j_dct.main, argv, capsys)
    t = _run(t_dct.main, argv, capsys)
    assert j == t and t[0] == 0 and t[1]


def _parser_choices(main, capsys) -> list:
    with pytest.raises(SystemExit):
        main(["--help"])
    out = capsys.readouterr().out
    return sorted(out.split("{", 1)[1].split("}", 1)[0].split(","))


def test_generate_artifacts_and_no_nvcc(capsys, monkeypatch):
    assert _parser_choices(t_generate.main, capsys) == \
        _parser_choices(j_generate.main, capsys) == sorted(
            j_generate.ARTIFACTS)
    if shutil.which("nvcc") or pathlib.Path(
            "/usr/local/cuda/bin/nvcc").exists():
        def no_nvcc():
            raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                               "built")
        monkeypatch.setattr(kernels, "_nvcc", no_nvcc)
    for art in sorted(t_generate.ARTIFACTS):
        rc, out = _run(t_generate.main, [art], capsys)
        assert rc != 0 and out == ""
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert t_generate.codec_step_mesh(8).endswith("= (1, 4) over 4 rank(s) "
                                                  "of 4")
    assert t_generate.codec_step_mesh(2).endswith("= (1, 2) over 2 rank(s) "
                                                  "of 4")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert t_generate.codec_step_mesh(4).endswith("= (1, 1) over 1 rank(s) "
                                                  "of 1")
