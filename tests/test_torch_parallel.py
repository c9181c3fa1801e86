"""The port's multi-device layer (``video_coding_tpu_torch/parallel`` and
the sessions' ``mesh=``) against the JAX package, on the CPU.

Each world size (1, 2 and 4 gloo ranks) is one run of
``tests/_torch_dist_worker.py``, a process a rank, that checks every mesh
that world allows ((1, n) row-major, and at four ranks (2, 2) and a
two-rank mesh smaller than the world) and writes each rank's results. The
JAX package's results come from the conftest's virtual CPU devices
(``codec_mesh(4)``, ``codec_mesh(4, seg_parallel=2)``) or from one device.
Integer outputs are held equal; a PSNR (float32 sums in another order)
within 1e-4 dB. No process group is ever made in this process.
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
from video_coding_tpu.common.bitstream import BitReader
from video_coding_tpu.common.frame import ChromaSubsampling, Frame
from video_coding_tpu.common.plane import Plane
from video_coding_tpu.entropy import tpu_decode
from video_coding_tpu.entropy.tables import pack_decoder_tables
from video_coding_tpu.model import decoder as mdec
from video_coding_tpu.model import encoder as menc
from video_coding_tpu.ops import datapath
from video_coding_tpu.parallel import (codec_mesh, distributed_psnr,
                                       mjpeg_codec_step, rate_estimate_bits,
                                       sharded_decode_e2e)
from video_coding_tpu.runtime.engine import (JpegEncoderSession,
                                             JpegTranscodeSession)

WORLDS = (1, 2, 4)
PSNR_TOL_DB = 1e-4
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_ROOT, "tests", "_torch_dist_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, tmp_path_factory):
    """One gloo run of ``world`` ranks → each rank's results."""
    world = request.param
    out = tmp_path_factory.mktemp(f"world{world}")
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=_ROOT)
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, str(world), str(r), port, str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=400)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"RANK{r} OK" in log, log[-4000:]
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]


def _tags(res: dict) -> list:
    return sorted({k.split("/")[0] for k in res if "/" in k
                   and not k.endswith("/shape")})


def _frame(planes) -> Frame:
    return Frame(*(Plane(data=p) for p in planes), ChromaSubsampling.C420)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's results on the worker's inputs."""
    assert len(jax.devices()) >= 4
    meshes = {"1x4": codec_mesh(4), "2x2": codec_mesh(4, seg_parallel=2)}
    ref = {}
    coefs, dquant, pixels, equant = worker.datapath_inputs()
    ref["decode_datapath"] = np.asarray(
        datapath.decode_datapath_jnp(coefs, dquant))
    ref["encode_datapath"] = np.asarray(
        datapath.encode_datapath_jnp(pixels, equant))
    ref["roundtrip"] = np.asarray(datapath.decode_datapath_jnp(
        ref["encode_datapath"], equant))
    frames, quant = worker.codec_step_inputs()
    for name, mesh in meshes.items():
        qc, recon, rates, psnr = mjpeg_codec_step(mesh, frames, quant)
        ref[f"step/{name}"] = (np.asarray(qc), np.asarray(recon),
                               np.asarray(rates), float(psnr))
    ref["rate_estimate"] = np.asarray(rate_estimate_bits(
        ref["step/1x4"][0].reshape(-1, 64)))
    a, b = worker.psnr_inputs()
    ref["psnr"] = float(distributed_psnr(meshes["1x4"], a, b))

    stream = menc.encode_420(_frame(worker.synth_planes(64, 64, 7)),
                             worker.QUALITY, restart_interval=1)
    bits = BitReader(stream)
    dec = mdec.Decoder(mdec.Header.decode(bits), bits)
    segbytes, _ = tpu_decode.pack_segments(dec.entropy_segments)
    B = 6
    comp_idx = np.array([s[0] for s in dec.block_schedule()], np.int32)
    tables = pack_decoder_tables([c.dc_tab for c in dec.components],
                                 [c.ac_tab for c in dec.components])
    qtabs = np.stack([c.quant_table for c in dec.components]).astype(np.int32)
    ref["decode_e2e"] = np.asarray(sharded_decode_e2e(
        meshes["1x4"], segbytes, np.full(len(segbytes), B, np.int32),
        comp_idx[:B], *tpu_decode.expand_luts(tables), qtabs[comp_idx[:B]],
        blocks_per_segment=B))

    for w, h, ri, _pack in worker.SESSION_CASES:
        case = f"{w}x{h}ri{ri}"
        frame = _frame(worker.synth_planes(w, h, w + ri))
        s_ref = JpegEncoderSession(menc.Parameters.c420(w, h, worker.QUALITY),
                                   restart_interval=ri).encode(frame)
        golden = mdec.decode_a_frame(s_ref)
        bits = BitReader(s_ref)
        header = mdec.Header.decode(bits)
        payload = s_ref[bits.bit_pos >> 3:]
        ref[f"{case}/stream"] = s_ref
        ref[f"{case}/golden"] = [getattr(golden, p).data for p in "yuv"]
        if ri == 1:
            ref[f"{case}/transcode"] = JpegTranscodeSession(
                header, quality=worker.TRANSCODE_QUALITY, restart_interval=1,
                entropy_out="device").transcode(payload)
    return ref


def test_mesh_shapes_and_make_mesh_past_the_world(ranks):
    world = len(ranks)
    for r, res in enumerate(ranks):
        assert res["make_mesh_raises"].all()
        assert tuple(res[f"all{world}/shape"]) == (1, world)
        if world == 4:
            assert tuple(res["2x2/shape"]) == (2, 2)
            assert tuple(res["sub2/shape"]) == (1, 2)
            # ranks off the smaller mesh take no part in its work
            assert ("sub2/step_qc" in res) == (r < 2)


def test_sharded_datapaths_exact(ranks, jax_ref):
    for res in ranks:
        for tag in _tags(res):
            n = int(np.prod(res[f"{tag}/shape"]))
            for name in ("decode_datapath", "encode_datapath", "roundtrip"):
                assert np.array_equal(res[f"{tag}/{name}"], jax_ref[name]), \
                    (tag, name)
            assert tuple(res[f"{tag}/sharded_local_rows"]) == (256 // n,
                                                               128 // n)


def test_mjpeg_codec_step_matches_jax(ranks, jax_ref):
    for res in ranks:
        for tag in _tags(res):
            qc, recon, rates, psnr = jax_ref[
                "step/2x2" if tag == "2x2" else "step/1x4"]
            assert np.array_equal(res[f"{tag}/step_qc"], qc)
            assert np.array_equal(res[f"{tag}/step_recon"], recon)
            assert np.array_equal(res[f"{tag}/step_rates"], rates)
            assert abs(float(res[f"{tag}/step_psnr"]) - psnr) < PSNR_TOL_DB


def test_multihost_step_equals_codec_step(ranks):
    for res in ranks:
        for tag in _tags(res):
            assert res[f"{tag}/multihost_equal"].all()
            assert float(res[f"{tag}/multihost_psnr"]) == pytest.approx(
                float(res[f"{tag}/step_psnr"]), abs=PSNR_TOL_DB)


def test_distributed_psnr_and_rate_estimate(ranks, jax_ref):
    a, b = worker.psnr_inputs()
    expect = 10 * np.log10(255.0 ** 2 / np.mean(
        (a.astype(float) - b.astype(float)) ** 2))
    for res in ranks:
        for tag in _tags(res):
            got = float(res[f"{tag}/psnr"])
            assert abs(got - jax_ref["psnr"]) < PSNR_TOL_DB
            assert abs(got - expect) < 1e-3
            assert np.array_equal(res[f"{tag}/rate_estimate"],
                                  jax_ref["rate_estimate"])


def test_sharded_decode_e2e_exact(ranks, jax_ref):
    for res in ranks:
        for tag in _tags(res):
            n = int(np.prod(res[f"{tag}/shape"]))
            assert np.array_equal(res[f"{tag}/decode_e2e"],
                                  jax_ref["decode_e2e"])
            assert tuple(res[f"{tag}/decode_e2e_sharded"]) == (1, 16 // n)


def test_sharded_encoder_bytes_equal_jax_host_encoder(ranks, jax_ref):
    """Encode bytes under every mesh (non-divisible segment counts, a
    short last segment, the fused and split packers) equal the JAX
    package's host encoder."""
    for res in ranks:
        for tag in _tags(res):
            for w, h, ri, _pack in worker.SESSION_CASES:
                case = f"{w}x{h}ri{ri}"
                assert res[f"{tag}/{case}/stream"].tobytes() == \
                    jax_ref[f"{case}/stream"], (tag, case)
                assert res[f"{tag}/{case}/batch_equal"].all()


def test_sharded_decoder_equals_golden_model(ranks, jax_ref):
    for res in ranks:
        for tag in _tags(res):
            n = int(np.prod(res[f"{tag}/shape"]))
            for w, h, ri, _pack in worker.SESSION_CASES:
                case = f"{w}x{h}ri{ri}"
                golden = jax_ref[f"{case}/golden"]
                flat = np.concatenate([g.ravel() for g in golden])
                assert np.array_equal(res[f"{tag}/{case}/decode"], flat)
                for got in res[f"{tag}/{case}/decode_batch"]:
                    assert np.array_equal(got, flat)
                stacked = np.concatenate(
                    [np.stack([g] * n).ravel() for g in golden])
                assert np.array_equal(res[f"{tag}/{case}/stacked"], stacked)
                # frame-sharded DTensors, one frame a rank
                assert res[f"{tag}/{case}/stacked_sharded"].all()
                assert tuple(res[f"{tag}/{case}/batch_iter"]) == (2, 1)


def test_sharded_transcode_equals_jax(ranks, jax_ref):
    for res in ranks:
        for tag in _tags(res):
            for w, h, ri, _pack in worker.SESSION_CASES:
                if ri != 1:
                    continue
                case = f"{w}x{h}ri{ri}"
                assert res[f"{tag}/{case}/transcode"].tobytes() == \
                    jax_ref[f"{case}/transcode"], (tag, case)
                assert res[f"{tag}/{case}/transcode_batch_equal"].all()


def test_sharded_dataset_equals_unsharded(ranks):
    for res in ranks:
        for tag in _tags(res):
            flags = res[f"{tag}/dataset"]
            assert flags.size == 1 + 2 * 2 and flags.all(), (tag, flags)


def test_replicated_results_equal_on_every_rank(ranks):
    """What JAX replicates (rates, PSNR, gathered planes, wire bytes) is
    the same on every rank of a mesh."""
    for res in ranks[1:]:
        for key, value in res.items():
            if key in ranks[0] and "sharded_local_rows" not in key \
                    and "decode_e2e_sharded" not in key:
                assert np.array_equal(value, ranks[0][key]), key


def test_mesh_needs_a_process_group_and_the_card(monkeypatch):
    from video_coding_tpu_torch.parallel import make_mesh
    from video_coding_tpu_torch.parallel import codec_mesh as t_codec_mesh
    from video_coding_tpu_torch.parallel.multihost import initialize
    from video_coding_tpu_torch.runtime.dataset import JpegRgbDataset

    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        t_codec_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh((1, 1), ("data", "seg"), device_type="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_codec_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize("127.0.0.1:1", 2, 0)
    initialize("127.0.0.1:1", 1, 0)      # one process: nothing to join
    assert not torch.distributed.is_initialized()
    with pytest.raises(TypeError, match="DeviceMesh"):
        JpegRgbDataset([b""], sharding="data")
