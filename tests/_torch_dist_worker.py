"""One rank of a gloo run of the port's multi-device layer on the CPU.

    python tests/_torch_dist_worker.py WORLD RANK PORT OUT_DIR

Every rank joins a gloo process group of WORLD ranks at
tcp://127.0.0.1:PORT, builds the same inputs from fixed seeds with numpy,
runs every sharded function and mesh session of the port on each mesh
this world allows, and writes what it got to OUT_DIR/rank<RANK>.npz for
the parent test (tests/test_torch_parallel.py) to hold against the JAX
package. Imports torch and the port only; the input functions below are
shared with the parent test.
"""

from __future__ import annotations

import sys

import numpy as np

# the sharded sessions' cases: (width, height, restart interval,
# device_pack); 91 segments of 208x112 do not divide 2 or 4 ranks, ri=4
# leaves a short last segment, ri=6 (36 blocks a segment) takes the split
# packer, and 32x16 at ri=3 is one segment shorter than its interval
SESSION_CASES = ((192, 128, 1, "auto"), (208, 112, 1, "auto"),
                 (208, 112, 4, "pallas"), (208, 112, 6, "pallas"),
                 (32, 16, 3, "pallas"))
QUALITY = 75
TRANSCODE_QUALITY = 50
DATASET_FRAMES = 5


def synth_planes(w: int, h: int, seed: int):
    """(y, u, v) uint8 planes of a 4:2:0 frame: gradients, texture, a
    hard-edged block and noise."""
    rng = np.random.default_rng(seed)

    def plane(pw, ph, base):
        yy, xx = np.mgrid[0:ph, 0:pw]
        p = base + 60 * np.sin(xx / 7.0) * np.cos(yy / 5.0) + 0.4 * xx
        x0, y0 = rng.integers(0, pw // 2), rng.integers(0, ph // 2)
        p[y0:y0 + ph // 3, x0:x0 + pw // 3] = rng.integers(0, 256)
        return np.clip(p + rng.normal(0, 8, p.shape), 0, 255).astype(
            np.uint8)

    return plane(w, h, 100), plane(w // 2, h // 2, 128), \
        plane(w // 2, h // 2, 128)


def datapath_inputs():
    rng = np.random.default_rng(0)
    coefs = rng.integers(-500, 500, size=(256, 64)).astype(np.int32)
    dquant = rng.integers(1, 256, size=(256, 64)).astype(np.int32)
    pixels = rng.integers(0, 256, size=(128, 8, 8)).astype(np.uint8)
    equant = rng.integers(1, 256, size=(128, 64)).astype(np.int32)
    return coefs, dquant, pixels, equant


def codec_step_inputs():
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, size=(4, 16, 8, 8)).astype(np.uint8)
    quant = rng.integers(1, 64, size=(16, 64)).astype(np.int32)
    return frames, quant


def psnr_inputs():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, size=(64, 64)).astype(np.int32)
    b = np.clip(a + rng.integers(-5, 6, a.shape), 0, 255).astype(np.int32)
    return a, b


def meshes(world: int):
    """(tag, n_devices, seg_parallel) of every mesh a world of this size
    is checked on: every rank, row-major (1, n) and, at four ranks, (2, 2)
    and a two-rank mesh smaller than the world."""
    out = [(f"all{world}", world, None)]
    if world == 4:
        out += [("2x2", 4, 2), ("sub2", 2, None)]
    return out


def _payload(stream: bytes):
    from video_coding_tpu_torch.common.bitstream import BitReader
    from video_coding_tpu_torch.model.header import Header

    bits = BitReader(stream)
    header = Header.decode(bits)
    return header, stream[bits.bit_pos >> 3:]


def run_pipelines(mesh, tag: str, res: dict) -> None:
    import torch
    from torch.distributed.tensor import DTensor

    from video_coding_tpu_torch.common.frame import ChromaSubsampling, Frame
    from video_coding_tpu_torch.common.plane import Plane
    from video_coding_tpu_torch.entropy.decode_tables import pack_segments
    from video_coding_tpu_torch.entropy.scan import destuff_segments
    from video_coding_tpu_torch.entropy.tables import pack_decoder_tables
    from video_coding_tpu_torch.model import encoder as menc
    from video_coding_tpu_torch.model.header import DecoderGeometry
    from video_coding_tpu_torch.parallel import (
        distributed_psnr, mjpeg_codec_step, mjpeg_multihost_step,
        rate_estimate_bits, sharded_decode_datapath, sharded_decode_e2e,
        sharded_encode_datapath)

    coefs, dquant, pixels, equant = datapath_inputs()
    dec = sharded_decode_datapath(mesh, coefs, dquant)
    enc = sharded_encode_datapath(mesh, pixels, equant)
    res[f"{tag}/decode_datapath"] = dec.full_tensor().numpy()
    res[f"{tag}/encode_datapath"] = enc.full_tensor().numpy()
    res[f"{tag}/sharded_local_rows"] = np.array(
        [dec.to_local().shape[0], enc.to_local().shape[0]])
    # a DTensor feeds the next sharded stage as it is
    res[f"{tag}/roundtrip"] = sharded_decode_datapath(
        mesh, enc, equant).full_tensor().numpy()

    frames, quant = codec_step_inputs()
    qc, recon, rates, psnr = mjpeg_codec_step(mesh, frames, quant)
    res[f"{tag}/step_qc"] = qc.full_tensor().numpy()
    res[f"{tag}/step_recon"] = recon.full_tensor().numpy()
    res[f"{tag}/step_rates"] = rates.numpy()
    res[f"{tag}/step_psnr"] = np.float64(psnr)
    res[f"{tag}/rate_estimate"] = rate_estimate_bits(
        qc.full_tensor().reshape(-1, 64)).numpy()
    d = mesh.get_coordinate()[0]
    D = mesh.shape[0]
    f_local = frames.shape[0] // D
    m_qc, m_recon, m_rates, m_psnr = mjpeg_multihost_step(
        mesh, frames[d * f_local:(d + 1) * f_local], quant)
    res[f"{tag}/multihost_equal"] = np.array([
        torch.equal(m_qc.full_tensor(), qc.full_tensor()),
        torch.equal(m_recon.full_tensor(), recon.full_tensor()),
        torch.equal(m_rates, rates)])
    res[f"{tag}/multihost_psnr"] = np.float64(m_psnr)

    a, b = psnr_inputs()
    res[f"{tag}/psnr"] = np.float64(distributed_psnr(mesh, a, b))

    y, u, v = synth_planes(64, 64, 7)
    frame = Frame(Plane(data=y), Plane(data=u), Plane(data=v),
                  ChromaSubsampling.C420)
    stream = menc.encode_420(frame, QUALITY, restart_interval=1)
    header, payload = _payload(stream)
    dm = DecoderGeometry(header)
    segbytes, _lens = pack_segments(destuff_segments(payload))
    B = 6
    comp_idx = np.array([s[0] for s in dm.block_schedule()], np.int32)
    tables = pack_decoder_tables([c.dc_tab for c in dm.components],
                                 [c.ac_tab for c in dm.components])
    qtabs = np.stack([c.quant_table for c in dm.components]) \
        .astype(np.int32)
    px = sharded_decode_e2e(mesh, segbytes, np.full(len(segbytes), B,
                                                    np.int32),
                            comp_idx[:B], tables, qtabs[comp_idx[:B]],
                            blocks_per_segment=B)
    res[f"{tag}/decode_e2e"] = px.full_tensor().numpy()
    res[f"{tag}/decode_e2e_sharded"] = np.array(
        [isinstance(px, DTensor), px.to_local().shape[0]])


def run_sessions(mesh, tag: str, res: dict) -> None:
    from torch.distributed.tensor import DTensor, Shard

    from video_coding_tpu_torch.common.frame import ChromaSubsampling, Frame
    from video_coding_tpu_torch.common.plane import Plane
    from video_coding_tpu_torch.model.header import Parameters
    from video_coding_tpu_torch.runtime.engine import (JpegDecoderSession,
                                                       JpegEncoderSession,
                                                       JpegTranscodeSession)

    n = mesh.size()
    for w, h, ri, pack in SESSION_CASES:
        case = f"{tag}/{w}x{h}ri{ri}"
        planes = synth_planes(w, h, w + ri)
        frame = Frame(*(Plane(data=p) for p in planes),
                      ChromaSubsampling.C420)
        enc = JpegEncoderSession(Parameters.c420(w, h, QUALITY), ri,
                                 device_pack=pack, mesh=mesh)
        stream = enc.encode_device(frame)
        res[f"{case}/stream"] = np.frombuffer(stream, np.uint8)
        res[f"{case}/batch_equal"] = np.array(
            [o == stream for o in enc.encode_device_batch([frame] * 2)])
        header, payload = _payload(stream)
        dec = JpegDecoderSession(header, mesh=mesh)
        got = dec.decode_device(payload)
        res[f"{case}/decode"] = np.concatenate(
            [getattr(got, p).data.ravel() for p in "yuv"])
        batch = dec.decode_device_batch([payload] * 2)
        res[f"{case}/decode_batch"] = np.stack([np.concatenate(
            [getattr(dec._to_frame(f), p).data.ravel() for p in "yuv"])
            for f in batch])
        stacked = dec.decode_device_batch_stacked([payload] * n)
        res[f"{case}/stacked"] = np.concatenate(
            [s.full_tensor().numpy().ravel() for s in stacked])
        res[f"{case}/stacked_sharded"] = np.array([
            all(isinstance(s, DTensor)
                and all(p == Shard(0) for p in s.placements)
                and s.to_local().shape[0] == 1 for s in stacked)])
        iters = list(dec.decode_device_batch_iter([payload] * 3, batch=2))
        res[f"{case}/batch_iter"] = np.array([
            len(iters), iters[1][0].shape[0]])
        if ri == 1:
            trans = JpegTranscodeSession(header, quality=TRANSCODE_QUALITY,
                                         restart_interval=1, mesh=mesh)
            one = trans.transcode(payload)
            res[f"{case}/transcode"] = np.frombuffer(one, np.uint8)
            outs = trans.transcode_batch([payload] * 2) + list(
                trans.transcode_batch_iter([payload] * 3, batch=2))
            res[f"{case}/transcode_batch_equal"] = np.array(
                [o == one for o in outs])


def run_dataset(mesh, tag: str, res: dict) -> None:
    import torch

    from video_coding_tpu_torch.model.header import Parameters
    from video_coding_tpu_torch.runtime.dataset import JpegRgbDataset
    from video_coding_tpu_torch.runtime.engine import JpegEncoderSession

    enc = JpegEncoderSession(Parameters.c420(64, 48, QUALITY), 1,
                             device="cpu")
    streams = enc.encode_device_batch(
        [synth_planes(64, 48, s) for s in range(DATASET_FRAMES)])
    plain = list(JpegRgbDataset(streams, batch_size=4, device="cpu"))
    sharded = list(JpegRgbDataset(streams, batch_size=4, sharding=mesh))
    res[f"{tag}/dataset"] = np.array(
        [len(plain) == len(sharded)]
        + [torch.equal(a, b.full_tensor()) for a, b in zip(plain, sharded)]
        + [b.to_local().shape[0] <= -(-b.shape[0] // mesh.size())
           for b in sharded])


def main(argv) -> int:
    world, rank, port, out_dir = (int(argv[1]), int(argv[2]), argv[3],
                                  argv[4])
    import torch.distributed as dist

    from video_coding_tpu_torch.parallel import codec_mesh, make_mesh
    from video_coding_tpu_torch.parallel.multihost import initialize

    if world == 1:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=1, rank=0)
    else:
        initialize(f"127.0.0.1:{port}", world, rank, device_type="cpu")
    res = {}
    try:
        make_mesh((world + 1,), ("x",), device_type="cpu")
    except ValueError:
        res["make_mesh_raises"] = np.array([True])
    for tag, n_dev, seg in meshes(world):
        mesh = codec_mesh(n_dev, seg, device_type="cpu")
        res[f"{tag}/shape"] = np.array(mesh.shape)
        if mesh.get_coordinate() is None:
            continue        # this rank is off a mesh smaller than the world
        run_pipelines(mesh, tag, res)
        run_sessions(mesh, tag, res)
        run_dataset(mesh, tag, res)
    np.savez(f"{out_dir}/rank{rank}.npz", **res)
    dist.destroy_process_group()
    print(f"RANK{rank} OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
