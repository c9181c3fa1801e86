"""generate: print the compiled device code of the framework's device
graphs.

Capability parity with reference jpeg/bin/generate.ml (:4-72), which
elaborates the RTL and prints Verilog, and with the JAX package's tool,
which prints the StableHLO of its jitted graphs. The port's device code is
its hand-written kernels, so for each artifact this tool prints the PTX
(``nvcc -ptx`` for sm_90a, from ``csrc/`` into the build directory) of the
kernels that artifact launches, or with ``--compiled`` their SASS from the
built library (``cuobjdump -sass``):

  decoder          K2 (the decode datapath)
  encoder          K3 (the encode datapath)
  entropy-decoder  K5, K1 and the decode lookup table
  codec-step       K3 and K2, and the rank mesh it would run on

Needs the CUDA toolkit; without ``nvcc`` it exits nonzero.
"""

from __future__ import annotations

import argparse
import sys

# artifact → (source, kernel entry) of each kernel it launches
ARTIFACTS = {
    "decoder": (("decode_datapath.cu", "decode_datapath_kernel"),),
    "encoder": (("encode_datapath.cu", "encode_datapath_kernel"),),
    "entropy-decoder": (
        ("huffman_decode_padded.cu", "huffman_decode_padded_kernel"),
        ("huffman_decode.cu", "huffman_decode_kernel"),
        ("huffman_lut.cu", "lut_level1_kernel"),
        ("huffman_lut.cu", "lut_level2_kernel")),
    "codec-step": (("encode_datapath.cu", "encode_datapath_kernel"),
                   ("decode_datapath.cu", "decode_datapath_kernel")),
}


def codec_step_mesh(n_devices: int) -> str:
    """The ('data', 'seg') mesh ``parallel.codec_mesh`` lays over
    min(n_devices, the ranks there are): the process group's world, else
    this host's cards, else one."""
    import torch
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        have = dist.get_world_size()
    else:
        have = max(1, torch.cuda.device_count())
    n = max(1, min(n_devices, have))
    seg = next((c for c in (4, 2) if n % c == 0), 1)
    return (f"// codec-step mesh ('data', 'seg') = ({n // seg}, {seg}) over "
            f"{n} rank(s) of {have}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="vct-torch-generate",
        description="print the PTX (or SASS) of a device graph's kernels")
    p.add_argument("artifact", choices=sorted(ARTIFACTS))
    p.add_argument("--blocks", type=int, default=512,
                   help="device count (codec-step); the kernels' code does "
                        "not depend on a batch size")
    p.add_argument("--compiled", action="store_true",
                   help="print the SASS of the built library instead")
    args = p.parse_args(argv)

    from .. import kernels

    parts = ARTIFACTS[args.artifact]
    try:
        if args.compiled:
            text = kernels.sass(tuple(k for _src, k in parts))
        else:
            text = "\n".join(f"// {src}\n{kernels.ptx(src)}"
                             for src in dict.fromkeys(s for s, _k in parts))
    except RuntimeError as err:
        print(f"vct-torch-generate: {err}", file=sys.stderr)
        return 1
    print(text)
    if args.artifact == "codec-step":
        print(codec_step_mesh(args.blocks))
    return 0


if __name__ == "__main__":
    sys.exit(main())
