"""Multi-device layer: rank meshes and sharded codec pipelines over
``torch.distributed`` (NCCL on the card, gloo on the CPU).

- **data axis**: frames of a Motion-JPEG stream sharded across ranks.
- **seg axis**: restart-interval segments (blocks) within a frame sharded
  across ranks — the parallelism DRI/RSTn allows.

One rank drives one device. Collectives are explicit: ``all_reduce`` for
distributed quality metrics and rates, ``all_gather_into_tensor`` for the
segment length exchange of parallel bitstream assembly (the sessions'
``mesh=``, ``runtime/engine.py``).
"""

from .mesh import codec_mesh, make_mesh
from .multihost import (global_codec_mesh, local_frames_to_global,
                        mjpeg_multihost_step)
from .pipeline import (distributed_psnr, mjpeg_codec_step, rate_estimate_bits,
                       rate_exact_bits, sharded_decode_datapath,
                       sharded_decode_e2e, sharded_encode_datapath)

__all__ = [
    "make_mesh",
    "codec_mesh",
    "sharded_decode_datapath",
    "sharded_encode_datapath",
    "sharded_decode_e2e",
    "mjpeg_codec_step",
    "distributed_psnr",
    "rate_estimate_bits",
    "rate_exact_bits",
    "global_codec_mesh",
    "local_frames_to_global",
    "mjpeg_multihost_step",
]
