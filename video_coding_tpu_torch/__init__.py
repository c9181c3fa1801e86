"""video_coding_tpu_torch — the baseline JPEG transcode path in PyTorch
and hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A second package beside ``video_coding_tpu`` (the JAX/Pallas reference).
It imports neither JAX nor the reference package; the host modules it
needs (bitstream I/O, markers, Huffman and quantization tables, zigzag)
are its own copies. Layout mirrors the reference:

- ``common``  — bitstream reader/writer.
- ``model``   — marker records, Annex-K tables, header parse and the
  session geometry taken from the golden model.
- ``entropy`` — destuffing, table packing, K1 (Huffman decode), K4
  (entropy encode) and wire assembly.
- ``ops``     — integer Chen transforms and K2/K3 (block datapaths).
- ``runtime`` — decoder, encoder and transcode sessions.
- ``csrc``    — the CUDA sources of K1-K4, built with nvcc at first use
  (``kernels.py``).

Every kernel wrapper runs its plain PyTorch version for CPU tensors and
launches its CUDA kernel (or raises) for CUDA tensors. Sessions run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
