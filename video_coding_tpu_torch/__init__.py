"""video_coding_tpu_torch — the baseline JPEG codec in PyTorch and
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A second package beside ``video_coding_tpu`` (the JAX/Pallas reference).
It imports neither JAX nor the reference package; the host modules it
needs (bitstream I/O, markers, Huffman and quantization tables, zigzag)
are its own copies. Layout mirrors the reference:

- ``common``  — planes, frames, sizes, bitstream reader/writer.
- ``model``   — the golden model in numpy: marker records, Annex-K
  tables, header parse and the session geometry, the Chen DCT family, the
  decoders and the encoder.
- ``entropy`` — destuffing, table packing, the host coder and decoder,
  the Huffman decode kernels (K1, K5-K7), the entropy encoders (K4, K8
  with symbol construction) and wire assembly.
- ``ops``     — integer Chen transforms, K2/K3 (block datapaths), K9,
  the sparse transfer and the RGB tail (``color``).
- ``runtime`` — decoder, encoder and transcode sessions, the RGB dataset
  for training and tracing.
- ``tools``   — YUV containers, formats, resampling, comparison,
  conversion, playback and the MJPEG stream helpers.
- ``csrc``    — the CUDA sources of K1-K9 and the decode lookup table,
  built with nvcc at first use (``kernels.py``).

Every kernel wrapper runs its plain PyTorch version for CPU tensors and
launches its CUDA kernel (or raises) for CUDA tensors. Sessions run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
