"""Plain transcode reference for the MJPEG re-encode service: a JPEG in,
the same frame re-encoded at another quality and restart interval out,
with no floating point anywhere.

1. parse the source stream's coefficients (``baseline_jpeg``'s bit-serial
   Huffman decode);
2. dequantise, clamp to 12 bits, the integer Chen IDCT, clip, level shift:
   the decoded planes, padded to whole MCUs (``baseline_jpeg.reconstruct``);
3. crop the planes to the frame's actual size and zero-pad them again,
   level shift, the integer Chen forward DCT, quantise at the output
   quality rounding half away from zero, entropy-code with an RSTn every
   ``restart_interval`` MCUs and write the header (``baseline_jpeg.encode``).

Every stage is ``baseline_jpeg``'s plain Python and NumPy int64; the file
imports nothing of the program under test, neither the JAX package nor
its PyTorch port, nor PyTorch itself. Departures from ITU-T T.81: none;
the transforms are the golden model's integer Chen transforms, which
T.81 permits (it fixes no IDCT, only its accuracy).

``transcode(..., dct="float32")`` swaps the integer IDCT for the
orthonormal DCT as float32 matrix products: the lower-precision control
that has to fail the comparison. ``encode``, ``Layout``, ``Encoded`` and
``reconstruct`` are ``baseline_jpeg``'s: the benchmark makes its sources
with them.
"""

from __future__ import annotations

import pathlib

from portbench import harness

_bj = harness.load_module(pathlib.Path(__file__).with_name("baseline_jpeg.py"),
                          "baseline_jpeg")
Layout = _bj.Layout
Encoded = _bj.Encoded
encode = _bj.encode
reconstruct = _bj.reconstruct


def transcode(stream: bytes, quality_in: int, quality_out: int,
              restart_interval: int, dct: str = "chen"):
    """A whole source JPEG → the re-encoded JPEG (``Encoded``)."""
    coefs, layout = _bj.decode_coefs(stream)
    return _bj.encode(_bj.reconstruct(coefs, layout, quality_in, dct),
                      layout, quality_out, restart_interval)
