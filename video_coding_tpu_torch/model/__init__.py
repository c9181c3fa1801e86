"""The golden model in numpy: marker records, Annex-K tables, zigzag,
quality scaling, the decoder/encoder geometry the sessions are built from,
the Chen DCT family, the single- and multi-scan decoders with the host
decoder pieces (segment walk, resync alignment, one-block Huffman decode)
and the encoder with its presets."""

from . import dct, huffman, marker_codes, markers, quant_tables, zigzag
from .decoder import Decoder, Header
from .encoder import Encoder, Parameters

__all__ = ["marker_codes", "markers", "zigzag", "quant_tables", "huffman",
           "dct", "Decoder", "Header", "Encoder", "Parameters"]
