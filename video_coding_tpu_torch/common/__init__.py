"""Common runtime pieces: MSB-first bitstream reader and writer."""

from .bitstream import BitReader, BitWriter

__all__ = ["BitReader", "BitWriter"]
