"""Header-level model: marker records, Annex-K tables, zigzag, quality
scaling, the decoder/encoder geometry the sessions are built from, the
Chen DCT family, and the host decoder pieces (segment walk, resync
alignment, one-block Huffman decode, the multi-scan decoder)."""
