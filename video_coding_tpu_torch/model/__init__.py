"""Header-level model: marker records, Annex-K tables, zigzag, quality
scaling, and the decoder/encoder geometry the sessions are built from.
The pixel-level golden model stays in the reference package."""
