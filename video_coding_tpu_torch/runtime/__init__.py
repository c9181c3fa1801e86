"""Decoder, encoder and transcode sessions.

The sessions load on first use, so that the host modules under
``entropy`` can import ``runtime.trace`` without loading the engine that
imports them."""

__all__ = ["JpegDecoderSession", "JpegEncoderSession",
           "JpegTranscodeSession", "decode_jpeg", "encode_jpeg",
           "resolve_device"]


def __getattr__(name: str):
    if name in __all__:
        from . import engine

        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
