"""Decoder, encoder and transcode sessions."""

from .engine import (JpegDecoderSession, JpegEncoderSession,
                     JpegTranscodeSession, decode_jpeg, encode_jpeg,
                     resolve_device)

__all__ = ["JpegDecoderSession", "JpegEncoderSession",
           "JpegTranscodeSession", "decode_jpeg", "encode_jpeg",
           "resolve_device"]
