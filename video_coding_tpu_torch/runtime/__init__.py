"""Decoder, encoder and transcode sessions."""

from .engine import (JpegDecoderSession, JpegEncoderSession,
                     JpegTranscodeSession, resolve_device)

__all__ = ["JpegDecoderSession", "JpegEncoderSession",
           "JpegTranscodeSession", "resolve_device"]
