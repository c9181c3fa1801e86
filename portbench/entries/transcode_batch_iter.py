"""Entry point: ``JpegTranscodeSession.transcode_batch_iter`` — the
re-encode service's main path. Chunks of ``frames_per_dispatch`` source
JPEGs are decoded on the card and re-encoded there at ``QUALITY_OUT``
with a restart every ``RESTART_INTERVAL_OUT`` MCUs, ``depth`` chunks in
flight. A unit is one frame's output JPEG on the host: the budget
ladder's fetch has brought it back before it is yielded, so it is
complete then.

The output settings are constants of this file: a traffic mix has no key
for them, and ``expected`` does not see the configuration. ``open``
checks them against the configuration's ``quality_out`` and
``restart_interval_out``."""

from __future__ import annotations

QUALITY_OUT = 75
RESTART_INTERVAL_OUT = 1


def open(cell, layout, sources, device=None):
    from video_coding_tpu_torch.common.bitstream import BitReader
    from video_coding_tpu_torch.model.header import Header
    from video_coding_tpu_torch.runtime.engine import JpegTranscodeSession

    for key, value in (("quality_out", QUALITY_OUT),
                       ("restart_interval_out", RESTART_INTERVAL_OUT)):
        if cell.config.get(key) != value:
            raise ValueError(f"configuration {cell.config_name}: {key} is "
                             f"{cell.config.get(key)!r}, the entry codes "
                             f"{value}")
    header = Header.decode(BitReader(sources[0].encoded.stream))
    return Runner(JpegTranscodeSession(header, quality=QUALITY_OUT,
                                       restart_interval=RESTART_INTERVAL_OUT,
                                       device=device), cell.traffic)


def expected(ref, layout, source, traffic, dct="chen"):
    """The reference's re-encode of the source (``Encoded``: the stream,
    and the symbols and entropy bytes it codes)."""
    return ref.transcode(source.encoded.stream, traffic["quality_in"],
                         QUALITY_OUT, RESTART_INTERVAL_OUT, dct)


def _stream(out) -> bytes:
    return getattr(out, "stream", out)


class Runner:
    dispatch = "transcode_batch"
    unit_frames = 1

    def __init__(self, session, traffic):
        self.session = session
        self.traffic = traffic

    def stream(self, feed):
        return self.session.transcode_batch_iter(
            iter(feed), batch=self.traffic["frames_per_dispatch"],
            depth=self.traffic["depth"])

    @staticmethod
    def frames(unit) -> int:
        return 1

    def wait(self, unit) -> None:
        pass

    @staticmethod
    def to_host(unit) -> list:
        return [unit]

    @staticmethod
    def same(got, want) -> bool:
        """Whole output streams, byte for byte."""
        return _stream(got) == _stream(want)
