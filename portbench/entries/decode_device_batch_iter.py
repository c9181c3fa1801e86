"""Entry point: ``JpegDecoderSession.decode_device_batch_iter`` — chunks of
``frames_per_dispatch`` frames decoded into stacked planes that stay on
the card, ``depth`` chunks in flight. A chunk is complete when a CUDA
event recorded right after its dispatch has completed."""

from __future__ import annotations

import numpy as np

from portbench import harness


def open(cell, layout, sources, device=None):
    from video_coding_tpu_torch.common.bitstream import BitReader
    from video_coding_tpu_torch.model.header import Header
    from video_coding_tpu_torch.runtime.engine import JpegDecoderSession

    header = Header.decode(BitReader(sources[0].encoded.stream))
    return Runner(JpegDecoderSession(header, device=device), cell.traffic)


def expected(ref, layout, source, traffic, dct="chen"):
    return ref.reconstruct(source.encoded.coefs, layout,
                           traffic["quality_in"], dct)


class Runner:
    dispatch = "decode_device_batch_stacked"

    def __init__(self, session, traffic):
        self.session = session
        self.traffic = traffic
        self.unit_frames = traffic["frames_per_dispatch"]
        self.events: dict = {}

    def stream(self, feed):
        harness.completion_probe(self.session, self.dispatch, self.events)
        return self.session.decode_device_batch_iter(
            iter(feed), batch=self.traffic["frames_per_dispatch"],
            depth=self.traffic["depth"])

    @staticmethod
    def frames(unit) -> int:
        return unit[0].shape[0]

    def wait(self, unit) -> None:
        ev = self.events.pop(id(unit), None)
        if ev is not None:
            ev.synchronize()

    @staticmethod
    def to_host(unit) -> list:
        planes = [p.cpu().numpy() for p in unit]
        return [[p[f] for p in planes] for f in range(len(planes[0]))]

    @staticmethod
    def same(got, want) -> bool:
        return len(got) == len(want) and all(
            g.shape == w.shape and np.array_equal(g, w)
            for g, w in zip(got, want))
