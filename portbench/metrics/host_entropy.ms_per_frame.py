"""Host entropy engine: milliseconds a frame inside the engine's entry
points that the sessions call — the destuff of each frame and, for
restart-free frames, the index scan — summed over the worker threads
(host spans around the calls)."""

SPANS = [("video_coding_tpu_torch.entropy.scan", "destuff_flat",
          "host_entropy.destuff"),
         ("video_coding_tpu_torch.runtime.engine", "index_scan",
          "host_entropy.index_scan")]


def read(run):
    if run.trace is None:
        return None
    frames = len(run.trace.spans_named("host_entropy.destuff"))
    spans = run.trace.spans_named("host_entropy.")
    if not frames:
        return None
    return sum(e - s for _n, _t, s, e in spans) / 1e3 / frames
