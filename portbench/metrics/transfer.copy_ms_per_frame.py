"""Host-device copies: device milliseconds a frame of every memcpy in the
window; frames counted as decode-datapath (K2) launches, one a dispatch,
times the frames a dispatch."""


def read(run):
    if run.trace is None:
        return None
    frames = len(run.trace.kernels({"decode_datapath_kernel"})) * run.batch
    if not frames:
        return None
    return sum(e - s for _n, s, e, _c, _k in run.trace.copies()) / 1e3 \
        / frames
