"""The 95th percentile, over every frame pulled in the window, of the time
from the entry point's pull of the frame to its output being complete
(host clock). In a closed loop at full speed it follows the rate (the
frames in flight over the rate), so it is read beside the per-layer
metrics, in the traced run."""

import numpy as np


def read(run):
    lat = run.latencies_s()
    return float(np.percentile(lat, 95)) * 1e3 if len(lat) else None
