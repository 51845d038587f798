"""still_ms_p95: the 95th percentile (numpy's linear interpolation), over
every still of the window, of the time from the request to its uint8
image on the host. Host clock."""

import numpy as np


def read(run):
    ms = [(f.t_done - f.t_request) * 1e3 for f in run.frames]
    return float(np.percentile(ms, 95)) if ms else None
