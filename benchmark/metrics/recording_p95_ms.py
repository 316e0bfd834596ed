"""The 95th percentile of every recording's call time in the window (the
call to its return with every result on the host); host clock."""

import numpy as np


def read(ctx):
    lat = ctx.window.latencies_s
    return 1e3 * float(np.percentile(lat, 95)) if lat else None
