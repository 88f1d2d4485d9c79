"""The 95th percentile, in ms, of the latency of every query call in
the window, each timed on the host from the call to its return (the
call returns numpy arrays, so the card has finished)."""

import numpy as np


def read(window):
    lat = window.get("latencies_s")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95)) * 1e3
