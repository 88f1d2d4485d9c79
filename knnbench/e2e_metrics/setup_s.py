"""Seconds from the process's start to the first timed call: imports,
the card's start, loading (and in a checkout's first run, building) the
kernels, making the data, the warm-up, and for queries the index's fit."""


def read(window):
    return window.get("setup_s")
