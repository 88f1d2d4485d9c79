"""Progress feedback for long-running loops.

The reference wraps its metric loops and the greedy anchor loop in
tqdm (reference annchor/utils.py:136,159, annchor/pickers.py:33-40);
long fits here otherwise print nothing between stage-timer lines.
On a tty this uses tqdm; in captured logs (benchmark drivers, CI) it
degrades to low-frequency heartbeat lines so logs stay readable.
"""

from __future__ import annotations

import sys
import time

__all__ = ["progress"]

_HEARTBEAT_S = 10.0


def progress(iterable, desc="", enabled=True, total=None):
    """Iterate `iterable`, reporting progress when `enabled`.

    tty: a transient tqdm bar.  Non-tty: at most one printed line per
    ~10 s ("desc: k/n (elapsed)").  Disabled: plain iteration.
    """
    if not enabled:
        yield from iterable
        return
    if total is None and hasattr(iterable, "__len__"):
        total = len(iterable)
    is_tty = False
    try:
        is_tty = sys.stderr.isatty()
    except Exception:
        pass
    if is_tty:
        try:
            from tqdm import tqdm

            yield from tqdm(iterable, desc=desc, total=total, leave=False)
            return
        except Exception:
            pass
    t0 = time.time()
    last = t0
    n = 0
    for item in iterable:
        yield item
        n += 1
        now = time.time()
        if now - last >= _HEARTBEAT_S and (total is None or n < total):
            tot = "/%d" % total if total is not None else ""
            print(
                "    %s: %d%s (%.0f s)" % (desc or "progress", n, tot, now - t0),
                flush=True,
            )
            last = now
