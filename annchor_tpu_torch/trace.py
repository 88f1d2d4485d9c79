"""Spans of the program's own work, recorded while a ``torch.profiler``
records and nowhere else.

``span(name, **counts)`` marks a block.  With no profiler recording it
does one check (``torch._C._autograd._profiler_enabled()``) and nothing
more.  With one recording it opens ``torch.profiler.record_function``
under the same name, so the block sits on the profiler's timeline beside
the card's kernels, and keeps a ``Span`` record in memory: its name,
its start and end in ``time.time_ns()`` (the clock of the profiler's
host events), the index of the span it opened in, the request it
belongs to and its counts.  The spans named in ``ROOTS`` each start a
request; every other span takes the request of the span it opened in.
``count(**counts)`` adds counts to the innermost open span from code
that does not hold it.  ``device_span(name, devices, **counts)`` is a
span over work queued on the card: while a profiler records it waits
for ``devices`` as it opens and before it closes, so its time is the
block's device time too.

``recording()`` says whether a profiler records, for counts that cost
work of their own.  ``spans()`` returns the records kept (at most ``CAP``, the oldest
dropped first), ``reset()`` clears them, and ``self_ns(records)`` gives
each span's time less the time its children cover.  The profiler's own
trace (``Annchor(trace_dir=...)``, ``export_chrome_trace``) carries the
spans; nothing else writes them out.
"""

from __future__ import annotations

import collections
import contextvars
import itertools
import time

import torch

from annchor_tpu_torch._backend import synchronize

CAP = 1 << 20
ROOTS = frozenset(("construct", "fit", "query"))

_enabled = torch._C._autograd._profiler_enabled
_records = collections.deque(maxlen=CAP)
_index = itertools.count()
_request = itertools.count(1)
# (record, request) of the innermost open span of this thread or task
_current = contextvars.ContextVar("annchor_tpu_torch_span", default=(None, None))


class Span:
    """One recorded span.  ``end_ns`` is None while it is open; ``parent``
    is the ``index`` of the span it opened in (None at the top)."""

    __slots__ = ("index", "name", "start_ns", "end_ns", "parent", "request", "counts")

    def __init__(self, index, name, start_ns, parent, request, counts):
        self.index = index
        self.name = name
        self.start_ns = start_ns
        self.end_ns = None
        self.parent = parent
        self.request = request
        self.counts = counts

    def __repr__(self):
        return "Span(%d, %r, %s ns, parent=%s, request=%s, %r)" % (
            self.index, self.name,
            None if self.end_ns is None else self.end_ns - self.start_ns,
            self.parent, self.request, self.counts)


class span:
    """Context manager over a block of the program's work; ``count(**kw)``
    adds counts known only inside the block."""

    __slots__ = ("_name", "_counts", "_rec", "_range", "_token")

    def __init__(self, name, **counts):
        self._name = name
        self._counts = counts
        self._rec = None

    def __enter__(self):
        if not _enabled():
            return self
        outer, request = _current.get()
        if self._name in ROOTS:
            request = next(_request)
        self._range = torch.profiler.record_function(self._name)
        self._range.__enter__()
        rec = Span(next(_index), self._name, time.time_ns(),
                   None if outer is None else outer.index, request, self._counts)
        _records.append(rec)
        self._rec = rec
        self._token = _current.set((rec, request))
        return self

    def __exit__(self, *exc):
        rec = self._rec
        if rec is None:
            return False
        rec.end_ns = time.time_ns()
        _current.reset(self._token)
        self._range.__exit__(*exc)
        self._rec = None
        return False

    def count(self, **counts):
        if self._rec is not None:
            self._rec.counts.update(counts)


class device_span(span):
    """A span over work queued on ``devices`` (torch devices; those not
    CUDA are skipped).  While a profiler records it synchronises them as
    it opens, so the work queued before it stays out, and before it
    closes, so the block's device time is in it; with none recording it
    costs what a span costs."""

    __slots__ = ("_devices",)

    def __init__(self, name, devices, **counts):
        super().__init__(name, **counts)
        self._devices = devices

    def __enter__(self):
        if _enabled():
            _synchronize(self._devices)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            if self._rec is not None:
                _synchronize(self._devices)
        finally:
            super().__exit__(*exc)
        return False


def _synchronize(devices):
    for d in devices:
        synchronize(torch.device(d))


def count(**counts):
    """Add ``counts`` to the innermost open span of this thread or task;
    nothing when none is open (as when no profiler records)."""
    rec = _current.get()[0]
    if rec is not None:
        rec.counts.update(counts)


def recording():
    """True while a profiler records, so that spans are kept."""
    return _enabled()


def spans():
    """The spans recorded, oldest first."""
    return list(_records)


def reset():
    _records.clear()


def self_ns(records):
    """For each span of ``records``, in order, its time less the part of
    it that its closed children in ``records`` cover (None while open)."""
    kids = {}
    for r in records:
        if r.parent is not None and r.end_ns is not None:
            kids.setdefault(r.parent, []).append((r.start_ns, r.end_ns))
    out = []
    for r in records:
        if r.end_ns is None:
            out.append(None)
            continue
        covered, reach = 0, r.start_ns
        for a, b in sorted(kids.get(r.index, ())):
            a, b = max(a, reach), min(b, r.end_ns)
            if b > a:
                covered += b - a
                reach = b
        out.append(r.end_ns - r.start_ns - covered)
    return out
