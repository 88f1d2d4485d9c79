"""Fit pipeline, scale pair build (ops/locality.py): seconds a fit spends
in the budgeted band build, both passes of K9a and the extraction of the
kept pairs: the program's ``locality.budgeted`` spans of the traced
window, per ``fit`` span.  Under the profiler the span waits for the
card as it opens and before it closes, so it holds the build's device
time."""

from knnbench import program_spans


def read(records):
    return program_spans.per_root("fit", "locality.budgeted")
