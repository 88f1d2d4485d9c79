"""Fit pipeline, sparse state (ops/device_pipeline.py): seconds a fit
spends tightening bounds, the column-subsampled tighten of the contender
pairs on the scale path: the program's ``pipeline.tighten`` spans of the
traced window, per ``fit`` span.  Under the profiler the span waits for
the card as it opens and before it closes, so it holds the tighten's
device time."""

from knnbench import program_spans


def read(records):
    return program_spans.per_root("fit", "pipeline.tighten")
