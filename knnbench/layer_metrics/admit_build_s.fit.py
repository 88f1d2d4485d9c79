"""Fit pipeline, scale pair build (ops/locality.py): seconds a fit spends
in the admit-everything build, counting pass and extraction (and the
budgeted build it hands over to, if it does): the program's
``locality.admit`` spans of the traced window, per ``fit`` span.  Under
the profiler the span waits for the card as it opens and before it
closes, so it holds the build's device time."""

from knnbench import program_spans


def read(records):
    return program_spans.per_root("fit", "locality.admit")
