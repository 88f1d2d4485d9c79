"""Metric engine, strings encoding (metrics.py, ops/levenshtein_myers.py):
seconds a fit spends encoding strings for the edit-distance engine, the
constructor's encoding included: the program's ``engine.encode`` spans
of the traced window, per ``fit`` span."""

from knnbench import program_spans


def read(records):
    return program_spans.per_root("fit", "engine.encode")
