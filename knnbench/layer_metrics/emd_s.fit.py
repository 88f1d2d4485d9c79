"""Metric engine, host EMD (metrics.py, native.py): seconds a fit spends
in the exact EMD solver: the program's ``engine.emd`` spans of the
traced window, per ``fit`` span."""

from knnbench import program_spans


def read(records):
    return program_spans.per_root("fit", "engine.emd")
