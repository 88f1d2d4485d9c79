"""Metric engine, host EMD (metrics.py, native.py): seconds a query call
spends in the exact EMD solver (the reported rows' certify): the
program's ``engine.emd`` spans of the traced window, per ``query``
span."""

from knnbench import program_spans


def read(records):
    return program_spans.per_root("query", "engine.emd")
