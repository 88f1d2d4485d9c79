"""Metric engine, strings encoding (metrics.py, ops/levenshtein_myers.py):
seconds a query call spends encoding strings (the anchors with the
queries, then the index with the queries): the program's
``engine.encode`` spans of the traced window, per ``query`` span."""

from knnbench import program_spans


def read(records):
    return program_spans.per_root("query", "engine.encode")
