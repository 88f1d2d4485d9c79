"""Query path (query.py): the walk's own host work per query call: the
self time of the program's ``query.walk`` spans of the traced window
(the metric engines' spans inside it taken out), per ``query`` span."""

from knnbench import program_spans


def read(records):
    return program_spans.per_root("query", "query.walk", own=True)
