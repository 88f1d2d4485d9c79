"""Query path (query.py): seconds a query call spends predicting its
candidates (the regression, its clip to the bounds and the error tags):
the program's ``query.predict`` spans of the traced window, per
``query`` span.  A device span where the program makes it one, so the
reading holds the predict's device time."""

from knnbench import program_spans


def read(records):
    return program_spans.per_root("query", "query.predict")
