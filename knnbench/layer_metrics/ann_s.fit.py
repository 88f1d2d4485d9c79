"""Orchestrator (annchor.py, Annchor.fit): seconds of the get_ann stage
(the graph's assembly and, in a hybrid, the exact certify): the
program's ``fit.get_ann`` spans of the traced window, which do not
synchronise, per ``fit`` span."""

from knnbench import program_spans


def read(records):
    return program_spans.per_root("fit", "fit.get_ann")
