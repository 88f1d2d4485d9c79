"""Fit pipeline, post-fit refinement (refine.py): seconds a fit spends
refining its graph with the share of p_work held back, the certify of
the predicted edges and the 2-hop rounds: the program's ``refine`` spans
of the traced window, per ``fit`` span."""

from knnbench import program_spans


def read(records):
    return program_spans.per_root("fit", "refine")
