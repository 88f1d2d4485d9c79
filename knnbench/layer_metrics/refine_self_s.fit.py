"""Fit pipeline, post-fit refinement (refine.py): the refinement's own
work per fit, its sorts, merges and row lists: the self time
of the program's ``refine`` spans of the traced window (its exact
batches, ``refine.exact``, and its 2-hop screens, ``refine.screen``, each
a child span, taken out), per ``fit`` span."""

from knnbench import program_spans


def read(records):
    return program_spans.per_root("fit", "refine", own=True)
