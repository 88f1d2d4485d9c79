"""Orchestrator (annchor.py, Annchor.fit): seconds of the
select_refine_candidate_pairs stage, summed over a fit's iterations: the
program's ``fit.select_refine_candidate_pairs`` spans of the traced
window, which do not synchronise, per ``fit`` span."""

from knnbench import program_spans


def read(records):
    return program_spans.per_root("fit", "fit.select_refine_candidate_pairs")
