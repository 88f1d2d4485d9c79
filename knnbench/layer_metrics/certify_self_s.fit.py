"""Orchestrator (annchor.py, Annchor.fit): the hybrid certify's own host
work, per fit: the self time of the program's ``certify`` spans of the
traced window (its exact EMD, scout evaluations and scout waits, each a
child span, taken out), per ``fit`` span."""

from knnbench import program_spans


def read(records):
    return program_spans.per_root("fit", "certify", own=True)
