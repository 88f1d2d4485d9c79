"""Queries answered a second: every query answered in the window over
the window's whole wall."""


def read(window):
    if not window.get("queries"):
        return None
    return window["queries"] / window["wall_s"]
