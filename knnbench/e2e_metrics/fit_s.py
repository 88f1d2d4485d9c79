"""Seconds a fit takes: the window's whole wall over the fits completed
in it (each fit ends in a synchronise; the window runs whole fits)."""


def read(window):
    if not window.get("fits"):
        return None
    return window["wall_s"] / window["fits"]
