"""Device: the share of the traced window of whole query calls in which
no kernel, copy or set ran on the card, 1 - busy / wall, in %."""


def read(records):
    prof = records.get("profile")
    if not prof or prof["window_s"] <= 0 or not records.get("calls"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
