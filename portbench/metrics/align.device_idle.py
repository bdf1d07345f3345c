"""``align.device_idle``: the share of the traced segment in which no
operation ran on the card."""


def read(r):
    if r.trace is None or not r.trace["busy_s"]:
        return None
    return 100.0 * (1.0 - r.trace["busy_s"] / r.trace["window_s"])
