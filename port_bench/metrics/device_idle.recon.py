"""The share of the traced window in which no operation ran on the card
(the union of the device's kernel, copy and set intervals)."""


def read(ctx: dict):
    t = ctx["trace"]
    if t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
