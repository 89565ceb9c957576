"""The device's idle share of the traced window: 100 * (1 - the union of
device activity / the window's length)."""


def read(r):
    if r.timeline is None or r.timeline.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.timeline.busy_s / r.timeline.window_s)
