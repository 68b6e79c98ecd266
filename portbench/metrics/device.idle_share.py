"""The share of the traced window in which nothing ran on the card:
1 - (the union of the device events' intervals) / (the window)."""

from portbench import trace


def read(rec):
    if not rec["names"] or rec["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s(rec) / rec["window_s"]), "%"
