"""device_idle.serve: the share of the profiled slice of a serving
window (its last arrivals and the drain) in which no operation ran on
the card, in percent."""


def read(rec):
    t = rec.trace
    if rec.mix["kind"] != "serve" or not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
