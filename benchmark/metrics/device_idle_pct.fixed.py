"""device_idle_pct.fixed (%, device trace): the share of the traced window
in which no operation ran on the card (the union of the device intervals
of the profiler's trace), in the fixed-budget cells."""


def read(r):
    t = r.get("trace")
    if t is None or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
