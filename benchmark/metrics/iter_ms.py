"""iter_ms (ms, host clock): the window's seconds x 1000 over the VAMP steps
its fits completed; the window holds whole fits, each from its start to the
host read of its estimate."""


def read(r):
    steps = r["counters"]["steps"]
    return r["window_s"] * 1e3 / steps if steps else None
