"""ld_pass_ms (ms, device trace): the seconds in which the band kernels and
their folds ran in the traced fits (yardstick.band_kernel_s, the union of
their intervals in the profiler's trace) over the LD passes those fits ran.
The lane casts and transposes around a kernel are the step's."""

from benchmark import yardstick


def read(r):
    s = yardstick.ld_pass_s(r.get("trace"))
    return None if s is None else s * 1e3
