"""step_ops_ms (ms, device trace): device-busy ms a step in the traced fits,
less the seconds in which the band kernels and their folds ran
(yardstick.band_kernel_s): what the step's small ops (EM, the denoiser,
CG's vector work, the operator's lane casts, Hutchinson, gamw) keep the
card busy."""

from benchmark import yardstick


def read(r):
    t = r.get("trace")
    if t is None or not t["steps"]:
        return None
    return (t["busy_s"] - yardstick.band_kernel_s(t["ops"])) / t["steps"] * 1e3
