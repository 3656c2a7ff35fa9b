"""ld_pass_roofline (%): the least time an LD pass's bytes allow on the card
(yardstick.bound_s: the blocks that hold data in the reference's count,
their scales, x read once and y written once, 2K lanes, over the published
memory rate) over the traced pass (ld_pass_ms)."""

from benchmark import yardstick


def read(r):
    s = yardstick.ld_pass_s(r.get("trace"))
    if s is None:
        return None
    c = r["config"]
    bound = yardstick.bound_s(r.get("blocks_with_data"), c["B"], c["M"], c["K"], 2,
                              c["operator"]["args"]["dtype"], r["device"])
    return None if bound is None else 100.0 * bound / s
