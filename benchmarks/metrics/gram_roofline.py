"""The Gram's share of its roofline (2 m^2 4^k over the TF32 peak), per forward."""

from kbench.readers import roofline_pct


def read(rec):
    return roofline_pct(rec, "gram", per="unit")
