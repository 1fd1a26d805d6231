"""seed_chain.submit_s: seconds a million reads of submitting a transfer group's seed+chain dispatch
(MC_STAGE_PROF stage `submit`, summed over the window's samples)."""
from mcbench.readers import per_mread


def read(view):
    return per_mread(view, "submit")
