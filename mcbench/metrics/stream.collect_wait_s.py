"""stream.collect_wait_s: seconds a million reads of collecting the device's seed+chain output, its wait for the device included
(MC_STAGE_PROF stage `collect`, summed over the window's samples)."""
from mcbench.readers import per_mread


def read(view):
    return per_mread(view, "collect")
