"""host_leg.cpp_s: seconds a million reads of the C++ host leg (pairing, slow-path alignment, evidence of slow reads)
(MC_STAGE_PROF stage `host_cpp`, summed over the window's samples)."""
from mcbench.readers import per_mread


def read(view):
    return per_mread(view, "host_cpp")
