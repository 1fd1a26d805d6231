"""evidence.apply_s: seconds a million reads of reconciling each batch's device evidence
(MC_STAGE_PROF stage `evidence`, summed over the window's samples)."""
from mcbench.readers import per_mread


def read(view):
    return per_mread(view, "evidence")
