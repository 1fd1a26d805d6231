"""stream.parse_s: seconds a million reads of the stream's native parse
(MC_STAGE_PROF stage `parse`, summed over the window's samples)."""
from mcbench.readers import per_mread


def read(view):
    return per_mread(view, "parse")
