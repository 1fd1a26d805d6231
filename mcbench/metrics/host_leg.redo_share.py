"""host_leg.redo_share: the share, in %, of the C++ host leg's 200-read
chunks mapped a second time because the running mean fragment distance
moved under them (MC_STAGE_PROF counters `host_chunks_redone` over
`host_chunks`, summed over the window's samples)."""


def read(view):
    keys = ("host_chunks", "host_chunks_redone")
    if not view.samples or any(s["stages"] is None or
                               any(k not in s["stages"] for k in keys)
                               for s in view.samples):
        return None
    chunks = sum(s["stages"]["host_chunks"] for s in view.samples)
    if chunks <= 0:
        return None
    return 100.0 * sum(s["stages"]["host_chunks_redone"]
                       for s in view.samples) / chunks
