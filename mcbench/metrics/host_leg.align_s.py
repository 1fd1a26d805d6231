"""host_leg.align_s: seconds a million reads of the C++ host leg's
alignment (the leg's own `align` timer, MC_STAGE_PROF counter
`host_align`, summed over the window's samples)."""


def read(view):
    if not view.samples or any(s["stages"] is None or "host_align" not in
                               s["stages"] for s in view.samples):
        return None
    return (sum(s["stages"]["host_align"] for s in view.samples)
            / (view.reads / 1e6))
