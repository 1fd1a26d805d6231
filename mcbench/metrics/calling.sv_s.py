"""calling.sv_s: seconds a sample of calling's inversion and translocation
calls (break-point candidates, identify_sv and the merge), the mean over
the window's samples (MC_STAGE_PROF span `call_sv`)."""


def read(view):
    if not view.samples or any(s["stages"] is None or "call_sv" not in
                               s["stages"] for s in view.samples):
        return None
    return (sum(s["stages"]["call_sv"] for s in view.samples)
            / len(view.samples))
