"""evidence.sample_s: seconds a sample of the evidence planes' set-up and
finalize (MC_STAGE_PROF spans `evidence_setup`: the host diff arrays and
the device planes made; `finalize`: engine.finalize's host-delta merge,
fold and scan with its wait, and mapping's closing statistics), the mean
over the window's samples."""


def read(view):
    keys = ("evidence_setup", "finalize")
    if not view.samples or any(s["stages"] is None or
                               any(k not in s["stages"] for k in keys)
                               for s in view.samples):
        return None
    return (sum(s["stages"][k] for s in view.samples for k in keys)
            / len(view.samples))
