"""calling.write_s: seconds a sample of writing the VCF (its header and
records), the mean over the window's samples (MC_STAGE_PROF span
`call_write`)."""


def read(view):
    if not view.samples or any(s["stages"] is None or "call_write" not in
                               s["stages"] for s in view.samples):
        return None
    return (sum(s["stages"]["call_write"] for s in view.samples)
            / len(view.samples))
