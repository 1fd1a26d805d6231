"""calling.device_s: seconds a sample of calling's device steps (the
caller scan, the column fetches and the NOR blocks, each with its copy
to the host; the overflow's plane download), the mean over the window's
samples (MC_STAGE_PROF span `call_device`)."""


def read(view):
    if not view.samples or any(s["stages"] is None or "call_device" not in
                               s["stages"] for s in view.samples):
        return None
    return (sum(s["stages"]["call_device"] for s in view.samples)
            / len(view.samples))
