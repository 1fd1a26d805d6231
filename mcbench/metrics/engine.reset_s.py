"""engine.reset_s: seconds a sample of engine.reset_run() (the host
planes zeroed, the native context reset), the mean over the window's
samples (MC_STAGE_PROF span `reset`)."""


def read(view):
    if not view.samples or any(s["stages"] is None or "reset" not in
                               s["stages"] for s in view.samples):
        return None
    return (sum(s["stages"]["reset"] for s in view.samples)
            / len(view.samples))
