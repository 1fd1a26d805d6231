"""calling.job_s: seconds of runner.run_calling a sample (the caller, its
kernels and the VCF writer), by the harness's host clock, the mean over
the window's samples."""


def read(view):
    if not view.samples:
        return None
    return sum(s["call_s"] for s in view.samples) / len(view.samples)
