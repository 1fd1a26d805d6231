"""stream.load_s: seconds a million reads of loading a sample's input
(both FASTQ files read whole, auto compaction, native.set_input)
(MC_STAGE_PROF span `load`, summed over the window's samples)."""


def read(view):
    if not view.samples or any(s["stages"] is None or "load" not in
                               s["stages"] for s in view.samples):
        return None
    return (sum(s["stages"]["load"] for s in view.samples)
            / (view.reads / 1e6))
