"""calling.records_s: seconds a sample of calling's host records (the
event-map sorts, break-point candidates and fetch positions; the SUB,
INS/DEL, UMR/CNV and NOR records and their sort), the mean over the
window's samples (MC_STAGE_PROF spans `call_prep` and `call_records`)."""


def read(view):
    keys = ("call_prep", "call_records")
    if not view.samples or any(s["stages"] is None or
                               any(k not in s["stages"] for k in keys)
                               for s in view.samples):
        return None
    return (sum(s["stages"][k] for s in view.samples for k in keys)
            / len(view.samples))
