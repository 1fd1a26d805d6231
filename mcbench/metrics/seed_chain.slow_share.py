"""seed_chain.slow_share: the share of the window's reads, in %, that the
device's seed+chain classed SLOW (the host oracle's forced SLOW reads
included), by the MC_STAGE_PROF counters `reads_fast`, `reads_slow` and
`reads_nocand` summed over the window's samples."""


def read(view):
    keys = ("reads_fast", "reads_slow", "reads_nocand")
    if not view.samples or any(s["stages"] is None or
                               any(k not in s["stages"] for k in keys)
                               for s in view.samples):
        return None
    total = sum(s["stages"][k] for s in view.samples for k in keys)
    if total <= 0:
        return None
    return 100.0 * sum(s["stages"]["reads_slow"]
                       for s in view.samples) / total
