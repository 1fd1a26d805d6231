"""seed_chain.device_ms: device milliseconds a million reads of the seed
scan and chain kernels (csrc/seed_scan.cu, csrc/chain.cu), by the traced
window's kernels whose names seed_chain_kernels.json lists."""
from mcbench import devtrace
from mcbench.readers import kernel_names


def read(view):
    if view.trace is None:
        return None
    sec, calls = devtrace.matching(view.trace,
                                   kernel_names(view, "seed_chain_kernels.json"))
    if not calls:
        return None
    return 1e3 * sec / (view.reads / 1e6)
