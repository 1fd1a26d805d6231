"""Variants of the calling kernels' finalize and scan (csrc/calling.cu,
evidence_finalize_kernel and caller_scan_kernel) timed on main-path
data, to find where their time goes. Needs one CUDA card and nvcc, and
the repository's kernel_variants.py and chip_smoke.py beside the package.

    python -m mapcaller_tpu_torch.calling_variants VARIANT [VARIANT ...]

A variant is tokens joined by "_", each an edit of the source as it is:
  F<n>      the least blocks an SM in the finalize's launch bounds
  S<n>      the same for the scan
  sleep<n>  a __nanosleep(n) between the look-back's polls
  nolb      timing only: no look-back (every tile's carry taken as 0, so
            the outputs are wrong and not held)
"source" is the source unedited. Each variant is compiled with the port's
nvcc flags, all at once. The data come from a main-path run of 20,000
simulated pairs (mapcaller_tpu_torch.simulator): the finalize folds the
run's own planes with the reference codes from its text words, as
DeviceEvidence.finalize does, and the scan reads the folded planes. Then
each variant's queued device ms (chip_smoke.cuda_ms), whether its outputs
equal the plain versions' in every word, and its ptxas report. Prints
the card's name and power limit, then one JSON line.
"""
import os
import re
import sys

from . import toolchain

SRC = os.path.join(toolchain.CSRC_DIR, "calling.cu")
KERNELS = ("evidence_finalize_kernel", "caller_scan_kernel")
POLL = "      if (__all_sync(FULL, (st >> 2) == lb.epoch)) break;\n"


def _harness():
    """The repository's variants harness (kernel_variants.py), beside
    the package."""
    sys.path.insert(0, toolchain.REPO_DIR)
    import kernel_variants
    return kernel_variants


def variant_source(name, src):
    """The kernel source edited as variant `name` asks."""
    kv = _harness()
    if name == "source":
        return src
    for tok in name.split("_"):
        if tok[0] in "FS" and tok[1:].isdigit():
            what = "FIN_THREADS" if tok[0] == "F" else "SCAN_THREADS"
            src = kv.edit(src, f"__launch_bounds__({what})",
                          f"__launch_bounds__({what}, {tok[1:]})")
        elif tok.startswith("sleep") and tok[5:].isdigit():
            src = kv.edit(src, POLL, POLL + f"      __nanosleep({tok[5:]});\n")
        elif tok == "nolb":
            src, n = re.subn(r"look_back<(\d)>\(lb, tile, \w+, \w+, (\w+)\);",
                             r"for (int k_ = 0; k_ < \1; ++k_) \2[k_] = 0;",
                             src)
            if n != 3:
                raise ValueError("the source no longer holds 3 look-backs")
        else:
            raise ValueError(f"unknown token {tok!r}")
    return src


def main_planes(workdir):
    """The finalize's arguments of a main-path run of 20,000 pairs: a tap
    on calling_kernels.evidence_finalize keeps copies of what
    DeviceEvidence.finalize passed it."""
    import torch
    from . import cli, runner
    from .ops import calling_kernels as cal
    argv = _harness().main_path_argv(workdir, 20_000)
    kept = {}
    real = cal.evidence_finalize

    def tap(acgt, exact_diff, f_diff, multi_diff, n, codes=None,
            words=None, **kw):
        kept.update(args=tuple(t.clone() for t in (acgt, exact_diff, f_diff,
                                                    multi_diff)),
                    n=n, words=words.clone())
        return real(acgt, exact_diff, f_diff, multi_diff, n, codes=codes,
                    words=words, **kw)

    cal.evidence_finalize = tap
    try:
        if runner.run_pipeline(cli.parse_args(argv), " ".join(argv)) != 0:
            raise RuntimeError("the main-path run failed")
    finally:
        cal.evidence_finalize = real
    torch.cuda.synchronize()
    return kept


def body(names, work):
    import numpy as np
    import torch
    kv = _harness()
    import chip_smoke
    from .ops import calling_kernels as cal
    libs = kv.build(SRC, names, variant_source, KERNELS, work)
    kept = main_planes(work)
    args, n, words = kept["args"], kept["n"], kept["words"]
    fb = np.float32(0.2)
    want = cal.evidence_finalize_plain(*args, n, words=words)
    scan_in = (want.acgt, want.multi, want.cov, want.codes, 2, fb, False)
    swant = cal.caller_scan_plain(*scan_in)
    out = dict(L=n, variants={})
    for name in names:
        lib, ptxas = libs[name]
        with kv.bound(cal, lib):
            got = cal.evidence_finalize(*args, n, words=words)
            sgot = cal.caller_scan(*scan_in)
            equal = (chip_smoke.max_err_of(tuple(got), tuple(want)) == 0
                     and chip_smoke.max_err_of(tuple(sgot), tuple(swant))
                     == 0)
            if not equal and "nolb" not in name:
                raise AssertionError(f"{name}: outputs differ from the "
                                     f"plain versions'")
            out["variants"][name] = dict(
                finalize_ms=chip_smoke.cuda_ms(
                    lambda: cal.evidence_finalize(*args, n, words=words), 30,
                    queued=True),
                scan_ms=chip_smoke.cuda_ms(lambda: cal.caller_scan(*scan_in),
                                           30, queued=True),
                equal=equal, ptxas=ptxas)
        print(name, out["variants"][name], flush=True)
    del got, sgot
    torch.cuda.synchronize()
    return out


if __name__ == "__main__":
    sys.exit(_harness().run(__doc__, None, body))
