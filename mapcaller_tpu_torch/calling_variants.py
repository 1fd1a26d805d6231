"""Variants of the calling kernels' finalize, scan and NOR blocks
(csrc/calling.cu: evidence_finalize_kernel, caller_scan_kernel,
nor_blocks_kernel and its slice form) timed on main-path data, to find
where their time goes. Needs one CUDA card and nvcc, and the repository's
kernel_variants.py and chip_smoke.py beside the package.

    python -m mapcaller_tpu_torch.calling_variants [--parent=PATH] \\
        VARIANT [VARIANT ...]

A variant is tokens joined by "_", each an edit of the source as it is:
  F<n>      the least blocks an SM in the finalize's launch bounds
  S<n>      the same for the scan
  Ft<n>     n threads a finalize block
  Fi<n>     n positions a finalize thread (a tile of n x threads)
  Sb<n>     n 100-base blocks a scan tile
  Si<n>     n positions a scan thread (100 / n threads a 100-base block)
  Fs<n>     n tiles staged a finalize block (1: none in flight while a
            tile is processed; 2: the next tile's copies are)
  Ss<n>     the same for the scan
  Nt<n>     n threads a NOR block (a multiple of 32, at least 128)
  Ni<n>     n positions a NOR thread (a tile of n x threads)
  Ns<n>     n breaks and excluded positions staged a NOR tile
  Nm<n>     the least NOR blocks an SM in its launch bounds
  Nb<n>     the NOR tile's coverage by one bulk copy with an mbarrier
            (Nb1) or by 16-byte cp.async (Nb0)
  Nfloor    timing only: the NOR kernels return at once (the launch's
            floor in this harness; their outputs are not held)
  Nland     timing only: a NOR tile ends once its coverage and breaks
            have landed (searches, stage and copies)
  Nred      timing only: a NOR tile ends after its fold and its warps'
            reductions, before it writes any segment
  Nfold     timing only: a NOR tile ends before its edges (all but the
            edges' adds, arrivals and writes)
  Nnozero   timing only: the excluded positions are not zeroed (nor read)
  sleep<n>  a __nanosleep(n) between the look-back's polls
  nolb      timing only: no look-back (tile k's carry taken as 4 k
            candidates and 5 k runs before it, and the same value for
            every other sum: the outputs are wrong and not held; the
            scan's tiles still write their tables in separate places)
  loads     timing only: each tile staged and nothing else (no sums, no
            look-back, no stores)
"source" is the source unedited; "parent" is an earlier tree's source,
read from PATH (default mapcaller_tpu_torch/build/calling_parent.cu,
git-ignored; write it first, e.g. the NOR blocks before their redesign
as one launch, a memset and two kernels:
    git show ea2f567:mapcaller_tpu_torch/csrc/calling.cu \\
        > mapcaller_tpu_torch/build/calling_parent.cu
). The parent's finalize and scan take the same C entries, so the port's
wrappers drive both; its NOR entries, which take no scratch, are called
as they are. A variant named twice is timed twice, in the order given
(parent source source parent compares the two forms in turns). Each
variant is compiled with the port's nvcc flags, all at once. The data
come from a main-path -gvcf run of 20,000 simulated pairs
(mapcaller_tpu_torch.simulator): the finalize folds the run's own planes
with the reference codes from its text words, as DeviceEvidence.finalize
does, the scan reads the folded planes, and the NOR blocks take the run's
own call (coverage, excluded positions, breaks). Then each variant's
queued device ms (chip_smoke.cuda_ms) a turn, whether its outputs equal
the plain versions' in every word (the whole planes, and two slices
through the slice forms: carries, a local coverage prefix, codes given, a
valid length and the seam; the NOR blocks' slice form on the same two
slices, keyed by the global breaks), its geometry (tile, threads,
stages, dynamic shared memory, blocks an SM; not the parent's) and its
ptxas report. Prints the card's name and power limit, then one JSON
line.
"""
import os
import re
import sys

from . import toolchain

SRC = os.path.join(toolchain.CSRC_DIR, "calling.cu")
PARENT = os.path.join(toolchain.BUILD_DIR, "calling_parent.cu")
KERNELS = ("evidence_finalize_kernel", "caller_scan_kernel",
           "nor_blocks_kernel", "nor_blocks_slice_kernel")
POLL = "      if (__all_sync(FULL, (st >> 2) == lb.epoch)) break;\n"
TIMING_ONLY = {"nolb", "loads"}        # tokens whose outputs are not held
NOR_TIMING_ONLY = {"Nfloor", "Nland", "Nred", "Nfold", "Nnozero"}
NOR_FLOOR = "  unsigned phase = 0;\n"   # nor_body's first line after the setup
# nor_tile's lines where Nland, Nred and Nfold end a tile; the zeroing
# that Nnozero drops
NOR_LAND = ("  __syncthreads();" + " " * 22
            + "// coverage and stages landed\n")
NOR_FOLD = "  // an edge: its minima here added to the words"
NOR_RED = "  if (!staged_b) __threadfence();"
NOR_ZERO = "  if (ex >= 0) s_cov[ex] = 0;\n"
# the last lines of fin_tile's and scan_tile's signatures: `loads` returns
# there (the scan with its next tile drawn and staged, as it would be)
LOADS_FIN = "unsigned long long* exb_s) {\n"
LOADS_SCAN = "unsigned long long* ex_s,\n" + " " * 41 + "int* tile_s) {\n"
# token prefix -> the constant it sets
KNOBS = (("Ft", "FIN_THREADS"), ("Fi", "FIN_ITEMS"), ("Fs", "FIN_STAGES"),
         ("Sb", "SCAN_BLOCKS"), ("Si", "SCAN_ITEMS"), ("Ss", "SCAN_STAGES"),
         ("F", "FIN_MIN_BLOCKS"), ("S", "SCAN_MIN_BLOCKS"),
         ("Nt", "NOR_THREADS"), ("Ni", "NOR_ITEMS"), ("Ns", "NOR_STAGE"),
         ("Nm", "NOR_MIN_BLOCKS"), ("Nb", "NOR_BULK"))


def _harness():
    """The repository's variants harness (kernel_variants.py), beside
    the package."""
    sys.path.insert(0, toolchain.REPO_DIR)
    import kernel_variants
    return kernel_variants


def variant_source(name, src, parent=None):
    """The kernel source edited as variant `name` asks; "parent" is
    `parent`, an earlier tree's source."""
    kv = _harness()
    if name == "source":
        return src
    if name == "parent":
        if parent is None:
            raise ValueError("variant 'parent' needs the parent's source "
                             "(--parent=PATH)")
        return parent
    for tok in name.split("_"):
        knob = next(((p, c) for p, c in KNOBS
                     if tok.startswith(p) and tok[len(p):].isdigit()), None)
        if knob is not None:
            src = kv.set_const(src, knob[1], tok[len(knob[0]):])
        elif tok.startswith("sleep") and tok[5:].isdigit():
            src = kv.edit(src, POLL, POLL + f"      __nanosleep({tok[5:]});\n")
        elif tok == "nolb":
            # the finalize's two chains and the scan's one
            src, n = re.subn(
                r"look_back<(\d)(?:, true)?>\(lb, tile, \w+, \w+, (\w+)\);",
                r"for (int k_ = 0; k_ < \1; ++k_) "
                r"\2[k_] = tile * 0x500000004ull;", src)
            if n != 3:
                raise ValueError("the source no longer holds 3 look-backs")
        elif tok == "Nfloor":
            src = kv.edit(src, NOR_FLOOR, "  return;\n" + NOR_FLOOR)
        elif tok == "Nland":
            src = kv.edit(src, NOR_LAND, NOR_LAND + "  return;\n")
        elif tok == "Nfold":
            src = kv.edit(src, NOR_FOLD, "  return;\n" + NOR_FOLD)
        elif tok == "Nred":
            src = kv.edit(src, NOR_RED, "  return;\n" + NOR_RED)
        elif tok == "Nnozero":
            src = kv.edit(src, NOR_ZERO, "")
        elif tok == "loads":
            src = kv.edit(src, LOADS_FIN, LOADS_FIN + "  return;\n")
            src = kv.edit(src, LOADS_SCAN, LOADS_SCAN + (
                "  {\n"
                "    const int next = draw_ticket(lb, ntiles, tile_s);\n"
                "    if (next < ntiles) scan_stage(in, next, S);\n"
                "    cp_commit();\n"
                "    return next;\n"
                "  }\n"))
        else:
            raise ValueError(f"unknown token {tok!r}")
    return src


def main_planes(workdir):
    """The finalize's and the NOR blocks' arguments of a main-path -gvcf
    run of 20,000 pairs: taps on calling_kernels.evidence_finalize and
    nor_blocks keep copies of what DeviceEvidence passed them."""
    import torch
    from . import cli, runner
    from .ops import calling_kernels as cal
    argv = _harness().main_path_argv(workdir, 20_000) + ["-gvcf"]
    kept = {}
    real, real_nor = cal.evidence_finalize, cal.nor_blocks

    def tap(acgt, exact_diff, f_diff, multi_diff, n, codes=None,
            words=None, **kw):
        kept.update(args=tuple(t.clone() for t in (acgt, exact_diff, f_diff,
                                                    multi_diff)),
                    n=n, words=words.clone())
        return real(acgt, exact_diff, f_diff, multi_diff, n, codes=codes,
                    words=words, **kw)

    def tap_nor(cov, emitted, brk_sorted, nseg):
        kept.update(nor=(cov.clone(), emitted.clone(), brk_sorted.clone(),
                         nseg))
        return real_nor(cov, emitted, brk_sorted, nseg)

    cal.evidence_finalize, cal.nor_blocks = tap, tap_nor
    try:
        if runner.run_pipeline(cli.parse_args(argv), " ".join(argv)) != 0:
            raise RuntimeError("the main-path run failed")
    finally:
        cal.evidence_finalize, cal.nor_blocks = real, real_nor
    torch.cuda.synchronize()
    if "nor" not in kept:
        raise RuntimeError("the -gvcf run made no NOR call")
    return kept


def parent_nor(lib):
    """The parent source's NOR entries (no scratch: a memset and two
    kernels) as (nor, nor_slice), taking the wrappers' arguments."""
    import ctypes as C
    import torch
    P, I, LL = C.c_void_p, C.c_int, C.c_longlong
    lib.mc_nor_blocks.argtypes = [P, I, P, I, P, I, I, P, P]
    lib.mc_nor_blocks_slice.argtypes = [P, I, P, I, P, I, I, LL, P, P]

    def run(fn, cov, L, em, brk, nseg, *off):
        out = torch.empty(3 * nseg, dtype=torch.int32, device=cov.device)
        err = fn(cov.data_ptr(), L, em.data_ptr(), em.numel(),
                 brk.data_ptr(), brk.numel(), nseg, *off, out.data_ptr(),
                 torch.cuda.current_stream(cov.device).cuda_stream)
        if err:
            raise RuntimeError(f"parent NOR: CUDA error {err}")
        return out
    return (lambda cov, em, brk, nseg: run(lib.mc_nor_blocks, cov,
                                           cov.numel(), em, brk, nseg),
            lambda cov, valid, em, brk, nseg, off: run(
                lib.mc_nor_blocks_slice, cov, valid, em, brk, nseg, off))


def nor_slices(nor_args, cut):
    """The NOR call's arguments as two slice-form calls cut at `cut`, as
    B4 makes them a shard: the first slice whole, the second with a valid
    length 777 short of its end, each with its own excluded positions
    and every break."""
    cov, em, brk, nseg = nor_args
    n = cov.numel()
    e = em.cpu()
    out = []
    for off, valid, pl in ((0, cut, cut), (cut, n - cut - 777, n - cut)):
        mine = e[(e >= off) & (e < off + valid)].to(em.device)
        out.append((cov[off:off + pl].contiguous(), valid, mine, brk, nseg,
                    off))
    return out


def sliced(fin, scan, args, n, words, scan_args, cut):
    """The finalize and the scan in two slices cut at `cut`, as B4 runs
    them a shard: the second slice's rows from `cut` on (acgt and f_diff
    at their own strides), its codes given, the first's carry, coverage
    total and seam; the scan's second slice with a valid length short of
    its end."""
    from .ops import calling_kernels as cal
    codes = cal.ref_codes_plain(words, n)
    acgt, exact, fdiff, mdiff = args
    a = fin(acgt, exact, fdiff, mdiff, cut, words=words, lead=False)
    rest = [t[..., cut:].contiguous() for t in (acgt, exact, fdiff, mdiff)]
    b = fin(*rest, n - cut, codes=codes[cut:].contiguous(), carry=a.carry,
            cov_in=int(a.carry[6]), lead=False)
    fb, ad, somatic = scan_args
    s1 = scan(a.acgt, a.multi, a.cov, a.codes, ad, fb, somatic)
    s2 = scan(b.acgt, b.multi, b.cov, b.codes, ad, fb, somatic,
              valid=n - cut - 777, seam=s1.seam)
    return tuple(a) + tuple(b) + tuple(s1) + tuple(s2)


def body(names, work, parent=None):
    import numpy as np
    import torch
    kv = _harness()
    import chip_smoke
    from .ops import calling_kernels as cal
    unique = list(dict.fromkeys(names))
    libs = kv.build(SRC, unique, lambda n, s: variant_source(n, s, parent),
                    KERNELS, work)
    kept = main_planes(work)
    args, n, words = kept["args"], kept["n"], kept["words"]
    # look-back scratch for the smallest tile a variant may take
    cal._look_back(args[0].device, n // 256 + 2)
    fb = np.float32(0.2)
    want = cal.evidence_finalize_plain(*args, n, words=words)
    scan_in = (want.acgt, want.multi, want.cov, want.codes, 2, fb, False)
    swant = cal.caller_scan_plain(*scan_in)
    cut = n // 3 + 13
    slices_want = sliced(cal.evidence_finalize_plain, cal.caller_scan_plain,
                         args, n, words, (fb, 2, False), cut)
    nor_args = kept["nor"]
    nor_sl = nor_slices(nor_args, cut)
    nor_want = (cal.nor_blocks_plain(*nor_args),
                *(cal.nor_blocks_slice_plain(*a) for a in nor_sl))
    out = dict(L=n, turns=names, nor=dict(
        L=nor_args[0].numel(), emitted=nor_args[1].numel(),
        breaks=nor_args[2].numel(), segments=nor_args[3],
        slices=[a[1] for a in nor_sl]), variants={})
    for name in names:
        lib, ptxas = libs[name]
        with kv.bound(cal, lib) as bound_lib:
            nor, nor_slice = (parent_nor(bound_lib) if name == "parent"
                              else (cal.nor_blocks, cal.nor_blocks_slice))
            got = cal.evidence_finalize(*args, n, words=words)
            sgot = cal.caller_scan(*scan_in)
            slices = sliced(cal.evidence_finalize, cal.caller_scan, args,
                            n, words, (fb, 2, False), cut)
            nor_got = (nor(*nor_args), *(nor_slice(*a) for a in nor_sl))
            equal = (chip_smoke.max_err_of(tuple(got), tuple(want)) == 0
                     and chip_smoke.max_err_of(tuple(sgot), tuple(swant))
                     == 0
                     and chip_smoke.max_err_of(slices, slices_want) == 0)
            nor_equal = chip_smoke.max_err_of(nor_got, nor_want) == 0
            toks = set(name.split("_"))
            if (not nor_equal and not NOR_TIMING_ONLY & toks) or (
                    not equal and not TIMING_ONLY & toks):
                raise AssertionError(f"{name}: outputs differ from the "
                                     f"plain versions'")
            turn = dict(
                finalize_ms=chip_smoke.cuda_ms(
                    lambda: cal.evidence_finalize(*args, n, words=words), 30,
                    queued=True),
                scan_ms=chip_smoke.cuda_ms(lambda: cal.caller_scan(*scan_in),
                                           30, queued=True),
                nor_ms=chip_smoke.cuda_ms(lambda: nor(*nor_args), 30,
                                          queued=True),
                nor_slice_ms=[chip_smoke.cuda_ms(
                    lambda a=a: nor_slice(*a), 30, queued=True)
                    for a in nor_sl])
            row = out["variants"].setdefault(name, dict(
                turns=[], equal=equal, nor_equal=nor_equal, ptxas=ptxas,
                geometry=None if name == "parent"
                else cal.geometry(args[0].device)))
            row["turns"].append(turn)
        print(name, turn, row["geometry"], flush=True)
    del got, sgot, slices, nor_got
    torch.cuda.synchronize()
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = PARENT
    names = []
    for a in argv:
        if a.startswith("--parent="):
            path = a.split("=", 1)[1]
        else:
            names.append(a)
    parent = None
    if "parent" in names:
        with open(path) as f:
            parent = f.read()
    return _harness().run(__doc__, names,
                          lambda ns, work: body(ns, work, parent))


if __name__ == "__main__":
    sys.exit(main())
