#!/usr/bin/env python3
"""Variants of the classify+pack kernel (csrc/chain.cu,
chain_classify_pack_kernel) timed on a main-path batch, to choose its
geometry and see where its time goes. Needs one CUDA card and nvcc.

    python3 chain_variants.py VARIANT [VARIANT ...]

A variant is tokens joined by "_", each an edit of the source as it is:
  G<n>      lanes a read (CP_GROUP)
  T<n>      reads a tile (CP_READS)
  acquire   acquire loads and release stores in the look-back, in place of
            relaxed ones
  nobound   the window's shuffle loops run all K_HITS slots, not only up
            to the warp's most kept hits
  cut<p>    the kernel stops after phase p (stage, window, sort, words,
            classify) and stores a value that depends on everything that
            phase computed, so the compiler keeps that work: the time to
            that point (its outputs are then wrong)
"source" is the source unedited. Each variant is compiled with the port's
nvcc flags, all at once; a batch of 32,768 reads comes from a main-path
run of 20,000 simulated pairs (mapcaller_tpu_torch.simulator); then each
variant's queued device ms on it (chip_smoke.cuda_ms), whether its
outputs equal the plain composition's, its ptxas report and the stand-
alone scan's ms on the batch's slow counts, beside the empty-launch floor.
Prints the card's name and power limit, then one JSON line.
"""
import ctypes
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "mapcaller_tpu_torch", "csrc", "chain.cu")

# cut<p>: where the kernel stops, and what it stores there
CUTS = {
    "stage": ("  const long long* keys = keys_staged ? s_keys : cx.bkeys;\n",
              "out[b0 + r] = s_off[r] ^ (int)s_words[r * nwords + j] ^ "
              "s_rlen[r] ^ s_flag[r] ^ (int)cx.bkeys[0];", True),
    "window": ("  // ---- the window stably sorted",
               "out[b] = w_pd[0] ^ w_rp[0] ^ w_ln[0] ^ nkept;", False),
    "sort": ("  // ---- masks along the diagonal",
             "out[b] = spd[0] ^ srp[0] ^ sln[0] ^ (int)span_ok ^ cscore ^ "
             "seed_end ^ (int)one_diag;", False),
    "words": ("  // ---- gaps: the group's leader walks",
              "out[b] = mm_total ^ (int)rw[j] ^ smm[j % MM_SLOTS];", False),
    "classify": ("  // ---- the pack: the slow counts' prefix", "", False),
}


def _edit(s, old, new):
    if old not in s:
        raise ValueError(f"the source no longer holds {old!r}")
    return s.replace(old, new)


def variant_source(name, src):
    """The kernel source edited as variant `name` asks."""
    if name == "source":
        return src
    for tok in name.split("_"):
        if tok[0] in "GT" and tok[1:].isdigit():
            const = "CP_GROUP" if tok[0] == "G" else "CP_READS"
            cur = src.split(f"constexpr int {const} = ", 1)[1].split(";")[0]
            src = _edit(src, f"{const} = {cur};", f"{const} = {tok[1:]};")
        elif tok == "acquire":
            src = _edit(src, "ld.relaxed.gpu", "ld.acquire.gpu")
            src = _edit(src, "st.relaxed.gpu", "st.release.gpu")
        elif tok == "nobound":
            src = _edit(src, "__reduce_max_sync(FULL, min(nkept, K_HITS))",
                        "K_HITS")
        elif tok.startswith("cut") and tok[3:] in CUTS:
            mark, store, after = CUTS[tok[3:]]
            stop = ("  if (in.max_len > 0) { if (live) { " + store
                    + " } return; }\n")
            src = _edit(src, mark, mark + stop if after else stop + mark)
        else:
            raise ValueError(f"unknown variant token {tok!r}")
    return src


def build(names, workdir):
    """Compile every variant at once -> {name: (library, ptxas report)}."""
    sys.path.insert(0, HERE)
    import chip_smoke
    from mapcaller_tpu_torch import toolchain
    with open(SRC) as f:
        src = f.read()
    procs = {}
    for n in names:
        cu = os.path.join(workdir, f"{n}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(n, src))
        lib = os.path.join(workdir, f"lib{n}.so")
        procs[n] = (lib, subprocess.Popen(
            [toolchain.nvcc_path(), *toolchain.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for n, (lib, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"{n}: nvcc failed\n{log[-3000:]}")
        out[n] = (lib, list(chip_smoke.ptxas_report(
            log, "chain_classify_pack_kernel").values()))
    return out


def main_path_batch(workdir):
    """(kernel, packed, rlens) of the first chain dispatch of a main-path
    run of 20,000 simulated pairs."""
    from mapcaller_tpu_torch import cli
    from mapcaller_tpu_torch.ops import fm_search
    from mapcaller_tpu_torch.simulator import write_ecoli_set
    got = {}
    call = fm_search.SeedChainKernel.__call__

    def tap(self, packed, rlens, planes=None, pair_end=False):
        got.setdefault("batch", (self, packed.clone(), rlens.clone()))
        return call(self, packed, rlens, planes=planes, pair_end=pair_end)

    fa, r1, r2 = write_ecoli_set(workdir, 20000)
    idx = os.path.join(workdir, "mci")
    if cli.main(["mapcaller", "index", fa, idx]) != 0:
        raise RuntimeError("index build failed")
    fm_search.SeedChainKernel.__call__ = tap
    try:
        rc = cli.main(["mapcaller", "-i", idx, "-f", r1, "-f2", r2, "-sam",
                       os.path.join(workdir, "out.sam"), "-vcf",
                       os.path.join(workdir, "out.vcf"), "-log",
                       os.path.join(workdir, "job.log")])
    finally:
        fm_search.SeedChainKernel.__call__ = call
    if rc != 0:
        raise RuntimeError("main path run failed")
    return got["batch"]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    import torch
    if not torch.cuda.is_available() or not argv:
        sys.stderr.write(__doc__)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from mapcaller_tpu_torch import toolchain
    from mapcaller_tpu_torch.ops import chain_kernels as ck
    card = cs.card_line()
    print(card, flush=True)
    os.makedirs(toolchain.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=toolchain.BUILD_DIR) as work:
        libs = build(argv, work)
        kern, packed, rlens = main_path_batch(work)
        seeds = kern._scan_packed(packed, rlens)
        scan = ck.chain_scan_seeds(seeds[4], seeds[0], kern.H)
        hits = ck.chain_hits(kern.fm1, scan, *seeds[:5], kern.H)
        B = kern.batch
        args = (kern.ctx, packed, rlens, scan.off, hits, seeds[5],
                kern.max_len)
        want = torch.empty(2 * B + 2 * kern.H2 + B // 2 + B // 32 + 2,
                           dtype=torch.int32, device=packed.device)
        want_mmp = ck.chain_classify_pack_plain(*args, want, kern.H2)
        slow = cs.slow_counts(want, B).to(torch.int32).contiguous()
        res = {}
        own = ck._load_kernel()
        try:
            for n, (lib_path, ptxas) in libs.items():
                lib = ctypes.CDLL(lib_path)
                for fn in ("mc_chain_classify_pack", "mc_chain_scan"):
                    getattr(lib, fn).restype = ctypes.c_int
                    getattr(lib, fn).argtypes = getattr(own, fn).argtypes
                ck._lib = lib
                out = torch.empty_like(want)

                def run():
                    return ck.chain_classify_pack(*args, out, kern.H2)

                mmp = run()
                torch.cuda.synchronize()
                res[n] = dict(
                    ms=cs.cuda_ms(run, 50, queued=True),
                    equal=bool(torch.equal(out, want)
                               and torch.equal(mmp, want_mmp)),
                    scan_ms=cs.cuda_ms(lambda: ck.chain_scan(slow), 50,
                                       queued=True),
                    ptxas=ptxas)
        finally:
            ck._lib = own
        res["floor_ms"] = cs.cuda_ms(lambda: torch.cuda._sleep(0), 50,
                                     queued=True)
        res["batch"] = dict(B=B, H=kern.H, H2=kern.H2,
                            total_raw=int(scan.off[-1]),
                            slow_kept=int(want[-2]))
    print(json.dumps(dict(card=card, variants=res)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
