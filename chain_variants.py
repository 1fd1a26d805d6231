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
import os
import sys

import kernel_variants as kv

SRC = os.path.join(kv.HERE, "mapcaller_tpu_torch", "csrc", "chain.cu")

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


def variant_source(name, src):
    """The kernel source edited as variant `name` asks."""
    if name == "source":
        return src
    for tok in name.split("_"):
        if tok[0] in "GT" and tok[1:].isdigit():
            src = kv.set_const(src, "CP_GROUP" if tok[0] == "G"
                               else "CP_READS", tok[1:])
        elif tok == "acquire":
            src = kv.edit(src, "ld.relaxed.gpu", "ld.acquire.gpu")
            src = kv.edit(src, "st.relaxed.gpu", "st.release.gpu")
        elif tok == "nobound":
            src = kv.edit(src, "__reduce_max_sync(FULL, min(nkept, K_HITS))",
                          "K_HITS")
        elif tok.startswith("cut") and tok[3:] in CUTS:
            mark, store, after = CUTS[tok[3:]]
            stop = ("  if (in.max_len > 0) { if (live) { " + store
                    + " } return; }\n")
            src = kv.edit(src, mark, mark + stop if after else stop + mark)
        else:
            raise ValueError(f"unknown variant token {tok!r}")
    return src


def main_path_batch(workdir, n_pairs=20000):
    """(kernel, packed, rlens) of the first chain dispatch of a main-path
    run of n_pairs simulated pairs."""
    from mapcaller_tpu_torch import cli
    from mapcaller_tpu_torch.ops import fm_search
    got = {}
    call = fm_search.SeedChainKernel.__call__

    def tap(self, packed, rlens, planes=None, pair_end=False, out=None):
        got.setdefault("batch", (self, packed.clone(), rlens.clone()))
        return call(self, packed, rlens, planes=planes, pair_end=pair_end,
                    out=out)

    argv = kv.main_path_argv(workdir, n_pairs)
    fm_search.SeedChainKernel.__call__ = tap
    try:
        rc = cli.main(argv)
    finally:
        fm_search.SeedChainKernel.__call__ = call
    if rc != 0:
        raise RuntimeError("main path run failed")
    return got["batch"]


def variants(names, work):
    import torch
    import chip_smoke as cs
    from mapcaller_tpu_torch.ops import chain_kernels as ck
    libs = kv.build(SRC, names, variant_source,
                    ("chain_classify_pack_kernel",), work)
    kern, packed, rlens = main_path_batch(work)
    seeds = kern._scan_packed(packed, rlens)
    scan = ck.chain_scan_seeds(seeds[4], seeds[0], kern.H)
    hits = ck.chain_hits(kern.fm1, scan, *seeds[:5], kern.H)
    B = kern.batch
    args = (kern.ctx, packed, rlens, scan.off, hits, seeds[5], kern.max_len)
    want = torch.empty(2 * B + 2 * kern.H2 + B // 2 + B // 32 + 2,
                       dtype=torch.int32, device=packed.device)
    want_mmp = ck.chain_classify_pack_plain(*args, want, kern.H2)
    slow = cs.slow_counts(want, B).to(torch.int32).contiguous()
    res = {}
    for n, (lib_path, ptxas) in libs.items():
        with kv.bound(ck, lib_path):
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
    res["floor_ms"] = cs.cuda_ms(lambda: torch.cuda._sleep(0), 50,
                                 queued=True)
    res["batch"] = dict(B=B, H=kern.H, H2=kern.H2,
                        total_raw=int(scan.off[-1]), slow_kept=int(want[-2]))
    return dict(variants=res)


def main(argv=None):
    return kv.run(__doc__, argv, variants)


if __name__ == "__main__":
    sys.exit(main())
