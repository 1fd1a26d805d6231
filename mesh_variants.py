#!/usr/bin/env python3
"""Variants of K1's scan and of K2 (csrc/chain.cu, dp_scatter_scan_kernel
and evidence_apply_bits_kernel) timed on main-path data, to choose their
geometry and forms. Needs one CUDA card and nvcc.

    python3 mesh_variants.py VARIANT [VARIANT ...]

A variant is tokens joined by "_", each an edit of the source as it is:
  T<n>      threads a K1 tile (DP_THREADS)
  I<n>      elements a K1 thread scans (DP_ITEMS)
  scalar    K1 loads the partials 4 bytes at a time, no 16-byte loads
  A<n>      threads a K2 block (APPLY_THREADS)
  thread    K2 as a thread a read (its form before the lanes-a-read
            redesign): the admit test, then the read's loads and its
            atomics, no warp-wide skip
"source" is the source unedited. Each variant is compiled with the port's
nvcc flags, all at once. The data come from a main-path run of 20,000
simulated pairs (mapcaller_tpu_torch.simulator): K1 scans the run's four
orientation planes (int32 diffs of genome length + 2) as four partials
in four slices on this card, as the mesh's n = 4 coverage scan does;
K2 applies the run's first batch (its host admit bits, and the classes
of its packed output) to zeroed planes. Then each variant's queued
device ms (chip_smoke.cuda_ms), whether its outputs equal the plain
versions', and its ptxas report of K1, beside the empty-launch floor.
Prints the card's name and power limit, then one JSON line.
"""
import os
import sys

import kernel_variants as kv

SRC = os.path.join(kv.HERE, "mapcaller_tpu_torch", "csrc", "chain.cu")

# K2 as a thread a read, the form it had before its redesign
THREAD_K2 = r'''  const int b = blockIdx.x * APPLY_THREADS + threadIdx.x;
  if (b >= B || !(meta != nullptr ? (__ldg(meta + b) & 3) == CLASS_FAST
                                  : ((__ldg(bits + (b >> 5)) >> (b & 31))
                                     & 1u)))
    return;
  const long long two_l = 2LL * pl.L;
  const int p = __ldg(pd + b), rlen = __ldg(rlens + b);
  const int4 row = __ldg(mmp + b);
#pragma unroll
  for (int q = 0; q < MM_SLOTS; ++q)
    apply_fast_evidence(pl, two_l, p, rlen, b, q, pick4(row, q), sign);
}
'''
K2_BODY = "  constexpr int GROUPS = 32 / APPLY_LANES, ITEMS = 32 / GROUPS;\n"


def variant_source(name, src):
    """The kernel source edited as variant `name` asks."""
    if name == "source":
        return src
    for tok in name.split("_"):
        if tok[0] in "TIA" and tok[1:].isdigit():
            src = kv.set_const(src, {"T": "DP_THREADS", "I": "DP_ITEMS",
                                     "A": "APPLY_THREADS"}[tok[0]], tok[1:])
        elif tok == "scalar":
            src = kv.edit(src, "if (aligned && e + 3 < nread) {",
                          "if (false) {")
        elif tok == "thread":
            head, rest = src.split(K2_BODY, 1)
            src = head + THREAD_K2 + rest.split("\n}\n", 1)[1]
            src = kv.edit(src, "const int warps = (B + 31) / 32, "
                          "per_block = APPLY_THREADS / 32;",
                          "const int warps = B, per_block = APPLY_THREADS;")
        else:
            raise ValueError(f"unknown variant token {tok!r}")
    return src


def main_path_data(workdir):
    """The planes and the first stand-alone apply's inputs of a main-path
    run of 20,000 simulated pairs: (planes, (pd, mmp, rlens, admit words,
    packed output), pair_end)."""
    from mapcaller_tpu_torch import cli
    from mapcaller_tpu_torch.pipeline import device_profile
    got = {}
    apply = device_profile.DeviceEvidence.apply_batch

    def tap(self, token, fast_bits, pair_end):
        if "apply" not in got:
            B = int(token.rl_dev.shape[0])
            got["apply"] = ((token.pd.clone(), token.mmp.clone(),
                             token.rl_dev.clone(),
                             self._words(fast_bits, B).clone(),
                             token.dev.clone()), pair_end)
        got["planes"] = self.planes
        return apply(self, token, fast_bits, pair_end)

    argv = kv.main_path_argv(workdir, 20000)
    device_profile.DeviceEvidence.apply_batch = tap
    try:
        rc = cli.main(argv)
    finally:
        device_profile.DeviceEvidence.apply_batch = apply
    if rc != 0:
        raise RuntimeError("main path run failed")
    return (got["planes"], *got["apply"])


def variants(names, work):
    import torch
    import chip_smoke as cs
    from mapcaller_tpu_torch.ops import chain_kernels as ck
    from mapcaller_tpu_torch.ops import mesh_kernels as mk
    libs = kv.build(SRC, names, variant_source,
                    ("dp_scatter_scan_kernel",), work)
    planes, (pd, mmp, rl, words, meta), pe = main_path_data(work)
    dev = pd.device
    cur = torch.cuda.current_stream(dev)
    parts = [planes.f_diff[k].contiguous() for k in range(4)]
    L = planes.L
    want_scan = torch.cat(mk.dp_scatter_scan_plain(parts, 4, L))
    want_k2 = {src: mk.apply_bits_plain(mk.zero_planes(L, dev), pd, mmp, rl,
                                        sel, pe, 1, src)
               for src, sel in (("bits", words), ("meta", meta))}
    own = (mk.DP_THREADS, mk.DP_ITEMS)
    res = {}
    for n, (lib_path, ptxas) in libs.items():
        toks = dict((t[0], int(t[1:])) for t in n.split("_")
                    if t[0] in "TI" and t[1:].isdigit())
        mk.DP_THREADS, mk.DP_ITEMS = toks.get("T", own[0]), toks.get("I",
                                                                     own[1])
        mk.DP_TILE = mk.DP_THREADS * mk.DP_ITEMS
        r = dict(ptxas=ptxas)
        with kv.bound(ck, lib_path):
            def scan():
                return mk.dp_scatter_scan(parts, 4, L, [dev] * 4, [cur] * 4)
            r["k1_equal"] = bool(torch.equal(torch.cat(scan()), want_scan))
            r["k1_ms"] = cs.cuda_ms(scan, 50, queued=True)
            for src, sel in (("bits", words), ("meta", meta)):
                out = mk.zero_planes(L, dev)

                def apply():
                    return mk.apply_bits(out, pd, mmp, rl, sel, pe, 1, src)
                apply()
                r[f"k2_{src}_equal"] = all(
                    torch.equal(a, b) for a, b in zip(out, want_k2[src]))
                r[f"k2_{src}_ms"] = cs.cuda_ms(apply, 50, queued=True)
        res[n] = r
    mk.DP_THREADS, mk.DP_ITEMS = own
    mk.DP_TILE = own[0] * own[1]
    res["floor_ms"] = cs.cuda_ms(lambda: torch.cuda._sleep(0), 50,
                                 queued=True)
    res["data"] = dict(L=L, reads=int(pd.shape[0]),
                       admitted=int(mk._admitted(words, pd.shape[0], "bits",
                                                 dev).sum()))
    return dict(variants=res)


def main(argv=None):
    return kv.run(__doc__, argv, variants)


if __name__ == "__main__":
    sys.exit(main())
