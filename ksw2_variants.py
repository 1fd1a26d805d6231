#!/usr/bin/env python3
"""Variants of the ksw2 DP kernel (csrc/ksw2.cu, ksw2_ops_kernel) timed on
the main path's own pairs and on random pairs, to choose its geometry and
split its time into the fill and the backtrack. Needs one CUDA card and
nvcc.

    python3 ksw2_variants.py VARIANT [VARIANT ...]

A variant is tokens joined by "_", each an edit of the source as it is
(and of the geometry ksw2_geometry computes for it):
  G<n>      lanes a pair (GROUP; 16 puts two pairs in a warp)
  fixed     flag rows at the widest row's stride, not back to back with
            an offset table
  bytes     a byte a flag cell in place of a nibble
  allchunks every chunk of a lane runs on every diagonal (its updates
            still kept inside the window): no chunk skipped
  vote      the test of a live chunk made by a warp vote (__all_sync)
  clocks    each pair's first three words are the SM cycles of its fill,
            of its backtrack, and its number of diagonals (clock64); the
            report gives them for the longest pair of each input
  noflags   the fill stores no direction flag (the words are then wrong)
  cutstage  the kernel stops after staging the query and the target
            codes, storing a value that depends on them
  cutfill   the kernel stops after the fill and stores a value that
            depends on every lane's state and on the flags, so the
            compiler keeps that work: the fill's time (its words are then
            wrong)
"source" is the source unedited. `cutfill` and `source` also apply to the
first design (a warp per pair, flags in device memory): copy this script
and kernel_variants.py into a checkout of it to time that design the same
way. Each variant is compiled with the port's nvcc flags, all at once;
then each runs on the largest ksw2 launch of a main-path `-alg ksw2` run
with device DP (100,000 simulated pairs, chip_smoke.py's main path), on
its longest pair alone, and on random pairs at tiers 32, 48, 96 and 192
(chip_smoke.ksw2_inputs): its queued device ms (chip_smoke.cuda_ms),
whether its words equal the plain version's, its ptxas report and, where
the source has it, its geometry and the pairs an SM holds, beside the
empty-launch floor and each input's bound. Prints the card's name and
power limit, then one JSON line.
"""
import functools
import os
import sys

import kernel_variants as kv

SRC = os.path.join(kv.HERE, "mapcaller_tpu_torch", "csrc", "ksw2.cu")

# G<n>: the group's lanes a mask, two groups to a warp at 16
_GMASK = ("  const unsigned gmask = FULL;            // the group's lanes\n",
          "  const unsigned gmask =\n"
          "      GROUP == 32 ? FULL : 0xffffu << (threadIdx.x & 16);\n")
_SKIP = "      if (k < klo || k > khi) continue;\n"
_STAGED = "  __syncwarp(gmask);                      // the staged query\n"
_FILLED = ("  __syncwarp(gmask);                      // the group's flag "
           "stores\n")
_W = "min(N, (min(M, N) + 30) >> 4 << 4)"      # the widest row's cells
# the other tokens: (old, new) edits of the source
EDITS = {
    "fixed": (
        ("  const long cells = packed_cells(M, N);\n",
         "  const long cells =\n"
         "      (long)(M + N - 1) * std::min(N, (std::min(M, N) + 30) >> 4 "
         "<< 4);\n"),
        ("  l.pbytes = l.qbytes + l.fbytes + ((2 * (M + N - 1) + 15) & "
         "~15);\n",
         "  l.pbytes = l.qbytes + l.fbytes;\n"),
        ("  const int M = sh.M, N = sh.N, NC = sh.NC;\n",
         f"  const int M = sh.M, N = sh.N, NC = sh.NC, W = {_W};\n"),
        ("    const int base = row - st;            // cell of column 0\n"
         "    if (lane == 0) rows[r] = (uint16_t)(row >> 4);\n"
         "    row += en - st + 1;\n",
         "    const int base = r * W - st;\n"),
        ("get_flag(fl, ((int)rows[r] << 4) + i - st)",
         "get_flag(fl, r * W + i - st)")),
    "bytes": (
        ("  l.fbytes = (int)((cells / 2 + 15) & ~15L);\n",
         "  l.fbytes = (int)((cells + 15) & ~15L);\n"),
        ("  const int nib = (d & 3) | ((d >> 1) & 0xC);\n"
         "  const int odd = __shfl_down_sync(gmask, nib, 1, GROUP);\n"
         "  if (in && !(lane & 1)) fl[cell >> 1] = (uint8_t)(nib | (odd << "
         "4));\n",
         "  if (in) fl[cell] = (uint8_t)d;\n"),
        ("  const int nib = (fl[cell >> 1] >> ((cell & 1) << 2)) & 15;\n"
         "  return (nib & 3) | ((nib << 1) & 0x18);\n",
         "  return fl[cell];\n")),
    "allchunks": ((_SKIP, ""),),
    "vote": ((_SKIP, "      if (!__all_sync(gmask, k >= klo && k <= khi)) "
                     "continue;\n"),),
    "noflags": (("      put_flag(fl, base + t, d, in, gmask, lane);\n", ""),),
    "cutstage": (("  const int nd = ql > 0 && tl > 0 ?",
                  "  if (ql >= 0) {\n"
                  "    unsigned acc = q[(ql * 131 + tl) % M];\n"
                  "#pragma unroll\n"
                  "    for (int k = 0; k < C; ++k) acc ^= tg[k] << k;\n"
                  "    acc = __reduce_xor_sync(gmask, acc);\n"
                  "    if (lane == 0) words[(size_t)b * ((M + N + 15) >> 4)]"
                  " = acc;\n"
                  "    return;\n"
                  "  }\n"
                  "  const int nd = ql > 0 && tl > 0 ?"),),
    "clocks": (
        (_STAGED, "  __syncwarp(gmask);\n  const long long c0 = clock64();\n"),
        (_FILLED, "  const long long c1 = clock64();\n  __syncwarp(gmask);\n"),
        ("    out[wd] = word;\n  }\n}\n",
         "    out[wd] = word;\n  }\n"
         "  out[0] = (uint32_t)(c1 - c0);\n"
         "  out[1] = (uint32_t)(clock64() - c1);\n"
         "  out[2] = (uint32_t)nd;\n}\n")),
}

# cutfill: the line after the fill, in this design and in the first one
# (mask, marker)
_FILL_ENDS = (
    ("gmask", _FILLED),
    ("FULL", "  __syncwarp();                           // the warp's flag "
             "stores\n"),
)
_CUT = """  {{
    unsigned acc = 0;
#pragma unroll
    for (int k = 0; k < C; ++k)
      acc ^= (unsigned)u[k] ^ ((unsigned)v[k] << 8) ^ ((unsigned)x[k] << 16)
             ^ ((unsigned)y[k] << 24);
    acc = __reduce_xor_sync({mask}, acc);
    __syncwarp({mask});
    if (lane == 0)
      words[(size_t)b * ((M + N + 15) >> 4)] = acc ^ {flag};
    return;
  }}
"""


def variant_source(name, src):
    """The kernel source edited as variant `name` asks."""
    if name == "source":
        return src
    for tok in name.split("_"):
        if tok[0] == "G" and tok[1:].isdigit():
            src = kv.edit(kv.set_const(src, "GROUP", tok[1:]), *_GMASK)
        elif tok in EDITS:
            for old, new in EDITS[tok]:
                src = kv.edit(src, old, new)
        elif tok == "cutfill":
            for mask, mark in _FILL_ENDS:
                if mark in src:
                    flag = ("fl[(ql * 131 + tl) % sh.l.fbytes]"
                            if mask == "gmask" else "0u")
                    src = src.replace(mark, _CUT.format(mask=mask, flag=flag)
                                      + mark)
                    break
            else:
                raise ValueError("the source holds no known end of the fill")
        else:
            raise ValueError(f"unknown variant token {tok!r}")
    return src


def pair_bytes(M, N, packed, flag_bits):
    """Shared memory of one pair in a variant's layout (ksw2_pair_bytes
    for packed nibble rows)."""
    from mapcaller_tpu_torch.ops import ksw2_device as k
    up16 = lambda n: (n + 15) // 16 * 16  # noqa: E731
    cells = (k.ksw2_pair_cells(M, N) if packed else
             (M + N - 1) * min(N, (min(M, N) + 30) // 16 * 16))
    return (up16(M) + up16(cells * flag_bits // 8)
            + (up16(2 * (M + N - 1)) if packed else 0))


def geometry_of(name, k, base):
    """`base` (ksw2_geometry) for the variant's lanes and flag layout,
    refusing a block of part of a warp (None for the first design, which
    has no geometry function)."""
    if base is None:
        return None
    toks = name.split("_")
    group = next((int(t[1:]) for t in toks
                  if t[0] == "G" and t[1:].isdigit()), k.KERNEL_GROUP)
    own = (k.KERNEL_GROUP, k.ksw2_pair_bytes)

    def geo(M, N):
        k.KERNEL_GROUP = group
        k.ksw2_pair_bytes = functools.partial(
            pair_bytes, packed="fixed" not in toks,
            flag_bits=8 if "bytes" in toks else 4)
        base.cache_clear()
        try:
            g = base(M, N)
        finally:
            k.KERNEL_GROUP, k.ksw2_pair_bytes = own
            base.cache_clear()
        if group * g[1] % 32:
            raise ValueError(f"{g[1]} pairs of {group} lanes are part of "
                             f"a warp")
        return g
    return geo


def main_path_launch(workdir):
    """The tensors of the largest ksw2 launch of an -alg ksw2 run with
    device DP on chip_smoke's main-path data, and the run's launches."""
    from mapcaller_tpu_torch import cli, runner
    from mapcaller_tpu_torch.ops import ksw2_device
    got = []
    ops = ksw2_device.ksw2_ops

    def tap(*args):
        got.append(tuple(a.clone() for a in args))
        return ops(*args)

    cfg = cli.parse_args(kv.main_path_argv(workdir, 100_000))
    cfg.use_nw = False
    cfg.device_extension = True
    ksw2_device.ksw2_ops = tap
    try:
        rc = runner.run_pipeline(cfg, "mapcaller -alg ksw2")
    finally:
        ksw2_device.ksw2_ops = ops
    if rc != 0 or not got:
        raise RuntimeError("main path -alg ksw2 run failed or launched no "
                           "ksw2 kernel")
    return max(got, key=lambda a: a[0].shape[0]), len(got)


def variants(names, work):
    import torch
    import chip_smoke as cs
    from mapcaller_tpu_torch.ops import ksw2_device as k
    libs = kv.build(SRC, names, variant_source, ("ksw2_ops_kernel",),
                    work)
    own, n_launches = main_path_launch(work)
    longest = int(torch.argmax(torch.maximum(own[2], own[3])))
    inputs = {"own": own,
              "own_longest": tuple(a[longest:longest + 1] for a in own),
              "random32": cs.ksw2_inputs(4096, 32, seed=32),
              "random48": cs.ksw2_inputs(4096, 48, seed=48),
              "random96": cs.ksw2_inputs(2004, 96, seed=1),
              "random192": cs.ksw2_inputs(2048, 192, seed=192)}
    want = {}
    info = {}
    for key, args in inputs.items():
        want[key] = k.ksw2_ops_plain(*args)
        bound, by = cs.ksw2_bound_ms(*args)
        info[key] = dict(B=args[0].shape[0], M=args[0].shape[1],
                         N=args[1].shape[1] - 16,
                         cells=cs.ksw2_cells(args[2], args[3]),
                         bound_ms=bound, bound_by=by)
    info["own"]["launches_a_run"] = n_launches
    own_geo = getattr(k, "ksw2_geometry", None)
    res = {}
    try:
        for n, (lib_path, ptxas) in libs.items():
            geo = geometry_of(n, k, own_geo)
            if geo is not None:
                k.ksw2_geometry = geo
            row = dict(ptxas=ptxas)
            with kv.bound(k, lib_path):
                for key, args in inputs.items():
                    M, N = info[key]["M"], info[key]["N"]
                    try:
                        g = geo(M, N) if geo is not None else None
                    except ValueError as e:    # a geometry it refuses
                        row[key] = dict(refused=str(e))
                        continue
                    words = k.ksw2_ops(*args)
                    torch.cuda.synchronize()
                    row[key] = dict(
                        ms=cs.cuda_ms(lambda: k.ksw2_ops(*args), 50,
                                      queued=True),
                        equal=bool(torch.equal(words, want[key])))
                    if "clocks" in n.split("_"):
                        p = int(torch.argmax(words[:, 0]))
                        row[key]["clocks_slowest_fill"] = dict(
                            fill=int(words[p, 0]), backtrack=int(words[p, 1]),
                            diagonals=int(words[p, 2]))
                    if g is not None:
                        row[key].update(geometry=g,
                                        pairs_an_sm=k.ksw2_resident_pairs(*g))
            res[n] = row
    finally:
        if own_geo is not None:
            k.ksw2_geometry = own_geo
    floor = cs.cuda_ms(lambda: torch.cuda._sleep(0), 50, queued=True)
    return dict(floor_ms=floor, inputs=info, variants=res)


def main(argv=None):
    return kv.run(__doc__, argv, variants)


if __name__ == "__main__":
    sys.exit(main())
