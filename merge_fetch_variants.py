#!/usr/bin/env python3
"""The host-delta merge (csrc/chain.cu host_merge_kernel) and the column
fetch (csrc/calling.cu caller_fetch_kernel, caller_fetch_slice_kernel)
timed beside an earlier tree's forms of them, in one call. Needs one CUDA
card and nvcc.

    python3 merge_fetch_variants.py [--parent=DIR] VARIANT [VARIANT ...]

A variant is "source" (the sources as they are), tokens joined by "_",
each an edit of them:
  T<n>      n threads a fetch block (FETCH_THREADS; a tile of n / 2
            positions)
  S<n>      n shards at most in a slice-form fetch launch's table
            (FETCH_MAX_SHARDS: the size of its parameters)
or:
  parent    the parent tree's csrc/chain.cu and csrc/calling.cu, read
            from DIR (default _checkouts/parent/mapcaller_tpu_torch/csrc,
            git-ignored; write them first, e.g.
                mkdir -p _checkouts/parent/mapcaller_tpu_torch/csrc
                git show 02300f2:mapcaller_tpu_torch/csrc/chain.cu \\
                    > _checkouts/parent/mapcaller_tpu_torch/csrc/chain.cu
            and calling.cu the same way): its merge a launch a shard (a
            thread an entry), its fetch's slice form a launch a shard at
            the shard's local indices, each called through its own entry
A variant named twice is timed twice, in the order given (parent source
source parent compares the two trees in turns). The data are made on the
card from seeds, at the main data's sizes: the merge takes the 1% deltas
of chip_smoke.py's time_host_merge (seeded_lists: L 4,600,000, seed 5)
into zeroed planes, the single-card planes (A5) and B4's shards at
-shards 2 and 4 (this tree's also held cut into launches of 7
segments, as a call past 512 segments is cut); the fetch takes random finalized planes of L positions
and 13,883 sorted positions, 224 prefix points and the positions'
blocks (the counts of the main data's first fetch), on one card's planes
and over B4's shards at -shards 2 and 4. Each variant's outputs are held
equal to the plain versions' in every word, then timed: queued device ms
(chip_smoke.cuda_ms) of each call's launches, beside an empty launch;
and each merge call whole by the host's clock (the parent's: the packed
lists' upload and its launches; this tree's: host_merge, its checks,
segments, packing, copy and launch, cut into those parts). Every turn
also times two controls of the merge (CONTROL, built once): the same
adds by red.global.add, 8 a thread by 16-byte loads of (word address,
value), with no lists, segments or runs, at the seeded deltas' own
word addresses in the single-card planes ("scatter", held equal to
the plain merge) and at as many consecutive words ("dense").
Prints the card's name and power limit, then one JSON line.
"""
import os
import subprocess
import sys

import kernel_variants as kv

CSRC = os.path.join(kv.HERE, "mapcaller_tpu_torch", "csrc")
PARENT = os.path.join(kv.HERE, "_checkouts", "parent", "mapcaller_tpu_torch",
                      "csrc")
L = 4_600_000
P_POS, Q_PTS = 13_883, 224   # the main data's first fetch
KERNELS = ("host_merge_kernel", "caller_fetch_kernel",
           "caller_fetch_slice_kernel")
# the merge's controls: its adds alone, from precomputed word addresses
CONTROL = r"""
#include <cuda_runtime.h>
__global__ void __launch_bounds__(256)
scatter_red_kernel(const long long* __restrict__ addr,
                   const int* __restrict__ val, long long units) {
  const long long u = (long long)blockIdx.x * 256 + threadIdx.x;
  if (u >= units) return;
  long long a[8];
  int v[8];
  const longlong2* ap = reinterpret_cast<const longlong2*>(addr + 8 * u);
  const int4* vp = reinterpret_cast<const int4*>(val + 8 * u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const longlong2 t = __ldcs(ap + k);
    a[2 * k] = t.x;
    a[2 * k + 1] = t.y;
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int4 t = __ldcs(vp + k);
    v[4 * k] = t.x;
    v[4 * k + 1] = t.y;
    v[4 * k + 2] = t.z;
    v[4 * k + 3] = t.w;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (a[j]) atomicAdd(reinterpret_cast<int*>(a[j]), v[j]);
}
extern "C" int mc_scatter_red(const void* addr, const void* val,
                              long long units, void* stream) {
  scatter_red_kernel<<<(unsigned int)((units + 255) / 256), 256, 0,
                       (cudaStream_t)stream>>>(
      (const long long*)addr, (const int*)val, units);
  return (int)cudaGetLastError();
}
"""


def sources(name, parent_dir):
    """(chain.cu, calling.cu) of variant `name`."""
    out = []
    for f in ("chain.cu", "calling.cu"):
        with open(os.path.join(parent_dir if name == "parent" else CSRC,
                               f)) as fh:
            out.append(fh.read())
    if name in ("parent", "source"):
        return out
    for tok in name.split("_"):
        if tok[:1] in "TS" and tok[1:].isdigit():
            out[1] = kv.set_const(out[1], "FETCH_THREADS" if tok[0] == "T"
                                  else "FETCH_MAX_SHARDS", tok[1:])
        else:
            raise ValueError(f"unknown variant token {tok!r}")
    return out


def build(names, parent_dir, work):
    """Both sources of every variant and the controls compiled at once
    (and the port's own libraries meanwhile) -> {name: ({"chain":
    libchain, "calling": libcalling}, ptxas)}, "control": the controls'
    library}."""
    import chip_smoke
    from mapcaller_tpu_torch import toolchain
    procs = {}
    cu = os.path.join(work, "control.cu")
    with open(cu, "w") as f:
        f.write(CONTROL)
    control = os.path.join(work, "libcontrol.so")
    procs["control", ""] = (control, subprocess.Popen(
        [toolchain.nvcc_path(), *toolchain.NVCC_FLAGS, "-o", control, cu],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for n in names:
        for tag, src in zip(("chain", "calling"), sources(n, parent_dir)):
            cu = os.path.join(work, f"{n}_{tag}.cu")
            with open(cu, "w") as f:
                f.write(src)
            lib = os.path.join(work, f"lib{n}_{tag}.so")
            procs[n, tag] = (lib, subprocess.Popen(
                [toolchain.nvcc_path(), *toolchain.NVCC_FLAGS, "-o", lib, cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    toolchain.build_all()
    out = {}
    for (n, tag), (lib, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"{n} {tag}: nvcc failed\n{log[-3000:]}")
        if n == "control":
            out[n] = lib
            continue
        libs, rep = out.setdefault(n, ({}, {}))
        libs[tag] = lib
        rep.update({k: chip_smoke.ptxas_report(log, k) for k in KERNELS
                    if chip_smoke.ptxas_report(log, k)})
    return out


def merge_data(torch, np):
    """The seeded lists (host), the zeroed single-card planes and B4's
    zeroed shards at n = 2 and 4 on the card."""
    import chip_smoke
    from mapcaller_tpu_torch.pipeline import device_profile as dp
    from mapcaller_tpu_torch.pipeline.big_profile import ShardPlanes
    buf, ends, _ = chip_smoke.seeded_lists(L)
    cuda = torch.device("cuda")
    layouts = {"a5": [(dp.DevicePlanes.zeros(L, cuda), 0)]}
    for n in (2, 4):
        Pl = -(-(L + 2) // (n * 400)) * 400
        layouts[f"shards_{n}"] = [(ShardPlanes.zeros(Pl, s * Pl, cuda),
                                   s * Pl) for s in range(n)]
    return buf, ends, layouts


def parent_merge_launches(lib, shards, gbuf, N, ends, gstrides):
    """The parent tree's merge: mc_host_merge(idx, val, ends, planes,
    gstride, lstride, off, stream), a launch a shard."""
    import ctypes as C
    import torch
    from mapcaller_tpu_torch.ops import mesh_kernels as mk
    P, LL = C.c_void_p, C.c_longlong
    lib.mc_host_merge.argtypes = [P] * 6 + [LL, P]
    lib.mc_host_merge.restype = C.c_int
    Np = mk._padded(N)
    L4 = LL * 4
    args = []
    for planes, off in shards:
        fields = [getattr(planes, f) for f in mk.MERGE_PLANES]
        args.append((gbuf.data_ptr(), gbuf.data_ptr() + 8 * Np, L4(*ends),
                     (P * 4)(*(t.data_ptr() for t in fields)),
                     L4(*gstrides), L4(*(t.shape[-1] for t in fields)),
                     int(off)))

    def run():
        stream = torch.cuda.current_stream().cuda_stream
        for a in args:
            err = lib.mc_host_merge(*a, stream)
            if err:
                raise RuntimeError(f"parent merge: CUDA error {err}")
    return run


def source_merge_launch(shards, buf, ends, gstrides):
    """This tree's merge: the call's one launch (its buffer made and
    uploaded once, before the timing)."""
    from mapcaller_tpu_torch.ops import mesh_kernels as mk
    calls = []
    real = mk._merge_launch
    mk._merge_launch = lambda *a: calls.append(a)
    try:
        mk.host_merge(shards, buf, ends, gstrides)
    finally:
        mk._merge_launch = real
    (a,) = calls
    return lambda: mk._merge_launch(*a)


def fetch_data(torch, np):
    """Random finalized planes of L positions on the card (int32 rows,
    the exclusive coverage prefix), sorted positions, points and their
    blocks; B4's shards of them at n = 2 and 4 (each shard's rows, its
    inclusive prefix, the coverage before it, its block depths)."""
    rng = np.random.default_rng(13)
    cuda = torch.device("cuda")
    acgt, F = (torch.from_numpy(rng.integers(0, 4096, (4, L)).astype(
        np.int32)).to(cuda) for _ in range(2))
    multi, cov = (torch.from_numpy(rng.integers(0, 4096, L).astype(
        np.int32)).to(cuda) for _ in range(2))
    cpre = torch.cat([torch.zeros(1, dtype=torch.int64, device=cuda),
                      torch.cumsum(cov.long(), 0)])
    bd = torch.from_numpy(rng.integers(0, 300, (L + 99) // 100).astype(
        np.int32)).to(cuda)
    p = np.sort(rng.choice(L, P_POS, replace=False)).astype(np.int64)
    pp = np.sort(rng.integers(0, L + 1, Q_PTS)).astype(np.int64)
    blocks = np.unique(p // 100)
    single = (acgt, multi, F, cov, cpre, bd)
    sharded = {}
    for n in (2, 4):
        Pl = -(-(L + 2) // (n * 400)) * 400
        shards, bds, before = [], [], []
        for s in range(n):
            lo, hi = s * Pl, min((s + 1) * Pl, L)

            def cut(t, lo=lo, hi=hi):
                z = torch.zeros(t.shape[:-1] + (Pl,), dtype=t.dtype,
                                device=cuda)
                z[..., :max(hi - lo, 0)] = t[..., lo:hi]
                return z
            c = cut(cov)
            shards.append((cut(acgt), cut(F), cut(multi), c,
                           torch.cumsum(c.long(), 0)))
            before.append(int(cpre[min(lo, L)]))
            b = torch.zeros(Pl // 100, dtype=torch.int32, device=cuda)
            nb = max(min(Pl // 100, bd.numel() - s * (Pl // 100)), 0)
            b[:nb] = bd[s * (Pl // 100):s * (Pl // 100) + nb]
            bds.append(b)
        sharded[n] = (Pl, shards, bds, before)
    return single, sharded, (p, pp, blocks)


def parent_fetch_slice(lib, Pl, shards, bds, before, p, pp, blocks):
    """The parent tree's slice-form fetch (chip_smoke.fetch_by_shard):
    mc_caller_fetch_slice a shard at its local indices (uploaded once,
    before the timing) -> (run: the launches alone, the output composed
    on the host as one array, laid out as caller_fetch's)."""
    import ctypes as C
    import numpy as np
    import torch
    import chip_smoke
    P, I, LL = C.c_void_p, C.c_int, C.c_longlong
    lib.mc_caller_fetch_slice.argtypes = [P] * 5 + [LL, P, P] + [I] * 4 \
        + [P, P]
    lib.mc_caller_fetch_slice.restype = C.c_int
    args = []

    def run():
        stream = torch.cuda.current_stream().cuda_stream
        for a in args:
            err = lib.mc_caller_fetch_slice(*a[:-2], stream)
            if err:
                raise RuntimeError(f"parent fetch: CUDA error {err}")

    def answer(jobs):
        for s, Ps, Qs, loc in jobs:
            acgt, F, multi, cov, ccov = shards[s]
            idx = torch.from_numpy(loc).cuda()
            out = torch.empty(idx.numel() + 9 * Ps, dtype=torch.int64,
                              device="cuda")
            args.append((acgt.data_ptr(), multi.data_ptr(), F.data_ptr(),
                         cov.data_ptr(), ccov.data_ptr(), before[s],
                         bds[s].data_ptr(), idx.data_ptr(), Pl, Ps, Qs,
                         idx.numel() - Ps - Qs, out.data_ptr(), idx, out))
        run()
        return [a[-1].cpu().numpy() for a in args]
    cols, pref, dep = chip_smoke.fetch_by_shard(Pl, len(shards), p, pp,
                                                blocks, answer)
    return run, np.concatenate([cols.reshape(-1), pref, dep])


def host_ms(call, reps):
    """Median ms of call() by the host's clock, the card idle before and
    waited for after."""
    import statistics
    import time
    import torch
    got = []
    for _ in range(reps + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        got.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(got[3:])


def source_merge_parts(call, reps):
    """This tree's merge call (call: host_merge) cut into its host parts
    by timers around the functions it calls: checks (up to the segment
    split: the strictly-increasing test and the unpacking), segments
    (merge_segments), tables (merge_launches), pack (the pinned buffer
    filled and its copy queued), launch (_merge_launch), wait (until the
    card is done) -> medians of ms over reps calls."""
    import collections
    import statistics
    import time
    import torch
    from mapcaller_tpu_torch.ops import mesh_kernels as mk
    marks = []

    def timed(fn, part):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                marks.append((part, t0, time.perf_counter()))
        return run
    names = ("merge_segments", "merge_launches", "_merge_launch")
    real = [getattr(mk, n) for n in names]
    for n, fn in zip(names, real):
        setattr(mk, n, timed(fn, n))
    parts = collections.defaultdict(list)
    try:
        for _ in range(reps + 3):
            marks.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            at = {n: (a, b) for n, a, b in marks}
            launch = [(a, b) for n, a, b in marks if n == "_merge_launch"]
            ms = dict(checks=at["merge_segments"][0] - t0,
                      segments=at["merge_segments"][1]
                      - at["merge_segments"][0],
                      tables=at["merge_launches"][1]
                      - at["merge_launches"][0],
                      pack=launch[0][0] - at["merge_launches"][1],
                      launch=sum(b - a for a, b in launch),
                      after=t1 - launch[-1][1], wait=t2 - t1, call=t2 - t0)
            for k, v in ms.items():
                parts[k].append(1e3 * v)
    finally:
        for n, fn in zip(names, real):
            setattr(mk, n, fn)
    return {k + "_ms": statistics.median(v[3:]) for k, v in parts.items()}


def controls(lib_path, torch, np, planes, buf, ends, want):
    """The merge's controls on the single-card planes (zeroed before and
    after): the seeded deltas' own word addresses and values, padded with
    zero addresses to whole units of 8, on the card; "scatter" held equal
    to the plain merge (want) -> {name: run}."""
    import ctypes as C
    from mapcaller_tpu_torch.ops import mesh_kernels as mk
    lib = C.CDLL(lib_path)
    lib.mc_scatter_red.argtypes = [C.c_void_p] * 2 + [C.c_longlong,
                                                      C.c_void_p]
    lib.mc_scatter_red.restype = C.c_int
    N = ends[-1]
    Np = mk._padded(N)
    idx, val = mk.unpack_deltas(buf, N)
    addr = np.zeros(Np, np.int64)
    for k, lo, hi in zip(mk.MERGE_PLANES, [0] + ends[:3], ends):
        # A5's planes: a row's stride is the lists' (merge_strides), so an
        # entry's word is its flat index
        addr[lo:hi] = getattr(planes, k).data_ptr() + 4 * idx[lo:hi]
    vals = np.zeros(Np, np.int32)
    vals[:N] = val
    dense = np.zeros(Np, np.int64)
    dense[:N] = planes.acgt.data_ptr() + 4 * np.arange(N, dtype=np.int64)
    ga, gd, gv = (torch.from_numpy(x).cuda() for x in (addr, dense, vals))

    def make(a):
        def run():
            err = lib.mc_scatter_red(a.data_ptr(), gv.data_ptr(), Np // 8,
                                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"control: CUDA error {err}")
        return run
    runs = dict(scatter=make(ga), dense=make(gd))
    fields = [getattr(planes, f) for f in mk.MERGE_PLANES]
    runs["scatter"]()
    equal = all(torch.equal(g, w) for g, w in zip(fields, want))
    for t in fields:
        t.zero_()
    if not equal:
        raise AssertionError("control: the scatter != the plain merge")
    runs["_keep"] = (ga, gd, gv)
    return runs


def body(names, work, parent_dir):
    import numpy as np
    import torch
    import chip_smoke
    from mapcaller_tpu_torch.ops import calling_kernels as cal
    from mapcaller_tpu_torch.ops import chain_kernels as chk
    from mapcaller_tpu_torch.ops import mesh_kernels as mk
    from mapcaller_tpu_torch.pipeline import device_profile as dp
    from mapcaller_tpu_torch.ops.device_util import upload
    unique = list(dict.fromkeys(names))
    libs = build(unique, parent_dir, work)
    control_lib = libs.pop("control")
    gstrides = dp.merge_strides(L)
    buf, ends, layouts = merge_data(torch, np)
    N = ends[-1]
    gbuf = torch.from_numpy(buf).cuda()
    # the plain merges from zero, for the holds
    idx_h, val_h = mk.unpack_deltas(torch.from_numpy(buf), N)
    want_merge = {}
    for key, shards in layouts.items():
        mk.host_merge_plain(shards, idx_h, val_h, ends, gstrides)
        want_merge[key] = [getattr(pl, f).clone() for pl, _ in shards
                           for f in mk.MERGE_PLANES]
        for pl, _ in shards:
            for f in mk.MERGE_PLANES:
                getattr(pl, f).zero_()
    ctl = controls(control_lib, torch, np, layouts["a5"][0][0], buf, ends,
                   want_merge["a5"])
    single, sharded, (p, pp, blocks) = fetch_data(torch, np)
    gidx = torch.from_numpy(np.concatenate([p, pp, blocks])).cuda()
    P, Q = p.size, pp.size
    want_fetch = cal.caller_fetch_plain(*single[:5], gidx, P, Q, single[5])
    want_slice = {n: cal.caller_fetch_slice_plain(
        sh, [s * Pl for s in range(n)], before, gidx, P, Q, L, bds)
        for n, (Pl, sh, bds, before) in sharded.items()}
    floor = chip_smoke.cuda_ms(lambda: torch.cuda._sleep(0), 50, queued=True)
    out = dict(L=L, deltas=N, positions=P, points=Q,
               blocks=int(blocks.size), turns=names, floor_ms=floor,
               variants={})
    for name in names:
        lib, ptxas = libs[name]
        lc, ll = lib["chain"], lib["calling"]
        turn, equal = {}, True
        with kv.bound(chk, lc) as chain_lib, kv.bound(cal, ll) as call_lib:
            for key, shards in layouts.items():
                run = (parent_merge_launches(chain_lib, shards, gbuf, N,
                                             ends, gstrides)
                       if name == "parent" else
                       source_merge_launch(shards, buf, ends, gstrides))
                run()
                got = [getattr(pl, f) for pl, _ in shards
                       for f in mk.MERGE_PLANES]
                equal &= all(torch.equal(g, w)
                             for g, w in zip(got, want_merge[key]))
                turn[f"merge_{key}_ms"] = chip_smoke.cuda_ms(run, 50,
                                                             queued=True)
                # the whole call by the host's clock: the parent's upload
                # of the packed lists and its launches, or host_merge
                if name == "parent":
                    def call(shards=shards):
                        g = upload(buf, "cuda")
                        parent_merge_launches(chain_lib, shards, g, N, ends,
                                              gstrides)()
                        torch.cuda.synchronize()
                    turn[f"merge_{key}_call_ms"] = host_ms(call, 20)
                else:
                    turn[f"merge_{key}_call"] = source_merge_parts(
                        lambda shards=shards: mk.host_merge(
                            shards, buf, ends, gstrides), 20)
                for t in got:
                    t.zero_()
            if name != "parent":
                # the call cut into launches of 7 segments (as past 512)
                shards = layouts["shards_4"]
                real = mk.merge_launches
                mk.merge_launches = lambda segs, bases: real(segs, bases, 7)
                try:
                    mk.host_merge(shards, buf, ends, gstrides)
                finally:
                    mk.merge_launches = real
                got = [getattr(pl, f) for pl, _ in shards
                       for f in mk.MERGE_PLANES]
                equal &= all(torch.equal(g, w)
                             for g, w in zip(got, want_merge["shards_4"]))
                for t in got:
                    t.zero_()
            for c in ("scatter", "dense"):
                turn[f"control_{c}_ms"] = chip_smoke.cuda_ms(ctl[c], 50,
                                                             queued=True)
            for t in (getattr(layouts["a5"][0][0], f)
                      for f in mk.MERGE_PLANES):
                t.zero_()
            fetch = (lambda: cal.caller_fetch(*single[:5], gidx, P, Q,
                                              single[5]))
            equal &= torch.equal(fetch(), want_fetch)
            turn["fetch_ms"] = chip_smoke.cuda_ms(fetch, 50, queued=True)
            for n, (Pl, sh, bds, before) in sharded.items():
                if name == "parent":
                    run, result = parent_fetch_slice(
                        call_lib, Pl, sh, bds, before, p, pp, blocks)
                    equal &= bool((result == want_slice[n].cpu().numpy())
                                  .all())
                else:
                    def run(n=n, Pl=Pl, sh=sh, bds=bds, before=before):
                        return cal.caller_fetch_slice(
                            sh, [s * Pl for s in range(n)], before, gidx, P,
                            Q, L, bds)
                    equal &= torch.equal(run(), want_slice[n])
                turn[f"fetch_slice_shards_{n}_ms"] = chip_smoke.cuda_ms(
                    run, 50, queued=True)
        if not equal:
            raise AssertionError(f"{name}: outputs differ from the plain "
                                 f"versions'")
        row = out["variants"].setdefault(name, dict(turns=[], equal=equal,
                                                    ptxas=ptxas))
        row["turns"].append(turn)
        print(name, turn, flush=True)
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    parent_dir = PARENT
    names = []
    for a in argv:
        if a.startswith("--parent="):
            parent_dir = a.split("=", 1)[1]
        else:
            names.append(a)
    return kv.run(__doc__, names, lambda ns, work: body(ns, work, parent_dir))


if __name__ == "__main__":
    sys.exit(main())
