#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mapcaller_tpu_torch) on one NVIDIA
card: builds the kernels from the sources in the checkout, holds every
hand-written kernel against its plain PyTorch version, drives the main
path end to end and checks what comes out.

    python3 chip_smoke.py

Phases, one JSON line each on stdout (any failure raises and the process
exits non-zero):
  env        card name and power limit (nvidia-smi), torch and CUDA
  build      nvcc for csrc/*.cu and g++ for the C++ host leg, in parallel,
             with the NW, ksw2, seed-scan, chain and calling kernels'
             registers,
             shared memory, stack frame and spills from -Xptxas -v (any
             stack frame or spill fails, and so do registers of the seed
             scans other than SCAN_REGISTERS and of the NOR blocks other
             than NOR_REGISTERS)
  kernels    the CUDA NW and ksw2 kernels each equal their plain version
             exactly at every DP tier (32, 48, 96, 192), on pairs whose
             lengths reach the tier's edges (for NW also the kernel's
             column chunks; for ksw2 with ~5% N bases) and on a batch that
             is not a multiple of the pairs per block, with their time,
             the plain version's time and the bound (ksw2: also its
             geometry and the empty-launch floor); then ksw2 on 8,192
             pairs at tier 192, many waves of blocks at its shared-memory
             footprint
  small_e2e  a 20 kb planted dataset: the port on cuda and on cpu write
             byte-identical SAM and VCF, both with device evidence, and
             again on the non-native path (use_native=False)
  main_path  100,000 read pairs on a 4.6 Mb genome through the user's
             command (`mapcaller_tpu_torch.cli`, in process): one warm-up
             run, which also captures the tensors of its largest NW
             launch, the evidence planes and inputs of its calling and
             every seed-scan batch, and runs its second transfer group's
             submit_chain_group with any host sync an error; then runs
             with the DP forced to the device kernels and to the scalar
             C++ DP in turns (device, scalar, scalar, device), with
             the stream's transfer group (pipeline/stream.TRANSFER_GROUP)
             set to 1 (a batch a submit) and 4 (the default: groups of 4
             and 3 batches) in turns (1, 4, 4, 1), the command as it
             is (auto DP), one
             run with host evidence (device_evidence=False) and one with
             the evidence apply folded into the chain dispatch
             (fold_evidence=True); then the other single-card paths, each
             writing the warm-up's SAM and VCF bytes: lane compaction
             (compact_factor=4: 8,192 lanes of a 32,768-read batch),
             host chaining (device_chain=False) and the 1-step index (the
             backend told the occ3 table does not fit); then the scale
             axes on this one card (devices and shards below); then
             -alg ksw2:
             a warm-up, which captures the tensors of every ksw2 launch
             (each then held equal to the plain version; the length
             histogram of the largest), and device-DP and scalar-DP turns,
             each writing the ksw2 warm-up's bytes with as many ksw2
             launches on the device-DP turns as the warm-up. Each run counts every kernel's launches
             (one seed-scan launch a batch: the occ3 kernel, or the
             1-step kernel on the 1-step run; the chain kernels once a
             batch: the seed-freq scan, the hits kernel and classify+
             pack, and no stand-alone scan of the slow counts; host
             chaining only the seed-freq scan and the hits kernel) and the
             evidence steps and the calling kernels (csrc/calling.cu:
             the finalize and the caller scan once, the column fetch at
             least once in every run that calls from the card planes,
             none with host evidence, and no plain version of them on the
             card);
             every run but the host-evidence and host-chaining ones
             accumulates evidence on the card and calls from it, with no
             capacity overflow; no run sends a read to the host oracle or
             reruns a batch; the seed+chain dispatch uploads twice and
             downloads once a transfer group (a batch in the group-1,
             folded and -shards runs; never with host chaining).
             Each run also reports the stream's stage
             seconds (MC_STAGE_PROF: parse, seed+chain submit, collect,
             host leg, evidence) and the host leg's own stage counters
             (stage_prof.host_leg_ns)
  seed_scan  the occ3 scan kernel equal to its plain version on every
             batch of the warm-up (batch 0 timed: device ms, call ms,
             plain ms, bound from its own step counts), on reads at each
             bucket (128, 192, 256) with the prefix skip off and on and
             in lanes mode (B / 4 lanes), and the 1-step kernel on the
             same reads with and without N; auto compaction's geometry
             (131,072 of the main path's reads on 32,768 lanes against a
             thread per read); then, after their runs, the compacted
             run's batches (8,192 lanes) and the 1-step run's batches
             (batch 0 timed), each equal to the plain version
  chain      each chain kernel (csrc/chain.cu: the scan, hits,
             classify+pack) equal to its plain version in every element on
             every batch of the warm-up at tier 2 (the folded apply on the
             even ones), on batch 0 at tier 18, on an edge batch at tier
             1, on batch 0's hits repeated 24 times (a tile's hits past
             the kernel's staging capacity: chunked staging) and on
             4,096 reads at bucket 496 (31 words a read); batch 0
             timed (device ms, call ms, plain ms, bound; the stand-alone
             scan on the slow counts beside torch.cumsum; the floor: an
             empty one-thread launch, timed alike; the times of the
             three launches classify+pack replaced, for reference);
             a race: the scan on the seed freqs, the hits kernel, the
             scan on the slow counts and classify+pack each launched 200
             times back to back on batch 0 and on 131,072 reads (four
             batches end to end, a scan tile cut short), every result
             equal to the plain version; then the 1-step run's batches
             replayed without the full SA (the inverse-Psi walk), equal
             too, batch 0's walk timed
  devices    the main path with -devices 2 on [cuda:0] * 2 through the
             stream (two replicas, each on a stream of its own, whole
             transfer groups round-robin, planes per replica summed
             once), writing the warm-up's bytes: each replica's groups,
             batches, launches, prefix-skip depth K and whether
             its planes fit, and the peak memory; and a race: batch 0's
             and batch 1's seed-freq scan and classify+pack launched 200
             times each on two streams, interleaved, every result equal
             to the plain version, each stream with its own look-back
             scratch
  shards     the main path with -shards 2 and -shards 4 on [cuda:0] * n,
             writing the warm-up's bytes, every batch through the sharded
             stage (sharded_invocations) with the routed scan and hits
             kernels once a shard a batch and their unrouted forms never,
             and every one of those launches (B / n reads, its own hit
             capacity) equal in every word to its plain routed version;
             then the first launch of each run (shard 0 of batch 0)
             replayed: equal to the stream's launch, to the plain routed
             versions and to the unrouted kernels' outputs (the hits also
             by the sharded inverse-Psi walk), timed beside the unrouted
             kernels on the same work, with the bound and the scan's
             launches x (ms - bound) a run; and the whole
             sharded stage by the walk (no full SA) on batch 0, equal to
             one card's walk stage, every read that differs from the
             full-SA stage flagged for the host oracle; the device bytes
             of placing the occ3 shards, built a shard at a time against
             the whole table built and then split
  big        the main path with big_x64 and -shards 2 and -shards 4 on
             [cuda:0] * n (the x64 big-genome path forced on this genome),
             writing the warm-up's bytes with the three 64-bit kernels
             (seed_scan3_big, chain_hits_big, chain_classify_pack_big)
             once a shard a batch and no 32-bit scan or chain kernel, every
             one of their launches equal in every word to its plain
             version, evidence on the genome-sharded planes; the bytes each
             shard holds and the check that no single-card table or
             genome-length plane is on the card; shard 0 of batch 0's
             launch timed beside the 32-bit routed forms on the same reads,
             with the bound (the scan also beside the unrouted kernel on
             the same rows, under -shards 4 too, and its launches x (ms -
             bound) a run); the scan and hits with the tables placed past
             2^31 (pointer tables with zero shards in front) against the
             same launch unshifted: s_x0 exactly C more, every valid hit
             equal; and a -gvcf run with big_x64 -shards 2 against a
             single-card -gvcf run, in bytes; the single-card routes
             under big_x64 -shards 2 (the index with its full SA dropped:
             the 1-step scan, the hits kernel's walk and classify+pack,
             evidence in the sharded planes; host chaining: the occ3
             scan and the hits kernel), each writing the warm-up's bytes
             with its kernels once a batch, every dispatch replayed
             against the plain versions; BigDeviceEvidence's apply a
             shard, host-delta merge and column fetch (one launch a call
             each, the fetch also shuffled and in the parent tree's
             per-shard form, its call cut into host parts beside that
             form's), fold and scan a shard, each beside its byte bound
             (the merge also its sector bound), the fold and the scan
             (evidence_finalize and caller_scan once a shard) held against
             their plain versions on the card at -shards 2 and 4; the
             -gvcf calls' NOR blocks, both forms, held against their plain
             versions in every word, and B4's NOR call cut into its host
             parts (sorts, uploads, launches, download, combine); one
             torch.profiler trace of a call of each NOR form, of B4's
             merge and fetch and of the single-card fetch: one kernel
             each, no memset. The devices
             phase also times the plane sum of -devices N (four add_ of
             two plane sets)
  evidence   device ms (queued launches) of the evidence apply of one
             batch, the finalize fold, the caller scan and the column
             fetch on the warm-up's own planes and inputs, each equal to
             the same call on the CPU, with the bound (bytes over the
             card's memory rate)
  calling    the calling kernels (csrc/calling.cu) on the warm-up's own
             planes: the finalize from the text words, the caller scan
             and the first column fetch (with its block depths), each
             equal to its plain version on the card in every word, with
             device ms, call ms, plain ms, the byte bound and the bytes/s
             achieved; the finalize's and the scan's geometry (dynamic
             shared memory, blocks an SM); the calling phase's peak
             device memory, plain versions against kernels
  dp_rates   on each algorithm's largest DP batch of the main path (its
             own pairs): one device DP call end to end on 1 pair and on
             all of them (fixed and per-pair cost), and the scalar C++
             aligner per pair (a ctypes loop over the pairs less the same
             loop over 1x1 pairs), and the least batch for which the
             device call would beat the scalar aligner
  ksw2_launches  every -alg ksw2 launch of the main path's warm-up equal
             to the plain version, and the largest launch's pairs by
             their longer side in bins of 16
  multihost  run_host (mapcaller_tpu_torch/parallel/multihost.py) on the
             card: in this process as a world of 1 over gloo, on the
             paired-end multi-host fixture (every seed+chain dispatch held
             against the plain versions, the VCF against the same run on
             the CPU) and on the main path's data (its first 32
             dispatches held); the four seed+chain kernels' launches
             counted from 0 around each run. Then 2 ranks on cuda:0 and
             2 ranks x --devices 2 on [cuda:0] * 2 over both, each rank a
             process of its own (`chip_smoke.py --multihost-child SPEC`,
             which writes the rank's device, launches, mapping_s and
             collective seconds to a file): every rank exits 0 and runs
             its seed+chain kernels on the card once a batch, and rank
             0's merged VCF equals the 1-rank VCF
  mesh       the one-process multichip pipeline
             (mapcaller_tpu_torch/parallel/mesh.py) on [cuda:0] * n: the
             reference's single-end and paired-end dry-run fixtures
             (__graft_entry__.dryrun_multichip / _pe, rebuilt with numpy)
             at n = 2 and 8, every output equal to the same calls on the
             CPU and to the port's single-device run, the stitched
             coverage equal to the cumsum of the summed exact plane; then
             the main path's data through run_mesh_pe_pipeline at max_len
             128 and n = 1, 2 and 4: a timed run (the seed+chain kernels,
             K1 dp_scatter_scan_kernel and K2 evidence_apply_bits_kernel
             counted from 0, phase A / host / phase B / merge seconds,
             peak memory, the variant records against the main path's VCF
             less its RC field) and a held run (every K1 and K2 call and
             the first 32 seed+chain dispatches against their plain
             versions, max_abs_err 0; phase A's summed planes and stitched
             coverage the same at every n); at n = 2 also the 1-step
             route, with the full SA (its records equal the occ3 run's)
             and without it (the hits kernel's walk; its records against
             the full-SA run's, reported, and equal to the same walk on
             two CPU devices), each run timed and held (the
             1-step scan, the chain kernels and the hits kernel's
             per-slot resolved flags against their plain versions); K1
             (the psum of phase A's planes and the genome-sharded scan,
             beside torch.cumsum) and K2 timed at n = 4 beside their byte
             bounds. The build gate
             holds chain_classify_pack_kernel at its parent's registers
             (its folded apply is the device function K2 shares) and K2
             at its 40 registers beside its slice form
Then the kernel table line ({"kernels": [...]}, the DP kernels timed on
their main path's own captured pairs and on random pairs of the same
shape, the scan and chain kernels on their main path's own batch 0, the
routed ones on shard 0 of it under -shards 2, the 64-bit ones on shard 0
of it under big_x64 -shards 2, as the runs launched them; the seed+chain
kernels also with their launches on the multihost and mesh runs; K1 and
K2 on the mesh's main-data run at n = 4; the calling kernels on the
main path's own planes with their launches a run, the NOR blocks on a
-gvcf run's own call, with B4's fold and scan a shard beside; the slice
forms of B4's apply, host-delta merge and fetch a shard under big_x64
-shards 2 and 4, its NOR on the -gvcf -shards 2 call, each held equal to
its plain version in every word, and the merge's single-card form, A5's,
on seeded deltas beside its four index_add_),
the card's name and power limit, and as the last line
{"ok": true, "device": {...}}.

Needs one CUDA card, nvcc and g++. Refuses to run without a card.
"""
import collections
import contextlib
import gc
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TIERS = (32, 48, 96, 192)
H100_BYTES_S = 3.35e12            # HBM3 rate, H100 SXM data sheet
# int32 issue rate: 64 INT32 lanes per SM (half the 128 FP32 lanes whose
# 67 TFLOP/s counts an FMA as 2), 132 SMs at the 1.98 GHz boost clock
H100_INT32_OPS_S = 132 * 64 * 1.98e9
NW_OPS_PER_CELL = 10              # see csrc/nw.cu
KSW2_OPS_PER_CELL = 40            # per in-window cell, see csrc/ksw2.cu
SCAN3_ROW_BYTES = 288             # an occ3 row; a scan step gathers two
SCAN1_ROW_BYTES = 32              # an occ4 row
SCAN3_OPS_PER_STEP = 930          # see csrc/seed_scan.cu
SCAN1_OPS_PER_STEP = 80
# ptxas registers of the seed scans (csrc/seed_scan.cu) with nvcc for
# sm_90a: the main path's thread-a-read scans keep theirs through the
# routed scans' redesign, and the routed scans' lane-group forms keep the
# counts they were measured at (PERF.md)
SCAN_REGISTERS = dict(seed_scan3_kernel=133, seed_scan3_routed_kernel=62,
                      seed_scan3_big_kernel=93, seed_scan1_kernel=32)
# int32 operations of the chain kernels (csrc/chain.cu), for their bounds:
# a scan read; a hit slot (binary search, seed walk, stores); an inverse-
# Psi step; a classified read's 16 bases and its kept hits; a packed read
# and a hit it copies
CHAIN_OPS = dict(scan_read=6, hit=40, walk_step=25, read_word=60,
                 kept_hit=40, pack_read=20, pack_hit=6)


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def cuda_ms(fn, reps, warmup=3, queued=False):
    """Median time of fn() over `reps` runs, each bracketed by CUDA
    events, after `warmup` runs. With `queued`, each run is enqueued
    behind a device-side sleep of its own, at least twice the host's time
    to issue one run (fn must not wait for the device), so the events
    time the device's work alone, however many launches a run makes;
    without it they also count the host's time to issue the run whenever
    that is longer than the device's."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    issue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # SM cycles at up to 1.98 GHz: >= 0.2 ms, and >= 2x the issue time
    sleep = int(max(400_000, 2 * issue_s * 1.98e9))
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in events:
        if queued:
            torch.cuda._sleep(sleep)
        a.record()
        fn()
        b.record()
        if not queued:
            b.synchronize()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def nw_inputs(B, M, seed):
    """B random pairs for an M x M tier on the card: lengths uniform in
    [0, M] with the edges (0 and M) forced on the first pairs and second
    sides of k*chunk - 1, k*chunk and k*chunk + 1 columns (the edges of
    the kernel's per-lane column chunks) on the next ones, s2 a mutated
    copy of s1 on most pairs."""
    import numpy as np
    import torch
    from mapcaller_tpu_torch.ops.nw_device import nw_geometry
    rng = np.random.default_rng(seed)
    m = rng.integers(0, M + 1, size=B).astype(np.int32)
    n = rng.integers(0, M + 1, size=B).astype(np.int32)
    m[:4], n[:4] = [0, M, 0, M], [0, M, M, 0]
    lanes, chunk, _, _ = nw_geometry(M, M)
    edges = [e for k in range(1, lanes + 1)
             for e in (k * chunk - 1, k * chunk, k * chunk + 1) if e <= M]
    edges = edges[:max(B - 4, 0)]
    n[4:4 + len(edges)] = edges
    c1 = rng.integers(0, 4, size=(B, M)).astype(np.uint8)
    c2 = c1.copy()
    mut = rng.random((B, M)) < 0.1
    c2[mut] = rng.integers(0, 4, size=int(mut.sum()))
    c2[::5] = rng.integers(0, 4, size=c2[::5].shape)
    cols = np.arange(M)[None, :]
    c1[cols >= m[:, None]] = 4
    c2[cols >= n[:, None]] = 4
    dev = torch.device("cuda")
    return tuple(torch.from_numpy(x).to(dev) for x in (c1, c2, m, n))


def nw_bound_ms(c1, c2, m, n):
    """Least time for the function on these inputs: the larger of the
    int32 operations its cells need and the bytes it must move."""
    B, M = c1.shape
    N = c2.shape[1]
    cells = int(((m.long() + 1) * (n.long() + 1)).sum())
    ops = NW_OPS_PER_CELL * cells
    nbytes = B * (M + N) + 8 * B + 4 * B * (M + N) // 16 + 4 * B
    return 1e3 * max(ops / H100_INT32_OPS_S, nbytes / H100_BYTES_S), \
        ("operations" if ops / H100_INT32_OPS_S >= nbytes / H100_BYTES_S
         else "bytes")


def equal_nw(nw, args):
    """Kernel vs plain version on the same tensors: exact equality of
    words and scores. Returns the max abs difference (0)."""
    import torch
    kw, ks = nw.nw_ops(*args)
    pw, ps = nw.nw_ops_plain(*args)
    torch.cuda.synchronize()
    err = max(int((kw.long() - pw.long()).abs().max()),
              int((ks.long() - ps.long()).abs().max()))
    if err != 0 or not torch.equal(kw, pw) or not torch.equal(ks, ps):
        raise AssertionError(f"NW kernel != plain version at "
                             f"{tuple(args[0].shape)}x{args[1].shape[1]} "
                             f"(max_abs_err {err})")
    return err


def measure_nw(nw, args, reps):
    """Equality with the plain version, then times on `args`: `ms` the
    kernel's device time (queued launches), `call_ms` one nw_ops call
    timed launch by launch, the host's issue time included."""
    B, M = args[0].shape
    N = args[1].shape[1]
    err = equal_nw(nw, args)
    ms = cuda_ms(lambda: nw.nw_ops(*args), reps, queued=True)
    call_ms = cuda_ms(lambda: nw.nw_ops(*args), reps)
    plain_ms = cuda_ms(lambda: nw.nw_ops_plain(*args), 3, warmup=1)
    bound, by = nw_bound_ms(*args)
    return dict(B=B, M=M, N=N, geometry=list(nw.nw_geometry(M, N)),
                max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, share_of_bound=bound / ms)


def check_nw(nw, B, M, seed, reps):
    """Kernel vs plain version on random pairs at (B, M, M), then at a
    ragged batch of B // 4 + 1 pairs, then times at B."""
    equal_nw(nw, nw_inputs(B // 4 + 1, M, seed + 1))
    return measure_nw(nw, nw_inputs(B, M, seed), reps)


def ksw2_inputs(B, M, seed):
    """B random pairs for an M x M tier on the card, in ksw2_ops's layout
    (reversed queries right-aligned in qbuf, targets left-aligned in M+16
    columns, pad 0): lengths uniform in [1, M] with the edges (1 and M)
    forced on the first pairs, the target a mutated copy of the query on
    most pairs, ~5% of the bases N (code 4)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    ql = rng.integers(1, M + 1, size=B).astype(np.int32)
    tl = rng.integers(1, M + 1, size=B).astype(np.int32)
    ql[:4], tl[:4] = [1, M, 1, M], [1, M, M, 1]
    q = rng.integers(0, 4, size=(B, M)).astype(np.uint8)
    t = q.copy()
    mut = rng.random((B, M)) < 0.1
    t[mut] = rng.integers(0, 4, size=int(mut.sum()))
    t[::5] = rng.integers(0, 4, size=t[::5].shape)
    q[rng.random((B, M)) < 0.05] = 4
    t[rng.random((B, M)) < 0.05] = 4
    cols = np.arange(M)[None, :]
    qbuf = np.where(cols >= M - ql[:, None], q[:, ::-1], 0).astype(np.uint8)
    tgt = np.zeros((B, M + 16), dtype=np.uint8)
    tgt[:, :M] = np.where(cols < tl[:, None], t, 0)
    dev = torch.device("cuda")
    return tuple(torch.from_numpy(x).to(dev) for x in (qbuf, tgt, ql, tl))


def ksw2_cells(qlen, tlen):
    """In-window cells of the diagonals each pair needs: the sum over
    r < qlen + tlen - 1 of en - st + 1, with (st, en) the 16-aligned
    window of ops/ksw2_device._bounds."""
    import numpy as np
    ql = qlen.cpu().numpy().astype(np.int64)[:, None]
    tl = tlen.cpu().numpy().astype(np.int64)[:, None]
    w = np.maximum(ql, tl)
    r = np.arange(int((ql + tl).max()) - 1)[None, :]
    st0 = np.maximum(np.maximum(0, r - ql + 1), (r - w + 1) >> 1)
    en0 = np.minimum(np.minimum(tl - 1, r), (r + w) >> 1)
    width = (en0 + 16) // 16 * 16 - 1 - st0 // 16 * 16 + 1
    return int(np.where(r < ql + tl - 1, width, 0).sum())


def ksw2_bound_ms(qbuf, tgt, qlen, tlen):
    """Least time for the function on these inputs: the larger of the
    int32 operations its in-window cells need and the bytes it must
    move."""
    B, M = qbuf.shape
    N = tgt.shape[1] - 16
    ops = KSW2_OPS_PER_CELL * ksw2_cells(qlen, tlen)
    nbytes = B * (M + N + 16) + 8 * B + 4 * B * ((M + N + 15) // 16)
    t_ops, t_bytes = ops / H100_INT32_OPS_S, nbytes / H100_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def equal_ksw2(k, args):
    """Kernel vs plain version on the same tensors: exact equality of the
    words. Returns the max abs difference (0)."""
    import torch
    kw = k.ksw2_ops(*args)
    # the plain version holds B x (M+N-1) x NC flags: 2,048 pairs at a time
    pw = torch.cat([k.ksw2_ops_plain(*(a[i:i + 2048] for a in args))
                    for i in range(0, args[0].shape[0], 2048)])
    torch.cuda.synchronize()
    err = int((kw.long() - pw.long()).abs().max())
    if err != 0 or not torch.equal(kw, pw):
        raise AssertionError(f"ksw2 kernel != plain version at "
                             f"{tuple(args[0].shape)}x{args[1].shape[1]} "
                             f"(max_abs_err {err})")
    return err


def measure_ksw2(k, args, reps, plain=True):
    """As measure_nw, for the ksw2 kernel, with its geometry (chunk, pairs
    a block, shared memory a block) and the floor: an empty launch timed
    alike. plain=False skips the plain version's time (its words are
    still compared)."""
    import torch
    B, M = args[0].shape
    N = args[1].shape[1] - 16
    err = equal_ksw2(k, args)
    ms = cuda_ms(lambda: k.ksw2_ops(*args), reps, queued=True)
    call_ms = cuda_ms(lambda: k.ksw2_ops(*args), reps)
    plain_ms = (cuda_ms(lambda: k.ksw2_ops_plain(*args), 3, warmup=1)
                if plain else None)
    floor_ms = cuda_ms(lambda: torch.cuda._sleep(0), reps, queued=True)
    bound, by = ksw2_bound_ms(*args)
    return dict(B=B, M=M, N=N, cells=ksw2_cells(args[2], args[3]),
                geometry=k.ksw2_geometry(M, N), max_abs_err=err, ms=ms,
                call_ms=call_ms, plain_ms=plain_ms, floor_ms=floor_ms,
                bound_ms=bound, bound_by=by, share_of_bound=bound / ms)


def check_ksw2(k, B, M, seed, reps):
    """Kernel vs plain version on a ragged batch of B // 4 + 1 random
    pairs (not a multiple of the kernel's 4 pairs per block), then times
    at B."""
    equal_ksw2(k, ksw2_inputs(B // 4 + 1, M, seed + 1))
    return measure_ksw2(k, ksw2_inputs(B, M, seed), reps)


def scan_fns(ssd, kind, fm, codes, rlens, max_len, S, lanes=0,
             has_n=False):
    """(kernel, plain) callables of one seed-scan call on the card; each
    takes with_iters (the plain compacted scan refuses it)."""
    if kind == "seed_scan3":
        return (lambda w=False: ssd.seed_scan3(fm, codes, rlens, max_len, S,
                                                lanes=lanes, with_iters=w),
                lambda w=False: ssd.seed_scan3_plain(
                    fm, codes, rlens, max_len, S, lanes=lanes, with_iters=w))
    return (lambda w=False: ssd.seed_scan1(fm, codes, rlens, max_len, S,
                                            has_n, with_iters=w),
            lambda w=False: ssd.seed_scan1_plain(fm, codes, rlens, max_len, S,
                                                 has_n, with_iters=w))


def equal_scan(what, kernel, plain, with_iters=False):
    """Kernel vs plain version on the same tensors: every element of the
    six outputs equal, the unused seed slots included, and with_iters each
    read's steps and row gathers. Returns the max abs difference (0)."""
    import torch
    got, want = kernel(with_iters), plain(with_iters)
    torch.cuda.synchronize()
    err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    if err != 0 or len(got) != len(want) or not all(
            torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{what}: scan kernel != plain version "
                             f"(max_abs_err {err})")
    return err


def scan_bound_ms(kind, B, width, S, rows):
    """Least time for a scan on these inputs: the larger of the bytes it
    must move (the index rows the reads' own trajectories gather, the
    reads and lengths read once, the outputs written once) and its int32
    operations, per two-row step as counted in csrc/seed_scan.cu."""
    row, per = ((SCAN3_ROW_BYTES, SCAN3_OPS_PER_STEP) if kind == "seed_scan3"
                else (SCAN1_ROW_BYTES, SCAN1_OPS_PER_STEP))
    nbytes = row * rows + B * (width + 4) + B * (8 + 32 * S + 1 + 8)
    t_b, t_o = nbytes / H100_BYTES_S, per * rows / 2 / H100_INT32_OPS_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def launch_gap(r, launches):
    """A timed launch's dict r with a run's launches of that kernel and
    launches x (ms - bound): the device time a run spends above the
    bound in it."""
    r["launches_a_run"] = launches
    r["gap_ms_a_run"] = launches * (r["ms"] - r["bound_ms"])
    return r


def measure_scan(what, kind, fns, codes, S, reps, plain_reps=3):
    """Equality with the plain version (step and row-gather counts too),
    then device ms (queued launches), call ms (one wrapper call, host
    issue included), plain ms and the bound from the call's own row
    gathers."""
    kernel, plain = fns
    err = equal_scan(what, kernel, plain, with_iters=True)
    steps, rows = (int(x.sum()) for x in kernel(True)[-2:])
    ms = cuda_ms(kernel, reps, queued=True)
    call_ms = cuda_ms(kernel, reps)
    plain_ms = cuda_ms(plain, plain_reps, warmup=1)
    B, width = codes.shape
    bound, by = scan_bound_ms(kind, B, width, S, rows)
    return dict(B=B, width=width, max_seeds=S, steps=steps, rows=rows,
                mean_steps=steps / B, max_abs_err=err, ms=ms,
                call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, share_of_bound=bound / ms)


def scan_inputs(packed, bucket, seed, has_n=False):
    """Reads of `bucket` bases on the card, one per read of a main-path
    batch (packed uint8[B, w]): the first bytes of that read and of the
    next one (real sequence: seeds with hits), then random bases; lengths
    uniform in [0, bucket] with 0, 15, 16, 17, bucket - 1 and bucket
    forced. has_n: byte codes with ~3% N and 4 past each read's end, else
    2-bit packed. -> (codes, rlens int32)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    p0 = packed.cpu().numpy()
    B, W = p0.shape[0], bucket // 4
    out = rng.integers(0, 256, size=(B, W), dtype=np.uint8)
    k = min(p0.shape[1], W // 2)
    out[:, :k] = p0[:, :k]
    out[:, k:2 * k] = np.roll(p0, -1, axis=0)[:, :k]
    rl = rng.integers(0, bucket + 1, size=B).astype(np.int32)
    rl[:6] = [0, 15, 16, 17, bucket - 1, bucket]
    codes = out
    if has_n:
        j = np.arange(bucket)
        codes = ((out[:, j >> 2] >> (2 * (j & 3))) & 3).astype(np.uint8)
        codes[rng.random(codes.shape) < 0.03] = 4
        codes[j[None, :] >= rl[:, None]] = 4
    dev = torch.device("cuda")
    return (torch.from_numpy(np.ascontiguousarray(codes)).to(dev),
            torch.from_numpy(rl).to(dev))


def run_seed_scan(ssd, batches, card, reps=20):
    """The occ3 scan kernel on the warm-up's own batches (every one equal
    to the plain scan, batch 0 timed), then on reads at each bucket with
    the prefix skip off and at the run's depth, in lanes mode (B / 4
    lanes), and the 1-step kernel on the same reads with and without N;
    then the auto compaction's geometry: 131,072 of the main path's reads
    (its first four batches) on 32,768 lanes against one thread per read.
    Returns batch 0's measurement."""
    import dataclasses
    import torch
    fm3, packed0, rlens0, max_len, S, _ = batches[0]
    for i, (f, p, r, ml, s_, lanes) in enumerate(batches):
        equal_scan(f"seed_scan3 main-path batch {i}",
                   *scan_fns(ssd, "seed_scan3", f, p, r, ml, s_, lanes))
    own = measure_scan("seed_scan3 main-path batch 0", "seed_scan3",
                       scan_fns(ssd, "seed_scan3", fm3, packed0, rlens0,
                                max_len, S), packed0, S, reps)
    B = packed0.shape[0]
    fm3_0 = dataclasses.replace(fm3, pfx_k=0, pfx_base=0)
    cases = []
    for bucket in (128, 192, 256):
        Sb = bucket // 17 + 2
        codes, rl = scan_inputs(packed0, bucket, seed=bucket)
        for tag, f, lanes in (("pfx_k 0", fm3_0, 0),
                              (f"pfx_k {fm3.pfx_k}", fm3, 0),
                              (f"pfx_k {fm3.pfx_k}, lanes B/4", fm3,
                               B // 4)):
            cases.append(dict(kernel="seed_scan3", bucket=bucket, case=tag,
                              max_abs_err=equal_scan(
                                  f"seed_scan3 {bucket} {tag}",
                                  *scan_fns(ssd, "seed_scan3", f, codes, rl,
                                            bucket, Sb, lanes))))
        for has_n in (False, True):
            c, r = scan_inputs(packed0, bucket, bucket + 1, has_n)
            tag = "byte codes with N" if has_n else "2-bit"
            cases.append(dict(kernel="seed_scan1", bucket=bucket, case=tag,
                              max_abs_err=equal_scan(
                                  f"seed_scan1 {bucket} {tag}",
                                  *scan_fns(ssd, "seed_scan1", fm3.fm, c, r,
                                            bucket, Sb, has_n=has_n))))
    big_p = torch.cat([b[1] for b in batches[:4]])
    big_r = torch.cat([b[2] for b in batches[:4]])
    lock, _ = scan_fns(ssd, "seed_scan3", fm3, big_p, big_r, max_len, S)
    comp, _ = scan_fns(ssd, "seed_scan3", fm3, big_p, big_r, max_len, S,
                       lanes=32768)
    equal_scan("seed_scan3 131,072 reads, 32,768 lanes vs one per read",
               comp, lock)
    geometry = dict(reads=int(big_p.shape[0]), lanes=32768,
                    ms_one_thread_per_read=cuda_ms(lock, reps, queued=True),
                    ms_lanes=cuda_ms(comp, reps, queued=True),
                    steps=int(lock(True)[-2].sum()))
    emit("seed_scan", card=card, main_path_batches=len(batches),
         main_path_batch0=own, random=cases, auto_compaction=geometry)
    return own


def check_scan_batches(ssd, kind, batches):
    """Each captured main-path call: kernel equal to the plain version."""
    for i, (f, p, r, ml, s_, extra) in enumerate(batches):
        kw = dict(lanes=extra) if kind == "seed_scan3" else dict(has_n=extra)
        equal_scan(f"{kind} main-path batch {i} ({kw})",
                   *scan_fns(ssd, kind, f, p, r, ml, s_, **kw))
    return len(batches)


def chain_run(ck, kern, packed, rlens, fm=None, tier=None, planes=None,
              pair_end=False):
    """The once-a-batch chain kernels of SeedChainKernel `kern` after its
    scan, on the scan kernel's seeds; fm replaces the kernel's 1-step
    table (a copy without the full SA walks), tier its hit buffers.
    Returns every stage's output: (seeds, the seed-freq scan, hits, out,
    mmp)."""
    import torch
    B = kern.batch
    H, H2 = ((kern.H, kern.H2) if tier is None else
             (B * max(9, tier) // 4, B * tier // 4))
    fm = kern.fm1 if fm is None else fm
    seeds = kern._scan_packed(packed, rlens)
    scan = ck.chain_scan_seeds(seeds[4], seeds[0], H)
    hits = ck.chain_hits(fm, scan, *seeds[:5], H)
    out = torch.empty(2 * B + 2 * H2 + B // 2 + B // 32 + 2,
                      dtype=torch.int32, device=packed.device)
    mmp = ck.chain_classify_pack(kern.ctx, packed, rlens, scan.off, hits,
                                 seeds[5], kern.max_len, out, H2, planes,
                                 pair_end)
    return seeds, scan, hits, out, mmp


def h2_of(B, out):
    """H2 of a packed output vector of B reads."""
    return (out.shape[0] - 2 * B - B // 2 - B // 32 - 2) // 2


def slow_counts(out, B):
    """Each read's SLOW kept hits (int32[B]) from a packed vector's
    counts2 words."""
    import torch
    o = 2 * B + 2 * h2_of(B, out)
    c2 = out[o:o + B // 2]
    return torch.stack([c2 & 0xFFFF, (c2 >> 16) & 0xFFFF], 1).reshape(-1)


def classify_pack_pairs(ck, kern, packed, rlens, off, hits, overflow, out,
                        mmp, pk=None, pair_end=False):
    """The classify+pack kernel's outputs (out, mmp, and planes pk when
    given) beside the plain composition's on the same inputs, as (name,
    kernel, plain) pairs."""
    import torch
    from mapcaller_tpu_torch.pipeline.device_profile import DevicePlanes
    B = kern.batch
    pp = (DevicePlanes.zeros(kern.ctx.seq_len // 2, packed.device)
          if pk is not None else None)
    outp = torch.empty_like(out)
    mmpp = ck.chain_classify_pack_plain(kern.ctx, packed, rlens, off, hits,
                                        overflow, kern.max_len, outp,
                                        h2_of(B, out), pp, pair_end)
    pairs = [("mmp", mmp, mmpp), ("meta_pd", out[:2 * B], outp[:2 * B]),
             ("pack", out[2 * B:], outp[2 * B:])]
    if pk is not None:
        pairs += [(f"planes.{k}", getattr(pk, k), getattr(pp, k))
                  for k in ("acgt", "exact_diff", "f_diff")]
    return pairs


def max_err(what, pairs):
    """Every pair equal in every element, or raise; -> the max abs
    difference (0)."""
    import torch
    torch.cuda.synchronize()
    errs = {k: int((a.long() - b.long()).abs().max()) if a.numel() else 0
            for k, a, b in pairs}
    bad = [k for k, a, b in pairs if errs[k] or not torch.equal(a, b)]
    if bad:
        raise AssertionError(f"{what}: chain kernel != plain version in "
                             f"{bad} ({errs})")
    return max(errs.values())


def equal_chain(what, ck, kern, packed, rlens, L, **kw):
    """Every chain kernel against its plain version on the same inputs
    (each stage's plain version takes the kernels' upstream outputs), on
    planes of their own when L is given: every element of every output
    equal. Returns the max abs difference (0) and the kernels' outputs."""
    from mapcaller_tpu_torch.pipeline.device_profile import DevicePlanes
    pk = DevicePlanes.zeros(L, packed.device) if L else None
    got = chain_run(ck, kern, packed, rlens, planes=pk, **kw)
    seeds, scan, hits, out, mmp = got
    off = scan.off
    fm = kw.get("fm") or kern.fm1
    H = hits.read.shape[0]
    want_scan = ck.chain_scan_seeds_plain(seeds[4], seeds[0], H)
    want_hits = ck.chain_hits_plain(fm, off, *seeds[:5], H)
    pairs = [("off", off, want_scan.off), ("start", scan.start,
                                           want_scan.start)]
    pairs += [(f"hits.{k}", getattr(hits, k), getattr(want_hits, k))
              for k in hits._fields]
    pairs += classify_pack_pairs(ck, kern, packed, rlens, off, hits,
                                 seeds[5], out, mmp, pk,
                                 kw.get("pair_end", False))
    return max_err(what, pairs), got


def dense_batch(ck, kern, packed, rlens, rep=24):
    """A batch's valid hits each repeated `rep` times, every read's hits
    still grouped (~35 a read on the main path's batch 0): a tile of
    CP_READS reads spans more hits than the classify+pack kernel stages
    at a time (CP_HIT_CAP), so it stages them in chunks, and with most
    reads SLOW (more than 8 kept hits) the pack restages them. H2 is half
    the hits: some slots are written, the rest dropped. -> (off, hits,
    overflow, H2, the largest tile hit range)."""
    import torch
    seeds, scan, hits, _, _ = chain_run(ck, kern, packed, rlens)
    n = min(int(scan.off[-1]), hits.read.shape[0])
    dense = ck.Hits(*(x[:n].repeat_interleave(rep) for x in hits[:6]),
                    hits.unresolved)
    off = (torch.clamp(scan.off, max=n) * rep).to(torch.int32)
    edges = off[::ck.CP_READS].long()         # whole tiles' first hits
    return off, dense, seeds[5], n * rep // 2, int((edges[1:]
                                                    - edges[:-1]).max())


def equal_dense(ck, kern, packed, rlens):
    """The classify+pack kernel equal to the plain composition on
    dense_batch's hits. -> (max abs difference (0), batch facts)."""
    import torch
    off, hits, overflow, H2, widest = dense_batch(ck, kern, packed, rlens)
    if widest <= ck.CP_HIT_CAP:
        raise AssertionError(f"dense batch: widest tile range {widest} "
                             f"fits the staging capacity {ck.CP_HIT_CAP}")
    B = kern.batch
    out = torch.empty(2 * B + 2 * H2 + B // 2 + B // 32 + 2,
                      dtype=torch.int32, device=packed.device)
    mmp = ck.chain_classify_pack(kern.ctx, packed, rlens, off, hits,
                                 overflow, kern.max_len, out, H2)
    err = max_err("chain dense batch (chunked staging)", classify_pack_pairs(
        ck, kern, packed, rlens, off, hits, overflow, out, mmp))
    return err, dict(H=int(hits.read.shape[0]), H2=H2,
                     widest_tile_hits=widest, hit_cap=ck.CP_HIT_CAP,
                     total_kept=int(out[-2]), buffer_overflow=int(out[-1]),
                     cls=[int(((out[:B] & 3) == c).sum()) for c in range(3)])


def hit_rows(seeds, H):
    """The SA row of each valid hit slot (its seed's x0 plus its rank
    there) and the flat seed slot it expands, as the hits kernel finds
    them."""
    import torch
    n, _, _, x0, freq = seeds[:5]
    S = freq.shape[1]
    valid = torch.arange(S, device=freq.device)[None, :] < n[:, None]
    flat = torch.where(valid, freq, 0).reshape(-1)
    csum = torch.cumsum(flat, 0)
    h = torch.arange(min(int(csum[-1]), H), device=freq.device)
    seed = torch.searchsorted(csum, h, right=True)
    return x0.reshape(-1)[seed] + h - (csum - flat)[seed], seed


def walk_work(fm, rows, max_walk):
    """The inverse-Psi walks of `rows` replayed as the hits kernel walks
    them: the steps taken, the distinct occ4 rows they gather and the
    distinct sa_samp entries they end on."""
    import torch
    from mapcaller_tpu_torch.ops.fm_device import inv_psi
    nrow = fm.occ_rows.shape[0]
    seen = torch.zeros(nrow + 1, dtype=torch.bool, device=rows.device)
    steps = torch.zeros((), dtype=torch.int64, device=rows.device)
    k = rows.clone()
    for _ in range(max_walk):
        todo = (k & 31) != 0
        kadj = k - (k >= fm.primary).to(k.dtype)
        seen[torch.where(todo, kadj >> 4, nrow)] = True
        steps += todo.sum()
        k = torch.where(todo, inv_psi(fm, torch.where(todo, k, 32)), k)
    return (int(steps), int(seen[:nrow].sum()),
            int(torch.unique(k >> 5).numel()))


def hits_work(fm, seeds, scan, hits):
    """Bytes and int32 operations of one chain_hits call, and its walk
    steps (None with the full SA): off[B], the start index, n_seeds, the
    valid seeds' freqs, x0/rpos/len of the seeds that own a valid hit
    (rpos/len of the last seed slot when slots are padded), the outputs,
    a flag byte per unresolved read, and the distinct SA entries of the
    valid hits, or without the full SA the distinct occ4 rows and
    sa_samp entries of their walks and L2's four counts."""
    import torch
    from mapcaller_tpu_torch.ops.chain_kernels import MAX_WALK
    B, S = seeds[4].shape
    H = hits.read.shape[0]
    rows, seed = hit_rows(seeds, H)
    nbytes = (4 + 8 * scan.start.shape[0] + 8 * B
              + 8 * int(seeds[0].clamp(0, S).sum())
              + 24 * int(torch.unique(seed).numel())
              + (16 if rows.shape[0] < H else 0)
              + 18 * H + int(hits.unresolved.sum()))
    ops = CHAIN_OPS["hit"] * H
    if fm.has_full_sa:
        return nbytes + 4 * int(torch.unique(rows).numel()), ops, None
    steps, nrows, nsamp = walk_work(fm, rows, MAX_WALK)
    return (nbytes + 32 * nrows + 8 * nsamp + 8 * 4,
            ops + CHAIN_OPS["walk_step"] * steps, steps)


def bound_of(nbytes, ops):
    """(bound_ms, bound_by): the larger of the bytes over the card's
    memory rate and the int32 operations over its peak rate."""
    t_b, t_o = nbytes / H100_BYTES_S, ops / H100_INT32_OPS_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def chain_bounds(kern, packed, got):
    """Least time of each chain kernel on this batch: the larger of the
    bytes it must move (each input read once, each output written once;
    of the int64 seed tables only the entries the kernel needs, one SA
    entry per distinct valid hit row) and its int32 operations
    (CHAIN_OPS), over the card's rates. chain_scan is the stand-alone
    scan of the slow counts. -> {kernel: (bound_ms, bound_by, bytes)}."""
    seeds, scan, hits, out, mmp = got
    B, S = seeds[4].shape
    groups = scan.start.shape[0]
    H2 = kern.H2
    nseeds = int(seeds[0].clamp(0, S).sum())
    nvalid = int(hits.valid.sum())
    nkept = int(hits.keep.sum())
    slow_h = int(slow_counts(out, B).sum())
    words = kern.max_len // 16
    nkeys = kern.ctx.bkeys.shape[0]
    o = CHAIN_OPS
    work = dict(
        chain_scan=(4 * B + 4 * (B + 1), o["scan_read"] * B),
        chain_scan_seeds=(8 * B + 8 * nseeds + 4 * (B + 1) + 8 * groups + B,
                          o["scan_read"] * B + nseeds),
        chain_hits=hits_work(kern.fm1, seeds, scan, hits)[:2],
        # off, rlens, the read words, unresolved and overflow, the valid
        # hits' rpos/len/loc/keep, words + 1 text words a read, the
        # chromosome ends; meta1 and pd, mmp, hit_w and hit_loc, counts2,
        # the overflow words and the two totals
        chain_classify_pack=(
            4 * (B + 1) + B * (4 + 4 * words + 1 + 1) + 13 * nvalid
            + 8 * (words + 1) * B + 8 * nkeys
            + 8 * B + 16 * B + 8 * H2 + 4 * (B // 2 + B // 32 + 2),
            o["read_word"] * words * B + o["kept_hit"] * nkept
            + o["pack_read"] * B + o["pack_hit"] * slow_h))
    return {k: (*bound_of(nbytes, ops), nbytes)
            for k, (nbytes, ops) in work.items()}


# batch 0's device ms of the three launches chain_classify_pack replaced
# (classify, the scan of the slow counts, pack), as this script measured
# them on an NVIDIA H100 80GB HBM3 at 700.00 W before they were fused
# (PERF.md, section 6)
SPLIT_CLASSIFY_SCAN_PACK_MS = dict(chain_classify=0.01168,
                                   chain_scan_slow_counts=0.00784,
                                   chain_pack=0.00666)


def measure_chain(ck, kern, packed, rlens, reps=50):
    """Device ms (queued launches), call ms and plain ms of each chain
    kernel on one main-path batch, its bound, and torch.cumsum on the
    slow counts beside the stand-alone scan (the one PyTorch call of the
    same function)."""
    import torch
    got = chain_run(ck, kern, packed, rlens)
    seeds, scan, hits, out, mmp = got
    off = scan.off
    B = kern.batch
    fm, H, H2 = kern.fm1, kern.H, kern.H2
    slow = slow_counts(out, B).to(torch.int32).contiguous()
    outk = out.clone()
    cp_args = (kern.ctx, packed, rlens, off, hits, seeds[5], kern.max_len,
               outk, H2)
    calls = dict(
        chain_scan=(lambda: ck.chain_scan(slow),
                    lambda: ck.chain_scan_plain(slow)),
        chain_scan_seeds=(lambda: ck.chain_scan_seeds(seeds[4], seeds[0], H),
                          lambda: ck.chain_scan_seeds_plain(seeds[4],
                                                            seeds[0], H)),
        chain_hits=(lambda: ck.chain_hits(fm, scan, *seeds[:5], H),
                    lambda: ck.chain_hits_plain(fm, off, *seeds[:5], H)),
        chain_classify_pack=(lambda: ck.chain_classify_pack(*cp_args),
                             lambda: ck.chain_classify_pack_plain(*cp_args)))
    bounds = chain_bounds(kern, packed, got)
    res = {}
    for name, (kfn, pfn) in calls.items():
        res[name] = dict(ms=cuda_ms(kfn, reps, queued=True),
                         call_ms=cuda_ms(kfn, reps),
                         plain_ms=cuda_ms(pfn, 3, warmup=1), library_ms=None)
        bound, by, nbytes = bounds[name]
        res[name].update(bound_ms=bound, bound_by=by, bytes=nbytes,
                         share_of_bound=bound / res[name]["ms"])
    res["chain_scan"]["library_ms"] = cuda_ms(
        lambda: torch.cumsum(slow, 0), reps, queued=True)
    res["chain_classify_pack"]["earlier_ms"] = dict(
        SPLIT_CLASSIFY_SCAN_PACK_MS,
        sum=sum(SPLIT_CLASSIFY_SCAN_PACK_MS.values()))
    # the floor under every launch: a one-thread kernel that returns at
    # once, timed as the kernels are
    res["floor_ms"] = cuda_ms(lambda: torch.cuda._sleep(0), reps,
                              queued=True)
    res["batch"] = dict(B=B, H=H, H2=H2, total_raw=int(off[-1]),
                        valid_hits=int(hits.valid.sum()),
                        kept_hits=int(hits.keep.sum()),
                        slow_kept=int(out[-2]),
                        cls=[int(((out[:B] & 3) == c).sum())
                             for c in range(3)])
    return res


def chain_launches(batches, chained=True):
    """Each chain kernel's launches in a run of `batches` batches: once a
    batch each, the seed-freq scan (chain_scan_seeds), the hits kernel and
    classify+pack, and no stand-alone scan (chain_scan); with host
    chaining only the seed-freq scan and the hits kernel."""
    if chained:
        return dict(chain_scan_seeds=batches, chain_hits=batches,
                    chain_classify_pack=batches)
    return dict(chain_scan_seeds=batches, chain_hits=batches)


def run_chain(ck, batches, card, reps=50):
    """The chain kernels on the warm-up's own batches, each stage equal to
    its plain version: every batch at tier 2 (the folded apply on the even
    ones), batch 0 at tier 18 (collect_chain's rerun), an edge batch
    (lengths 0, 15, 16, 17, bucket - 1 and bucket forced, random tails)
    at tier 1 with the apply, single-end, batch 0's hits repeated 24
    times (dense_batch: chunked staging) and 4,096 reads at bucket 496;
    then batch 0 timed."""
    kern, packed0, rlens0, pair_end = batches[0]
    L = kern.ctx.seq_len // 2
    errs = [equal_chain(f"chain main-path batch {i}", ck, k, p, r,
                        L if i % 2 == 0 else None, pair_end=pe)[0]
            for i, (k, p, r, pe) in enumerate(batches)]
    errs.append(equal_chain("chain batch 0 at tier 18", ck, kern, packed0,
                            rlens0, None, tier=18, pair_end=pair_end)[0])
    codes, rl = scan_inputs(packed0, kern.max_len, seed=7)
    errs.append(equal_chain("chain edge batch at tier 1", ck, kern, codes,
                            rl, L, tier=1)[0])
    err, dense = equal_dense(ck, kern, packed0, rlens0)
    errs.append(err)
    # 4,096 reads of up to 496 bases (31 words a read; the kernel's shared
    # memory passes 48 KB), the first 128 from the main path's reads
    from mapcaller_tpu_torch.ops.fm_search import SeedChainKernel
    codes, rl = scan_inputs(packed0[:4096], 496, seed=9)
    errs.append(equal_chain("chain 496-base batch", ck, SeedChainKernel(
        kern.fm, kern.ctx, 496, 4096), codes, rl, L)[0])
    own = measure_chain(ck, kern, packed0, rlens0, reps)
    own["max_abs_err"] = max(errs)
    emit("chain", card=card, main_path_batches=len(batches),
         calls_equal=len(errs), max_abs_err=max(errs), dense_batch=dense,
         main_path_batch0=own)
    run_chain_race(ck, batches, card)
    run_stream_race(ck, batches, card)
    return own


def run_chain_race(ck, batches, card, launches=200):
    """The redesigned kernels launched `launches` times back to back each
    (the scan on the seed freqs, the hits kernel on each of those scans,
    the stand-alone scan on the slow counts, classify+pack), on batch 0
    and on four batches end to end (131,072 reads: 341 1/3 scan tiles,
    1,024 classify+pack tiles), every result equal to its plain version
    in every element: the look-back's tickets, epochs and status words
    from launch to launch."""
    import torch
    kern = batches[0][0]
    parts = [chain_run(ck, k, p, r) for k, p, r, _ in batches[:4]]
    big = [torch.cat([pt[0][i] for pt in parts]) for i in range(6)]
    nb = big[0].shape[0]
    inputs = (("batch 0", parts[0][0], batches[0][1], batches[0][2],
               slow_counts(parts[0][3], kern.batch), kern.H, kern.H2),
              (f"{nb} reads", big, torch.cat([b[1] for b in batches[:4]]),
               torch.cat([b[2] for b in batches[:4]]),
               torch.cat([slow_counts(pt[3], kern.batch) for pt in parts]),
               nb * kern.H // kern.batch, nb * kern.H2 // kern.batch))
    res = {}
    for what, seeds, packed, rlens, slow, H, H2 in inputs:
        freq, n = seeds[4], seeds[0]
        B = n.shape[0]
        slow = slow.to(torch.int32).contiguous()
        want_scan = ck.chain_scan_seeds_plain(freq, n, H)
        want_hits = ck.chain_hits_plain(kern.fm1, want_scan.off, *seeds[:5],
                                        H)
        want_off2 = ck.chain_scan_plain(slow)
        want_out = torch.empty(2 * B + 2 * H2 + B // 2 + B // 32 + 2,
                               dtype=torch.int32, device=packed.device)
        cp_args = (kern.ctx, packed, rlens, want_scan.off, want_hits,
                   seeds[5], kern.max_len)
        want_mmp = ck.chain_classify_pack_plain(*cp_args, want_out, H2)
        scans = [ck.chain_scan_seeds(freq, n, H) for _ in range(launches)]
        hits = [ck.chain_hits(kern.fm1, sc, *seeds[:5], H) for sc in scans]
        offs2 = [ck.chain_scan(slow) for _ in range(launches)]
        cps = []
        for _ in range(launches):
            out = torch.empty_like(want_out)
            cps.append((out, ck.chain_classify_pack(*cp_args, out, H2)))
        torch.cuda.synchronize()
        bad = dict(
            chain_scan_seeds=sum(not all(map(torch.equal, sc, want_scan))
                                 for sc in scans),
            chain_hits=sum(not all(map(torch.equal, h, want_hits))
                           for h in hits),
            chain_scan=sum(not torch.equal(o, want_off2) for o in offs2),
            chain_classify_pack=sum(not (torch.equal(o, want_out)
                                         and torch.equal(m, want_mmp))
                                    for o, m in cps))
        if any(bad.values()):
            raise AssertionError(f"chain race on {what}: results that "
                                 f"differ from the plain version {bad}")
        res[what] = dict(B=B, H=H, H2=H2, launches_each=launches,
                         scan_tiles=-(-B // ck.SCAN_THREADS),
                         classify_pack_tiles=-(-B // ck.CP_READS),
                         total_raw=int(want_scan.off[-1]),
                         total_kept=int(want_out[-2]), unequal=bad)
        del scans, hits, offs2, cps
    emit("chain", card=card, race=res)


def run_stream_race(ck, batches, card, launches=200):
    """Two replicas of -devices on one card, each issuing on a stream of
    its own: the seed-freq scan and classify+pack of batch 0 (replica A)
    and of batch 1 (replica B) launched `launches` times each, A and B
    interleaved, every result equal to its plain version. Each stream
    has its own look-back scratch and epochs (ops/chain_kernels.
    _scratch_key); with one scratch for the card the two streams' tiles
    would read each other's status words."""
    import torch
    replicas = []
    for k, p, r, _ in batches[:2]:
        seeds, scan, hits, out, mmp = chain_run(ck, k, p, r)
        want_scan = ck.chain_scan_seeds_plain(seeds[4], seeds[0], k.H)
        want_out = torch.empty_like(out)
        want_mmp = ck.chain_classify_pack_plain(
            k.ctx, p, r, want_scan.off, hits, seeds[5], k.max_len, want_out,
            k.H2)
        replicas.append((k, p, r, seeds, hits, want_scan, want_out,
                         want_mmp))
    dev = batches[0][1].device
    streams = [torch.cuda.Stream(device=dev) for _ in replicas]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(dev))
    got = [[] for _ in replicas]
    for _ in range(launches):
        for s, g, (k, p, r, seeds, hits, *_w) in zip(streams, got, replicas):
            with torch.cuda.stream(s):
                sc = ck.chain_scan_seeds(seeds[4], seeds[0], k.H)
                out = torch.empty(2 * k.batch + 2 * k.H2 + k.batch // 2
                                  + k.batch // 32 + 2, dtype=torch.int32,
                                  device=dev)
                mmp = ck.chain_classify_pack(k.ctx, p, r, sc.off, hits,
                                             seeds[5], k.max_len, out, k.H2)
                g.append((sc, out, mmp))
    torch.cuda.synchronize()
    bad = {}
    for name, g, (*_i, want_scan, want_out, want_mmp) in zip(
            "AB", got, replicas):
        bad[name] = dict(
            chain_scan_seeds=sum(not all(map(torch.equal, sc, want_scan))
                                 for sc, _, _ in g),
            chain_classify_pack=sum(not (torch.equal(o, want_out)
                                         and torch.equal(m, want_mmp))
                                    for _, o, m in g))
    scratches = len({key for key in ck._scan_scratch
                     if key[0] == dev and key[1] in
                     {s.cuda_stream for s in streams}})
    emit("devices", card=card, race=dict(
        streams=len(streams), launches_each=launches, unequal=bad,
        scratches_of_the_streams=scratches,
        reads=[int(x[0].batch) for x in replicas]))
    if any(v for b in bad.values() for v in b.values()) or scratches != 2:
        raise AssertionError(f"two-stream race: results that differ from "
                             f"the plain version {bad}, or the streams "
                             f"shared a look-back scratch ({scratches})")


def run_chain_walk(ck, batches, card, reps=20):
    """The 1-step run's batches replayed with the full SA withheld, so the
    hits kernel walks inverse-Psi: each chain stage equal to its plain
    version; batch 0's hits kernel timed beside its bound (hits_work)."""
    import dataclasses
    import torch
    kern = batches[0][0]
    fm = dataclasses.replace(kern.fm1, sa_full=torch.zeros(
        0, dtype=torch.int32, device=kern.fm1.device))
    errs, unresolved = [], 0
    for i, (k, p, r, pe) in enumerate(batches):
        err, got = equal_chain(f"chain 1-step batch {i}, no full SA", ck, k,
                               p, r, None, fm=fm, pair_end=pe)
        errs.append(err)
        unresolved += int(got[2].unresolved.sum())
    _, p, r, _ = batches[0]
    seeds = kern._scan_packed(p, r)
    scan = ck.chain_scan_seeds(seeds[4], seeds[0], kern.H)
    hits = ck.chain_hits(fm, scan, *seeds[:5], kern.H)
    nbytes, ops, steps = hits_work(fm, seeds, scan, hits)
    bound, by = bound_of(nbytes, ops)
    walk = dict(ms=cuda_ms(lambda: ck.chain_hits(fm, scan, *seeds[:5],
                                                 kern.H), reps, queued=True),
                call_ms=cuda_ms(lambda: ck.chain_hits(fm, scan, *seeds[:5],
                                                      kern.H), reps),
                plain_ms=cuda_ms(lambda: ck.chain_hits_plain(
                    fm, scan.off, *seeds[:5], kern.H), 2, warmup=1),
                valid_hits=int(min(int(scan.off[-1]), kern.H)),
                walk_steps=steps, bound_ms=bound, bound_by=by, bytes=nbytes)
    walk["share_of_bound"] = bound / walk["ms"]
    emit("chain", card=card, one_step_batches_equal_without_full_sa=len(errs),
         max_abs_err=max(errs), unresolved_reads=unresolved,
         walk_batch0=walk)


def backend_facts(be):
    """What a devices or shards run records of its backend: each
    replica's device, batches, prefix-skip depth K and whether its planes
    fit; or the shard devices, the occ3 rows a shard and the sharded
    dispatches."""
    if getattr(be, "is_multi_device", False):
        return dict(replicas=[dict(device=str(d), batches=n, groups=g,
                                   pfx_k=b.pfx_k,
                                   device_evidence_ok=b.device_evidence_ok)
                              for d, n, g, b in zip(be.devs, be.batches,
                                                    be.groups, be.bes)])
    tabs = be._big if getattr(be, "big", False) else be._sharded
    sfm3s = tabs[0] if tabs else {}
    occ3 = next(iter(sfm3s.values())).occ3 if sfm3s else None
    return dict(index_shards=be.index_shards,
                shard_devices=[str(d) for d in be.shard_devs],
                occ3_rows_a_shard=occ3.per if occ3 else None,
                sharded_invocations=be.sharded_invocations,
                n_tier_reruns=be.n_tier_reruns)


def run_scale_axes(run, check, card, L):
    """The main path with -devices 2 (two replicas on this card, each on a
    stream of its own, evidence planes per replica summed once) and with
    -shards 2 and 4 (the occ3 rows and the SA split over shards on this
    card, every batch's reads split over the shards and mapped by the
    routed kernels), each writing the warm-up's bytes. The devices run
    counts each replica's batches and kernel launches; the shards runs
    launch the routed scan and hits kernels once a shard a batch and
    their unrouted forms never, and every one of those launches (its
    shard's B / n reads, its own hit capacity H) is held equal in every
    word to its plain routed version. The copies of a run's launches count
    in that run's peak memory, and the -shards 4 run's peak also holds
    the first -shards 2 launch's tables. -> (the devices run, the shards
    runs, {n: (the shards run's first launch, its scan launches)})."""
    import collections
    import torch
    from mapcaller_tpu_torch.ops import chain_kernels as ck
    from mapcaller_tpu_torch.ops import seed_scan_device as ssd
    from mapcaller_tpu_torch.parallel.devices import MultiDeviceBackend
    from mapcaller_tpu_torch.parallel.sharded_index import ShardChainKernel
    from mapcaller_tpu_torch.pipeline.device_backend import DeviceBackend
    cuda0 = torch.device("cuda", 0)

    def total():
        return (sum(ssd.STATS.launches.values())
                + sum(ck.STATS.launches.values()))

    per = collections.Counter()
    submits = {"submit_chain_group": MultiDeviceBackend.submit_chain_group}

    def tapped(submit):
        def tap(self, *a, **kw):
            i, before = self._rr, total()
            tok = submit(self, *a, **kw)
            per[i] += total() - before
            return tok
        return tap

    for k, f in submits.items():
        setattr(MultiDeviceBackend, k, tapped(f))
    try:
        multi = check(run(backend=lambda idx, cfg: MultiDeviceBackend(
            idx, cfg, devices=[cuda0] * 2)))
    finally:
        for k, f in submits.items():
            setattr(MultiDeviceBackend, k, f)
    reps = multi["backend"]["replicas"]
    for i, r in enumerate(reps):
        r["launches"] = per[i]
    batches = multi["stages"]["batches"]
    # whole transfer groups of 4 go round-robin: a replica's batches are
    # the members of its groups
    want_groups = [len(range(i, -(-batches // 4), 2)) for i in range(2)]
    want_batches = [sum(min(4, batches - 4 * g)
                        for g in range(i, -(-batches // 4), 2))
                    for i in range(2)]
    emit("devices", card=card, replicas=reps, batches=batches,
         transfers=multi["transfers"],
         plane_add=time_plane_add(L),
         peak_mem_bytes=multi["peak"],
         reads_per_s=multi["metrics"]["reads_per_sec"],
         mapping_s=multi["metrics"]["mapping_seconds"],
         sam_identical=multi["sam_identical"],
         vcf_identical=multi["vcf_identical"])
    if not (len(reps) == 2 and all(r["batches"] > 0 for r in reps)
            and [r["batches"] for r in reps] == want_batches
            and [r["groups"] for r in reps] == want_groups
            and sum(r["launches"] for r in reps) == 4 * batches):
        raise AssertionError(f"devices: a replica mapped no batch, the "
                             f"transfer groups did not go round-robin "
                             f"whole, or the batches or launches do not "
                             f"add up {reps}")

    # taps on a shard's routed scan and hits: each launch's kernel, its
    # inputs and a copy of its outputs, in launch order
    scan_packed = ShardChainKernel._scan_packed
    hits_of = ShardChainKernel._hits
    launches = []

    def tap_scan(self, packed, rlens):
        seeds = scan_packed(self, packed, rlens)
        launches.append(dict(kern=self, packed=packed.clone(),
                             rlens=rlens.clone(),
                             seeds=tuple(t.clone() for t in seeds)))
        return seeds

    def tap_hits(self, *seeds):
        off, hits = hits_of(self, *seeds)
        launches[-1].update(off=off.clone(),
                            hits=ck.Hits(*(t.clone() for t in hits)))
        return off, hits

    sharded, shard_launches = [], {}
    for n in (2, 4):
        launches = []
        ShardChainKernel._scan_packed = tap_scan
        ShardChainKernel._hits = tap_hits
        try:
            t = check(run(index_shards=n, backend=lambda idx, cfg, n=n:
                          DeviceBackend(idx, cfg,
                                        shard_devices=[cuda0] * n)))
        finally:
            ShardChainKernel._scan_packed = scan_packed
            ShardChainKernel._hits = hits_of
        b = t["stages"]["batches"]
        scan_err, hits_err = check_shard_launches(ck, ssd, n, launches)
        emit("shards", card=card, shards=n, backend=t["backend"], batches=b,
             scan_launches=t["scan_launches"],
             chain_launches=t["chain_launches"], peak_mem_bytes=t["peak"],
             reads_per_s=t["metrics"]["reads_per_sec"],
             mapping_s=t["metrics"]["mapping_seconds"],
             sam_identical=t["sam_identical"],
             vcf_identical=t["vcf_identical"],
             launches_held_to_plain=len(launches),
             reads_a_launch=sorted({int(x["rlens"].shape[0])
                                    for x in launches}),
             H_a_launch=sorted({x["kern"].H for x in launches}),
             routed_scan_max_abs_err=scan_err,
             routed_hits_max_abs_err=hits_err)
        if not (t["sam_identical"] and t["vcf_identical"]
                and t["backend"]["sharded_invocations"] == b > 0
                and t["scan_launches"] == {"seed_scan3_routed": n * b}
                and t["chain_launches"] == dict(
                    chain_scan_seeds=n * b, chain_hits_routed=n * b,
                    chain_classify_pack=n * b)
                and len(launches) == n * b
                and t["metrics"]["n_oracle_reads"] == 0
                and t["metrics"]["n_tier_reruns"] == 0):
            raise AssertionError(f"shards {n}: bytes differ from the "
                                 f"warm-up's, a batch missed the sharded "
                                 f"stage, an unrouted kernel ran or a routed "
                                 f"one did not run once a shard a batch")
        sharded.append(t)
        # run_routed replays the first, and counts the run's scans
        shard_launches[n] = (launches[0], len(launches))
    return multi, sharded, shard_launches


SEED_KEYS = ("n_seeds", "s_rpos", "s_len", "s_x0", "s_freq", "overflow")


def time_plane_add(L, reps=50):
    """The merge of -devices 2's planes (parallel/devices.py: replica 1's
    four planes added into replica 0's, four add_ calls) on two plane sets
    of genome size L on this card: device ms (queued) and the bound, two
    plane sets read and one written over the memory rate."""
    import torch
    from mapcaller_tpu_torch.pipeline.device_profile import DevicePlanes
    a, b = (DevicePlanes.zeros(L, "cuda") for _ in range(2))
    names = ("acgt", "exact_diff", "f_diff", "multi_diff")
    nbytes = sum(getattr(a, k).numel() * 4 for k in names)
    ms = cuda_ms(lambda: [getattr(a, k).add_(getattr(b, k)) for k in names],
                 reps, queued=True)
    bound = 1e3 * 3 * nbytes / H100_BYTES_S
    return dict(L=L, plane_set_bytes=nbytes, adds=4, ms=ms, bound_ms=bound,
                bound_by="bytes", share_of_bound=bound / ms)


def check_shard_launches(ck, ssd, n, launches):
    """Every routed scan and hits launch of a -shards n run equal in every
    word to its plain routed version on the launch's own inputs (the
    shard's reads and tables, its hit capacity). -> the max abs
    differences (0, 0)."""
    scan_err = hits_err = 0
    for j, x in enumerate(launches):
        k = x["kern"]
        want = ssd.seed_scan3_routed_plain(k.fm, x["packed"], x["rlens"],
                                           k.max_len, k.max_seeds)
        scan_err = max(scan_err, max_err(
            f"-shards {n} launch {j}: seed_scan3_routed",
            list(zip(SEED_KEYS, x["seeds"], want))))
        want_h = ck.chain_hits_plain(k.fm1, x["off"], *x["seeds"][:5], k.H)
        hits_err = max(hits_err, max_err(
            f"-shards {n} launch {j}: chain_hits_routed",
            [(f, getattr(x["hits"], f), getattr(want_h, f))
             for f in want_h._fields]))
    return scan_err, hits_err


def read_records(out):
    """SeedChainKernel.collect's tuple -> one record a read: its class,
    pd, mm, rplast, cscore and its hits (rpos, gpos, slen)."""
    import numpy as np
    cls, pd, mm, rplast, cscore, counts, rpos, gpos, slen = out[:9]
    ends = np.cumsum(counts)
    recs = []
    for i in range(len(counts)):
        s, e = ends[i] - counts[i], ends[i]
        recs.append((int(cls[i]), int(pd[i]), int(mm[i]), int(rplast[i]),
                     int(cscore[i]), tuple(rpos[s:e].tolist()),
                     tuple(gpos[s:e].tolist()), tuple(slen[s:e].tolist())))
    return recs


def sharded_walk_stage(ck, be, flat_walk, packed, rlens, n):
    """The whole sharded chain stage without the full SA (the inverse-Psi
    walk over sharded occ4 rows and sampled SA) on the main path's batch
    0, against one card's stage on the same walk tables (equal in every
    output) and against one card's stage with the full SA: the reads that
    differ from the full-SA stage must all be reads whose walk ran out
    (flagged for the host oracle, as a seed overflow is), which the stream
    re-seeds on the host. -> facts of the comparison."""
    import numpy as np
    import torch
    from mapcaller_tpu_torch.ops.fm_search import build_seed_chain_kernel
    from mapcaller_tpu_torch.parallel.sharded_index import (
        ShardedChainKernel, replicate_ctx, shard_index)
    max_len, B = packed.shape[1] * 4, packed.shape[0]
    devs = [packed.device] * n
    ctx = be.chain_ctx
    stage = ShardedChainKernel(shard_index(flat_walk, devs),
                               replicate_ctx(ctx, devs), devs, max_len, B)
    one_walk = build_seed_chain_kernel(flat_walk, ctx, max_len, B,
                                       slow_hits_x4=2)
    one_full = be._chain_kernel_for(max_len, 2, B)
    before = dict(ck.STATS.launches)
    got = stage.collect(stage(packed, rlens)[0])
    routed = {k: v - before.get(k, 0) for k, v in ck.STATS.launches.items()}
    want = one_walk.collect(one_walk(packed, rlens)[0])
    full = one_full.collect(one_full(packed, rlens)[0])
    torch.cuda.synchronize()
    names = ("cls", "pd", "mm", "rplast", "cscore", "counts", "rpos", "gpos",
             "slen", "overflow")
    bad = [k for k, a, b in zip(names, got, want)
           if not np.array_equal(np.asarray(a), np.asarray(b))]
    if bad or got[10] != want[10] or routed.get("chain_hits_routed") != n:
        raise AssertionError(f"sharded walk stage, {n} shards: differs from "
                             f"one card's walk stage in {bad} (buffer "
                             f"overflow {got[10]} vs {want[10]}) or the "
                             f"routed hits ran {routed} times")
    flagged = set(np.nonzero(got[9])[0].tolist())
    diff = {i for i, (a, b) in enumerate(zip(read_records(got),
                                             read_records(full)))
            if a != b}
    if not diff <= flagged:
        raise AssertionError(f"sharded walk stage, {n} shards: "
                             f"{len(diff - flagged)} reads differ from the "
                             f"full-SA stage without a flag")
    return dict(shards=n, reads=B, equal_to_one_card_walk=True,
                reads_flagged_by_walk=len(flagged),
                reads_flagged_with_full_sa=int(np.count_nonzero(full[9])),
                reads_differing_from_full_sa=len(diff),
                all_differing_reads_flagged=True)


def shard_setup_bytes(be, dev):
    """Device bytes of placing the occ3 shards, above what the backend
    already holds (its 1-step rows, full SA, text words): the peak and
    what stays, for the build a shard at a time (build_shard_index, the
    backend's) and for the whole table built and then split (shard_index
    of DeviceFM3.from_host), with 2 and 4 shards on this card."""
    import torch
    from mapcaller_tpu_torch.ops.fm3_device import DeviceFM3
    from mapcaller_tpu_torch.parallel.sharded_index import (
        build_shard_index, shard_index)
    tw = be.chain_ctx.text_words

    def measure(build):
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = build()
        torch.cuda.synchronize()
        got = dict(peak=torch.cuda.max_memory_allocated() - base,
                   held=torch.cuda.memory_allocated() - base)
        del out
        return got

    res = {}
    for n in (2, 4):
        devs = [dev] * n
        res[n] = dict(
            a_shard_at_a_time=measure(lambda: build_shard_index(
                be.idx, be.fm, devs, tw)),
            whole_table_then_split=measure(lambda: shard_index(
                DeviceFM3.from_host(be.idx, be.fm, pfx_k=0, text_words=tw),
                devs)))
    return res


def run_routed(prefix, batch, shard_launches, card, reps=20):
    """The routed scan and hits kernels on the first launch of each
    -shards n run (shard 0 of the main path's batch 0: B / n reads, that
    kernel's own tables and hit capacity): each equal in every word to
    its plain routed version (ops/seed_scan_device.
    seed_scan3_routed_plain; chain_hits_plain over the routed SA), to
    what the launch gave in the stream and to the unrouted kernels'
    outputs on the same reads (the main path's scan with its prefix skip,
    the hits kernel over the one SA); the hits also by the inverse-Psi
    walk over sharded occ4 rows and sampled SA. Device ms beside the
    unrouted kernel's on the same work (the scan without the prefix
    skip), call ms, plain ms and the bound (the unrouted kernel's bytes:
    the same rows and SA entries). Then the whole sharded stage by the
    walk on batch 0 (sharded_walk_stage) and the bytes of placing the
    shards (shard_setup_bytes)."""
    import dataclasses
    import torch
    from mapcaller_tpu_torch.config import Config
    from mapcaller_tpu_torch.index.fmindex import load_index
    from mapcaller_tpu_torch.ops import chain_kernels as ck
    from mapcaller_tpu_torch.ops import seed_scan_device as ssd
    from mapcaller_tpu_torch.parallel.sharded_index import shard_index
    from mapcaller_tpu_torch.pipeline.device_backend import DeviceBackend
    p0, r0 = batch[:2]
    cuda0 = p0.device
    be = DeviceBackend(load_index(prefix), Config(device="cuda"))
    fm3 = be.fm3
    # the same rows without the prefix-skip rows: the routed scan's work
    flat = dataclasses.replace(fm3, occ3_rows=fm3.occ3_rows[
        :fm3.pfx_base or fm3.occ3_rows.shape[0]], pfx_k=0, pfx_base=0)
    fm1 = fm3.fm
    fm_walk = dataclasses.replace(fm1, sa_full=fm1.sa_full[:0])
    res, walk_stage = {}, []
    for n in (2, 4):
        x, n_scans = shard_launches[n]
        k, packed, rlens = x["kern"], x["packed"], x["rlens"]
        sfm, S, H, max_len = k.fm, k.max_seeds, k.H, k.max_len
        B = packed.shape[0]
        fns = (lambda w=False: ssd.seed_scan3_routed(
                   sfm, packed, rlens, max_len, S, with_iters=w),
               lambda w=False: ssd.seed_scan3_routed_plain(
                   sfm, packed, rlens, max_len, S, with_iters=w))
        scan_r = measure_scan(f"seed_scan3_routed, {n} shards, shard 0 of "
                              f"batch 0", "seed_scan3", fns, packed, S, reps)
        seeds = fns[0]()
        flat_kernel = scan_fns(ssd, "seed_scan3", flat, packed, rlens,
                               max_len, S)[0]
        scan_r["max_abs_err_vs_unrouted"] = max_err(
            f"routed scan, {n} shards, vs the stream's launch and the "
            f"unrouted scans", list(zip(SEED_KEYS, seeds, x["seeds"]))
            + list(zip(SEED_KEYS, seeds, flat_kernel()))
            + list(zip(SEED_KEYS, seeds, ssd.seed_scan3(
                fm3, packed, rlens, max_len, S))))
        scan_r["unrouted_ms"] = cuda_ms(flat_kernel, reps, queued=True)
        scan_r["unrouted_with_prefix_skip_ms"] = cuda_ms(
            lambda: ssd.seed_scan3(fm3, packed, rlens, max_len, S), reps,
            queued=True)
        launch_gap(scan_r, n_scans)

        def hits_pairs(what, fm_r, fm_flat):
            sc = [ck.chain_scan_seeds(seeds[4], seeds[0], H)
                  for _ in range(2)]
            got = ck.chain_hits_routed(fm_r, sc[0], *seeds[:5], H)
            plain = ck.chain_hits_plain(fm_r, sc[0].off, *seeds[:5], H)
            flat_h = ck.chain_hits(fm_flat, sc[1], *seeds[:5], H)
            err = max_err(what, [(f"{f} vs plain", getattr(got, f),
                                  getattr(plain, f)) for f in got._fields]
                          + [(f"{f} vs unrouted", getattr(got, f),
                              getattr(flat_h, f)) for f in got._fields])
            return err, sc[0], got

        err, sc, hits = hits_pairs(f"routed hits, {n} shards", sfm.fm, fm1)
        err = max(err, max_err(f"routed hits, {n} shards, vs the stream's "
                               f"launch", [(f, getattr(hits, f),
                                            getattr(x["hits"], f))
                                           for f in hits._fields]))
        nbytes, ops, _ = hits_work(fm1, seeds, sc, hits)
        bound, by = bound_of(nbytes, ops)
        hits_r = dict(
            B=B, H=H, max_abs_err=err, bytes=nbytes, bound_ms=bound,
            bound_by=by,
            ms=cuda_ms(lambda: ck.chain_hits_routed(sfm.fm, sc, *seeds[:5],
                                                    H), reps, queued=True),
            call_ms=cuda_ms(lambda: ck.chain_hits_routed(
                sfm.fm, sc, *seeds[:5], H), reps),
            plain_ms=cuda_ms(lambda: ck.chain_hits_plain(
                sfm.fm, sc.off, *seeds[:5], H), 3, warmup=1),
            unrouted_ms=cuda_ms(lambda: ck.chain_hits(
                fm1, sc, *seeds[:5], H), reps, queued=True),
            valid_hits=int(hits.valid.sum()))
        hits_r["share_of_bound"] = bound / hits_r["ms"]
        devs = [cuda0] * n
        sfm_w = shard_index(dataclasses.replace(flat, fm=fm_walk), devs)
        werr, wsc, whits = hits_pairs(f"routed walk, {n} shards",
                                      sfm_w[cuda0].fm, fm_walk)
        hits_r.update(walk_max_abs_err=werr,
                      walk_unresolved_reads=int(whits.unresolved.sum()),
                      walk_ms=cuda_ms(lambda: ck.chain_hits_routed(
                          sfm_w[cuda0].fm, wsc, *seeds[:5], H), reps,
                          queued=True),
                      walk_unrouted_ms=cuda_ms(lambda: ck.chain_hits(
                          fm_walk, wsc, *seeds[:5], H), reps, queued=True))
        res[n] = dict(seed_scan3_routed=scan_r, chain_hits_routed=hits_r,
                      reads=B, rows_a_shard=sfm.occ3.per,
                      sa_entries_a_shard=sfm.fm.sa_full.per)
        del sfm_w
        walk_stage.append(sharded_walk_stage(
            ck, be, dataclasses.replace(flat, fm=fm_walk), p0, r0, n))
    emit("shards", card=card, routed_kernels_shard0_batch0=res,
         routed_scan_gap_ms_a_run={
             n: res[n]["seed_scan3_routed"]["gap_ms_a_run"] for n in res},
         sharded_walk_stage_batch0=walk_stage,
         setup_bytes=shard_setup_bytes(be, cuda0))
    del be, fm3, flat
    return res


BIG_KERNELS = ("seed_scan3_big", "chain_hits_big", "chain_classify_pack_big")


def big_launch_equal(ck, ssd, n, x):
    """One x64 shard launch (its kernel, inputs and the copies of its
    outputs) equal in every word to the plain versions on the same inputs:
    the 64-bit scan, the hits over the routed int64 SA, classify+pack
    with the int64 side output. -> the max abs differences."""
    import torch
    k = x["kern"]
    want = ssd.seed_scan3_big_plain(k.fm, x["packed"], x["rlens"],
                                    k.max_len, k.max_seeds)
    scan_err = max_err(f"-shards {n} x64: seed_scan3_big",
                       list(zip(SEED_KEYS, x["seeds"], want)))
    want_h = ck.chain_hits_big_plain(k.fm, x["off"], *x["seeds"][:5], k.H)
    hits_err = max_err(f"-shards {n} x64: chain_hits_big",
                       [(f, getattr(x["hits"], f), getattr(want_h, f))
                        for f in want_h._fields])
    out = torch.zeros_like(x["out"])
    wide = torch.zeros_like(x["wide"])
    mmp = ck.chain_classify_pack_big_plain(
        k.ctx, x["packed"], x["rlens"], x["off"], x["hits"], x["seeds"][5],
        k.max_len, out, wide, k.H2)
    cp_err = max_err(f"-shards {n} x64: chain_classify_pack_big",
                     [("out", x["out"], out), ("wide", x["wide"], wide),
                      ("mmp", x["mmp"], mmp)])
    return dict(seed_scan3_big=scan_err, chain_hits_big=hits_err,
                chain_classify_pack_big=cp_err)


def shifted_tables(bfm, lead):
    """The x64 tables placed as if the text began C = lead * 16 * per rows
    later: each Routed table reached through a pointer table whose first
    `lead` entries point at one zero shard (never read by a valid query),
    base3 and base3x with lead zero rows before them, and L2, c3_first and
    the correction rows moved by C. -> (the shifted BigShardedFM3, C)."""
    import dataclasses
    import torch
    from mapcaller_tpu_torch.ops.routed import Routed
    C = lead * 16 * bfm.occ3.per

    def lead_zero(r):
        z = torch.zeros_like(r.shards[0])
        return Routed([z] * lead + list(r.shards), r.per)

    def lead_rows(t):
        return torch.cat([t.new_zeros((lead, t.shape[1])), t])

    return dataclasses.replace(
        bfm, occ3=lead_zero(bfm.occ3), sa=lead_zero(bfm.sa),
        base3=lead_rows(bfm.base3), base3x=lead_rows(bfm.base3x),
        L2=bfm.L2 + C, c3_first=bfm.c3_first + C, primary=bfm.primary + C,
        row_p1=bfm.row_p1 + C, row_p2=bfm.row_p2 + C), C


def run_shifted(ck, ssd, x):
    """The 64-bit scan and hits on a launch's reads with the tables
    placed past 2^31 (shifted_tables) against the same kernels unshifted:
    s_x0 exactly C more in every used slot (0 in the others), every other
    seed output, step and row count equal; every valid hit equal, its
    location too (an invalid slot reads the pad row 32, below the shift:
    the zero shard)."""
    import torch
    k = x["kern"]
    bfm = k.fm
    lead = -(-(1 << 31) // (16 * bfm.occ3.per))
    sfm, C = shifted_tables(bfm, lead)
    args = (x["packed"], x["rlens"], k.max_len, k.max_seeds)
    base = ssd.seed_scan3_big(bfm, *args, with_iters=True)
    shift = ssd.seed_scan3_big(sfm, *args, with_iters=True)
    used = (torch.arange(k.max_seeds, device=base[0].device)[None, :]
            < base[0][:, None])
    want = list(base)
    want[3] = torch.where(used, base[3] + C, 0)
    err = max_err("shifted seed_scan3_big",
                  list(zip(SEED_KEYS + ("iters", "rows"), shift, want)))
    hits = []
    for fm, seeds in ((bfm, base), (sfm, shift)):
        scan = ck.chain_scan_seeds(seeds[4], seeds[0], k.H)
        hits.append(ck.chain_hits_big(fm, scan, *seeds[:5], k.H))
    valid = hits[0].valid
    err = max(err, max_err("shifted chain_hits_big", [
        (f, getattr(hits[1], f), getattr(hits[0], f)) for f in
        ("read", "rpos", "len", "valid", "keep", "unresolved")] + [
        ("loc", torch.where(valid, hits[1].loc, 0),
         torch.where(valid, hits[0].loc, 0))]))
    torch.cuda.synchronize()
    return dict(C=C, lead_shards=lead, max_abs_err=err,
                s_x0_max=int(shift[3].max()),
                s_x0_above_2_31=int((shift[3] >= 1 << 31).sum()),
                valid_hits=int(valid.sum()),
                invalid_hits_reading_zero_shard=int((~valid).sum()),
                classify_pack="int64 positions above 2^31 not verified: "
                              "its text and chromosome-end inputs cannot be "
                              "shifted without a new argument (a read "
                              "without hits reads text word 0)")


def tables32(bfm):
    """The 32-bit forms of an x64 launch's tables, on the same rows: the
    routed tables (occ3 rows made absolute, an int32 SA) and those rows
    end to end as one unrouted table without the prefix skip. -> (fm32,
    sfm32, flat32)."""
    import types
    import torch
    from mapcaller_tpu_torch.ops.routed import Routed
    from mapcaller_tpu_torch.parallel.sharded_index import ShardedFM3
    rows32 = []
    for s, t in enumerate(bfm.occ3.shards):
        r = t.clone()
        r[:, :64] += bfm.base3[s].to(torch.int32)
        rows32.append(r)
    fm32 = types.SimpleNamespace(
        L2=bfm.L2, primary=bfm.primary, seq_len=bfm.seq_len,
        has_full_sa=True,
        sa_full=Routed([t.to(torch.int32) for t in bfm.sa.shards],
                       bfm.sa.per))
    consts = {c: getattr(bfm, c) for c in (
        "row_p1", "row_p2", "t0", "t1", "tail1", "tail2a", "tail2b")}
    c3 = bfm.c3_first.to(torch.int32)
    sfm32 = ShardedFM3(fm=fm32, occ3=Routed(rows32, bfm.occ3.per),
                       c3_first=c3, **consts)
    flat32 = types.SimpleNamespace(occ3_rows=torch.cat(rows32), fm=fm32,
                                   c3_first=c3, pfx_k=0, pfx_base=0,
                                   **consts)
    return fm32, sfm32, flat32


def time_big_scan(ssd, x, n, reps=20):
    """The 64-bit scan on one launch's inputs of the -shards n run (shard
    0 of batch 0, as the run launched it): equal to its plain version
    (steps and gathers too) and to the 32-bit routed and unrouted scans on
    the same rows; device ms (queued) beside theirs on the same reads,
    call ms, plain ms and the bound (rows x 288 B). -> (its dict, its
    seeds, fm32)."""
    k = x["kern"]
    bfm, packed, rlens = k.fm, x["packed"], x["rlens"]
    S, max_len = k.max_seeds, k.max_len
    fm32, sfm32, flat32 = tables32(bfm)
    fns = (lambda w=False: ssd.seed_scan3_big(bfm, packed, rlens, max_len, S,
                                              with_iters=w),
           lambda w=False: ssd.seed_scan3_big_plain(bfm, packed, rlens,
                                                    max_len, S,
                                                    with_iters=w))
    scan = measure_scan(f"seed_scan3_big, {n} shards, shard 0 of batch 0",
                        "seed_scan3", fns, packed, S, reps)
    seeds = fns[0]()
    scan["max_abs_err_vs_32bit_routed"] = max_err(
        "x64 scan vs the 32-bit routed and unrouted scans",
        list(zip(SEED_KEYS, seeds, ssd.seed_scan3_routed(
            sfm32, packed, rlens, max_len, S)))
        + list(zip(SEED_KEYS, seeds, ssd.seed_scan3(
            flat32, packed, rlens, max_len, S))))
    scan["routed32_ms"] = cuda_ms(lambda: ssd.seed_scan3_routed(
        sfm32, packed, rlens, max_len, S), reps, queued=True)
    scan["unrouted_ms"] = cuda_ms(lambda: ssd.seed_scan3(
        flat32, packed, rlens, max_len, S), reps, queued=True)
    scan["share_of_bound"] = scan["bound_ms"] / scan["ms"]
    return scan, seeds, fm32


def time_big(ck, ssd, x, card, reps=20):
    """The three 64-bit kernels on one launch's inputs (shard 0 of batch 0,
    as the -shards 2 run launched it), each beside its 32-bit form on the
    same reads: the scan as time_big_scan, the routed hits over the same
    SA in int32, the 32-bit classify+pack on the same hits. Device ms
    (queued), call ms, plain ms and the bound: bytes (rows x 288 B for
    the scans; the int64 SA entries and locations and the rest of each
    kernel's inputs and outputs) or int32 operations."""
    import torch
    k = x["kern"]
    bfm, packed, rlens = k.fm, x["packed"], x["rlens"]
    B, S, H, H2, max_len = packed.shape[0], k.max_seeds, k.H, k.H2, k.max_len
    scan, seeds, fm32 = time_big_scan(ssd, x, 2, reps)
    sc = ck.chain_scan_seeds(seeds[4], seeds[0], H)
    hits = ck.chain_hits_big(bfm, sc, *seeds[:5], H)
    sc32 = ck.chain_scan_seeds(seeds[4], seeds[0], H)
    h32 = ck.chain_hits_routed(fm32, sc32, *seeds[:5], H)
    herr = max_err("x64 hits vs the 32-bit routed hits", [
        (f, getattr(hits, f).long(), getattr(h32, f).long())
        for f in hits._fields])
    nvalid = int(hits.valid.sum())
    nseeds = int(seeds[0].clamp(0, S).sum())
    # off, the start index, n_seeds, the valid seeds' freq/x0/rpos/len,
    # one int64 SA entry a valid hit; read/rpos/len int32, loc int64,
    # valid and keep a byte each
    hbytes = (4 * (B + 1) + 8 * sc.start.shape[0] + 8 * B + 32 * nseeds
              + 8 * nvalid + 22 * H)
    hb, hby = bound_of(hbytes, CHAIN_OPS["hit"] * H)
    hits_r = dict(B=B, H=H, valid_hits=nvalid, max_abs_err=herr,
                  bytes=hbytes, bound_ms=hb, bound_by=hby,
                  ms=cuda_ms(lambda: ck.chain_hits_big(bfm, sc, *seeds[:5],
                                                       H), reps, queued=True),
                  call_ms=cuda_ms(lambda: ck.chain_hits_big(
                      bfm, sc, *seeds[:5], H), reps),
                  plain_ms=cuda_ms(lambda: ck.chain_hits_big_plain(
                      bfm, sc.off, *seeds[:5], H), 3, warmup=1),
                  routed32_ms=cuda_ms(lambda: ck.chain_hits_routed(
                      fm32, sc32, *seeds[:5], H), reps, queued=True))
    n32, n64 = ck.big_out_sizes(B, H2)
    out = torch.empty(n32, dtype=torch.int32, device=packed.device)
    wide = torch.empty(n64, dtype=torch.int64, device=packed.device)
    cp = (k.ctx, packed, rlens, sc.off, hits, seeds[5], max_len, out, wide,
          H2)
    mmp = ck.chain_classify_pack_big(*cp)
    out_p, wide_p = torch.zeros_like(out), torch.zeros_like(wide)
    cerr = max_err("x64 classify+pack vs plain", [
        ("out", out, out_p), ("wide", wide, wide_p),
        ("mmp", mmp, ck.chain_classify_pack_big_plain(
            k.ctx, packed, rlens, sc.off, hits, seeds[5], max_len, out_p,
            wide_p, H2))])
    # the 32-bit form on the same hits (its locations fit int32 here)
    h32c = hits._replace(loc=hits.loc.to(torch.int32))
    out32 = torch.empty(2 * B + 2 * H2 + B // 2 + B // 32 + 2,
                        dtype=torch.int32, device=packed.device)
    cp32 = (k.ctx, packed, rlens, sc.off, h32c, seeds[5], max_len, out32, H2)
    ck.chain_classify_pack(*cp32)
    # a read without kept hits: pd is INT64_MAX here, INT32_MAX there
    pd64 = torch.where(wide[:B] == 0x7FFFFFFFFFFFFFFF, 0x7FFFFFFF, wide[:B])
    cerr = max(cerr, max_err("x64 classify+pack vs the 32-bit form", [
        ("meta1", out[:B], out32[:B]), ("pd", pd64, out32[B:2 * B]),
        ("hit_w", out[B:B + H2], out32[2 * B:2 * B + H2]),
        ("hit_loc", wide[B:], out32[2 * B + H2:2 * B + 2 * H2]),
        ("tail", out[B + H2:B + H2 + B // 2 + B // 32 + 2],
         out32[2 * B + 2 * H2:])]))
    words = max_len // 16
    nkept = int(hits.keep.sum())
    slow_h = int(out[B + H2 + B // 2 + B // 32])
    nkeys = k.ctx.bkeys.shape[0]
    # chain_bounds' count with int64 locations (read 8 B a valid hit) and
    # pd and hit_loc written as int64
    cbytes = (4 * (B + 1) + B * (4 + 4 * words + 1 + 1) + 17 * nvalid
              + 8 * (words + 1) * B + 8 * nkeys
              + 12 * B + 16 * B + 12 * H2 + 4 * (B // 2 + B // 32 + 2))
    o = CHAIN_OPS
    cb, cby = bound_of(cbytes, o["read_word"] * words * B
                       + o["kept_hit"] * nkept + o["pack_read"] * B
                       + o["pack_hit"] * slow_h)
    cp_r = dict(B=B, H2=H2, max_abs_err=cerr, bytes=cbytes, bound_ms=cb,
                bound_by=cby, slow_kept=slow_h,
                ms=cuda_ms(lambda: ck.chain_classify_pack_big(*cp), reps,
                           queued=True),
                call_ms=cuda_ms(lambda: ck.chain_classify_pack_big(*cp),
                                reps),
                plain_ms=cuda_ms(lambda: ck.chain_classify_pack_big_plain(
                    *cp), 3, warmup=1),
                int32_form_ms=cuda_ms(lambda: ck.chain_classify_pack(*cp32),
                                      reps, queued=True))
    res = dict(seed_scan3_big=scan, chain_hits_big=hits_r,
               chain_classify_pack_big=cp_r)
    for r in res.values():
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
    return res


def live_cuda_tensors():
    """The CUDA tensors the Python heap holds: {id: tensor}."""
    import torch
    out = {}
    for o in gc.get_objects():
        try:
            if torch.is_tensor(o) and o.is_cuda:
                out[id(o)] = o
        except Exception:
            continue
    return out


def big_memory(be, ev, earlier=()):
    """What the x64 run holds on the card: each shard's bytes (occ3 rows,
    SA, plane slices, finalize outputs) and the largest live CUDA tensors.
    Raises if the backend built a single-card table (1-step rows, int32
    occ3 table, whole SA) or any live tensor other than an SA shard (of
    this run, or of the earlier runs' tables in `earlier`) has a
    dimension of L + 1 or more (a plane of genome length); the SA shards
    hold 1/n of the SA's 2L + 1 entries each."""
    bfm = next(iter(be._big[0].values()))
    n, L = len(be.shard_devs), be.idx.genome_size
    sa_ids = {id(t) for f in (bfm, *earlier) for t in f.sa.shards}
    big = sorted(((max(t.shape) if t.dim() else 1, tuple(t.shape),
                   str(t.dtype)) for i, t in live_cuda_tensors().items()
                  if i not in sa_ids), reverse=True)[:6]
    outs, _ = ev.finalize()
    fin = sum(t.numel() * t.element_size() for t in outs[0])
    res = dict(
        shards=n, genome_L=L, single_card_tables=dict(
            fm=be.fm is not None, fm3=be._fm3 is not None,
            sharded32=be._sharded is not None),
        shard_bytes=dict(
            occ3_rows=bfm.occ3.per * 288, sa_int64=bfm.sa.per * 8,
            plane_slices=40 * ev.Pl, finalize_outputs=fin,
            text_words_replicated=be.chain_ctx.text_words.numel() * 8),
        Pl=ev.Pl, sa_entries_a_shard=bfm.sa.per,
        largest_other_tensors=big)
    if (any(res["single_card_tables"].values())
            or (big and big[0][0] >= L + 1)):
        raise AssertionError(f"x64 memory: a single-card table or a "
                             f"genome-length tensor on the card {res}")
    return res


def keep_big_inputs(ev, kept):
    import numpy as np
    """Copies of a BigDeviceEvidence's inputs, taken as its big run makes
    them, for time_big_evidence after the run: its first apply's token,
    admit bits and mode, the host profile's slow-read deltas as its
    merge finds them, and its first column fetch's positions and
    prefix points."""
    import types
    apply, merge, fetch = (ev.apply_batch, ev._merge_host_deltas,
                           ev.fetch_columns)

    def fetch_tap(positions, prefix_pts, bd_blocks=None):
        kept.setdefault("fetch", (np.asarray(positions).copy(),
                                  np.asarray(prefix_pts).copy()))
        return fetch(positions, prefix_pts, bd_blocks)

    def apply_tap(token, fast_bits, pair_end):
        kept.setdefault("apply", (types.SimpleNamespace(
            pd=token.pd.clone(), mmp=token.mmp.clone(),
            rl_dev=token.rl_dev.clone()), fast_bits.copy(), pair_end))
        return apply(token, fast_bits, pair_end)

    def merge_tap():
        p = ev.host_profile
        if not hasattr(p, "any_host_evidence") or p.any_host_evidence():
            kept.setdefault("host", {k: getattr(p, k).copy()
                                     for k in BIG_HOST})
        return merge()

    ev.apply_batch, ev._merge_host_deltas = apply_tap, merge_tap
    ev.fetch_columns = fetch_tap


BIG_HOST = ("acgt", "exact_diff", "F1_diff", "R2_diff", "F2_diff",
            "R1_diff", "multi_diff")


@contextlib.contextmanager
def plain_entries(*swaps):
    """Each (module, kernel entry, plain version) swapped while inside:
    the wrappers then run the plain version where they would launch (the
    entries take the plain versions' arguments)."""
    real = [getattr(m, e) for m, e, _ in swaps]
    for m, e, fn in swaps:
        setattr(m, e, fn)
    try:
        yield
    finally:
        for (m, e, _), fn in zip(swaps, real):
            setattr(m, e, fn)


@contextlib.contextmanager
def entry_calls(mod, entry, calls):
    """The arguments of each call of a kernel entry while inside, kept
    in `calls` (the call still runs)."""
    real = getattr(mod, entry)

    def tap(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)
    setattr(mod, entry, tap)
    try:
        yield
    finally:
        setattr(mod, entry, real)


def replay_ms(fn, calls, reps, queued=True):
    """ms of fn over the kept calls' arguments, one program's launches of
    one call replayed: queued device ms of the kernels; of the plain
    versions (some wait for the card: a mask's nonzero) not queued."""
    return cuda_ms(lambda: [fn(*a, **kw) for a, kw in calls], reps,
                   queued=queued)


def shard_planes(ev):
    """Copies of every shard's planes."""
    return [{k: getattr(sp, k).clone() for k in BIG_PLANES}
            for sp in ev.planes]


def set_planes(ev, copies):
    for sp, c in zip(ev.planes, copies):
        for k in BIG_PLANES:
            getattr(sp, k).copy_(c[k])


def planes_err(a, b):
    return max(int((x[k].long() - y[k].long()).abs().max())
               for x, y in zip(a, b) for k in BIG_PLANES)


def owned_deltas(ev, deltas, ends):
    """The host merge's packed lists (host) split by owner, as the parent
    tree's merge split them: for each shard and plane a numpy mask of the
    entries the shard owns -> [(shard planes, device, plane, local flat
    indices, values)]."""
    from mapcaller_tpu_torch.ops import mesh_kernels as mk
    from mapcaller_tpu_torch.pipeline import device_profile as dp
    idx, val = mk.unpack_deltas(deltas, ends[-1])
    parts = []
    for sp, d in zip(ev.planes, ev.devs):
        lo = 0
        for name, hi, gs in zip(mk.MERGE_PLANES, ends,
                                dp.merge_strides(ev.L)):
            x, v = idx[lo:hi], val[lo:hi]
            lo = hi
            row, g = x // gs, x % gs
            mine = (g >= sp.off) & (g < sp.off + ev.Pl)
            if mine.any():
                parts.append((sp, d, name, g[mine] - sp.off
                              + row[mine] * ev.Pl, v[mine]))
    return parts


def parent_merge(ev, deltas, ends):
    """What the parent tree's merge did after its nonzero scans: the
    masks of owned_deltas, then for each shard and plane their upload
    and an index_add_ (timed as the merge's device part before its
    kernel)."""
    import torch
    from mapcaller_tpu_torch.ops.device_util import upload
    for sp, d, name, li, v in owned_deltas(ev, deltas, ends):
        getattr(sp, name).view(-1).index_add_(0, upload(li, d),
                                              upload(v, d))
    torch.cuda.synchronize()


BIG_PLANES = ("acgt", "exact_diff", "f_diff", "multi_diff")


def time_big_evidence(ev, kept, reps=10):
    """BigDeviceEvidence's programs of one big run, after the run, on
    copies of their inputs. The fold and the scan (on the run's merged
    planes and final fold), the apply (the run's first batch), the
    host-delta merge (the host profile's slow-read deltas as the run's
    merge found them) and the column fetch (the run's first, with its
    positions' block depths; also in shuffled order, and as the parent
    tree ran it, parent_fetch) are each held against their plain
    versions on the card, every word of every shard's outputs, by
    swapping the kernel entries for the plain versions; then timed: each
    call (host work and syncs inside), its kernels' device ms (queued:
    the call's launches replayed, per call and per shard) and the plain
    versions' on the same launches, beside the bound, the bytes they must
    move over the card's memory rate (apply: every shard reads the
    batch's pd, mmp, read lengths and admit bits, and each plane update
    is read and written once; merge: each entry's index and value read
    and its plane word read and written once, by the shard that owns it,
    and beside it the sectors: 12 B an entry and each distinct 32-byte
    sector of the words read and written; fold: 40 B of planes and 4 of
    codes read, 48 of outputs written a position; scan: 28 B read a
    position; fetch: the indices read, 40 B gathered a position and 8 a
    prefix point, 80 and 8 written). The merge and the fetch are one
    launch a call (one device). The merge's two parts apart: its nonzero
    scans of the host arrays (host work, as before its kernel), then its
    upload and launch (BigDeviceEvidence._merge_lists), beside the parent
    tree's masks, uploads and index_add_ on the same lists; the library
    call is that index_add_ alone. The fetch call cut into its host parts
    (split_b4_call), the parent tree's (parent_fetch: a launch a shard)
    and this one's."""
    import types
    import numpy as np
    import torch
    from mapcaller_tpu_torch.ops import calling_kernels as cal
    from mapcaller_tpu_torch.ops import mesh_kernels as mk
    from mapcaller_tpu_torch.ops.device_util import upload
    from mapcaller_tpu_torch.pipeline import device_profile as dp
    # the taps: the class's again
    del ev.apply_batch, ev._merge_host_deltas, ev.fetch_columns
    n, Pl = ev.n, ev.Pl
    tok, fast_bits, pe = kept["apply"]
    B, S = tok.mmp.shape
    fb = np.zeros((B + 31) // 32, dtype=np.int32)
    fb[:fast_bits.size] = fast_bits.view(np.int32)
    adm = ((fb[np.arange(B) >> 5].astype(np.int64) >> (np.arange(B) & 31))
           & 1).astype(bool)
    n_mm = int((tok.mmp.cpu().numpy()[adm] >= 0).sum())
    def rescan():
        ev._scan = None
        return ev.scan()

    # the fold and the scan a shard on the kernels, as the run took them,
    # against their plain versions on the card (the kernel entries
    # swapped for the plain versions, which take the same arguments), on
    # the run's merged planes and final fold
    got = ev._fold(), rescan()
    with plain_entries((cal, "_finalize_kernel", cal.evidence_finalize_plain),
                       (cal, "_scan_kernel", cal.caller_scan_plain)):
        want = ev._fold(), rescan()
        plain_ms = dict(fold=cuda_ms(ev._fold, reps),
                        scan=cuda_ms(rescan, reps))
    (gouts, gtots), gscan = got
    (wouts, wtots), wscan = want
    errs = dict(
        fold=max([max_err_of(g, w) for g, w in zip(gouts, wouts)]
                 + [int(np.abs(gtots - wtots).max())]),
        scan=max([max_err_of(g, w) for g, w in zip(gscan[0]._parts,
                                                   wscan[0]._parts)]
                 + [int(np.abs(np.asarray(g, np.int64)
                               - np.asarray(w, np.int64)).max())
                    if np.asarray(g).size else 0
                    for g, w in zip(gscan[1:], wscan[1:])]))
    rescan()
    # the fetch: positions, prefix points and their block depths, routed
    # and launched as fetch_columns does
    pos, pref = kept["fetch"]
    p = np.clip(pos.astype(np.int64), 0, ev.L - 1)
    pp = np.clip(pref.astype(np.int64), 0, ev.L)
    blocks = np.unique(p // 100)
    bds = ev._scan[0]._parts
    fcalls = []
    with entry_calls(cal, "_fetch_slice_kernel", fcalls):
        fgot = ev._fetch(p, pp, blocks, bds)
    with plain_entries((cal, "_fetch_slice_kernel",
                        cal.caller_fetch_slice_plain)):
        fwant = ev._fetch(p, pp, blocks, bds)
    # the same elements shuffled, and the parent's form (a launch a
    # shard, the outputs scattered back)
    rng = np.random.default_rng(n)
    perm = [rng.permutation(x.size) for x in (p, pp, blocks)]
    shuffled = [x[o] for x, o in zip((p, pp, blocks), perm)]
    sgot = ev._fetch(*shuffled, bds)
    with plain_entries((cal, "_fetch_slice_kernel",
                        cal.caller_fetch_slice_plain)):
        swant = ev._fetch(*shuffled, bds)
    pgot = parent_fetch(ev, p, pp, blocks, bds)
    errs["fetch"] = max(int(np.abs(g - w).max()) if g.size else 0
                        for g, w in zip(
                            (*fgot, *sgot, *sgot, *pgot),
                            (*fwant, *swant,
                             *(x[o] for x, o in zip(fgot, perm)), *fwant)))
    # the apply, held on the run's final planes, which it leaves as they
    # were
    base = shard_planes(ev)
    acalls = []
    with entry_calls(mk, "_apply_slice_kernel", acalls):
        ev.apply_batch(tok, fast_bits, pe)
    agot = shard_planes(ev)
    set_planes(ev, base)
    with plain_entries((mk, "_apply_slice_kernel", mk.apply_slice_plain)):
        ev.apply_batch(tok, fast_bits, pe)
    errs["apply"] = planes_err(agot, shard_planes(ev))
    del agot
    # the merge, held the same way on copies of the host arrays
    host, live = kept.get("host"), ev.host_profile

    def host_copy():
        return types.SimpleNamespace(**{k: v.copy() for k, v in host.items()})
    mcalls, lcalls = [], []
    if host:
        set_planes(ev, base)
        ev.host_profile = host_copy()
        with entry_calls(mk, "_host_merge_kernel", mcalls), \
                entry_calls(mk, "_merge_launch", lcalls):
            ev._merge_host_deltas()
        mgot = shard_planes(ev)
        set_planes(ev, base)
        ev.host_profile = host_copy()
        with plain_entries((mk, "_host_merge_kernel", mk.host_merge_plain)):
            ev._merge_host_deltas()
        errs["merge"] = planes_err(mgot, shard_planes(ev))
        del mgot
    set_planes(ev, base)
    if any(errs.values()):
        raise AssertionError(f"big: B4's kernels != their plain versions "
                             f"{errs}")
    # times: whole calls, then each call's launches replayed
    ms = dict(fold=cuda_ms(ev._fold, reps), scan=cuda_ms(rescan, reps),
              fetch=cuda_ms(lambda: ev.fetch_columns(pos, pref), reps),
              apply=cuda_ms(lambda: ev.apply_batch(tok, fast_bits, pe), reps))
    dev = dict(apply=replay_ms(mk._apply_slice_kernel, acalls, reps),
               fetch=replay_ms(cal._fetch_slice_kernel, fcalls, reps))
    plain = dict(apply=replay_ms(mk.apply_slice_plain, acalls, reps, False),
                 fetch=replay_ms(cal.caller_fetch_slice_plain, fcalls, reps,
                                   False))
    launches = dict(apply=len(acalls), fetch=len(fcalls), fold=n, scan=n)
    fetch_args = (p, pp, blocks, bds)
    fetch_parts = dict(
        change=split_b4_call(lambda: ev._fetch(*fetch_args),
                             "caller_fetch_slice", reps, "select",
                             "scatter"),
        parent=split_b4_call(lambda: parent_fetch(ev, *fetch_args),
                             "caller_fetch_slice", reps, "select",
                             "scatter"))
    nbytes = dict(apply=n * (B * (8 + 4 * S + 4) + fb.nbytes)
                  + 8 * (4 * int(adm.sum()) + 3 * n_mm),
                  fold=n * 92 * Pl, scan=n * 28 * Pl,
                  fetch=8 * (p.size + pp.size + blocks.size) + 120 * p.size
                  + 16 * pp.size + 12 * blocks.size)
    res = {k: dict(ms_a_shard=ms[k] / n, bytes_a_shard=nbytes[k] / n,
                   bound_ms_a_shard=1e3 * nbytes[k] / n / H100_BYTES_S,
                   bound_ms=1e3 * nbytes[k] / H100_BYTES_S,
                   bound_by="bytes", call_ms=ms[k], max_abs_err=errs[k],
                   launches_a_call=launches[k]) for k in ms}
    for k in ("fold", "scan"):
        res[k].update(plain_ms_a_shard=plain_ms[k] / n,
                      plain_call_ms=plain_ms[k])
    for k in dev:
        res[k].update(device_ms=dev[k],
                      device_ms_a_launch=dev[k] / launches[k],
                      plain_ms=plain[k],
                      plain_ms_a_launch=plain[k] / launches[k])
    res["fetch"].update(call_parts=fetch_parts,
                        positions=int(p.size), points=int(pp.size),
                        blocks=int(blocks.size))
    if host:
        deltas, ends = dp.host_delta_lists(host_copy(), ev.L)
        times = dict(scans=[], upload_launches=[], parent_part=[], call=[])
        for _ in range(reps):
            h = host_copy()
            t0 = time.perf_counter()
            lists = dp.host_delta_lists(h, ev.L)
            times["scans"].append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev._merge_lists(*lists)
            torch.cuda.synchronize()
            times["upload_launches"].append(1e3 * (time.perf_counter()
                                                   - t0))
            t0 = time.perf_counter()
            parent_merge(ev, *lists)
            times["parent_part"].append(1e3 * (time.perf_counter() - t0))
            ev.host_profile = host_copy()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev._merge_host_deltas()
            torch.cuda.synchronize()
            times["call"].append(1e3 * (time.perf_counter() - t0))
        ev.host_profile = live
        # the library call: the index_add_ of the parent's merge on this
        # run's own lists, their owned entries' indices and values
        # uploaded before the timing
        od = owned_deltas(ev, deltas, ends)
        parts = [(getattr(sp, name).view(-1), upload(li, d), upload(v, d))
                 for sp, d, name, li, v in od]
        owned = [sum(int(li.size) for sp2, _, _, li, _ in od if sp2 is sp)
                 for sp in ev.planes]
        if sum(owned) != ends[-1]:
            raise AssertionError(f"big: the merge's entries are not each "
                                 f"owned by one shard {owned}")

        def index_add():
            for t, i, v in parts:
                t.index_add_(0, i, v)
        library = cuda_ms(index_add, reps, queued=True)
        set_planes(ev, base)
        med = {k: statistics.median(v) for k, v in times.items()}
        N = ends[-1]
        # what the merge must move: each entry's index (8 B) and value (4)
        # read once and its plane word read and written (8), by the shard
        # that owns it; at the card's granularity, each distinct 32-byte
        # sector of those words read and written
        nb = 20 * N
        sb = 12 * N + sector_bytes([li for _, _, _, li, _ in od])
        res["merge"] = dict(
            call_ms=med["call"], ms_a_shard=med["call"] / n,
            host_scans_ms=med["scans"],
            upload_launches_ms=med["upload_launches"],
            parent_masks_uploads_index_add_ms=med["parent_part"],
            device_ms=replay_ms(mk._merge_launch, lcalls, reps),
            plain_ms=replay_ms(mk.host_merge_plain, mcalls, reps, False),
            library_ms=library, library="the index_add_ of the parent's "
            "merge on the run's own lists, one a shard and plane that "
            "owns entries, indices and values on the card",
            launches_a_call=len(lcalls), entries=N, entries_a_shard=owned,
            bound_ms=1e3 * nb / H100_BYTES_S, bound_by="bytes", bytes=nb,
            sector_bytes=sb, sector_bound_ms=1e3 * sb / H100_BYTES_S,
            bound_ms_by_shard=[1e3 * 20 * k / H100_BYTES_S for k in owned],
            max_abs_err=errs["merge"],
            host_bytes_scanned=sum(v.nbytes for v in host.values()))
        for k in ("device_ms", "plain_ms", "library_ms"):
            res["merge"][k.replace("ms", "ms_a_launch")] = (
                res["merge"][k] / len(lcalls))
        res["merge"]["bound_ms_a_shard"] = res["merge"]["bound_ms"] / n
    return res | dict(shards=n, Pl=Pl, batch=B, admitted=int(adm.sum()),
                      mismatches=n_mm)


def split_b4_call(call, launch, reps, first="sort", last="combine"):
    """One of B4's calls (a BigDeviceEvidence method: call()) cut into
    its host parts by timers around the functions it calls: `first`, the
    work before the first upload; the uploads (big_profile.upload); the
    launches (calling_kernels.<launch>: the wrapper's checks and the
    launch); the download (the copies and the wait for the card); `last`,
    the work after it; and the rest; ms, medians over reps calls,
    measured only."""
    import torch
    from mapcaller_tpu_torch.ops import calling_kernels as cal
    from mapcaller_tpu_torch.pipeline import big_profile as bp
    marks = []

    def timed(fn, part):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                marks.append((part, t0, time.perf_counter()))
        return run
    real = bp.upload, bp.download, getattr(cal, launch)
    bp.upload, bp.download = timed(real[0], "upload"), timed(real[1],
                                                             "download")
    setattr(cal, launch, timed(real[2], "launches"))
    parts = collections.defaultdict(list)
    try:
        for _ in range(reps + 3):
            marks.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            t1 = time.perf_counter()
            ms = collections.Counter()
            for part, a, b in marks:
                ms[part] += 1e3 * (b - a)
            ms[first] = 1e3 * (min(a for p, a, _ in marks if p == "upload")
                               - t0)
            ms[last] = 1e3 * (t1 - max(b for p, _, b in marks
                                       if p == "download"))
            ms["call"] = 1e3 * (t1 - t0)
            ms["rest"] = ms["call"] - sum(ms[k] for k in (
                first, "upload", "launches", "download", last))
            for k, v in ms.items():
                parts[k].append(v)
    finally:
        bp.upload, bp.download = real[:2]
        setattr(cal, launch, real[2])
    return {k + "_ms": statistics.median(v[3:]) for k, v in parts.items()}


def fetch_by_shard(Pl, n, p, pp, blocks, answer):
    """B4's fetch as the parent tree (02300f2) ran it: three np.nonzero a
    shard choose the elements it owns (p // Pl, pp // Pl, blocks //
    (Pl / 100)), answer([(s, P_s, Q_s, local idx int64)]) gives each
    shard's output (numpy, laid out as caller_fetch's) from its elements
    at local coordinates, and each output is scattered back by fancy
    indexing -> (cols, pref, depths). Shared by parent_fetch and
    merge_fetch_variants.py."""
    import numpy as np
    nbl = Pl // 100
    sels, jobs = [], []
    for s in range(n):
        sel = [np.nonzero(x // g == s)[0] for x, g in ((p, Pl), (pp, Pl),
                                                        (blocks, nbl))]
        if any(x.size for x in sel):
            sels.append(sel)
            jobs.append((s, sel[0].size, sel[1].size, np.concatenate(
                [p[sel[0]] - s * Pl, pp[sel[1]] - s * Pl,
                 blocks[sel[2]] - s * nbl]).astype(np.int64)))
    cols = np.zeros((p.size, 10), dtype=np.int64)
    pref = np.zeros(pp.size, dtype=np.int64)
    depths = np.zeros(blocks.size, dtype=np.int64)
    for (sel, selp, selb), (_, P, Q, _), o in zip(sels, jobs, answer(jobs)):
        cols[sel] = o[:10 * P].reshape(P, 10)
        pref[selp] = o[10 * P:10 * P + Q]
        depths[selb] = o[10 * P + Q:]
    return cols, pref, depths


def parent_fetch(ev, p, pp, blocks, bds):
    """B4's fetch as the parent tree ran it (fetch_by_shard): the shards'
    local indices up in one copy a device, one launch a shard that owns
    any element (here the slice form over that shard alone), one
    download -> (cols, pref, depths)."""
    import numpy as np
    from mapcaller_tpu_torch.ops import calling_kernels as cal
    from mapcaller_tpu_torch.pipeline import big_profile as bp
    outs, tots = ev.finalize()
    before = np.concatenate([[0], np.cumsum(tots)])

    def answer(jobs):
        ups, at, got = {}, {}, []
        for d in dict.fromkeys(ev.devs[j[0]] for j in jobs):
            ups[d] = bp.upload(np.concatenate(
                [j[3] for j in jobs if ev.devs[j[0]] == d]), d)
        for s, P, Q, idx in jobs:
            d = ev.devs[s]
            lo = at.get(d, 0)
            at[d] = lo + idx.size
            got.append(cal.caller_fetch_slice(
                [outs[s]], [0], [int(before[s])], ups[d][lo:lo + idx.size],
                P, Q, ev.Pl, [bds[s]] if idx.size > P + Q else None))
        return bp.download(got)
    return fetch_by_shard(ev.Pl, ev.n, p, pp, blocks, answer)


def time_big_nor(bev, em, brk, reps):
    """B4's NOR blocks on a -gvcf run's own call (its emitted positions
    and breaks): held against their plain versions on the card in every
    word (the kernel entry swapped), the call timed and split into its
    host parts (split_b4_call), its launches replayed (device ms, plain
    ms) beside the bound: the coverage, the positions and breaks read
    once, three words a segment written, a shard's share of it. -> (the
    row, the first launch's arguments)."""
    from mapcaller_tpu_torch.ops import calling_kernels as cal
    calls = []
    with entry_calls(cal, "_nor_slice_kernel", calls):
        got = bev.nor_blocks(em, brk)
    with plain_entries((cal, "_nor_slice_kernel",
                        cal.nor_blocks_slice_plain)):
        want = bev.nor_blocks(em, brk)
    err = max(int(abs(g - w).max()) for g, w in zip(got, want))
    if err:
        raise AssertionError("big -gvcf: B4's NOR kernels != their plain "
                             "versions")
    nseg = brk.size + 2
    nbytes = 4 * bev.L + 8 * (em.size + brk.size) + 12 * nseg
    dev = replay_ms(cal._nor_slice_kernel, calls, reps)
    plain = replay_ms(cal.nor_blocks_slice_plain, calls, reps, False)
    return dict(call_ms=cuda_ms(lambda: bev.nor_blocks(em, brk), reps),
                call_parts=split_b4_call(lambda: bev.nor_blocks(em, brk),
                                         "nor_blocks_slice", reps),
                device_ms=dev, device_ms_a_launch=dev / len(calls),
                plain_ms=plain, plain_ms_a_launch=plain / len(calls),
                launches_a_call=len(calls), shards=bev.n,
                emitted=int(em.size), breaks=int(brk.size), max_abs_err=err,
                bound_ms=1e3 * nbytes / H100_BYTES_S,
                bound_ms_a_shard=1e3 * nbytes / H100_BYTES_S / bev.n,
                bound_by="bytes"), calls[0]


def run_big(run, card, sam, vcf, reps=20):
    """The big phase: the main path with big_x64 and -shards 2 and 4 on
    [cuda:0] * n through the stream, each writing the warm-up's bytes with
    the three 64-bit kernels once a shard a batch and no 32-bit chain or
    scan kernel, every one of their launches equal in every word to its
    plain version; the memory each shard holds and that no single-card
    table or genome-length plane exists; then shard 0 of batch 0 timed
    (time_big) and the shifted-coordinates check (run_shifted); and one
    -gvcf run with big_x64 and -shards 2 against a single-card -gvcf run,
    in bytes (the sharded NOR blocks and their seams); between them the
    single-card routes under -shards 2 (run_big_single). -> (the timings,
    the -shards 2 run's launches by kernel, the single-card routes)."""
    import numpy as np
    import torch
    from mapcaller_tpu_torch.ops import calling_kernels as cal
    from mapcaller_tpu_torch.ops import chain_kernels as ck
    from mapcaller_tpu_torch.ops import seed_scan_device as ssd
    from mapcaller_tpu_torch.parallel import big_index
    from mapcaller_tpu_torch.pipeline import device_profile
    from mapcaller_tpu_torch.pipeline.big_profile import BigDeviceEvidence
    from mapcaller_tpu_torch.pipeline.device_backend import DeviceBackend
    cuda0 = torch.device("cuda", 0)
    K = big_index.BigShardChainKernel
    scan_packed, hits_of = K._scan_packed, K._hits
    cp_big = big_index.chain_classify_pack_big
    make_ev = device_profile.make_device_evidence
    launches, held = [], {}

    def tap_scan(self, packed, rlens):
        seeds = scan_packed(self, packed, rlens)
        launches.append(dict(kern=self, packed=packed.clone(),
                             rlens=rlens.clone(),
                             seeds=tuple(t.clone() for t in seeds)))
        return seeds

    def tap_hits(self, *seeds):
        off, hits = hits_of(self, *seeds)
        launches[-1].update(off=off.clone(),
                            hits=ck.Hits(*(t.clone() for t in hits)))
        return off, hits

    def tap_cp(*a):
        mmp = cp_big(*a)
        launches[-1].update(out=a[7].clone(), wide=a[8].clone(),
                            mmp=mmp.clone())
        return mmp

    def tap_ev(*a):
        held["ev"] = make_ev(*a)
        keep_big_inputs(held["ev"], held.setdefault("kept", {}))
        return held["ev"]

    def backend(n):
        def make(idx, cfg):
            held["be"] = DeviceBackend(idx, cfg, shard_devices=[cuda0] * n)
            return held["be"]
        return make

    runs, first, memory, ev_times = {}, {}, {}, {}
    for n in (2, 4):
        launches = []
        K._scan_packed, K._hits = tap_scan, tap_hits
        big_index.chain_classify_pack_big = tap_cp
        device_profile.make_device_evidence = tap_ev
        try:
            t = run(index_shards=n, big_x64=True, backend=backend(n))
        finally:
            K._scan_packed, K._hits = scan_packed, hits_of
            big_index.chain_classify_pack_big = cp_big
            device_profile.make_device_evidence = make_ev
        t.update(sam_identical=same_bytes(sam, sam + ".warm"),
                 vcf_identical=same_bytes(vcf, vcf + ".warm"))
        b = t["stages"]["batches"]
        errs = {}
        for x in launches:
            for name, e in big_launch_equal(ck, ssd, n, x).items():
                errs[name] = max(errs.get(name, 0), e)
        ev = held.pop("ev")
        memory[n] = big_memory(held.pop("be"), ev,
                               [x["kern"].fm for x in first.values()])
        kept = held.pop("kept")
        merged = "host" in kept           # the run had slow-read evidence
        ev_times[n] = time_big_evidence(ev, kept)
        del kept
        del ev
        emit("big", card=card, shards=n, backend=t["backend"], batches=b,
             scan_launches=t["scan_launches"],
             chain_launches=t["chain_launches"], peak_mem_bytes=t["peak"],
             reads_per_s=t["metrics"]["reads_per_sec"],
             mapping_s=t["metrics"]["mapping_seconds"], stages=t["stages"],
             sam_identical=t["sam_identical"],
             vcf_identical=t["vcf_identical"], evidence=t["evidence"],
             calling_launches=t["calling"], evidence_launches=t["mesh"],
             launches_held_to_plain=len(launches),
             reads_a_launch=sorted({int(x["rlens"].shape[0])
                                    for x in launches}),
             max_abs_err=errs, memory=memory[n],
             evidence_programs=ev_times[n])
        if not (t["sam_identical"] and t["vcf_identical"]
                and t["backend"]["sharded_invocations"] == b > 0
                and t["scan_launches"] == {"seed_scan3_big": n * b}
                and t["chain_launches"] == dict(
                    chain_scan_seeds=n * b, chain_hits_big=n * b,
                    chain_classify_pack_big=n * b)
                and len(launches) == n * b
                and all(len(x) == 9 for x in launches)
                and evidence_path_ok(t["evidence"])
                and calling_ok(t, n)
                # B4's apply a launch a shard a batch, its merge one
                # launch (one card) with slow-read evidence, no K2 launch
                and t["mesh"].get("evidence_apply_slice") == n * b
                and t["mesh"].get("host_merge", 0) == (1 if merged else 0)
                and ev_times[n]["fetch"]["launches_a_call"] == 1
                and ev_times[n].get("merge", {}).get(
                    "launches_a_call", 1) == 1
                and not t["mesh"].get("evidence_apply_bits")
                and t["metrics"]["n_oracle_reads"] == 0
                and t["metrics"]["n_tier_reruns"] == 0):
            raise AssertionError(f"big {n}: bytes differ from the warm-up's, "
                                 f"a batch missed the x64 stage, a 32-bit "
                                 f"kernel ran, a 64-bit one did not run "
                                 f"once a shard a batch, B4's apply not "
                                 f"once a shard, its merge or fetch not "
                                 f"one launch a call, or "
                                 f"evidence left the sharded planes "
                                 f"{t['mesh']} {t['calling']}")
        runs[n] = t
        first[n] = launches[0]
        del launches
    timing = time_big(ck, ssd, first[2], card, reps)
    # the scan also on -shards 4's half as many reads, and each scan's
    # launches x gap a run
    timing["seed_scan3_big"]["shards_4"] = time_big_scan(ssd, first[4], 4,
                                                         reps)[0]
    for n, r in ((2, timing["seed_scan3_big"]),
                 (4, timing["seed_scan3_big"]["shards_4"])):
        launch_gap(r, runs[n]["scan_launches"]["seed_scan3_big"])
    shifted = run_shifted(ck, ssd, first[2])
    emit("big", card=card, x64_kernels_shard0_batch0=timing,
         scan_gap_ms_a_run={2: timing["seed_scan3_big"]["gap_ms_a_run"],
                            4: timing["seed_scan3_big"]["shards_4"][
                                "gap_ms_a_run"]},
         shifted_coordinates=shifted)
    del first
    single = run_big_single(run, card, backend, sam, vcf)
    # -gvcf: the sharded NOR blocks against one card's
    gv = {}
    nor_blocks = cal.nor_blocks

    def tap_nor(*args):
        # the kernel's own arguments, as DeviceEvidence.nor_blocks makes them
        held["nor"] = args
        return nor_blocks(*args)

    big_nor = BigDeviceEvidence.nor_blocks

    def tap_big_nor(self, emitted, brk):
        held["big_nor"] = (self, np.asarray(emitted).copy(),
                           np.asarray(brk).copy())
        return big_nor(self, emitted, brk)

    for tag, kw in (("one", {}), ("big", dict(index_shards=2, big_x64=True,
                                               backend=backend(2)))):
        cal.nor_blocks = tap_nor
        BigDeviceEvidence.nor_blocks = tap_big_nor
        try:
            t = run(gvcf=True, **kw)
        finally:
            cal.nor_blocks = nor_blocks
            BigDeviceEvidence.nor_blocks = big_nor
        if tag == "big":
            # B4's NOR blocks (a slice-form launch a shard) on their own
            # call, with the run's launches
            bev, em, brk = held.pop("big_nor")
            nor_big, slice_call = time_big_nor(bev, em, brk, reps)
            nor_big["launches"] = t["calling"].get("nor_blocks_slice", 0)
            nor_big["fetch_launches"] = t["calling"].get(
                "caller_fetch_slice", 0)
            if not (nor_big["launches"] >= 1
                    and nor_big["fetch_launches"] >= 1
                    and not t["calling"].get("nor_blocks")):
                raise AssertionError("big -gvcf: B4's NOR or fetch slice "
                                     "kernels did not run")
        if tag == "one":
            # A6's NOR blocks on the single-card run's finalized planes
            if t["calling"].get("nor_blocks") != 1:
                raise AssertionError("-gvcf: the NOR block kernel did not "
                                     "run once")
            nor_args = held.pop("nor")
            nor = time_nor(nor_args, t["calling"]["nor_blocks"])
        held.clear()
        with open(sam, "rb") as f, open(vcf, "rb") as g:
            gv[tag] = (f.read(), g.read(), t)
    # a NOR call of each form, B4's merge and fetch calls (on the -gvcf
    # -shards 2 run's evidence) and the single-card fetch are one kernel
    # each, no memset; the merge's and the fetch's copies beside them
    a, kw = slice_call
    traced = merge_fetch_calls(bev, em, brk)
    ops = device_operations([lambda: cal.nor_blocks(*nor_args),
                             lambda: cal._nor_slice_kernel(*a, **kw)]
                            + list(traced.values()))
    kernels = {k: sum(k + "_kernel" in o for o in ops) for k in (
        "nor_blocks", "nor_blocks_slice", "host_merge", "caller_fetch_slice",
        "caller_fetch")}
    copies = [o for o in ops if "memcpy" in o.lower()]
    others = [o for o in ops if "_kernel" not in o and o not in copies]
    if set(kernels.values()) != {1} or others or len(ops) - len(
            copies) != len(kernels):
        raise AssertionError(f"-gvcf: a NOR call, a NOR slice launch, B4's "
                             f"merge and fetch calls and a single-card "
                             f"fetch queued {ops}, not one kernel each")
    nor["device_operations_a_call"] = kernels["nor_blocks"]
    nor_big["device_operations_a_launch"] = kernels["nor_blocks_slice"]
    nor["device_operations_traced"] = nor_big[
        "device_operations_traced"] = ops
    one_op = dict(kernels_a_call=kernels, copies=copies,
                  calls=list(traced), traced=ops)
    del a, kw, slice_call, nor_args, bev, traced
    same = gv["one"][:2] == gv["big"][:2]
    tb = gv["big"][2]
    emit("big", card=card, gvcf_nor_blocks_one_card=nor, gvcf_shards=2,
         gvcf_nor_blocks_sharded=nor_big,
         gvcf_identical_to_one_card=same,
         gvcf_records=sum(not ln.startswith(b"#")
                          for ln in gv["big"][1].splitlines()),
         chain_launches=tb["chain_launches"], evidence=tb["evidence"],
         peak_mem_bytes=tb["peak"])
    if not (same and evidence_path_ok(tb["evidence"])
            and set(tb["chain_launches"]) == {
                "chain_scan_seeds", "chain_hits_big",
                "chain_classify_pack_big"}):
        raise AssertionError("big -gvcf: bytes differ from one card's or "
                             "the run left the x64 path")
    b4 = {n: dict(ev_times[n], launches=runs[n]["calling"],
                  evidence_launches=runs[n]["mesh"]) for n in ev_times}
    b4["nor_shards_2"] = nor_big
    b4["one_kernel_a_call"] = one_op
    return timing, runs[2], single, nor, b4


def equal_scan_hits(what, ck, ssd, kern, packed, rlens):
    """A host-chaining dispatch (SeedKernelPacked `kern`) replayed: its
    seed scan, seed-freq scan and hits kernel against their plain versions
    on the same inputs, every element equal. -> max abs err (0)."""
    kind = "seed_scan3" if kern.use_occ3 else "seed_scan1"
    err = equal_scan(what, *scan_fns(ssd, kind, kern.fm, packed, rlens,
                                     kern.max_len, kern.max_seeds,
                                     lanes=kern.compact_lanes))
    seeds = kern._scan_packed(packed, rlens)
    scan = ck.chain_scan_seeds(seeds[4], seeds[0], kern.H)
    hits = ck.chain_hits(kern.fm1, scan, *seeds[:5], kern.H)
    want_scan = ck.chain_scan_seeds_plain(seeds[4], seeds[0], kern.H)
    want_hits = ck.chain_hits_plain(kern.fm1, scan.off, *seeds[:5], kern.H)
    pairs = [("off", scan.off, want_scan.off),
             ("start", scan.start, want_scan.start)]
    pairs += [(f"hits.{k}", getattr(hits, k), getattr(want_hits, k))
              for k in hits._fields]
    return max(err, max_err(what, pairs))


def run_big_single(run, card, make_backend, sam, vcf):
    """The x64 big-genome path's single-card routes (the reference's rule:
    mapcaller_tpu/pipeline/device_backend.py:72-75) through the stream
    under big_x64 -shards 2 on [cuda:0] * 2: the main data's index with
    its full SA dropped (device chaining: the 1-step scan, the hits
    kernel's inverse-Psi walk and classify+pack, the evidence applied to
    the genome-sharded planes) and host chaining (device_chain=False: the
    occ3 scan and the hits kernel's gather). Each writes the warm-up's
    bytes with its single-card kernels launched once a batch (counted
    from 0 around the run), no sharded dispatch and no 64-bit kernel;
    every dispatch is replayed against the plain versions, max_abs_err 0.
    -> {route: the run's facts}."""
    import dataclasses
    from mapcaller_tpu_torch import runner
    from mapcaller_tpu_torch.ops import chain_kernels as ck
    from mapcaller_tpu_torch.ops import fm_search
    from mapcaller_tpu_torch.ops import seed_scan_device as ssd
    chained, packed_call = (fm_search.SeedChainKernel.__call__,
                            fm_search.SeedKernelPacked.__call__)
    load_index = runner.load_index
    held = []

    def tap_chained(self, packed, rlens, planes=None, pair_end=False,
                    out=None):
        held.append((self, packed.clone(), rlens.clone(), pair_end))
        return chained(self, packed, rlens, planes=planes,
                       pair_end=pair_end, out=out)

    def tap_packed(self, packed, rlens):
        held.append((self, packed.clone(), rlens.clone(), None))
        return packed_call(self, packed, rlens)

    routes = {}
    for route, flags in (("no_full_sa", {}),
                         ("host_chaining", dict(device_chain=False))):
        held = []
        fm_search.SeedChainKernel.__call__ = tap_chained
        fm_search.SeedKernelPacked.__call__ = tap_packed
        if route == "no_full_sa":
            runner.load_index = lambda prefix: dataclasses.replace(
                load_index(prefix), sa_full=None)
        try:
            t = run(index_shards=2, big_x64=True, backend=make_backend(2),
                    **flags)
        finally:
            fm_search.SeedChainKernel.__call__ = chained
            fm_search.SeedKernelPacked.__call__ = packed_call
            runner.load_index = load_index
        b = t["stages"]["batches"]
        errs = []
        for i, (kern, p, r, pe) in enumerate(held):
            what = f"big single-card {route} batch {i}"
            if pe is None:
                errs.append(equal_scan_hits(what, ck, ssd, kern, p, r))
                continue
            errs.append(equal_scan(what, *scan_fns(
                ssd, "seed_scan1", kern.fm, p, r, kern.max_len,
                kern.max_seeds)))
            errs.append(equal_chain(what, ck, kern, p, r, None,
                                    pair_end=pe)[0])
        walks = all(not k.fm1.has_full_sa for k, *_ in held)
        n_held = len(held)
        del held
        scan = {"seed_scan1" if route == "no_full_sa" else "seed_scan3": b}
        chain = dict(chain_scan_seeds=b, chain_hits=b)
        if route == "no_full_sa":
            chain["chain_classify_pack"] = b
        fact = dict(batches=b, scan_launches=t["scan_launches"],
                    chain_launches=t["chain_launches"],
                    sharded_invocations=t["backend"]["sharded_invocations"],
                    hits_walk_inverse_psi=walks,
                    dispatches_held_to_plain=n_held,
                    max_abs_err=max(errs) if errs else None,
                    n_oracle_reads=t["metrics"]["n_oracle_reads"],
                    n_tier_reruns=t["metrics"]["n_tier_reruns"],
                    evidence=t["evidence"], transfers=t["transfers"],
                    reads_per_s=t["metrics"]["reads_per_sec"],
                    mapping_s=t["metrics"]["mapping_seconds"],
                    stages=t["stages"], peak_mem_bytes=t["peak"],
                    sam_identical=same_bytes(sam, sam + ".warm"),
                    vcf_identical=same_bytes(vcf, vcf + ".warm"))
        emit("big", card=card, shards=2, single_card_route=route, **fact)
        ev_ok = (evidence_path_ok(t["evidence"]) if route == "no_full_sa"
                 else t["evidence"]["applies"] == 0) and calling_ok(t, 2)
        if not (fact["sam_identical"] and fact["vcf_identical"]
                and fact["sharded_invocations"] == 0 and b > 0
                and t["scan_launches"] == scan
                and t["chain_launches"] == chain
                and fact["dispatches_held_to_plain"] == b
                and set(errs) == {0} and ev_ok
                and walks == (route == "no_full_sa")
                and t["metrics"]["n_tier_reruns"] == 0):
            raise AssertionError(f"big single-card {route}: bytes differ "
                                 f"from the warm-up's, a single-card kernel "
                                 f"did not run once a batch, a sharded or "
                                 f"64-bit one ran, a dispatch differs from "
                                 f"its plain version, or evidence took the "
                                 f"wrong path")
        routes[route] = fact
    return routes


def ptxas_report(out, kernel="nw_ops_kernel"):
    """Registers, shared memory, stack frame and spill bytes of each
    instantiation of `kernel` (keyed by its chunk) from the output of
    nvcc -Xptxas -v."""
    fields = (("registers", r"Used (\d+) registers"),
              ("smem_bytes", r"(\d+) bytes smem"),
              ("stack_frame_bytes", r"(\d+) bytes stack frame"),
              ("spill_store_bytes", r"(\d+) bytes spill stores"),
              ("spill_load_bytes", r"(\d+) bytes spill loads"))
    rep, cur = {}, None
    for ln in out.splitlines():
        fn = re.search(r"(?:entry function|properties for) '?(\w+)", ln)
        if fn:
            cur = None
            if kernel in fn.group(1):
                ch = re.search(r"ILi(\d+)E", fn.group(1))
                cur = f"chunk{ch.group(1)}" if ch else fn.group(1)
                rep.setdefault(cur, {})
            continue
        if cur is not None:
            for key, pat in fields:
                hit = re.search(pat, ln)
                if hit:
                    rep[cur][key] = int(hit.group(1))
    return rep


def same_bytes(a, b):
    with open(a, "rb") as f, open(b, "rb") as g:
        return f.read() == g.read()


def evidence_path_ok(st, applies=True, folded=False):
    """The run accumulated evidence on the device planes (stand-alone
    applies and/or applies folded into the chain dispatch), ran the
    caller scan once and never fell back to a plane download."""
    return ((st["applies"] > 0) == applies and (st["folded"] > 0) == folded
            and st["scans"] == 1 and st["downloads"] == 0
            and st["overflow_fallbacks"] == 0)


def run_small_e2e(work):
    """Port on cuda vs port on cpu, planted 20 kb set, DP batches sent to
    the DP kernel (device_extension=True; the plain version on the cpu):
    default flags, then the non-native path (use_native=False: per-read
    Python host leg, the 1-step seed kernel on byte codes)."""
    from mapcaller_tpu_torch import runner
    from mapcaller_tpu_torch.config import Config
    from mapcaller_tpu_torch.index.fmindex import build_index
    from mapcaller_tpu_torch.ops import nw_device
    from mapcaller_tpu_torch.pipeline import device_profile
    from mapcaller_tpu_torch.simulator import write_planted_dataset
    d = os.path.join(work, "small")
    os.makedirs(d)
    fa, f1, f2 = write_planted_dataset(d)
    build_index(fa, os.path.join(d, "idx"))
    outs = {}
    for native in (True, False):
        for dev in ("cuda", "cpu"):
            tag = f"{dev}_{'native' if native else 'python'}"
            launches = nw_device.STATS.launches
            device_profile.STATS.reset()
            cfg = Config(device=dev, index_prefix=os.path.join(d, "idx"),
                         read_files1=[f1], read_files2=[f2],
                         stream_batch_size=1024, use_native=native,
                         device_extension=True,
                         sam_file=os.path.join(d, f"{tag}.sam"),
                         vcf_file=os.path.join(d, f"{tag}.vcf"),
                         log_file=os.path.join(d, f"{tag}.log"))
            t0 = time.time()
            if runner.run_pipeline(cfg, "mapcaller small_e2e") != 0:
                raise RuntimeError(f"small_e2e run {tag} failed")
            outs[native, dev] = (cfg.sam_file, cfg.vcf_file,
                                 nw_device.STATS.launches - launches,
                                 vars(device_profile.STATS).copy(),
                                 time.time() - t0)
    sam_ok = same_bytes(outs[True, "cuda"][0], outs[True, "cpu"][0])
    vcf_ok = same_bytes(outs[True, "cuda"][1], outs[True, "cpu"][1])
    py_ok = (same_bytes(outs[False, "cuda"][0], outs[False, "cpu"][0])
             and same_bytes(outs[False, "cuda"][1], outs[False, "cpu"][1]))
    with open(outs[True, "cuda"][1]) as f:
        n_var = sum(1 for ln in f if not ln.startswith("#"))
    emit("small_e2e", sam_identical=sam_ok, vcf_identical=vcf_ok,
         variants=n_var, nw_launches_cuda=outs[True, "cuda"][2],
         nw_launches_cpu=outs[True, "cpu"][2],
         evidence_cuda=outs[True, "cuda"][3],
         evidence_cpu=outs[True, "cpu"][3],
         non_native_identical=py_ok,
         non_native_seconds={dev: outs[False, dev][4]
                             for dev in ("cuda", "cpu")})
    if not (sam_ok and vcf_ok and py_ok and n_var > 0
            and outs[True, "cuda"][2] > 0 and outs[True, "cpu"][2] == 0
            and evidence_path_ok(outs[True, "cuda"][3])
            and evidence_path_ok(outs[True, "cpu"][3])):
        raise AssertionError("small_e2e: cuda and cpu outputs differ, no "
                             "variants, the NW kernel did not run, or "
                             "evidence left the device planes")


def host_ms(fn, reps):
    """Median host wall time of fn() over `reps` runs, after one warm-up
    run; fn must end with the device's result on the host."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def run_dp_rates(pair_sets, card, reps=20):
    """Device DP call against the scalar C++ aligner on the main path's own
    largest DP batch of each algorithm: the call end to end (encode,
    upload, kernel, download) on 1 pair and on all n gives its fixed cost
    and its cost per further pair; the scalar aligner's cost per pair is a
    ctypes loop over the n pairs less the same loop over n 1x1 pairs (the
    loop's own overhead). A batch pays on the card from fixed / (scalar -
    device per pair) pairs."""
    from mapcaller_tpu_torch import native
    from mapcaller_tpu_torch.ops import ksw2_device, nw_device
    out = {}
    for alg, align, scalar in (
            ("nw", nw_device.nw_align_batch, native.nw_align_native),
            ("ksw2", ksw2_device.ksw2_align_batch, native.ksw2_align_native)):
        pairs, M = pair_sets[alg]
        n = len(pairs)

        def device_call(k):
            return lambda: align(pairs[:k], M=M, N=M, return_ops=True,
                                 device="cuda")

        one_ms = host_ms(device_call(1), reps)
        all_ms = host_ms(device_call(n), reps)
        loop_ms = host_ms(lambda: [scalar(a, b) for a, b in pairs], 5)
        base_ms = host_ms(lambda: [scalar("A", "A") for _ in pairs], 5)
        device_us = 1e3 * (all_ms - one_ms) / (n - 1)
        scalar_us = 1e3 * (loop_ms - base_ms) / n
        fixed_ms = one_ms - device_us / 1e3
        margin = scalar_us - device_us
        out[alg] = dict(
            pairs=n, tier=M, mean_cells=statistics.mean(
                (len(a) + 1) * (len(b) + 1) for a, b in pairs),
            device_call_ms_1=one_ms, device_call_ms_all=all_ms,
            device_fixed_ms=fixed_ms, device_per_pair_us=device_us,
            scalar_loop_ms=loop_ms, scalar_loop_1x1_ms=base_ms,
            scalar_per_pair_us=scalar_us,
            min_pairs=1e3 * fixed_ms / margin if margin > 0 else None)
    emit("dp_rates", card=card, **out)


def last_metrics(log):
    with open(log) as f:
        return json.loads([ln for ln in f if ln.startswith("{")][-1])


class K2MainTap:
    """A tap on K2's wrapper as the main path calls it: the attribute
    mesh_kernels.apply_bits, which pipeline/device_profile calls (the
    mesh binds its own name, so its calls do not pass here). Each call is
    counted by source and sign; while `hold` is set, each call on the card
    is also held against its plain version on copies of the planes taken
    just before it, on the same stream (the largest difference is kept on
    the card and read once a run). The plain version's calls on the card
    outside a hold are counted as `eager`: the eager scatter the main path
    no longer runs."""

    def __init__(self):
        self.hold = False
        self.reset()

    def reset(self):
        self.calls, self.held, self.eager, self.err = (
            collections.Counter(), 0, 0, None)

    def install(self):
        import torch
        from mapcaller_tpu_torch.ops import mesh_kernels as mk
        self.mk, self.real, self.plain = mk, mk.apply_bits, mk.apply_bits_plain

        def apply(planes, pd, mmp, rlens, sel, pair_end, sign=1,
                  source="bits"):
            self.calls[f"{source}{sign:+d}"] += 1
            if not (self.hold and pd.is_cuda):
                return self.real(planes, pd, mmp, rlens, sel, pair_end,
                                 sign, source)
            want = mk.Planes(*(getattr(planes, f).clone()
                               for f in mk.Planes._fields))
            out = self.real(planes, pd, mmp, rlens, sel, pair_end, sign,
                            source)
            self.plain(want, pd, mmp, rlens, sel, pair_end, sign, source)
            for f, w in zip(mk.Planes._fields, want):
                e = (getattr(out, f).long() - w.long()).abs().max()
                self.err = e if self.err is None else torch.maximum(
                    self.err, e)
            self.held += 1
            return out

        def plain(planes, pd, *a, **kw):
            self.eager += int(pd.is_cuda)
            return self.plain(planes, pd, *a, **kw)

        mk.apply_bits, mk.apply_bits_plain = apply, plain
        return self

    def uninstall(self):
        self.mk.apply_bits, self.mk.apply_bits_plain = self.real, self.plain

    def result(self, launches):
        """This run's K2 launches and calls, the eager scatter's calls on
        the card, and the held calls with their largest difference."""
        return dict(launches=launches.get("evidence_apply_bits", 0),
                    k1_launches=launches.get("dp_scatter_scan", 0),
                    calls=dict(self.calls), eager_scatter_calls=self.eager,
                    held=self.held,
                    max_abs_err=(int(self.err) if self.err is not None
                                 else 0))


class CallingEagerTap:
    """Counts the calls of the calling kernels' plain versions
    (ops/calling_kernels: the finalize, scan, fetch and NOR bodies and the
    fetch's and NOR's slice forms) and of B4's apply and the host merge
    (ops/mesh_kernels) on card tensors (on_card: their shards and planes
    too) while installed: the eager programs the port no longer runs."""

    NAMES = ("evidence_finalize_plain", "caller_scan_plain",
             "caller_fetch_plain", "nor_blocks_plain",
             "caller_fetch_slice_plain", "nor_blocks_slice_plain")
    MESH_NAMES = ("apply_slice_plain", "host_merge_plain")

    def reset(self):
        self.eager = 0

    def install(self):
        import torch
        from mapcaller_tpu_torch.ops import calling_kernels as cal
        from mapcaller_tpu_torch.ops import mesh_kernels as mk
        self.real = {(m, n): getattr(m, n) for m, names in (
            (cal, self.NAMES), (mk, self.MESH_NAMES)) for n in names}
        self.reset()
        for (mod, name), fn in self.real.items():
            def tapped(*a, _fn=fn, **kw):
                self.eager += int(on_card(a))
                return _fn(*a, **kw)
            setattr(mod, name, tapped)
        return self

    def uninstall(self):
        for (mod, name), fn in self.real.items():
            setattr(mod, name, fn)


def on_card(x) -> bool:
    """Whether x holds a card tensor: a tensor, a sequence of them
    (shards), or planes (their acgt)."""
    import torch
    if torch.is_tensor(x):
        return x.is_cuda
    if isinstance(x, (list, tuple)):
        return any(on_card(y) for y in x)
    return torch.is_tensor(getattr(x, "acgt", None)) and x.acgt.is_cuda


def calling_ok(t, shards=1):
    """A run's calling kernels: with evidence on the card planes (one
    caller scan), the finalize and the scan once a shard, the column fetch
    on one card, its slice form on the genome-sharded planes (shards > 1:
    B4), no NOR block kernel of either form without -gvcf; with host
    evidence none; and no plain version on the card."""
    c = t["calling"]
    if t["calling_eager"]:
        return False
    if t["evidence"]["scans"] != 1:
        return not c
    return (c.get("evidence_finalize") == shards
            and c.get("caller_scan") == shards
            and (c.get("caller_fetch", 0) >= 1) == (shards == 1)
            and (c.get("caller_fetch_slice", 0) >= 1) == (shards > 1)
            and not c.get("nor_blocks") and not c.get("nor_blocks_slice"))


def run_main_path(work, card):
    """One warm-up run through the CLI (device DP), with a tap around
    nw_device.nw_ops that keeps the tensors of its largest NW launch and
    a tap on the evidence that copies its planes and the inputs of its
    first batch apply and its first column fetch to the host, then
    device-DP and scalar-DP runs in turns, then a host-evidence run, a
    folded-evidence run, a compacted, a host-chaining and a 1-step run,
    the -devices 2 and -shards 2 / 4 runs (run_scale_axes) and the routed
    kernels on batch 0 (run_routed),
    then the -alg ksw2 warm-up (tapping ksw2_device.ksw2_ops the same way)
    and its device-DP and scalar-DP turns. Returns the first device
    turns' launch counts (nw, ksw2), the captured launches' tensors (nw,
    ksw2) and the captured evidence."""
    import torch
    from mapcaller_tpu_torch import cli, runner, stage_prof
    from mapcaller_tpu_torch.ops import calling_kernels as cal
    from mapcaller_tpu_torch.ops import chain_kernels as ck
    from mapcaller_tpu_torch.ops import fm_search, ksw2_device, nw_device
    from mapcaller_tpu_torch.ops import mesh_kernels as mk
    from mapcaller_tpu_torch.ops import seed_scan_device as ssd
    from mapcaller_tpu_torch.pipeline import device_profile, stream
    from mapcaller_tpu_torch.pipeline.device_backend import DeviceBackend
    from mapcaller_tpu_torch.simulator import write_ecoli_set
    d = os.path.join(work, "main")
    os.makedirs(d)
    t0 = time.time()
    fa, r1, r2 = write_ecoli_set(d)
    captured = {"main_files": (fa, r1, r2)}
    idx = os.path.join(d, "mci")
    if cli.main(["mapcaller", "index", fa, idx]) != 0:
        raise RuntimeError("index build failed")
    setup_s = time.time() - t0
    sam, vcf, log = (os.path.join(d, x) for x in ("out.sam", "out.vcf",
                                                  "job.log"))
    argv = ["mapcaller", "-i", idx, "-f", r1, "-f2", r2, "-sam", sam,
            "-vcf", vcf, "-log", log]

    def run(device_dp=True, one_step=False, auto_dp=False, backend=None,
            group=None, **flags):
        """One run of the user's command: with auto_dp through the CLI
        as it is (device_extension "auto"), else the same command with the
        DP forced to the device kernels (device_dp) or to the scalar C++
        aligners, and other flags; one_step: the backend is told the occ3
        table does not fit; backend(idx, cfg): the device backend the
        runner builds (the devices and shards runs: replicas or shards on
        this one card), whose facts backend_facts(be) records; group: the
        stream's transfer group for this run (stream.TRANSFER_GROUP)."""
        gc.collect()      # an earlier run's cycles must not hold memory
        torch.cuda.reset_peak_memory_stats()
        nw_device.STATS.reset()
        ksw2_device.STATS.reset()
        ssd.STATS.reset()
        ck.STATS.reset()
        mk.STATS.reset()
        cal.STATS.reset()
        k2_main.reset()
        calling_tap.reset()
        device_profile.STATS.reset()
        cfg = None
        occ3_fits = DeviceBackend._occ3_fits
        if one_step:
            DeviceBackend._occ3_fits = lambda self, idx: False
        transfer_group = stream.TRANSFER_GROUP
        if group is not None:
            stream.TRANSFER_GROUP = group
        facts = {}
        make_engine = runner.make_engine

        def make(idx_, cfg_):
            if backend is None:
                eng = make_engine(idx_, cfg_)
            else:
                eng = runner.MappingEngine(idx_, cfg_,
                                           backend=backend(idx_, cfg_))
            facts["of"] = eng.backend
            return eng
        runner.make_engine = make
        err = io.StringIO()       # the stream's stage-prof line
        try:
            with contextlib.redirect_stderr(err):
                if auto_dp and not flags:
                    rc = cli.main(argv)
                else:
                    cfg = cli.parse_args(argv)
                    cfg.device_extension = bool(device_dp)
                    for k, v in flags.items():
                        setattr(cfg, k, v)
                    rc = runner.run_pipeline(cfg, " ".join(argv))
        finally:
            DeviceBackend._occ3_fits = occ3_fits
            stream.TRANSFER_GROUP = transfer_group
            runner.make_engine = make_engine
            sys.stderr.write(err.getvalue())
        stages = [json.loads(ln.split("] ", 1)[1])
                  for ln in err.getvalue().splitlines()
                  if ln.startswith("[stage-prof] {")]
        if rc != 0:
            raise RuntimeError(f"main path run failed (device_dp={device_dp}"
                               f", one_step={one_step}, {flags})")
        st, ks = nw_device.STATS, ksw2_device.STATS
        be = facts.pop("of")
        # the seed+chain dispatch's own host-device copies this run, and
        # its transfer groups (the stream's grouped submit)
        transfers = dict(uploads=be.n_uploads, downloads=be.n_downloads,
                         groups=sum(be.groups) if hasattr(be, "groups")
                         else None)
        return dict(metrics=last_metrics(log), launches=st.launches,
                    pairs=st.pairs, shapes=dict(st.shapes),
                    ksw2_launches=ks.launches, ksw2_pairs=ks.pairs,
                    ksw2_shapes=dict(ks.shapes),
                    scan3_launches=ssd.STATS.launches["seed_scan3"],
                    scan_launches=dict(ssd.STATS.launches),
                    scan1_launches=ssd.STATS.launches["seed_scan1"],
                    chain_launches=dict(ck.STATS.launches),
                    host_prof=dict(stage_prof.host_leg_ns),
                    compact_factor=cfg.compact_factor if cfg else None,
                    stages=stages[-1] if stages else None,
                    evidence=vars(device_profile.STATS).copy(),
                    peak=torch.cuda.max_memory_allocated(),
                    transfers=transfers,
                    k2=k2_main.result(mk.STATS.launches),
                    mesh=dict(mk.STATS.launches),
                    calling=dict(cal.STATS.launches),
                    calling_eager=calling_tap.eager,
                    backend=(backend_facts(be) if backend is not None
                             else None))

    nw_ops = nw_device.nw_ops
    ksw2_ops = ksw2_device.ksw2_ops
    make_ev = device_profile.make_device_evidence

    def keep_largest(key, args):
        cells = args[0].shape[0] * args[0].shape[1] * args[1].shape[1]
        if cells > captured.get(key, (-1,))[0]:
            captured[key] = (cells, tuple(x.clone() for x in args))

    def tap(c1, c2, m, n):
        keep_largest("nw", (c1, c2, m, n))
        return nw_ops(c1, c2, m, n)

    def tap_ksw2(qbuf, tgt, qlen, tlen):
        keep_largest("ksw2", (qbuf, tgt, qlen, tlen))
        captured.setdefault("ksw2_all", []).append(
            tuple(x.clone() for x in (qbuf, tgt, qlen, tlen)))
        return ksw2_ops(qbuf, tgt, qlen, tlen)

    def tap_pairs(alg, align):
        """Keep the pairs (strings) and tier of the largest DP batch."""
        def tapped(pairs, M=192, N=192, **kw):
            if len(pairs) > len(captured.get("pairs_" + alg, ((),))[0]):
                captured["pairs_" + alg] = (list(pairs), M)
            return align(pairs, M=M, N=N, **kw)
        return tapped

    nw_align = nw_device.nw_align_batch
    ksw2_align = ksw2_device.ksw2_align_batch

    # taps on the scans the kernels call: in a run with a capture mode set,
    # every call's tables and a copy of its batch
    scan_mode = {"mode": None}
    scan3, scan1 = fm_search.seed_scan3, fm_search.seed_scan1

    def tap_scan3(fm3, packed, rlens, max_len, max_seeds, lanes=0, **kw):
        if scan_mode["mode"]:
            captured.setdefault(scan_mode["mode"], []).append(
                (fm3, packed.clone(), rlens.clone(), max_len, max_seeds,
                 lanes))
        return scan3(fm3, packed, rlens, max_len, max_seeds, lanes=lanes,
                     **kw)

    def tap_scan1(fm, codes, rlens, max_len, max_seeds, has_n, **kw):
        if scan_mode["mode"]:
            captured.setdefault(scan_mode["mode"], []).append(
                (fm, codes.clone(), rlens.clone(), max_len, max_seeds,
                 has_n))
        return scan1(fm, codes, rlens, max_len, max_seeds, has_n, **kw)

    # a tap on the chain dispatch: in a run with a chain capture mode set,
    # every call's kernel object and a copy of its batch
    chain_call = fm_search.SeedChainKernel.__call__

    def tap_chain(self, packed, rlens, planes=None, pair_end=False,
                  out=None):
        if scan_mode.get("chain"):
            captured.setdefault(scan_mode["chain"], []).append(
                (self, packed.clone(), rlens.clone(), pair_end))
        return chain_call(self, packed, rlens, planes=planes,
                          pair_end=pair_end, out=out)

    submit_group = DeviceBackend.submit_chain_group

    def submit_tap(self, *a, **kw):
        """The second transfer group's submit (the first built the
        tables) runs with any host sync an error: submit_chain_group must
        not wait for the card. The error, if any, is kept for main_path's
        verdict and the submit made again without the check (the verdict
        fails the run then)."""
        n = captured["submits"] = captured.get("submits", 0) + 1
        if n != 2:
            return submit_group(self, *a, **kw)
        torch.cuda.set_sync_debug_mode("error")
        try:
            captured["submit_sync_error"] = None
            return submit_group(self, *a, **kw)
        except RuntimeError as e:
            captured["submit_sync_error"] = str(e)[-600:]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return submit_group(self, *a, **kw)

    def tap_evidence(be, cfg, host_profile):
        """Keep host copies only: device tensors held past the warm-up
        would count in the later turns' peak memory."""
        ev = make_ev(be, cfg, host_profile)
        apply_batch, fetch_columns = ev.apply_batch, ev.fetch_columns

        def apply_tap(token, fast_bits, pair_end):
            captured.setdefault("apply", dict(
                pd=token.pd.cpu(), mmp=token.mmp.cpu(),
                rl=token.rl_dev.cpu(), fast_bits=fast_bits.copy(),
                packed=token.dev.cpu(), pair_end=pair_end))
            return apply_batch(token, fast_bits, pair_end)

        def fetch_tap(positions, prefix_pts, bd_blocks=None):
            if "fetch" not in captured:
                # the planes are final once calling fetches columns
                pl = ev.planes
                captured.update(
                    fetch=(positions.copy(), prefix_pts.copy()),
                    planes={k: getattr(pl, k).cpu() for k in (
                        "acgt", "exact_diff", "f_diff", "multi_diff")},
                    ref_codes=ev._ref_codes.cpu(), L=ev.L, two_l=ev.two_l,
                    text_words=ev.be.chain_ctx.text_words[
                        :(ev.L + 15) // 16].cpu(),
                    somatic=bool(cfg.somatic),
                    freq=0.01 if cfg.somatic else cfg.frequency_thr,
                    ad=int(cfg.min_allele_depth))
            return fetch_columns(positions, prefix_pts, bd_blocks)

        ev.apply_batch, ev.fetch_columns = apply_tap, fetch_tap
        return ev

    os.environ["MC_STAGE_PROF"] = "1"
    k2_main = K2MainTap().install()
    calling_tap = CallingEagerTap().install()
    nw_device.nw_ops = tap
    nw_device.nw_align_batch = tap_pairs("nw", nw_align)
    device_profile.make_device_evidence = tap_evidence
    DeviceBackend.submit_chain_group = submit_tap
    fm_search.seed_scan3, fm_search.seed_scan1 = tap_scan3, tap_scan1
    fm_search.SeedChainKernel.__call__ = tap_chain
    scan_mode.update(mode="scan3", chain="chain_warm")
    k2_main.hold = True
    try:
        warm = run()
    finally:
        k2_main.hold = False
        nw_device.nw_ops = nw_ops
        nw_device.nw_align_batch = nw_align
        device_profile.make_device_evidence = make_ev
        DeviceBackend.submit_chain_group = submit_group
        scan_mode.update(mode=None, chain=None)
    if "submit_sync_error" not in captured:
        raise AssertionError("main_path: the sync check of "
                             "submit_chain_group did not run")
    scan_table = dict(seed_scan3=run_seed_scan(ssd, captured.pop("scan3"),
                                               card))
    k0, p0, r0, pe0 = captured["chain_warm"][0]
    routed_batch = (p0, r0, k0.max_len, k0.batch)
    chain_table = run_chain(ck, captured.pop("chain_warm"), card)
    del k0
    os.replace(sam, sam + ".warm")
    os.replace(vcf, vcf + ".warm")
    with open(vcf + ".warm", "rb") as f:
        captured.update(main_vcf=f.read(), main_index=idx, main_argv=argv)

    def check(r):
        r.update(sam_identical=same_bytes(sam, sam + ".warm"),
                 vcf_identical=same_bytes(vcf, vcf + ".warm"))
        return r

    turns = []
    for device_dp in (True, False, False, True):
        r = check(run(device_dp))
        r.update(device_dp=device_dp)
        turns.append(r)
    # the stream's transfer groups in turns: a group of 1 (one batch a
    # submit: 2 uploads and a download each) and 4 (the default: 2 and 1
    # a group), with the DP where auto sends it on the card (the scalar
    # aligners), each writing the warm-up's bytes
    gturns = []
    for group in (1, 4, 4, 1):
        r = check(run(False, group=group))
        r.update(group=group)
        gturns.append(r)
    # the user's command as it is: the DP goes where the auto policy sends
    # it on the card
    auto = check(run(auto_dp=True))
    host_ev = check(run(device_evidence=False))
    k2_main.hold = True
    fold_ev = check(run(fold_evidence=True))
    k2_main.hold = False
    # the other single-card paths: 8,192 compacted lanes of the default
    # 32,768-read batch, host chaining, the 1-step index; the scan kernel
    # of each held equal to its plain version on the run's own batches
    scan_mode["mode"] = "compact"
    compact = check(run(compact_factor=4))
    scan_mode["mode"] = None
    n_compact = check_scan_batches(ssd, "seed_scan3", captured.pop("compact"))
    unchained = check(run(device_chain=False))
    scan_mode.update(mode="scan1", chain="chain_1step")
    one_step = check(run(one_step=True))
    scan_mode.update(mode=None, chain=None)
    fm_search.seed_scan3, fm_search.seed_scan1 = scan3, scan1
    fm_search.SeedChainKernel.__call__ = chain_call
    run_chain_walk(ck, captured.pop("chain_1step"), card)
    b1 = captured.pop("scan1")
    n_one_step = check_scan_batches(ssd, "seed_scan1", b1)
    f, p, r, ml, s_, has_n = b1[0]
    scan_table["seed_scan1"] = measure_scan(
        "seed_scan1 main-path batch 0", "seed_scan1",
        scan_fns(ssd, "seed_scan1", f, p, r, ml, s_, has_n=has_n), p, s_,
        reps=20)
    del b1, f, p, r
    emit("seed_scan", card=card, compacted_batches_equal=n_compact,
         one_step_batches_equal=n_one_step,
         one_step_batch0=scan_table["seed_scan1"])
    # -devices 2 and -shards 2 / 4 through the stream, replicas and shards
    # on this one card, each writing the warm-up's bytes
    k2_main.hold = True
    multi, sharded, shard_launches = run_scale_axes(run, check, card,
                                                    captured["L"])
    k2_main.hold = False
    routed_table = run_routed(idx, routed_batch, shard_launches, card)
    del shard_launches
    # big_x64 under -shards 2 and 4, and -gvcf, through the stream
    big_table, big_run, _, nor_row, b4 = run_big(run, card, sam, vcf)
    captured.update(nor_row=nor_row, b4=b4)
    dev = [t for t in turns if t["device_dp"]]
    sca = [t for t in turns if not t["device_dp"]]

    # -alg ksw2: warm-up (tapped), then device and scalar DP in turns,
    # each against the ksw2 warm-up's bytes
    ksw2_device.ksw2_ops = tap_ksw2
    ksw2_device.ksw2_align_batch = tap_pairs("ksw2", ksw2_align)
    try:
        kwarm = run(use_nw=False)
    finally:
        ksw2_device.ksw2_ops = ksw2_ops
        ksw2_device.ksw2_align_batch = ksw2_align
    os.replace(sam, sam + ".warm")
    os.replace(vcf, vcf + ".warm")
    kturns = []
    for device_dp in (True, False, False, True):
        r = check(run(device_dp, use_nw=False))
        r.update(device_dp=device_dp)
        kturns.append(r)
    kdev = [t for t in kturns if t["device_dp"]]
    ksca = [t for t in kturns if not t["device_dp"]]

    def med(runs, key):
        return statistics.median(t["metrics"][key] for t in runs)

    def summary(t, **kw):
        ev = t["evidence"]
        return dict(kw, reads_per_s=t["metrics"]["reads_per_sec"],
                    mapping_s=t["metrics"]["mapping_seconds"],
                    calling_s=t["metrics"]["calling_seconds"],
                    total_s=t["metrics"]["total_seconds"],
                    nw_launches=t["launches"], nw_pairs=t["pairs"],
                    ksw2_launches=t["ksw2_launches"],
                    ksw2_pairs=t["ksw2_pairs"], stages=t["stages"],
                    seed_scan3_launches=t["scan3_launches"],
                    seed_scan1_launches=t["scan1_launches"],
                    chain_launches=t["chain_launches"],
                    host_leg_ns=t["host_prof"],
                    evidence=ev,
                    transfers=t["transfers"],
                    k2=t["k2"],
                    peak_mem_bytes=t["peak"],
                    sam_identical=t.get("sam_identical"),
                    vcf_identical=t.get("vcf_identical"))

    m1 = dev[0]["metrics"]
    paths = [compact, unchained, one_step, multi]
    everything = ([warm] + turns + gturns + [auto, host_ev, fold_ev] + paths
                  + [kwarm] + kturns)
    g1 = [t for t in gturns if t["group"] == 1]
    g4 = [t for t in gturns if t["group"] == 4]

    def transfers_ok(t, grouped):
        """2 uploads and 1 download a transfer group of 4 batches, or a
        batch when the run submits one at a time."""
        b = t["stages"]["batches"]
        n = -(-b // 4) if grouped else b
        return (t["transfers"]["uploads"], t["transfers"]["downloads"]) == (
            2 * n, n)
    grouped = [warm] + turns + g4 + [auto, host_ev, compact, one_step,
                                      multi, kwarm] + kturns
    ungrouped = g1 + [fold_ev] + sharded
    emit("main_path", card=card, setup_s=setup_s,
         reads=m1["total_reads"],
         mapped_pct=100.0 * m1["mapped"] / max(m1["total_reads"], 1),
         variants=m1["variant_counts"],
         n_oracle_reads=max(t["metrics"]["n_oracle_reads"]
                            for t in everything),
         n_tier_reruns=max(t["metrics"]["n_tier_reruns"] for t in everything),
         warmup=summary(warm, dp="device", evidence_path="device"),
         warmup_nw_launches=warm["launches"],
         turns=[summary(t, dp="device" if t["device_dp"] else "scalar",
                        evidence_path="device") for t in turns],
         group_turns=[summary(t, dp="scalar", evidence_path="device",
                              transfer_group=t["group"])
                             for t in gturns],
         group_1_median_mapping_s=med(g1, "mapping_seconds"),
         group_4_median_mapping_s=med(g4, "mapping_seconds"),
         group_1_median_reads_per_s=med(g1, "reads_per_sec"),
         group_4_median_reads_per_s=med(g4, "reads_per_sec"),
         auto_dp=summary(auto, dp="auto", evidence_path="device"),
         submit_chain_sync_error=captured["submit_sync_error"],
         host_evidence=summary(host_ev, dp="device", evidence_path="host"),
         fold_evidence=summary(fold_ev, dp="device",
                               evidence_path="device, folded"),
         compacted=summary(compact, dp="device", evidence_path="device",
                           compact_factor=4),
         host_chaining=summary(unchained, dp="device",
                               evidence_path="host", device_chain=False),
         one_step=summary(one_step, dp="device", evidence_path="device",
                          index="1-step"),
         devices=summary(multi, dp="device", evidence_path="device",
                         backend=multi["backend"]),
         shards=[summary(t, dp="device", evidence_path="device",
                         backend=t["backend"]) for t in sharded],
         auto_compact_factor=sca[0]["compact_factor"],
         device_dp_median_reads_per_s=med(dev, "reads_per_sec"),
         device_dp_median_mapping_s=med(dev, "mapping_seconds"),
         scalar_dp_median_reads_per_s=med(sca, "reads_per_sec"),
         scalar_dp_median_mapping_s=med(sca, "mapping_seconds"),
         nw_shapes={f"{b}x{m}x{n}": c
                    for (b, m, n), c in dev[0]["shapes"].items()},
         ksw2_warmup=summary(kwarm, dp="device", evidence_path="device",
                             alg="ksw2"),
         ksw2_turns=[summary(t, dp="device" if t["device_dp"] else "scalar",
                             evidence_path="device", alg="ksw2")
                     for t in kturns],
         ksw2_variants=kwarm["metrics"]["variant_counts"],
         ksw2_device_dp_median_mapping_s=med(kdev, "mapping_seconds"),
         ksw2_scalar_dp_median_mapping_s=med(ksca, "mapping_seconds"),
         ksw2_shapes={f"{b}x{m}x{n}": c
                      for (b, m, n), c in kdev[0]["ksw2_shapes"].items()})
    hst = host_ev["evidence"]
    ucs = unchained["evidence"]
    # device DP runs of each kernel; host chaining has no DP batch step
    nw_dp = dev + [host_ev, fold_ev, compact, one_step, multi] + sharded
    ksw2_dp = [kwarm] + kdev
    ok = (all(t["launches"] > 0 and t["pairs"] > 0 for t in nw_dp)
          and all(t["ksw2_launches"] > 0 and t["ksw2_pairs"] > 0
                  for t in ksw2_dp)
          and all(t["ksw2_launches"] == kwarm["ksw2_launches"]
                  and t["ksw2_pairs"] == kwarm["ksw2_pairs"] for t in kdev)
          and len(captured["ksw2_all"]) == kwarm["ksw2_launches"]
          and all(t["launches"] == 0 for t in everything
                  if all(t is not x for x in [warm, auto] + nw_dp))
          and all(t["ksw2_launches"] == 0 for t in everything
                  if all(t is not x for x in ksw2_dp))
          and all(t["sam_identical"] and t["vcf_identical"]
                  for t in everything if t is not warm and t is not kwarm)
          and all(t["metrics"]["n_oracle_reads"] == 0
                  and t["metrics"]["n_tier_reruns"] == 0 for t in everything)
          and all(evidence_path_ok(t["evidence"])
                  for t in [warm] + turns + [auto, compact, one_step, multi,
                                             kwarm] + kturns + sharded)
          # one scan launch a batch: the occ3 kernel on every path but the
          # 1-step one, which runs only the 1-step kernel
          and all(t["scan3_launches"] == t["stages"]["batches"]
                  and t["scan1_launches"] == 0
                  for t in everything if t is not one_step)
          and one_step["scan1_launches"] == one_step["stages"]["batches"]
          # the chain kernels once a batch on every path
          # but host chaining, which runs only the scan and hits kernels
          and all(t["chain_launches"] == chain_launches(
              t["stages"]["batches"], t is not unchained) for t in everything)
          and one_step["scan3_launches"] == 0
          and evidence_path_ok(fold_ev["evidence"], applies=False,
                               folded=True)
          and hst["applies"] == hst["folded"] == hst["scans"] == 0
          and ucs["applies"] == ucs["folded"] == ucs["scans"] == 0
          and sca[0]["compact_factor"] == 1
          and captured["submit_sync_error"] is None
          and all(transfers_ok(t, True) for t in grouped)
          and all(transfers_ok(t, False) for t in ungrouped)
          and unchained["transfers"]["uploads"] == 0
          and multi["transfers"]["groups"] == -(
              -multi["stages"]["batches"] // 4))
    # K2 (evidence_apply_bits_kernel) is each run's every stand-alone
    # evidence step on the card: one launch a batch on the default path, a
    # correction or undo where the folded run needs one, none with host
    # evidence; no eager scatter and no K1 launch; every held call equal
    # to its plain version
    held_runs = [warm, fold_ev, multi] + sharded
    unfolded = [warm] + turns + gturns + [auto, compact, one_step, multi,
                                          kwarm] + kturns + sharded
    for t in everything + sharded:
        k, ev = t["k2"], t["evidence"]
        bad = (k["launches"] != ev["applies"] + ev["corrections"]
               + ev["undos"] or k["eager_scatter_calls"] or k["k1_launches"]
               or k["max_abs_err"]
               or (any(t is x for x in held_runs)
                   and k["held"] != k["launches"])
               or (any(t is x for x in unfolded)
                   and k["calls"] != {"bits+1": t["stages"]["batches"]})
               or (any(t is x for x in (host_ev, unchained))
                   and k["launches"]))
        ok = ok and not bad
    emit("main_path_k2", card=card,
         launches_a_run={k: t["k2"]["launches"] for k, t in (
             ("warmup", warm), ("fold", fold_ev), ("host_evidence", host_ev),
             ("devices_2", multi), ("shards_2", sharded[0]),
             ("shards_4", sharded[1]))},
         turns=[t["k2"]["launches"] for t in turns + gturns],
         fold_calls=fold_ev["k2"]["calls"],
         held={k: t["k2"]["held"] for k, t in (
             ("warmup", warm), ("fold", fold_ev), ("devices_2", multi),
             ("shards_2", sharded[0]), ("shards_4", sharded[1]))},
         max_abs_err=max(t["k2"]["max_abs_err"] for t in held_runs),
         eager_scatter_calls=sum(t["k2"]["eager_scatter_calls"]
                                 for t in everything + sharded))
    # the calling kernels (csrc/calling.cu) take the finalize, the caller
    # scan and the column fetch of every run that calls from the card
    # planes, and no eager body runs on the card
    ok = ok and all(calling_ok(t) for t in everything + sharded)
    w_ops = dict(warm["calling"])
    # finalize: 1 kernel; scan: 2 memsets + 1 kernel; fetch: 1 kernel
    w_total = (w_ops.get("evidence_finalize", 0)
               + 3 * w_ops.get("caller_scan", 0)
               + w_ops.get("caller_fetch", 0))
    ok = ok and w_total <= 5
    emit("main_path_calling", card=card,
         launches_a_run={k: t["calling"] for k, t in (
             ("warmup", warm), ("fold", fold_ev), ("host_evidence", host_ev),
             ("devices_2", multi), ("shards_2", sharded[0]),
             ("shards_4", sharded[1]), ("ksw2_warmup", kwarm))},
         warmup_device_operations=w_total,
         eager_calls=sum(t["calling_eager"] for t in everything + sharded))
    calling_tap.uninstall()
    k2_main.uninstall()
    captured["k2_main"] = dict(
        launches=warm["k2"]["launches"],
        max_abs_err=max(t["k2"]["max_abs_err"] for t in held_runs),
        held=sum(t["k2"]["held"] for t in held_runs),
        eager_scatter_calls=sum(t["k2"]["eager_scatter_calls"]
                                for t in everything + sharded))
    if not ok:
        raise AssertionError("main_path: a kernel not launched with device "
                             "DP or launched with scalar DP, a scan or chain "
                             "kernel not launched once a batch, outputs "
                             "differ from their warm-up's, reads left the "
                             "device "
                             "path, evidence did not take the path its "
                             "flags ask for, auto compaction was not 1, "
                             "submit_chain_group waited for the card, "
                             "the seed+chain dispatch's uploads and "
                             "downloads are not 2 and 1 a group (a batch "
                             "ungrouped), or K2 did not take every "
                             "stand-alone evidence step, once each, equal "
                             "to its plain version, or the calling kernels "
                             "did not take the finalize, scan and fetch")
    captured["scan_table"] = {
        "seed_scan3": (scan_table["seed_scan3"], dev[0]["scan3_launches"]),
        "seed_scan1": (scan_table["seed_scan1"], one_step["scan1_launches"])}
    captured["chain_table"] = (chain_table, dev[0]["chain_launches"])
    captured["calling_launches"] = dev[0]["calling"]
    captured["routed_table"] = (routed_table, sharded[0]["chain_launches"],
                                sharded[0]["scan_launches"])
    captured["big_table"] = (big_table, {**big_run["scan_launches"],
                                         **big_run["chain_launches"]})
    return ((dev[0]["launches"], kdev[0]["ksw2_launches"]),
            (captured["nw"][1], captured["ksw2"][1]), captured)


def run_evidence(cap, card, reps=50):
    """The evidence steps on the warm-up's own planes and inputs: the
    apply, the finalize (from the captured reference codes), the scan and
    the fetch each held equal to the same call on the CPU; the apply's
    device ms (queued launches) beside its bound: the bytes it must move
    over the card's memory rate (every input read once, every output
    written once; the plane entries its admitted reads update, read and
    written). -> K2's numbers on the apply (one launch): device ms, call
    ms, its plain version's ms on the card, the bound and the empty-launch
    floor; and on its two retractions (a sparse correction, the dense
    undo from the classes), each held against its plain version; and
    A5's host merge on seeded deltas (time_host_merge)."""
    import numpy as np
    import torch
    from mapcaller_tpu_torch.calling import scan_device
    from mapcaller_tpu_torch.ops import mesh_kernels as mk
    from mapcaller_tpu_torch.pipeline import device_profile as dp
    L, two_l = cap["L"], cap["two_l"]
    a = cap["apply"]
    B = int(a["rl"].shape[0])
    fb = np.zeros((B + 31) // 32, dtype=np.int32)
    fb[:a["fast_bits"].size] = a["fast_bits"].view(np.int32)
    apply_in = dict(pd=a["pd"], mmp=a["mmp"], rl=a["rl"],
                    fb=torch.from_numpy(fb))
    cuda = torch.device("cuda")

    def planes(device):
        return dp.DevicePlanes(L=L, **{k: v.to(device).clone()
                                       for k, v in cap["planes"].items()})

    def apply_on(device):
        x = {k: v.to(device) for k, v in apply_in.items()}
        kern = dp.build_apply_kernel(L, two_l, B, a["pair_end"])
        pl = planes(device)
        return pl, lambda: kern(pl, x["pd"], x["mmp"], x["rl"], x["fb"])

    def pipeline(device):
        """finalize -> scan -> fetch on `device`, as DeviceEvidence runs
        them -> their outputs."""
        rc = cap["ref_codes"].to(device)
        pos, pref = (torch.from_numpy(x.astype(np.int64)).to(device)
                     for x in cap["fetch"])
        fin = dp.build_finalize_kernel(L)(planes(device), rc)
        acgt, F, multi, cov, cov_prefix = fin
        return (fin, scan_device.build_scan_kernel(L, cap["somatic"])(
            acgt, multi, cov, rc, cap["ad"], np.float32(cap["freq"])),
            scan_device.build_fetch_kernel(L)(acgt, multi, F, cov,
                                              cov_prefix, pos, pref))

    # equality with the CPU, one call each
    gpl, gapply = apply_on(cuda)
    cpl, capply = apply_on("cpu")
    gapply()
    capply()
    gout = pipeline(cuda)
    cout = pipeline("cpu")
    diffs = [(k, int((getattr(gpl, k).cpu().long()
                      - getattr(cpl, k).long()).abs().max()))
             for k in ("acgt", "exact_diff", "f_diff", "multi_diff")]
    for name, g, c in zip(("finalize", "scan", "fetch"), gout, cout):
        for i, (x, y) in enumerate(zip(g, c)):
            diffs.append((f"{name}[{i}]", int((x.cpu().long()
                                               - y.long()).abs().max())
                          if x.numel() else 0))
    bad = [k for k, e in diffs if e != 0]
    if bad:
        raise AssertionError(f"evidence: cuda != cpu in {bad}")
    # times: apply on its own copy of the planes (it adds into them); the
    # finalize, scan and fetch kernels are timed in run_calling
    ms = dict(apply=cuda_ms(gapply, reps, queued=True))
    # bytes the apply must move on these inputs
    bit = (fb[np.arange(B) >> 5].astype(np.int64) >> (np.arange(B) & 31)) & 1
    adm = bit.astype(bool)
    n_mm = int((a["mmp"].numpy()[adm] >= 0).sum())
    n_upd = 4 * int(adm.sum()) + 3 * n_mm
    small = gout[1][4].cpu().numpy()
    P, Q = (x.size for x in cap["fetch"])
    nbytes = dict(
        apply=B * (4 + 4 * a["mmp"].shape[1] + 4) + fb.nbytes + 8 * n_upd)
    steps = {k: dict(ms=ms[k], bound_ms=1e3 * nbytes[k] / H100_BYTES_S,
                     bound_by="bytes", bytes=nbytes[k],
                     share_of_bound=1e3 * nbytes[k] / H100_BYTES_S / ms[k])
             for k in ms}
    # the apply is one K2 launch (mesh_kernels.apply_bits): one call with
    # its host issue, and its plain version (the eager scatter the main
    # path ran before) on the card, on the same inputs
    x = {k: v.to(cuda) for k, v in apply_in.items()}
    k2_bytes, k2_ops, _ = k2_work(x["pd"], x["mmp"], x["fb"], "bits")
    bound, by = bound_of(k2_bytes, k2_ops)
    ppl = planes(cuda)
    k2 = dict(ms=ms["apply"], call_ms=cuda_ms(gapply, reps),
              plain_ms=cuda_ms(lambda: mk.apply_bits_plain(
                  ppl, x["pd"], x["mmp"], x["rl"], x["fb"], a["pair_end"]),
                  reps),
              bound_ms=bound, bound_by=by, reads=B, admitted=int(adm.sum()),
              floor_ms=cuda_ms(lambda: torch.cuda._sleep(0), reps,
                               queued=True))
    # the two retractions the main data never takes (no reject, no tier
    # rerun): K2 on every 97th admitted read's bit with sign -1 (the
    # sparse correction) and on the batch's packed output (source "meta",
    # the dense undo), each against its plain version on the same planes
    rej = np.zeros(fb.size, dtype=np.uint32)
    for i in np.nonzero(adm)[0][::97]:
        rej[i >> 5] |= np.uint32(1) << np.uint32(i & 31)
    for what, sel, src in (
            ("correct", torch.from_numpy(rej.view(np.int32)).to(cuda),
             "bits"), ("undo", a["packed"].to(cuda), "meta")):
        got, want = planes(cuda), planes(cuda)
        mk.apply_bits(got, x["pd"], x["mmp"], x["rl"], sel, a["pair_end"],
                      -1, src)
        mk.apply_bits_plain(want, x["pd"], x["mmp"], x["rl"], sel,
                            a["pair_end"], -1, src)
        k2[what + "_max_abs_err"] = max(
            int((getattr(got, f).long() - getattr(want, f).long()).abs()
                .max()) for f in mk.Planes._fields)
        k2[what + "_ms"] = cuda_ms(lambda: mk.apply_bits(
            got, x["pd"], x["mmp"], x["rl"], sel, a["pair_end"], -1, src),
            reps, queued=True)
        del got, want
    if k2["correct_max_abs_err"] or k2["undo_max_abs_err"]:
        raise AssertionError("evidence: K2's retractions differ from their "
                             "plain versions")
    steps["host_merge"] = time_host_merge(planes, reps)
    emit("evidence", card=card, L=L, batch=B, admitted=int(adm.sum()),
         mismatches=n_mm, fetch_positions=P, prefix_points=Q,
         n_cand=int(small[0]), n_runs=int(small[1]),
         equal_to_cpu=True, steps=steps, k2_apply=k2)
    return k2, steps["host_merge"]


def max_err_of(got, want):
    """Largest absolute difference of two tensors or sequences of them (0
    for empty ones)."""
    import torch
    if torch.is_tensor(got):
        return (int((got.long() - want.long()).abs().max()) if got.numel()
                else 0)
    return max(max_err_of(g, w) for g, w in zip(got, want))


def run_calling(cap, card, launches, reps=50):
    """The calling kernels (csrc/calling.cu) on the main path's own planes
    and calling inputs (the warm-up's): the finalize (from the text words,
    as the main path runs it), the caller scan and the column fetch (the
    run's first fetch, with the block depths of its positions), each
    against its plain version on the card, every word (max_abs_err 0);
    device ms (queued), call ms, plain ms (queued), the bound (bytes over
    the card's memory rate: inputs read once, outputs written once; the
    scan's outputs are its whole tables, fills included); and the calling
    phase's peak device memory (finalize, scan, fetch from the same
    planes), the plain versions against the kernels. launches: the main
    path run's. -> {kernel: row}."""
    import numpy as np
    import torch
    from mapcaller_tpu_torch.ops import calling_kernels as cal
    from mapcaller_tpu_torch.pipeline import device_profile as dp
    cuda = torch.device("cuda")
    L = cap["L"]
    pl = dp.DevicePlanes(L=L, **{k: v.to(cuda) for k, v in
                                 cap["planes"].items()})
    words = cap["text_words"].to(cuda)
    pos, pref = cap["fetch"]
    blocks = np.unique(np.asarray(pos, dtype=np.int64) // 100)
    blocks = blocks[(blocks >= 0) & (blocks < (L + 99) // 100)]
    idx = torch.from_numpy(np.concatenate([pos, pref, blocks]).astype(
        np.int64)).to(cuda)
    P, Q = len(pos), len(pref)
    fb = np.float32(cap["freq"])
    fin_args = (pl.acgt, pl.exact_diff, pl.f_diff, pl.multi_diff, L)

    def phase(fin, scan, fetch):
        f = fin(*fin_args, words=words)
        sc = scan(f.acgt, f.multi, f.cov, f.codes, cap["ad"], fb,
                  cap["somatic"])
        return f, sc, fetch(f.acgt, f.multi, f.F, f.cov, f.cov_prefix, idx,
                            P, Q, sc.block_depth)

    kern = (cal.evidence_finalize, cal.caller_scan, cal.caller_fetch)
    plain = (cal.evidence_finalize_plain, cal.caller_scan_plain,
             cal.caller_fetch_plain)
    peak = {}
    for tag, fns in (("plain", plain), ("kernels", kern), ("plain_2", plain),
                     ("kernels_2", kern)):
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = phase(*fns)
        torch.cuda.synchronize()
        peak[tag] = torch.cuda.max_memory_allocated() - base
        if tag == "kernels":
            got = out
        elif tag == "plain":
            want = out
        del out
    errs = [max_err_of(g, w) for g, w in zip(got, want)]
    codes_err = max_err_of(got[0].codes, cap["ref_codes"].to(cuda))
    if any(errs) or codes_err:
        raise AssertionError(f"calling kernels != plain {errs}, codes "
                             f"{codes_err}")
    f, sc, _ = got
    n_cand, n_runs = (int(x) for x in sc.small[:2])
    nw = (L + 15) // 16
    nbytes = dict(
        evidence_finalize=40 * L + 8 * nw + (16 + 16 + 4 + 4 + 4) * L
        + 8 * (L + 1),
        caller_scan=(16 + 4 + 4 + 4) * L + 4 * ((L + 99) // 100)
        + 4 * (cal.CAND_CAP + 2 * cal.RUN_CAP) + 32 + 4,
        caller_fetch=8 * idx.numel() + 40 * P + 8 * Q + 4 * blocks.size
        + 8 * (10 * P + Q + blocks.size))
    calls = dict(
        evidence_finalize=(lambda: kern[0](*fin_args, words=words),
                           lambda: plain[0](*fin_args, words=words)),
        caller_scan=tuple((lambda fn=fn: fn(f.acgt, f.multi, f.cov, f.codes,
                                             cap["ad"], fb, cap["somatic"]))
                          for fn in (kern[1], plain[1])),
        caller_fetch=tuple((lambda fn=fn: fn(f.acgt, f.multi, f.F, f.cov,
                                              f.cov_prefix, idx, P, Q,
                                              sc.block_depth))
                           for fn in (kern[2], plain[2])))
    # the finalize's and the scan's persistent blocks: dynamic shared
    # memory (ptxas reports only the static) and blocks an SM
    geo = cal.geometry(cuda)
    rows = {}
    for name, (k, p) in calls.items():
        bound = 1e3 * nbytes[name] / H100_BYTES_S
        ms = cuda_ms(k, reps, queued=True)
        rows[name] = dict(max_abs_err=0, ms=ms, call_ms=cuda_ms(k, reps),
                          plain_ms=cuda_ms(p, reps, queued=True),
                          bound_ms=bound, bound_by="bytes",
                          bytes=nbytes[name], share_of_bound=bound / ms,
                          bytes_per_s=nbytes[name] / (ms * 1e-3),
                          launches=launches.get(name, 0),
                          **({"geometry": geo[name]} if name in geo else {}))
    # the fetch beside an empty launch (its floor in this harness)
    rows["caller_fetch"]["floor_ms"] = cuda_ms(
        lambda: torch.cuda._sleep(0), reps, queued=True)
    emit("calling", card=card, L=L, fetch_positions=P, prefix_points=Q,
         fetch_blocks=int(blocks.size), n_cand=n_cand, n_runs=n_runs,
         peak_mem_bytes=peak, kernels=rows,
         device_operations=dict(evidence_finalize=1, caller_scan=3,
                                caller_fetch=1))
    return rows


def seeded_lists(L, density=0.01, seed=5):
    """Host-delta lists as device_profile.host_delta_lists lays them out
    (the single-card planes' flat indices, each list strictly
    increasing), at `density` of each plane's entries, values 1-3, made
    from `seed` -> (pack_deltas' buffer, ends, the lists)."""
    import numpy as np
    from mapcaller_tpu_torch.ops import mesh_kernels as mk
    rng = np.random.default_rng(seed)
    lists = []
    for k, n in zip(mk.MERGE_PLANES, (4 * (L + 1), L + 2, 4 * (L + 2),
                                      L + 2)):
        idx = np.unique(rng.integers(0, n, int(n * density)))
        lists.append((idx, rng.integers(1, 4, idx.size).astype(np.int32)))
    ends = np.cumsum([i.size for i, _ in lists]).tolist()
    return mk.pack_deltas(lists), ends, lists


def sector_bytes(words):
    """What a scatter of read-add-writes must move at the card's
    granularity: each distinct 32-byte sector its int32 words fall in
    (word indices into arrays that start on 32 bytes, one array of
    indices an entry of `words`), read and written once."""
    import numpy as np
    return 64 * sum(int(np.unique(np.asarray(w) >> 3).size) for w in words)


def time_host_merge(planes, reps=50, density=0.01, seed=5):
    """A5's host merge (pipeline/device_profile.build_host_merge_kernel:
    host_merge_kernel, the four lists of the host profile's sparse nonzero
    deltas and their row segments in one upload and one launch), which
    the main data never takes (every read's evidence is applied on the
    card): seeded_lists at `density` into planes(device) (the main path's
    own). Equal to the same call on the CPU and to its plain version on
    the card (every word); the launch's device ms (queued) beside two
    bounds: bytes (each delta's index and value read, its plane word read
    and written: 20 B an entry) and sectors (the lists' 12 B an entry and
    each distinct 32-byte sector of the words read and written); the
    call's ms (the host's split, packing and copy too), beside the
    upload of the packed lists alone (upload_ms: the host part of the
    parent tree's call, which took them as they are); the plain
    version's ms (four masked index_add_) and, as the library call, the
    four index_add_ at the flat indices (the eager merge before the
    kernel), indices and values already on the card."""
    import numpy as np
    import torch
    from mapcaller_tpu_torch.ops import mesh_kernels as mk
    from mapcaller_tpu_torch.ops.device_util import upload
    from mapcaller_tpu_torch.pipeline import device_profile as dp
    gpl, cpl, ppl = planes("cuda"), planes("cpu"), planes("cuda")
    names = mk.MERGE_PLANES
    buf, ends, lists = seeded_lists(cpl.L, density, seed)
    merge = dp.build_host_merge_kernel(cpl.L)
    launches = []
    with entry_calls(mk, "_merge_launch", launches):
        merge(gpl, buf, ends)
    merge(cpl, buf, ends)

    def plain():
        with plain_entries((mk, "_host_merge_kernel", mk.host_merge_plain)):
            merge(ppl, buf, ends)
    plain()
    err = max(max(int((getattr(gpl, k).cpu().long() - getattr(x, k).cpu()
                       .long()).abs().max()) for k in names)
              for x in (cpl, ppl))
    if err or len(launches) != 1:
        raise AssertionError("evidence: the host merge on the card != cpu "
                             "or != its plain version, or not one launch")
    N = ends[-1]
    nbytes = N * (8 + 4 + 8)
    sbytes = 12 * N + sector_bytes([i for i, _ in lists])
    (a, kw), = launches
    ms = cuda_ms(lambda: mk._merge_launch(*a, **kw), reps, queued=True)
    gi, gv = (torch.from_numpy(np.ascontiguousarray(x)).cuda()
              for x in mk.unpack_deltas(buf, N))
    parts = [(getattr(gpl, k).view(-1), gi[lo:hi], gv[lo:hi])
             for k, lo, hi in zip(names, [0] + ends[:3], ends)]

    def index_add():
        for t, i, v in parts:
            t.index_add_(0, i, v)
    bound = 1e3 * nbytes / H100_BYTES_S
    sbound = 1e3 * sbytes / H100_BYTES_S
    return dict(deltas=N, density=density, max_abs_err=err, ms=ms,
                launches_a_call=len(launches), segments=int(a[3]),
                runs=int(a[4]), units=int(a[8]),
                call_ms=cuda_ms(lambda: merge(gpl, buf, ends), reps),
                upload_ms=cuda_ms(lambda: upload(buf, "cuda"), reps),
                plain_ms=cuda_ms(plain, reps),
                library_ms=cuda_ms(index_add, reps, queued=True),
                library="four index_add_ at the flat indices, one a plane",
                bound_ms=bound, bound_by="bytes", bytes=nbytes,
                share_of_bound=bound / ms, sector_bytes=sbytes,
                sector_bound_ms=sbound, share_of_sector_bound=sbound / ms,
                floor_ms=cuda_ms(lambda: torch.cuda._sleep(0), reps,
                                 queued=True))


def merge_fetch_calls(bev, em, brk):
    """Calls for one trace, on a -gvcf big run's evidence bev: B4's merge
    of seeded lists over bev's shards (_merge_lists: one copy, one
    launch), B4's fetch at the run's excluded positions, breaks as
    prefix points and the positions' blocks (_fetch: a copy each way, one
    launch), and the single-card fetch (caller_fetch) on shard 0's
    finalized slice, its coverage prefix made exclusive, the indices on
    the card before -> {name: call}."""
    import numpy as np
    import torch
    from mapcaller_tpu_torch.ops import calling_kernels as cal
    outs, _ = bev.finalize()
    L = bev.L
    buf, ends, _ = seeded_lists(L, 0.001, 11)
    p = np.clip(em, 0, L - 1).astype(np.int64)
    pp = np.clip(brk, 0, L).astype(np.int64)
    blocks = np.unique(p // 100)
    bds = bev.scan()[0]._parts
    acgt, F, multi, cov, ccov = outs[0]
    Pl = cov.shape[0]
    cpre = torch.cat([torch.zeros(1, dtype=torch.int64,
                                  device=ccov.device), ccov])
    one = [p[p < Pl], pp[pp <= Pl], blocks[blocks < Pl // 100]]
    idx = torch.from_numpy(np.concatenate(one)).to(ccov.device)
    return {"b4_merge": lambda: bev._merge_lists(buf, ends),
            "b4_fetch": lambda: bev._fetch(p, pp, blocks, bds),
            "fetch": lambda: cal.caller_fetch(
                acgt, multi, F, cov, cpre, idx, one[0].size, one[1].size,
                bds[0])}


def device_operations(fns):
    """The device operations (kernels, memsets, copies) that calls of the
    functions fns queue, from one torch.profiler trace of one call of
    each, after a call of each outside it -> their names. One trace a
    process: a second one has reported no device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn in fns:
            fn()
            torch.cuda.synchronize()
    return sorted(e.name for e in prof.events()
                  if str(getattr(e, "device_type", "")).endswith("CUDA")
                  and not getattr(e, "is_user_annotation", False))


def time_nor(args, launches, reps=20):
    """A6's NOR blocks (ops/calling_kernels.nor_blocks: nor_blocks_kernel,
    one launch) on a -gvcf run's own call: the finalized coverage, the
    sorted excluded positions and breaks and the segment count as
    DeviceEvidence.nor_blocks passed them. Equal in every word to its
    plain version on the card; device ms (queued), call ms, plain ms
    (queued), beside the bound: the coverage, the positions and breaks
    read once, three int32 words a segment written; the launch geometry.
    launches: the -gvcf run's."""
    from mapcaller_tpu_torch.ops import calling_kernels as cal
    cov, em, bkt, nseg = args
    err = max_err_of(cal.nor_blocks(*args), cal.nor_blocks_plain(*args))
    if err:
        raise AssertionError("big -gvcf: the NOR block kernel != its plain "
                             "version")
    L = cov.numel()
    nbytes = 4 * L + 8 * (em.numel() + bkt.numel()) + 12 * nseg
    ms = cuda_ms(lambda: cal.nor_blocks(*args), reps, queued=True)
    bound = 1e3 * nbytes / H100_BYTES_S
    return dict(L=L, emitted=int(em.numel()), breaks=int(bkt.numel()),
                segments=nseg, max_abs_err=err, ms=ms,
                bytes_per_s=nbytes / (ms * 1e-3),
                call_ms=cuda_ms(lambda: cal.nor_blocks(*args), reps),
                plain_ms=cuda_ms(lambda: cal.nor_blocks_plain(*args), reps,
                                 queued=True),
                bound_ms=bound, bound_by="bytes", bytes=nbytes,
                share_of_bound=bound / ms, launches=launches,
                geometry=cal.geometry(cov.device)["nor_blocks"])


def run_ksw2_launches(k, launches, card):
    """Every -alg ksw2 launch of the main path's warm-up against the plain
    version, word for word, and the length histogram of the largest:
    pairs by max(qlen, tlen) in bins of 16 (the longest pair sets a
    launch's time)."""
    import numpy as np
    errs = [equal_ksw2(k, args) for args in launches]
    big = max(launches, key=lambda a: a[0].shape[0])
    longest = np.maximum(big[2].cpu().numpy(), big[3].cpu().numpy())
    counts = np.bincount((longest - 1) // 16)
    emit("ksw2_launches", card=card, launches=len(launches),
         equal=len(errs), max_abs_err=max(errs),
         shapes=[f"{a[0].shape[0]}x{a[0].shape[1]}x{a[1].shape[1] - 16}"
                 for a in launches],
         largest_max_len_histogram={f"{16 * i + 1}-{16 * i + 16}": int(c)
                                    for i, c in enumerate(counts) if c},
         largest_longest_pair=int(longest.max()))


def write_pe_fixture(d):
    """The reference package's multi-host paired-end fixture
    (tests/test_multihost.py:_write_pe_fixtures, seed 17): an 8 kb genome,
    pairs tiling it, SNP pileups on mate 1 and a deletion pileup. ->
    (fasta, r1, r2). A copy: that helper decodes with the JAX package's
    dna module, which this script does not import."""
    import numpy as np
    from mapcaller_tpu_torch.dna import decode
    codes = np.random.default_rng(17).integers(0, 4, size=8000).astype(
        np.uint8)
    comp = 3 - codes
    fa = os.path.join(d, "pe.fa")
    with open(fa, "w") as f:
        f.write(">chr1\n")
        s = decode(codes)
        for i in range(0, len(s), 70):
            f.write(s[i:i + 70] + "\n")
    RL, frag = 100, 300
    pairs = []

    def add(p, r1=None):
        if r1 is None:
            r1 = codes[p:p + RL].copy()
        pairs.append((decode(r1), decode(comp[p + frag - RL:p + frag][::-1])))

    for p in range(0, len(codes) - frag - 10, 22):
        add(p)
    for site in (2000, 5500):
        alt = (int(codes[site]) + 1) % 4
        for k in range(8):
            p = site - 12 - 4 * k
            r1 = codes[p:p + RL].copy()
            r1[site - p] = alt
            add(p, r1)
    for k in range(8):
        p = 4000 - 20 - 3 * k
        add(p, np.concatenate([codes[p:4000], codes[4002:4002 + RL]])[:RL])
    out = []
    for mate in (0, 1):
        path = os.path.join(d, f"pe_r{mate + 1}.fq")
        with open(path, "w") as f:
            for i, pr in enumerate(pairs):
                f.write(f"@p{i}/{mate + 1}\n{pr[mate]}\n+\n{'I' * RL}\n")
        out.append(path)
    return (fa, *out)


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


SEED_CHAIN = ("seed_scan3", "chain_scan_seeds", "chain_hits",
              "chain_classify_pack")


def seed_chain_launches():
    """The four seed+chain kernels' launch counts since the last reset."""
    from mapcaller_tpu_torch.ops import chain_kernels as ck
    from mapcaller_tpu_torch.ops import seed_scan_device as ssd
    counts = {**ssd.STATS.launches, **ck.STATS.launches}
    return {k: counts.get(k, 0) for k in SEED_CHAIN}


def multihost_launches(path_launches, name):
    """A seed+chain kernel's launches on the multihost and mesh paths'
    runs: the 1-rank runs in this process, each rank of the 2-rank run on
    the main data, and the mesh runs."""
    return {run: ([x[name] for x in v] if isinstance(v, list) else v[name])
            for run, v in path_launches.items()}


def multihost_child(spec_path):
    """One rank of the multihost phase, in a process of its own: run_host
    on the card with the spec's arguments, then this rank's facts (its
    mapping device, mapping_s, the collectives' seconds and the
    seed+chain launches of its run) into the spec's facts file."""
    sys.path.insert(0, HERE)
    from mapcaller_tpu_torch.ops import chain_kernels as ck
    from mapcaller_tpu_torch.ops import seed_scan_device as ssd
    from mapcaller_tpu_torch.parallel.multihost import run_host
    with open(spec_path) as f:
        spec = json.load(f)
    ssd.STATS.reset()
    ck.STATS.reset()
    facts = run_host(*spec["args"], reads2=spec["reads2"],
                     devices=spec["devices"])
    facts["launches"] = seed_chain_launches()
    with open(spec["facts"], "w") as f:
        json.dump(facts, f)
    return 0


def launch_ranks(d, tag, n, fasta, r1, r2, out, devices, timeout=300):
    """n ranks of run_host on cuda:0, each a `chip_smoke.py
    --multihost-child` process started by the port's own launcher (a rank
    that exits non-zero gets the others killed, and every rank still
    running at the deadline is killed). -> (wall seconds, each rank's
    facts)."""
    from mapcaller_tpu_torch.parallel import multihost
    port = free_port()
    cmds, logs, facts = [], [], []
    for pid in range(n):
        spec = os.path.join(d, f"{tag}_{pid}.json")
        facts.append(os.path.join(d, f"{tag}_{pid}.facts.json"))
        with open(spec, "w") as f:
            json.dump(dict(args=[pid, n, f"127.0.0.1:{port}", fasta, r1, out,
                                 "multihost-test"],
                           reads2=r2, devices=devices, facts=facts[-1]), f)
        cmds.append([sys.executable, os.path.join(HERE, "chip_smoke.py"),
                     "--multihost-child", spec])
        logs.append(open(os.path.join(d, f"{tag}_{pid}.log"), "wb"))
    t0 = time.time()
    try:
        rcs = multihost.launch_ranks(cmds, logs, timeout, cwd=HERE)
    finally:
        for f in logs:
            f.close()
    wall = time.time() - t0
    if rcs != [0] * n:
        for f in logs:
            with open(f.name, "rb") as g:
                sys.stderr.write(g.read()[-4000:].decode(errors="replace"))
        raise AssertionError(f"multihost {tag}: rank exit codes {rcs}")
    out_facts = []
    for path in facts:
        with open(path) as f:
            out_facts.append(json.load(f))
    return wall, out_facts


def held_run_host(d, tag, fasta, r1, r2, hold, device="cuda"):
    """run_host in this process as a world of 1 (gloo), with a tap that
    copies the inputs of the first `hold` seed+chain dispatches; the four
    kernels' launch counts set to 0 just before the run and read just
    after; then each copied dispatch's scan, hits, seed-freq scan and
    classify+pack held equal in every word to their plain versions (on
    the card). -> (wall seconds, VCF path, facts, launches, dispatches
    held, max abs err by kernel)."""
    from mapcaller_tpu_torch.ops import chain_kernels as ck
    from mapcaller_tpu_torch.ops import fm_search
    from mapcaller_tpu_torch.ops import seed_scan_device as ssd
    from mapcaller_tpu_torch.parallel.multihost import run_host
    call = fm_search.SeedChainKernel.__call__
    kept = []

    def tap(self, packed, rlens, planes=None, pair_end=False, out=None):
        if len(kept) < hold:
            kept.append((self, packed.clone(), rlens.clone(), planes is None,
                         pair_end))
        return call(self, packed, rlens, planes=planes, pair_end=pair_end,
                    out=out)

    out = os.path.join(d, f"{tag}.vcf")
    fm_search.SeedChainKernel.__call__ = tap
    ssd.STATS.reset()
    ck.STATS.reset()
    t0 = time.time()
    try:
        facts = run_host(0, 1, f"127.0.0.1:{free_port()}", fasta, r1, out,
                         "multihost-test", reads2=r2, device=device)
    finally:
        wall = time.time() - t0
        fm_search.SeedChainKernel.__call__ = call
    launches = seed_chain_launches()
    errs = dict.fromkeys(SEED_CHAIN, 0)
    for i, (kern, packed, rlens, no_planes, pe) in enumerate(kept):
        if not no_planes:
            raise AssertionError("multihost: a dispatch folded the apply")
        errs["seed_scan3"] = max(errs["seed_scan3"], equal_scan(
            f"multihost {tag} batch {i}", *scan_fns(
                ssd, "seed_scan3", kern.fm, packed, rlens, kern.max_len,
                kern.max_seeds, lanes=kern.compact_lanes)))
        err = equal_chain(f"multihost {tag} batch {i}", ck, kern, packed,
                          rlens, None, pair_end=pe)[0]
        for k in SEED_CHAIN[1:]:
            errs[k] = max(errs[k], err)
    return wall, out, facts, launches, len(kept), errs


def run_multihost(work, card, main_files, hold=32):
    """The multihost phase: run_host (parallel/multihost.py) on the card.
    First in this process as a world of 1 over gloo, on the paired-end
    multi-host fixture (every dispatch held against the plain versions;
    the VCF also against the same run on the CPU) and on the main path's
    data (its first `hold` dispatches held); then 2 ranks on cuda:0 and
    2 ranks x --devices 2 on [cuda:0] * 2, each rank a process of its
    own, over both: every rank exits 0, runs its seed+chain kernels on
    the card, and rank 0's merged VCF equals the 1-rank VCF. -> the four
    kernels' launches in the 1-rank and 2-rank runs on the main data."""
    import torch
    d = os.path.join(work, "multihost")
    os.makedirs(d)
    data = {"fixture": write_pe_fixture(d), "main": main_files}
    held, path_launches = {}, {}
    for name, (fa, r1, r2) in data.items():
        wall, vcf, facts, launches, n_held, errs = held_run_host(
            d, f"held_{name}", fa, r1, r2,
            hold=1 << 30 if name == "fixture" else hold)
        cpu_same = None
        if name == "fixture":
            cpu_vcf = held_run_host(d, "cpu_fixture", fa, r1, r2, 0,
                                    device="cpu")[1]
            cpu_same = same_bytes(vcf, cpu_vcf)
        with open(vcf, "rb") as f:
            held[name] = f.read()
        emit("multihost", card=card, data=name, ranks=1, in_this_process=True,
             wall_s=wall, mapping_device=facts["device"],
             mapping_s=facts["mapping_s"], collectives_s={
                 k: facts[k] for k in ("allreduce_s", "allmax_s",
                                       "allgather_s")},
             allreduce_bytes=facts["allreduce_bytes"], launches=launches,
             dispatches_held_to_plain=n_held,
             launches_held_to_plain=4 * n_held, max_abs_err=errs,
             vcf_bytes=len(held[name]), vcf_identical_to_cpu=cpu_same)
        if not (facts["device"].startswith("cuda") and n_held > 0
                and min(launches.values()) > 0
                and len(set(launches.values())) == 1
                and max(errs.values()) == 0 and cpu_same is not False):
            raise AssertionError(f"multihost {name}: a seed+chain kernel did "
                                 f"not run on the card once a batch, "
                                 f"differs from its plain version, or the "
                                 f"VCF differs from the CPU run's")
        path_launches[f"multihost_1_rank_{name}"] = launches
    gc.collect()
    torch.cuda.empty_cache()
    cuda0 = ["cuda:0"] * 2
    for name, (fa, r1, r2) in data.items():
        for devices in (1, cuda0):
            tag = f"{name}_2x{2 if devices != 1 else 1}"
            out = os.path.join(d, f"{tag}.vcf")
            wall, facts = launch_ranks(d, tag, 2, fa, r1, r2, out, devices)
            with open(out, "rb") as f:
                same = f.read() == held[name]
            emit("multihost", card=card, data=name, ranks=2,
                 devices_a_rank=devices, wall_s=wall, ranks_facts=facts,
                 vcf_identical_to_1_rank=same,
                 vcf_records=sum(not ln.startswith(b"#")
                                 for ln in held[name].splitlines()))
            if not (same and all(
                    f["device"].startswith("cuda")
                    and min(f["launches"].values()) > 0
                    and len(set(f["launches"].values())) == 1
                    for f in facts)):
                raise AssertionError(f"multihost {tag}: a rank ran its "
                                     f"seed+chain kernels off the card or "
                                     f"not once a batch, or the merged VCF "
                                     f"differs from the 1-rank VCF")
            if name == "main" and devices == 1:
                path_launches["multihost_2_ranks_main"] = [
                    f["launches"] for f in facts]
    return path_launches


MESH_KERNELS = ("dp_scatter_scan", "evidence_apply_bits")
# K1 launches of a mesh run on one card, at every n: phase A's psum of
# three planes, its coverage scan (one launch), phase B's psum of three
MESH_K1_LAUNCHES = 7
MESH_MAX_LEN = 128                # the main data's bucket (100-base reads)
# ptxas registers of chain_classify_pack_kernel on the parent tree: its
# folded apply became a device function that K2 shares, and its code must
# not change (PERF.md)
CLASSIFY_PACK_REGISTERS = 64
# K2's main instantiation (evidence_apply_bits_kernel), measured before
# its body took the slice form beside it
K2_REGISTERS = 40
# ptxas registers of the NOR blocks' two instantiations (csrc/calling.cu):
# NOR_MIN_BLOCKS blocks of NOR_THREADS an SM hold at most 65,536 / (6 x
# 256) of them, and the slice form shares the body
NOR_REGISTERS = dict(nor_blocks_kernel=40, nor_blocks_slice_kernel=40)


def mesh_launches():
    """The mesh path's launches since the last reset: the four seed+chain
    kernels and the two collectives (K1, K2)."""
    from mapcaller_tpu_torch.ops import mesh_kernels as mk
    return {**seed_chain_launches(),
            **{k: mk.STATS.launches.get(k, 0) for k in MESH_KERNELS}}


def reset_mesh_launches():
    from mapcaller_tpu_torch.ops import chain_kernels as ck
    from mapcaller_tpu_torch.ops import mesh_kernels as mk
    from mapcaller_tpu_torch.ops import seed_scan_device as ssd
    for st in (ssd.STATS, ck.STATS, mk.STATS):
        st.reset()


def dryrun_reads(g, rng):
    """The reference package's single-end dry-run reads
    (__graft_entry__._dryrun_reads): a tiling with an uncovered gap and
    flanks, SNP pileups, 2-base deletion reads. A copy: that module
    imports the JAX package, which this script does not import."""
    import numpy as np
    L, RL = g.size, 70
    reads = []

    def rc(c):
        return (3 - c)[::-1]

    for p in range(0, L - RL, 20):
        if 700 - RL < p < 800 or 3930 - RL < p < 4120:
            continue
        c = g[p:p + RL].copy()
        reads.append((rc(c), True) if (p // 20) % 3 == 2 else (c, False))
    for site in (1500, 2500, 5200):
        alt = (int(g[site]) + 1) % 4
        for k in range(8):
            p = site - 10 - 5 * k
            c = g[p:p + RL].copy()
            c[site - p] = alt
            reads.append((c, False))
    for k in range(8):
        p = 3200 - 20 - 3 * k
        c = np.concatenate([g[p:3200], g[3202:3202 + RL - (3200 - p)]])
        reads.append((c[:RL], False))
    return reads


def mesh_index(codes):
    from mapcaller_tpu_torch.index.fmindex import build_index
    from mapcaller_tpu_torch.index.packer import PackedReference
    return build_index(None, packed=PackedReference(
        ["chr1"], [codes.size], [0], codes, []))


def mesh_key(v):
    return (v.gPos, v.VarType, v.DP, v.AD_ref, v.AD_alt, v.GenoType,
            v.qscore, v.ALTstr)


def se_fixture():
    """__graft_entry__.dryrun_multichip's genome (6 kb, seed 7, a 120-base
    repeat) and reads, rebuilt with numpy."""
    import numpy as np
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, size=6000).astype(np.uint8)
    codes[4000:4120] = codes[1000:1120]
    return mesh_index(codes), dryrun_reads(codes, rng)


def pe_fixture():
    """__graft_entry__.dryrun_multichip_pe's genome (6 kb, seed 31) and
    pairs (mate 2 as the parser hands it on), rebuilt with numpy."""
    import numpy as np
    rng = np.random.default_rng(31)
    L, RL = 6000, 70
    codes = rng.integers(0, 4, size=L).astype(np.uint8)
    comp = 3 - codes
    pairs = []

    def add(p, frag=300, r1=None):
        if r1 is None:
            r1 = codes[p:p + RL].copy()
        pairs.append((r1, comp[p + frag - RL:p + frag][::-1].copy()))

    for p in range(0, L - 400, 25):
        add(p)
    for site in (1500, 2500, 4200):
        alt = (int(codes[site]) + 1) % 4
        for k in range(8):
            p = site - 10 - 5 * k
            r1 = codes[p:p + RL].copy()
            r1[site - p] = alt
            add(p, r1=r1)
    for k in range(8):
        p = 3200 - 20 - 3 * k
        add(p, r1=np.concatenate([codes[p:3200], codes[3202:3202 + RL]])[:RL])
    return mesh_index(codes), pairs


def mesh_layout(seqs, n, width, multiple):
    """Codes shard-major in mat uint8[n * B, width], B the reads a share
    rounded up to `multiple` (the reference's dry runs: 8 single-end, 16
    paired) -> (mat, rlens, B)."""
    import numpy as np
    B = -(-len(seqs) // n)
    B = -(-B // multiple) * multiple
    mat = np.zeros((B * n, width), dtype=np.uint8)
    rlens = np.zeros(B * n, dtype=np.int32)
    for i, c in enumerate(seqs):
        mat[i, :c.size] = c
        rlens[i] = c.size
    return mat, rlens, B


class MeshDispatch:
    """One mesh entry's seed+chain dispatch as chain_run and equal_chain
    take a SeedChainKernel: the occ3 scan without prefix skip over the
    entry's padded share, or on the 1-step route (a DeviceFMIndex `fm`,
    with or without its full SA) the 1-step scan; H = H2 = hits_per_read
    * B."""

    def __init__(self, fm, ctx, max_len, max_seeds, batch, H):
        from mapcaller_tpu_torch.ops.fm3_device import DeviceFM3
        self.occ3 = isinstance(fm, DeviceFM3)
        self.fm, self.fm1, self.ctx = fm, fm.fm if self.occ3 else fm, ctx
        self.max_len, self.max_seeds = max_len, max_seeds
        self.batch, self.H, self.H2 = batch, H, H

    def _scan_packed(self, packed, rlens):
        from mapcaller_tpu_torch.ops import seed_scan_device as ssd
        if self.occ3:
            return ssd.seed_scan3(self.fm, packed, rlens, self.max_len,
                                  self.max_seeds)
        return ssd.seed_scan1(self.fm, packed, rlens, self.max_len,
                              self.max_seeds, has_n=False)


def equal_resolved(what, ck, fm, packed, rlens, kern):
    """The hits kernel's per-slot resolved flags (the output the mesh's
    map step reads) against the plain version's on a dispatch's seeds;
    -> max abs err (0)."""
    import torch
    seeds = kern._scan_packed(packed, rlens)
    scan = ck.chain_scan_seeds(seeds[4], seeds[0], kern.H)
    got = torch.empty(kern.H, dtype=torch.bool, device=packed.device)
    ck.chain_hits(fm, scan, *seeds[:5], kern.H, resolved=got)
    want = torch.empty_like(got)
    ck.chain_hits_plain(fm, scan.off, *seeds[:5], kern.H, resolved=want)
    return max_err(what + " resolved", [("resolved", got, want)])


class MeshTap:
    """Taps on parallel/mesh.py's kernel wrappers (in that module's
    namespace) for one run: the inputs of the first `hold` seed scans
    (each a dispatch: the chain kernels after it take its outputs), and
    every K1 and K2 call's inputs and outputs, copied on the card in
    stream order. check() then holds each against its plain version."""

    NAMES = ("seed_scan3", "seed_scan1", "dp_reduce", "dp_scatter_scan",
             "apply_bits")

    def __init__(self, hold):
        self.hold, self.scans, self.k1, self.k2 = hold, [], [], []

    def __enter__(self):
        import torch
        from mapcaller_tpu_torch.parallel import mesh as tm
        self.real = {k: getattr(tm, k) for k in self.NAMES}
        real = self.real

        def scan(fm3, packed, rlens, max_len, max_seeds):
            if len(self.scans) < self.hold:
                self.scans.append((fm3, packed.clone(), rlens.clone(),
                                   max_len, max_seeds))
            return real["seed_scan3"](fm3, packed, rlens, max_len, max_seeds)

        def scan1(fm, packed, rlens, max_len, max_seeds, has_n):
            if len(self.scans) < self.hold:
                self.scans.append((fm, packed.clone(), rlens.clone(),
                                   max_len, max_seeds))
            return real["seed_scan1"](fm, packed, rlens, max_len, max_seeds,
                                      has_n=has_n)

        def reduce(parts, streams=None):
            out = real["dp_reduce"](parts, streams)
            self.k1.append(("psum", [p.clone() for p in parts], (),
                            [out.clone()]))
            return out

        def scatter_scan(parts, n, length=None, devices=None, streams=None):
            outs = real["dp_scatter_scan"](parts, n, length, devices, streams)
            for s in streams or ():
                if s is not None:
                    torch.cuda.current_stream(s.device).wait_stream(s)
            self.k1.append(("scatter_scan", [p.clone() for p in parts],
                            (n, length), [o.clone() for o in outs]))
            return outs

        def apply(planes, pd, mmp, rlens, sel, pair_end, sign=1,
                  source="bits"):
            before = [t.clone() for t in (*planes, pd, mmp, rlens, sel)]
            out = real["apply_bits"](planes, pd, mmp, rlens, sel, pair_end,
                                     sign, source)
            self.k2.append((before, pair_end, sign, source,
                            [t.clone() for t in out]))
            return out

        for k, f in zip(self.NAMES, (scan, scan1, reduce, scatter_scan,
                                     apply)):
            setattr(tm, k, f)
        return self

    def __exit__(self, *exc):
        from mapcaller_tpu_torch.parallel import mesh as tm
        for k, f in self.real.items():
            setattr(tm, k, f)

    def check(self, what, mesh, idx, B, hits_per_read=8):
        """Every held dispatch's seed scan and chain kernels, and every K1
        and K2 call, equal to their plain versions on the same inputs on
        the card. -> (dispatches held, max abs err by kernel)."""
        from mapcaller_tpu_torch.ops import chain_kernels as ck
        from mapcaller_tpu_torch.ops import mesh_kernels as mk
        from mapcaller_tpu_torch.ops import seed_scan_device as ssd
        errs = dict.fromkeys(SEED_CHAIN + MESH_KERNELS, 0)
        for i, (fm, pk, rl, ml, S) in enumerate(self.scans):
            kern = MeshDispatch(fm, mesh.chain_ctx(idx)[pk.device], ml, S,
                                pk.shape[0], hits_per_read * B)
            kind = "seed_scan3" if kern.occ3 else "seed_scan1"
            errs.setdefault(kind, 0)
            errs[kind] = max(errs[kind], equal_scan(
                f"{what} dispatch {i}", *scan_fns(ssd, kind, fm, pk, rl, ml,
                                                  S)))
            err = equal_chain(f"{what} dispatch {i}", ck, kern, pk, rl,
                              kern.ctx.seq_len // 2)[0]
            if not kern.occ3:
                err = max(err, equal_resolved(f"{what} dispatch {i}", ck,
                                              kern.fm1, pk, rl, kern))
            for k in SEED_CHAIN[1:]:
                errs[k] = max(errs[k], err)
        for kind, parts, args, outs in self.k1:
            want = ([mk.dp_reduce_plain(parts)] if kind == "psum" else
                    mk.dp_scatter_scan_plain(parts, *args))
            errs["dp_scatter_scan"] = max(errs["dp_scatter_scan"], max_err(
                f"{what} K1 {kind}", [(f"slice{i}", o, w) for i, (o, w)
                                      in enumerate(zip(outs, want))]))
        for before, pe, sign, source, outs in self.k2:
            planes = mk.Planes(*before[:3])
            want = mk.apply_bits_plain(planes, *before[3:], pe, sign, source)
            errs["evidence_apply_bits"] = max(
                errs["evidence_apply_bits"], max_err(
                    f"{what} K2", list(zip(mk.Planes._fields, outs, want))))
        return len(self.scans), errs


def se_mesh_variants(idx, cfg, reads, n, device):
    """__graft_entry__.dryrun_multichip's flow on the port: phase A on a
    mesh of n entries on `device` ([cuda:0] * n, or n CPU devices), the
    SLOW reads through a per-shard host pipeline, the merge and the
    caller (no phase B: the single-end dry run's evidence is phase A's).
    -> (variant keys, merged acgt, multi, the stitched coverage equal to
    the cumsum of the summed exact plane, phase A, the mesh)."""
    import numpy as np
    from mapcaller_tpu_torch.calling.caller import (cal_block_read_depth,
                                                    identify_variants)
    from mapcaller_tpu_torch.dna import decode
    from mapcaller_tpu_torch.ops.chain_device import CLASS_SLOW
    from mapcaller_tpu_torch.parallel import mesh as tm
    from mapcaller_tpu_torch.pipeline.engine import MappingEngine
    from mapcaller_tpu_torch.pipeline.profile import MAX_ALLELE_COUNT
    from mapcaller_tpu_torch.pipeline.read import ReadState
    L = idx.genome_size
    mat, rlens, B = mesh_layout([c for c, _ in reads], n, 80, 8)
    mesh = tm.make_mesh(n, devices=[device] * n)
    res = tm.build_multichip_pipeline(idx, 80, B, mesh)(
        tm.pack_reads(mat, 80), rlens)
    cls = res.cls.cpu().numpy()
    exact = res.exact.cpu().numpy()
    engines = []
    for d in range(n):
        eng = MappingEngine(idx, cfg, backend=None, use_native=False)
        slow = [i for i in range(d * B, min((d + 1) * B, len(reads)))
                if cls[i] == CLASS_SLOW]
        if slow:
            eng.process_chunk_single([ReadState(
                f"r{i}", decode(mat[i, :rlens[i]]), None) for i in slow])
        engines.append(eng)
    ref_codes = idx.ref.ref_sequence_codes()
    exact_cov = np.cumsum(exact[:L]).astype(np.int64)
    acgt = res.acgt.cpu().numpy()[:, :L].astype(np.int64)
    for c in range(4):
        acgt[c] += np.where(ref_codes[:L] == c, exact_cov, 0)
    F = np.cumsum(res.fd.cpu().numpy()[:, :L], axis=1).astype(np.int64)
    multi = np.zeros(L, dtype=np.int64)
    for eng in engines:
        acgt += eng.profile.acgt
        multi += eng.profile.multi_hit
        for nm, k in (("F1", 0), ("R2", 1), ("F2", 2), ("R1", 3)):
            F[k] += getattr(eng.profile, nm)
    np.minimum(acgt, MAX_ALLELE_COUNT, out=acgt)
    np.minimum(multi, MAX_ALLELE_COUNT, out=multi)
    stitched = np.array_equal(
        np.concatenate([c.cpu().numpy() for c in res.cov_shard])[:L],
        exact_cov)
    merged = MappingEngine(idx, cfg, backend=None, use_native=False)
    merged.profile.acgt = acgt.astype(np.int32)
    merged.profile.multi_hit = multi.astype(np.int32)
    for nm, k in (("F1", 0), ("R2", 1), ("F2", 2), ("R1", 3)):
        getattr(merged.profile, nm)[:] = F[k].astype(np.int32)
    for eng in engines:
        for src, dst in ((eng.profile.insert_map, merged.profile.insert_map),
                         (eng.profile.delete_map, merged.profile.delete_map)):
            for posk, inner in src.items():
                dd = dst.setdefault(posk, {})
                for seq, cnt in inner.items():
                    dd[seq] = dd.get(seq, 0) + cnt
    v = identify_variants(cfg, merged.genome, merged.profile, ref_codes,
                          cal_block_read_depth(merged.profile, L))
    return [mesh_key(x) for x in v], acgt, multi, stitched, res, mesh


def single_variants(idx, cfg, reads, paired):
    """The port's single-device run of a fixture (the pure-Python
    pipeline, the reference's dry-run oracle) -> (keys, profile)."""
    from mapcaller_tpu_torch.calling.caller import (cal_block_read_depth,
                                                    identify_variants)
    from mapcaller_tpu_torch.dna import decode
    from mapcaller_tpu_torch.pipeline.engine import MappingEngine
    from mapcaller_tpu_torch.pipeline.read import ReadState
    eng = MappingEngine(idx, cfg, backend=None, use_native=False)
    if paired:
        rs = []
        for i, (a, b) in enumerate(reads):
            rs.append(ReadState(f"p{i}/1", decode(a), None))
            rs.append(ReadState(f"p{i}/2", decode((3 - b)[::-1]), None))
        eng.process_chunk_paired(rs)
    else:
        eng.process_chunk_single([ReadState(
            f"r{i}", decode(c if not isrc else (3 - c)[::-1]), None)
            for i, (c, isrc) in enumerate(reads)])
    eng.finalize()
    L = idx.genome_size
    v = identify_variants(cfg, eng.genome, eng.profile,
                          idx.ref.ref_sequence_codes(),
                          cal_block_read_depth(eng.profile, L))
    return [mesh_key(x) for x in v], eng.profile


def run_mesh_fixtures(card):
    """The reference's single-end and paired-end dry runs on the card at n
    = 2 and 8 on [cuda:0] * n, each against the same calls on the CPU and
    the port's single-device run, every K1 / K2 launch and every dispatch
    held against its plain version. -> the launches of the n = 8 PE run."""
    import numpy as np
    from mapcaller_tpu_torch.config import Config
    from mapcaller_tpu_torch.parallel import mesh as tm
    from mapcaller_tpu_torch.pipeline.profile import MAX_ALLELE_COUNT
    cfg_se = Config(vcf_file="dry.vcf", log_file="dry.log")
    idx, reads = se_fixture()
    want_se, single = single_variants(idx, cfg_se, reads, paired=False)
    for n in (2, 8):
        reset_mesh_launches()
        with MeshTap(1 << 30) as tap:
            keys, acgt, multi, stitched, res, mesh = se_mesh_variants(
                idx, cfg_se, reads, n, "cuda:0")
        launches = mesh_launches()
        cpu = se_mesh_variants(idx, cfg_se, reads, n, "cpu")
        held, errs = tap.check(f"mesh se n={n}", mesh, idx,
                               res.cls.shape[0] // n)
        same_cpu = all(
            [keys == cpu[0], np.array_equal(acgt, cpu[1]),
             np.array_equal(multi, cpu[2])]
            + [torch_equal_cpu(getattr(res, f), getattr(cpu[4], f))
               for f in ("cls", "pd", "mm", "rplast", "cscore", "mmp",
                         "slow_counts", "exact", "fd", "acgt")])
        ok = (same_cpu and stitched and keys == want_se
              and np.array_equal(acgt, np.minimum(single.acgt,
                                                  MAX_ALLELE_COUNT))
              and np.array_equal(multi, single.multi_hit)
              and {0, 2, 6} <= {k[1] for k in keys}
              and held == n and launches["evidence_apply_bits"] == 0
              and min(v for k, v in launches.items()
                      if k != "evidence_apply_bits") > 0)
        emit("mesh", card=card, data="fixture_se", n=n, devices="cuda:0",
             variants=len(keys), types=sorted({k[1] for k in keys}),
             equal_to_cpu=same_cpu, equal_to_single_device=keys == want_se,
             coverage_stitched=stitched, launches=launches,
             dispatches_held_to_plain=held, max_abs_err=errs)
        if not ok:
            raise AssertionError(f"mesh se n={n}: differs from the CPU or "
                                 f"the single-device run, or a kernel did "
                                 f"not run")
    idx, pairs = pe_fixture()
    cfg = Config(vcf_file="dry.vcf", log_file="dry.log", min_allele_depth=3)
    want_pe, single = single_variants(idx, cfg, pairs, paired=True)
    seqs = [c for pr in pairs for c in pr]
    for n in (2, 8):
        mat, rlens, B = mesh_layout(seqs, n, 80, 16)
        out = {}
        for dev in ("cuda:0", "cpu"):
            reset_mesh_launches()
            mesh = tm.make_mesh(n, devices=[dev] * n)
            tap = MeshTap(1 << 30) if dev != "cpu" else None
            with tap or contextlib.nullcontext():
                v, merged, _ = tm.run_mesh_pe_pipeline(
                    idx, cfg, mat, rlens, len(seqs), n, max_len=80,
                    mesh=mesh)
            out[dev] = ([mesh_key(x) for x in v], merged.profile,
                        mesh_launches(), tap, mesh)
        keys, prof, launches, tap, mesh = out["cuda:0"]
        held, errs = tap.check(f"mesh pe n={n}", mesh, idx, B)
        planes_cpu = all(np.array_equal(getattr(prof, k),
                                        getattr(out["cpu"][1], k))
                         for k in ("acgt", "F1", "R2", "F2", "R1",
                                   "multi_hit"))
        ok = (keys == out["cpu"][0] == want_pe and planes_cpu
              and np.array_equal(prof.acgt, np.minimum(single.acgt,
                                                       MAX_ALLELE_COUNT))
              and np.array_equal(prof.F1, single.F1)
              and np.array_equal(prof.R2, single.R2)
              and {0, 2} <= {k[1] for k in keys}
              and min(launches.values()) > 0 and held == n
              and not any(out["cpu"][2].values()))
        emit("mesh", card=card, data="fixture_pe", n=n, devices="cuda:0",
             variants=len(keys), types=sorted({k[1] for k in keys}),
             equal_to_cpu=keys == out["cpu"][0] and planes_cpu,
             equal_to_single_device=keys == want_pe, launches=launches,
             dispatches_held_to_plain=held, max_abs_err=errs)
        if not ok:
            raise AssertionError(f"mesh pe n={n}: differs from the CPU or "
                                 f"the single-device run, or a kernel did "
                                 f"not run")
    return launches


def torch_equal_cpu(a, b):
    import torch
    return bool(torch.equal(a.cpu(), b.cpu()))


def main_mesh_reads(r1, r2):
    """The main data's pairs as the parser hands them on: mate 1, then
    mate 2 reverse-complemented, interleaved -> the reads' codes."""
    from mapcaller_tpu_torch.dna import encode, revcomp_codes
    from mapcaller_tpu_torch.io.fastq import iter_reads
    seqs = []
    for a, b in zip(iter_reads(r1), iter_reads(r2)):
        seqs.append(encode(a.seq))
        seqs.append(revcomp_codes(encode(b.seq)))
    return seqs


def vcf_records(text):
    """The record lines of a VCF, each without its RC (the duplicate gate's
    per-start read count, profile.read_count, which the mesh's merge does
    not carry: the reference's merge leaves it zero)."""
    return [re.sub(r"RC=\d+;?", "", ln) for ln in text.splitlines()
            if not ln.startswith("#")]


def mesh_vcf(cfg, merged, variants):
    """The mesh's variants as the VCF writer writes them (io/vcf.py)."""
    from mapcaller_tpu_torch.io.vcf import write_variants
    f = io.StringIO()
    write_variants(f, cfg, merged.genome, merged.profile, merged.ref_chars,
                   variants)
    return f.getvalue()


def time_mesh_kernels(tap, card, n, L, reps=20):
    """K1 and K2 on the held inputs of the n-entry main-data run, on this
    card, each beside its plain version, its byte bound and PyTorch calls
    of the same function: K1's psum of phase A's three planes (library:
    torch.stack(parts).sum(0) a plane), K1's genome-sharded scan of every
    slice (one launch on one card; library: the stacked partials summed,
    then torch.cumsum, over the partials' length; torch.cumsum of the
    already-summed vector beside it), and K2 on entry 0's share of phase
    B."""
    import torch
    from mapcaller_tpu_torch.ops import mesh_kernels as mk
    dev = torch.device("cuda:0")
    cur = torch.cuda.current_stream(dev)
    psums = [p for kind, p, _, _ in tap.k1 if kind == "psum"][:3]
    scan_parts = next(p for kind, p, _, _ in tap.k1
                      if kind == "scatter_scan")
    per = -(-L // n)

    def psum():
        return [mk.dp_reduce(p) for p in psums]

    def scan():
        return mk.dp_scatter_scan(scan_parts, n, L, [dev] * n, [cur] * n)

    mk.STATS.reset()
    scan()
    scan_launches = mk.STATS.launches["dp_scatter_scan"]
    summed = torch.zeros(per * n, dtype=torch.int32, device=dev)
    summed[:L] = mk.dp_reduce_plain(scan_parts)[:L]
    before, pe, sign, source, _ = tap.k2[0]
    planes = mk.zero_planes(L, dev)
    pd, mmp, rlens, bits = before[3:]

    def apply():
        return mk.apply_bits(planes, pd, mmp, rlens, bits, pe, sign, source)

    out = {}
    for name, fn, plain, library, nbytes, ops in (
            ("psum", psum, lambda: [mk.dp_reduce_plain(p) for p in psums],
             lambda: [torch.stack(p).sum(0, dtype=torch.int32)
                      for p in psums],
             sum((len(p) + 1) * p[0].numel() * 4 for p in psums),
             sum(len(p) * p[0].numel() for p in psums)),
            ("scatter_scan", scan,
             lambda: mk.dp_scatter_scan_plain(scan_parts, n, L),
             lambda: torch.cumsum(torch.stack(scan_parts).sum(
                 0, dtype=torch.int32), 0, dtype=torch.int32),
             4 * (n * L + n * per), 2 * n * L),
            ("apply_bits", apply,
             lambda: mk.apply_bits_plain(mk.zero_planes(L, dev), pd, mmp,
                                         rlens, bits, pe, sign, source),
             None, None, None)):
        if nbytes is None:
            nbytes, ops, adm = k2_work(pd, mmp, bits, source)
            out["apply_reads"], out["apply_admitted"] = pd.shape[0], adm
        bound, by = bound_of(nbytes, ops)
        ms = cuda_ms(fn, reps, queued=True)
        out[name] = dict(ms=ms, call_ms=cuda_ms(fn, reps),
                         plain_ms=cuda_ms(plain, 3), bound_ms=bound,
                         bound_by=by, bytes=nbytes, share_of_bound=bound / ms,
                         library_ms=(cuda_ms(library, reps, queued=True)
                                     if library else None))
    out["scatter_scan"]["launches_a_call"] = scan_launches
    out["scatter_scan"]["torch_cumsum_ms"] = cuda_ms(
        lambda: torch.cumsum(summed, 0, dtype=torch.int32), reps, queued=True)
    out["scatter_scan"]["torch_cumsum_slice_ms"] = cuda_ms(
        lambda: torch.cumsum(summed[:per], 0, dtype=torch.int32), reps,
        queued=True)
    out["slice_elements"] = per
    emit("mesh", card=card, data="main", n=n, kernel_times=out)
    if scan_launches != 1:
        raise AssertionError(f"K1's scan on one card: {scan_launches} "
                             f"launches, expected 1")
    return out


def k2_work(pd, mmp, sel, source):
    """(bytes, int32 operations, admitted reads) of one K2 call on these
    inputs: pd, rlens, mmp and the admit words (a word a read for "meta")
    read once, and each plane word its updates touch read and written (4
    a read's span, 3 a mismatch), as run_evidence counts the apply."""
    import torch
    from mapcaller_tpu_torch.ops import mesh_kernels as mk
    B = pd.shape[0]
    adm = mk._admitted(sel, B, source, pd.device)
    n_adm = int(adm.sum())
    nmm = int(((mmp >= 0) & adm[:, None]).sum())
    updates = 4 * n_adm + 3 * nmm
    sel_bytes = 4 * (B if source == "meta" else -(-B // 32))
    return (24 * B + sel_bytes + 8 * updates, 40 * n_adm + 10 * nmm + 4 * B,
            n_adm)


def run_mesh_one_step(card, idx, cfg, mat, rlens, n_total, B, mesh,
                      full_records, hold=32):
    """The mesh's 1-step route on the main data at n = mesh.n: asked for
    with the full SA (one_step=True: seed_scan1_kernel and the hits
    kernel's gather), whose variant records must equal the occ3 run's
    (`full_records`), and taken for the index without its full SA (the
    hits kernel's inverse-Psi walk). Each route: a timed run (launches
    counted from 0, phase seconds) and a held run, every dispatch's 1-step
    scan and chain kernels (and the hits kernel's per-slot resolved flags)
    against their plain versions, max_abs_err 0. The walk's records are
    compared with the full-SA run's and reported (phase A, as the
    reference's, ignores the walk's resolved flag), and must equal the
    same walk's on n CPU devices, where the plain versions run. -> the
    walk run's launches."""
    import dataclasses
    from mapcaller_tpu_torch.ops import seed_scan_device as ssd
    from mapcaller_tpu_torch.parallel import mesh as tm
    n = mesh.n
    launches = None
    for route, index in (("one_step", idx),
                         ("walk", dataclasses.replace(idx, sa_full=None))):
        reset_mesh_launches()
        phase = {}
        t0 = time.time()
        v, merged, _ = tm.run_mesh_pe_pipeline(
            index, cfg, mat, rlens, n_total, n, max_len=MESH_MAX_LEN,
            mesh=mesh, times=phase, one_step=True)
        wall = time.time() - t0
        launches = {**mesh_launches(),
                    "seed_scan1": ssd.STATS.launches.get("seed_scan1", 0)}
        records = vcf_records(mesh_vcf(cfg, merged, v))
        differ = sorted(set(records) ^ set(full_records))
        del merged
        cpu = {}
        if route == "walk":
            # the same walk on n CPU devices (the plain versions): the
            # records the walk changes are the route's, not the kernels'
            t0 = time.time()
            vc, mc, _ = tm.run_mesh_pe_pipeline(
                index, cfg, mat, rlens, n_total, n, max_len=MESH_MAX_LEN,
                mesh=tm.make_mesh(n, devices=["cpu"] * n), one_step=True)
            cpu = dict(cpu_walk_s=time.time() - t0,
                       cpu_walk_records_equal=vcf_records(
                           mesh_vcf(cfg, mc, vc)) == records)
            del vc, mc
        with MeshTap(hold) as tap:
            v_held = tm.run_mesh_pe_pipeline(
                index, cfg, mat, rlens, n_total, n, max_len=MESH_MAX_LEN,
                mesh=mesh, one_step=True)[0]
        held, errs = tap.check(f"mesh main {route} n={n}", mesh, index,
                                  B)
        del tap
        held_same = ([mesh_key(x) for x in v_held]
                     == [mesh_key(x) for x in v])
        emit("mesh", card=card, data="main", route=route, n=n,
             devices="cuda:0", wall_s=wall, phase_seconds=phase,
             launches=launches, variants=len(v),
             vcf_records_equal_full_sa=not differ,
             vcf_records_differing=differ[:20],
             vcf_records_differing_count=len(differ),
             dispatches_held_to_plain=held, held_run_variants_equal=held_same,
             max_abs_err=errs, **cpu)
        if not (held == min(n, hold) and held_same
                and cpu.get("cpu_walk_records_equal", True)
                and launches["seed_scan1"] == n
                and launches["dp_scatter_scan"] == MESH_K1_LAUNCHES
                and launches["seed_scan3"] == 0
                and min(v_ for k, v_ in launches.items()
                        if k != "seed_scan3") > 0
                and set(errs.values()) == {0}
                and (route == "walk" or not differ)):
            raise AssertionError(f"mesh main {route} n={n}: a 1-step "
                                 f"dispatch not held or not run once an "
                                 f"entry, the occ3 scan ran, the full-SA "
                                 f"1-step records differ from the occ3 "
                                 f"run's, or the walk's differ from the "
                                 f"same walk on the CPU")
    return launches


def run_map_step(card, idx, mat, rlens, B, mesh, worst):
    """build_multichip_map_step (the reference's round-1 step) on the main
    data at n = mesh.n on one card, held: its two K1 calls (the coverage
    scan, one launch, and the psum of the hit counts) against their plain
    versions, and the coverage against the cumsum of the summed hit spans
    the plain scan gives. Updates `worst` with K1's largest difference.
    -> the step's launches."""
    from mapcaller_tpu_torch.parallel import mesh as tm
    n = mesh.n
    reset_mesh_launches()
    with MeshTap(0) as tap:
        cov, total = tm.build_multichip_map_step(idx, MESH_MAX_LEN, B, mesh)(
            tm.pack_reads(mat, MESH_MAX_LEN), rlens)
    launches = mesh_launches()
    _, errs = tap.check(f"mesh map step n={n}", mesh, idx, B)
    worst["dp_scatter_scan"] = max(worst["dp_scatter_scan"],
                                   errs["dp_scatter_scan"])
    emit("mesh", card=card, data="main", route="map_step", n=n,
         launches=launches, k1_calls=len(tap.k1), hits=int(total),
         coverage_slices=len(cov), max_abs_err=errs)
    if not (launches["dp_scatter_scan"] == 2 and len(tap.k1) == 2
            and errs["dp_scatter_scan"] == 0 and int(total) > 0):
        raise AssertionError(f"mesh map step n={n}: K1 not one scan and "
                             f"one psum, or not equal to its plain version")
    return launches


def run_mesh(card, cap, hold=32):
    """The mesh phase: parallel/mesh.py on the card. The dry-run fixtures
    at n = 2 and 8 (run_mesh_fixtures), then the main path's data
    (100,000 pairs on the 4.6 Mb genome) through run_mesh_pe_pipeline at
    max_len 128 on [cuda:0] * n for n = 1, 2 and 4: a timed run (launches
    counted from 0, phase seconds, peak memory; the variant records
    against the main path's VCF) and a held run (every K1 and K2 call and
    the first `hold` dispatches against their plain versions; phase A's
    summed planes and stitched coverage the same at every n). -> (the
    kernel timings at n = 4, the launches of every mesh run by name)."""
    import torch
    from mapcaller_tpu_torch import cli
    from mapcaller_tpu_torch.index.fmindex import load_index
    from mapcaller_tpu_torch.parallel import mesh as tm
    path_launches = {"mesh_fixture_pe_8": run_mesh_fixtures(card)}
    idx = load_index(cap["main_index"])
    cfg = cli.parse_args(cap["main_argv"])
    L = idx.genome_size
    _, r1, r2 = cap["main_files"]
    seqs = main_mesh_reads(r1, r2)
    main_records = vcf_records(cap["main_vcf"].decode())
    first = times = None
    worst = dict.fromkeys(MESH_KERNELS, 0)
    for n in (1, 2, 4):
        mat, rlens, B = mesh_layout(seqs, n, MESH_MAX_LEN, 2)
        mesh = tm.make_mesh(n, devices=["cuda:0"] * n)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_mesh_launches()
        phase = {}
        t0 = time.time()
        v, merged, _ = tm.run_mesh_pe_pipeline(
            idx, cfg, mat, rlens, len(seqs), n, max_len=MESH_MAX_LEN,
            mesh=mesh, times=phase)
        wall = time.time() - t0
        launches = mesh_launches()
        peak = torch.cuda.max_memory_allocated()
        records = vcf_records(mesh_vcf(cfg, merged, v))
        differ = sorted(set(records) ^ set(main_records))
        with MeshTap(hold) as tap:
            v_held = tm.run_mesh_pe_pipeline(
                idx, cfg, mat, rlens, len(seqs), n, max_len=MESH_MAX_LEN,
                mesh=mesh)[0]
        held_same = [mesh_key(x) for x in v_held] == [mesh_key(x) for x in v]
        held, errs = tap.check(f"mesh main n={n}", mesh, idx, B)
        for k in MESH_KERNELS:
            worst[k] = max(worst[k], errs[k])
        planes = [o[0] for kind, _, _, o in tap.k1 if kind == "psum"][:3]
        cov = torch.cat(next(o for kind, _, _, o in tap.k1
                             if kind == "scatter_scan"))[:L]
        stitched = torch.equal(cov, torch.cumsum(planes[0][:L], 0,
                                                 dtype=torch.int32))
        if first is None:
            first = (planes, cov)
        same_as_n1 = (all(torch.equal(a, b) for a, b in zip(planes, first[0]))
                      and torch.equal(cov, first[1]))
        path_launches[f"mesh_main_{n}"] = launches
        if n == 2:
            path_launches["mesh_main_walk_2"] = run_mesh_one_step(
                card, idx, cfg, mat, rlens, len(seqs), B, mesh, records)
        emit("mesh", card=card, data="main", n=n, devices="cuda:0",
             reads=len(seqs), per_device_batch=B, wall_s=wall,
             phase_seconds=phase, launches=launches, peak_bytes=peak,
             variants=len(v), vcf_records_main_path=len(main_records),
             vcf_records_equal_main_path=not differ,
             vcf_records_differing=differ[:20],
             vcf_records_differing_count=len(differ),
             phase_a_planes_and_coverage_equal_n1=same_as_n1,
             coverage_stitched=stitched, dispatches_held_to_plain=held,
             held_run_variants_equal=held_same, max_abs_err=errs)
        if not (same_as_n1 and stitched and held_same
                and held == min(n, hold)
                and launches["seed_scan3"] == n
                and launches["dp_scatter_scan"] == MESH_K1_LAUNCHES
                and min(launches.values()) > 0):
            raise AssertionError(f"mesh main n={n}: phase A's planes or "
                                 f"coverage differ from n=1's or do not "
                                 f"stitch, the held run's variants differ, "
                                 f"K1 did not launch {MESH_K1_LAUNCHES} "
                                 f"times, or a kernel of the path did not "
                                 f"run")
        if n == 4:
            times = time_mesh_kernels(tap, card, n, L)
            del tap
            path_launches["mesh_map_step_4"] = run_map_step(
                card, idx, mat, rlens, B, mesh, worst)
        else:
            del tap
    times["max_abs_err"] = worst
    return times, path_launches


def main():
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device visible; this smoke "
                         "run needs an NVIDIA card\n")
        return 2
    sys.path.insert(0, HERE)
    from mapcaller_tpu_torch import toolchain
    from mapcaller_tpu_torch.ops import ksw2_device, nw_device

    card = card_line()
    print(card, flush=True)
    emit("env", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), python=sys.version.split()[0])

    t0 = time.time()
    outputs = toolchain.build_all()
    gated = ((("libnw.so", "nw_ops_kernel"), nw_device.KERNEL_MAX_CHUNK),
             (("libksw2.so", "ksw2_ops_kernel"), ksw2_device.KERNEL_MAX_CHUNK),
             (("libseed_scan.so", "seed_scan3_kernel"), 1),
             (("libseed_scan.so", "seed_scan3_routed_kernel"), 1),
             (("libseed_scan.so", "seed_scan3_big_kernel"), 1),
             (("libseed_scan.so", "seed_scan1_kernel"), 1),
             (("libchain.so", "chain_scan_kernel"), 1),
             (("libchain.so", "chain_hits_kernel"), 1),
             (("libchain.so", "chain_hits_routed_kernel"), 1),
             (("libchain.so", "chain_hits_big_kernel"), 1),
             (("libchain.so", "chain_classify_pack_kernel"), 1),
             (("libchain.so", "chain_classify_pack_big_kernel"), 1),
             (("libchain.so", "dp_scatter_scan_kernel"), 1),
             (("libchain.so", "evidence_apply_bits_kernel"), 1),
             (("libchain.so", "evidence_apply_slice_kernel"), 1),
             (("libchain.so", "host_merge_kernel"), 1),
             (("libcalling.so", "evidence_finalize_kernel"), 1),
             (("libcalling.so", "caller_scan_kernel"), 1),
             (("libcalling.so", "caller_fetch_kernel"), 1),
             (("libcalling.so", "nor_blocks_kernel"), 1),
             (("libcalling.so", "caller_fetch_slice_kernel"), 1),
             (("libcalling.so", "nor_blocks_slice_kernel"), 1))
    reports = {kernel: ptxas_report(outputs.get(lib, ""), kernel)
               for (lib, kernel), _ in gated}
    # ksw2 takes all its shared memory dynamically (ptxas reports 0):
    # each tier's geometry and the pairs an SM holds at it
    ksw2_geo = {}
    for tier in TIERS:
        geo = ksw2_device.ksw2_geometry(tier, tier)
        ksw2_geo[str(tier)] = dict(
            zip(("chunk", "pairs_a_block", "smem_bytes"), geo),
            pairs_an_sm=ksw2_device.ksw2_resident_pairs(*geo))
    emit("build", seconds=time.time() - t0,
         nvcc=" ".join(toolchain.NVCC_FLAGS),
         libs=sorted(os.listdir(toolchain.BUILD_DIR)),
         ksw2_geometry=ksw2_geo, **reports)
    for (lib, kernel), n in gated:
        rep = reports[kernel]
        if len(rep) != n or any(
                v.get("registers") is None or v.get("stack_frame_bytes", 1)
                or v.get("spill_store_bytes", 1)
                or v.get("spill_load_bytes", 1) for v in rep.values()):
            sys.stderr.write(outputs.get(lib, ""))
            raise AssertionError(f"{kernel}: a stack frame or spills in "
                                 f"ptxas's report, or no report for a chunk")
    # the seed scans keep the registers of their measured forms (PERF.md)
    for kernel, regs in SCAN_REGISTERS.items():
        got = [v.get("registers") for v in reports[kernel].values()]
        if got != [regs]:
            raise AssertionError(f"{kernel}: {got} registers, expected "
                                 f"{regs}")
    # classify+pack's folded apply is the device function K2 shares: its
    # registers stay those of the parent tree
    got = [v.get("registers")
           for v in reports["chain_classify_pack_kernel"].values()]
    emit("build", chain_classify_pack_kernel_registers=got,
         parent_registers=CLASSIFY_PACK_REGISTERS)
    if got != [CLASSIFY_PACK_REGISTERS]:
        raise AssertionError(f"chain_classify_pack_kernel: {got} registers, "
                             f"expected {CLASSIFY_PACK_REGISTERS}")
    # K2's main instantiation keeps its registers beside its slice form
    got = [v.get("registers")
           for v in reports["evidence_apply_bits_kernel"].values()]
    if got != [K2_REGISTERS]:
        raise AssertionError(f"evidence_apply_bits_kernel: {got} registers, "
                             f"expected {K2_REGISTERS}")
    # the NOR blocks keep the registers they were measured at (PERF.md)
    got = {k: [v.get("registers") for v in reports[k].values()]
           for k in NOR_REGISTERS}
    emit("build", nor_registers=got, pinned=NOR_REGISTERS)
    if got != {k: [v] for k, v in NOR_REGISTERS.items()}:
        raise AssertionError(f"the NOR blocks: {got} registers, expected "
                             f"{NOR_REGISTERS}")

    for tier in TIERS:
        B = 4096 if tier < 192 else 2048
        r = check_nw(nw_device, B, tier, seed=tier, reps=50)
        emit("kernels", kernel="nw", card=card, **r)
        r = check_ksw2(ksw2_device, B, tier, seed=tier, reps=50)
        emit("kernels", kernel="ksw2", card=card, **r)
    # ksw2 past one wave: 8,192 pairs at tier 192
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    wave = sms * ksw2_geo["192"]["pairs_an_sm"]
    r = measure_ksw2(ksw2_device, ksw2_inputs(8192, 192, seed=8192), 20,
                     plain=False)
    if r["B"] <= wave:
        raise AssertionError(f"ksw2: 8,192 pairs fit one wave ({wave})")
    emit("kernels", kernel="ksw2", card=card, batch="multi-wave",
         pairs_a_wave=wave, waves=r["B"] / wave, **r)

    os.makedirs(toolchain.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=toolchain.BUILD_DIR) as work:
        run_small_e2e(work)
        launches, own, cap = run_main_path(work, card)
        path_launches = run_multihost(work, card, cap["main_files"])
        mesh_times, mesh_path = run_mesh(card, cap)
        path_launches.update(mesh_path)
        for k in ("main_files", "main_vcf"):
            cap.pop(k)
    k2_main_t, a5_merge = run_evidence(cap, card)
    calling_t = run_calling(cap, card, cap["calling_launches"])
    run_dp_rates({alg: cap["pairs_" + alg] for alg in ("nw", "ksw2")}, card)
    run_ksw2_launches(ksw2_device, cap["ksw2_all"], card)

    # the kernel table: each kernel on its main path's largest launch's
    # own pairs, and on random pairs at the same shape
    kernels = []
    for (name, mod, measure, inputs, src, replaces), n, args in zip(
            (("nw_ops", nw_device, measure_nw, nw_inputs,
              "mapcaller_tpu_torch/csrc/nw.cu",
              "mapcaller_tpu/ops/nw_device.py:136"),
             ("ksw2_ops", ksw2_device, measure_ksw2, ksw2_inputs,
              "mapcaller_tpu_torch/csrc/ksw2.cu",
              "mapcaller_tpu/ops/ksw2_device.py:49")),
            launches, own):
        B, M = args[0].shape
        r = measure(mod, args, reps=50)
        rnd = measure(mod, inputs(B, M, seed=1), reps=50)
        emit("kernels", kernel=name, card=card, pairs="main path's own", **r)
        emit("kernels", kernel=name, card=card, pairs="random", **rnd)
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": n,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None, "tolerance": 0,
            "call_ms": r["call_ms"], "share_of_bound": r["share_of_bound"],
            **({k: r[k] for k in ("floor_ms", "geometry") if k in r}),
            "shape": f"{B}x{M}x{r['N']}, the main path's own pairs of its "
                     f"largest launch; 'random' holds random pairs at that "
                     f"shape",
            "random": {k: rnd[k] for k in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by")}})
    # the scan kernels on their main path's own batch 0 (seed_scan phase)
    for name, src_line in (("seed_scan3", "mapcaller_tpu/ops/fm_search.py:55"),
                           ("seed_scan1",
                            "mapcaller_tpu/ops/fm_search.py:856")):
        r, n = cap["scan_table"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mapcaller_tpu_torch/csrc/seed_scan.cu",
            "replaces": src_line, "launches": n,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None, "tolerance": 0,
            "call_ms": r["call_ms"], "steps": r["steps"],
            "shape": f"{r['B']} reads x {4 * r['width']} bases (bucket), "
                     f"the main path's own batch 0"})
        if name == "seed_scan3":
            kernels[-1]["path_launches"] = multihost_launches(
                path_launches, name)
        else:
            kernels[-1]["path_launches"] = {
                "mesh_main_walk_2": path_launches["mesh_main_walk_2"][name]}
    # the chain kernels on the main path's own batch 0 (chain phase)
    chain, n = cap["chain_table"]
    b0 = chain["batch"]
    for name, src_line in (
            ("chain_scan_seeds", "mapcaller_tpu/ops/fm_search.py:713"),
            ("chain_scan", "mapcaller_tpu/ops/fm_search.py:752"),
            ("chain_hits", "mapcaller_tpu/ops/fm_search.py:704"),
            ("chain_classify_pack",
             "mapcaller_tpu/ops/chain_device.py:103")):
        r = chain[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mapcaller_tpu_torch/csrc/chain.cu",
            "replaces": src_line, "launches": n.get(name, 0),
            "max_abs_err": chain["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "tolerance": 0,
            "call_ms": r["call_ms"], "floor_ms": chain["floor_ms"],
            "shape": f"{b0['B']} reads, H {b0['H']}, H2 {b0['H2']}, the main "
                     f"path's own batch 0"})
        if name in SEED_CHAIN:
            kernels[-1]["path_launches"] = multihost_launches(
                path_launches, name)
    # classify+pack also replaces the pack and its cumsum
    kernels[-1]["also_replaces"] = ["mapcaller_tpu/ops/fm_search.py:749",
                                    "mapcaller_tpu/ops/fm_search.py:752"]
    # the routed instantiations on the first launch of the -shards 2 run
    # (shard 0 of the main path's batch 0: B / 2 reads), with the -shards 4
    # run's first launch beside; launches of the -shards 2 run
    routed, chain_n, scan_n = cap["routed_table"]
    for name, src, src_line, n in (
            ("seed_scan3_routed", "mapcaller_tpu_torch/csrc/seed_scan.cu",
             "mapcaller_tpu/parallel/sharded_index.py:115", scan_n),
            ("chain_hits_routed", "mapcaller_tpu_torch/csrc/chain.cu",
             "mapcaller_tpu/parallel/sharded_index.py:176", chain_n)):
        r = routed[2][name]
        gap = (("launches_a_run", "gap_ms_a_run") if "gap_ms_a_run" in r
               else ())
        regs = next(iter(reports[name + "_kernel"].values()))
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": src_line, "launches": n.get(name, 0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None, "tolerance": 0,
            "call_ms": r["call_ms"], "unrouted_ms": r["unrouted_ms"],
            "registers": regs.get("registers"), **{k: r[k] for k in gap},
            "shards_4": {k: routed[4][name][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "unrouted_ms",
                *gap)},
            "shape": f"{routed[2]['reads']} reads, shard 0 of the main "
                     f"path's batch 0 under -shards 2 on one card, as the "
                     f"run launched it; shards_4: {routed[4]['reads']} "
                     f"reads under -shards 4"})
    # the 64-bit kernels of the x64 path on the first launch of the
    # big_x64 -shards 2 run (shard 0 of batch 0), as the run launched them,
    # with their 32-bit routed forms on the same reads; launches of that run
    big, big_n = cap["big_table"]
    for name, src, src_line in (
            ("seed_scan3_big", "mapcaller_tpu_torch/csrc/seed_scan.cu",
             "mapcaller_tpu/parallel/big_index.py:73"),
            ("chain_hits_big", "mapcaller_tpu_torch/csrc/chain.cu",
             "mapcaller_tpu/parallel/big_index.py:97"),
            ("chain_classify_pack_big", "mapcaller_tpu_torch/csrc/chain.cu",
             "mapcaller_tpu/parallel/big_index.py:273")):
        r = big[name]
        regs = next(iter(reports[name + "_kernel"].values()))
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": src_line, "launches": big_n.get(name, 0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None, "tolerance": 0,
            "call_ms": r["call_ms"], "registers": regs.get("registers"),
            "spill_bytes": regs.get("spill_store_bytes", 0)
            + regs.get("spill_load_bytes", 0),
            "int32_form_ms": r.get("routed32_ms", r.get("int32_form_ms")),
            **{k: r[k] for k in ("unrouted_ms", "launches_a_run",
                                 "gap_ms_a_run") if k in r},
            **({"shards_4": {k: r["shards_4"][k] for k in (
                "B", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "routed32_ms", "unrouted_ms", "launches_a_run",
                "gap_ms_a_run")}} if "shards_4" in r else {}),
            "shape": f"{r['B']} reads, shard 0 of the main path's batch 0 "
                     f"under big_x64 -shards 2 on one card, as the run "
                     f"launched it; int32_form_ms: the 32-bit routed form "
                     f"on the same reads; unrouted_ms: the unrouted scan on "
                     f"the same rows; shards_4: the scan on shard 0 of "
                     f"batch 0 under -shards 4"})
    # K1 and K2 on the held inputs of the main data's mesh run at n = 4 on
    # [cuda:0] * 4 (launches of that run, and of every mesh run); K2 also
    # on the main path's batch 0 (run_evidence) with its launches a
    # main-path run (the warm-up's)
    mesh_n = path_launches["mesh_main_4"]
    scan_t, psum_t, apply_t = (mesh_times[k] for k in (
        "scatter_scan", "psum", "apply_bits"))
    k2_main = cap["k2_main"]
    k2_errs = (k2_main["max_abs_err"], k2_main_t["correct_max_abs_err"],
               k2_main_t["undo_max_abs_err"])
    for name, r, src_line, extra, shape in (
            ("dp_scatter_scan", scan_t, "mapcaller_tpu/parallel/mesh.py:165",
             {"also_replaces": ["mapcaller_tpu/parallel/mesh.py:171",
                                "mapcaller_tpu/parallel/mesh.py:451"],
              "launches_a_scan": scan_t["launches_a_call"],
              "psum": psum_t,
              "torch_cumsum_ms": scan_t["torch_cumsum_ms"],
              "torch_cumsum_slice_ms": scan_t["torch_cumsum_slice_ms"]},
             f"the genome-sharded coverage of phase A at n = 4 on one card: "
             f"4 partials of {mesh_times['slice_elements'] * 4} elements, 4 "
             f"slices of {mesh_times['slice_elements']}, one launch; "
             f"library_ms: torch.cumsum of torch.stack(parts).sum(0) (the "
             f"same function); torch_cumsum_ms: torch.cumsum of the "
             f"already-summed vector; psum: phase A's three planes summed "
             f"(three launches), its library_ms torch.stack(parts).sum(0) a "
             f"plane"),
            ("evidence_apply_bits", apply_t,
             "mapcaller_tpu/parallel/mesh.py:211",
             {"also_replaces": [
                 "mapcaller_tpu/pipeline/device_profile.py:67",
                 "mapcaller_tpu/pipeline/device_profile.py:103"],
              "floor_ms": k2_main_t["floor_ms"],
              "main_path": {**k2_main_t, **k2_main}},
             f"entry 0's share of phase B at n = 4: "
             f"{mesh_times['apply_reads']} reads, "
             f"{mesh_times['apply_admitted']} admitted; main_path: the "
             f"apply of the main path's batch 0 "
             f"({k2_main_t['reads']} reads, {k2_main_t['admitted']} "
             f"admitted), its launches a main-path run, its held calls "
             f"(warm-up, folded, -devices 2, -shards 2 and 4), the eager "
             f"scatter's calls on the card, and a sparse correction and "
             f"the dense undo on batch 0 (correct_*, undo_*); floor_ms: an "
             f"empty launch")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mapcaller_tpu_torch/csrc/chain.cu",
            "replaces": src_line, "launches": mesh_n[name],
            "max_abs_err": max([mesh_times["max_abs_err"][name], *(
                k2_errs if name == "evidence_apply_bits" else ())]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "tolerance": 0,
            "call_ms": r["call_ms"], "shape": shape, **extra,
            "path_launches": {k: v[name] for k, v in path_launches.items()
                              if k.startswith("mesh")}})
    # the calling kernels on the main path's own planes (run_calling),
    # with their launches a main-path run; the NOR blocks on a -gvcf run's
    # own call, with that run's launches; B4's fold and scan a shard under
    # big_x64 -shards 2 and 4 (big phase)
    calling_t["nor_blocks"] = cap["nor_row"]
    b4 = cap["b4"]
    for name, src_line, also, shape in (
            ("evidence_finalize",
             "mapcaller_tpu/pipeline/device_profile.py:169",
             ["mapcaller_tpu/pipeline/device_profile.py:308",
              "mapcaller_tpu/pipeline/big_profile.py:291"],
             f"the warm-up's planes, L {cap['L']}, codes from the text "
             f"words"),
            ("caller_scan", "mapcaller_tpu/calling/scan_device.py:94",
             ["mapcaller_tpu/pipeline/big_profile.py:363"],
             f"the warm-up's finalized planes, L {cap['L']}"),
            ("caller_fetch", "mapcaller_tpu/calling/scan_device.py:180", [],
             "the warm-up's first column fetch, its positions' block "
             "depths in the same buffer"),
            ("nor_blocks", "mapcaller_tpu/calling/scan_device.py:255", [],
             "a -gvcf run's own call (nor_blocks_kernel, one launch)")):
        r = calling_t[name]
        regs = next(iter(reports[name + "_kernel"].values()))
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mapcaller_tpu_torch/csrc/calling.cu",
            "replaces": src_line, "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None, "tolerance": 0,
            "call_ms": r["call_ms"], "registers": regs.get("registers"),
            "also_replaces": also, "shape": shape,
            **{k: r[k] for k in ("bytes_per_s", "geometry", "floor_ms")
               if k in r},
            **({"b4_a_shard": {
                f"shards_{n}": dict(b4[n]["fold" if name == "evidence_finalize"
                                       else "scan"],
                                    launches=b4[n]["launches"].get(name, 0))
                for n in (2, 4)}}
               if name in ("evidence_finalize", "caller_scan") else {})})
    # the slice forms of the x64 path's evidence programs (big phase): B4's
    # apply, merge and fetch a shard under big_x64 -shards 2 (shards_4
    # beside), the NOR on the -gvcf -shards 2 call; launches of those runs;
    # the merge also as A5's single-card form on seeded deltas (evidence
    # phase), beside its own four index_add_; the B4 row's library call
    # is the parent merge's index_add_ on the run's own lists
    for name, key, src, src_line, also, shape in (
            ("evidence_apply_slice", "apply",
             "mapcaller_tpu_torch/csrc/chain.cu",
             "mapcaller_tpu/pipeline/big_profile.py:103", [],
             "K2's slice form: the big_x64 -shards 2 run's first batch, a "
             "launch a shard; ms and plain_ms a launch"),
            ("host_merge", "merge", "mapcaller_tpu_torch/csrc/chain.cu",
             "mapcaller_tpu/pipeline/big_profile.py:189",
             ["mapcaller_tpu/pipeline/device_profile.py:136"],
             "B4: the big_x64 -shards 2 run's slow-read deltas, one launch "
             "over both shards (a segment a shard, list and row); ms, "
             "plain_ms, bound_ms and library_ms (the run's own lists' "
             "index_add_, four a shard) a call, sector_bound_ms beside; "
             "a5: the single-card form on deltas at 1% of the main path's "
             "planes, seeded, with its own library_ms"),
            ("caller_fetch_slice", "fetch",
             "mapcaller_tpu_torch/csrc/calling.cu",
             "mapcaller_tpu/pipeline/big_profile.py:532", [],
             "the big_x64 -shards 2 run's first fetch with its positions' "
             "block depths, one launch over both shards, elements in the "
             "caller's order; ms and plain_ms a call; call_parts: the "
             "call's host parts, parent (a launch a shard) and change"),
            ("nor_blocks_slice", "nor", "mapcaller_tpu_torch/csrc/calling.cu",
             "mapcaller_tpu/pipeline/big_profile.py:603", [],
             "the -gvcf big_x64 -shards 2 run's own call, a launch a shard "
             "(nor_blocks_slice_kernel); ms and plain_ms a launch")):
        rs = {n: (b4["nor_shards_2"] if key == "nor" else b4[n].get(key))
              for n in (2, 4)}
        r = rs[2]
        launches = (r["launches"] if key == "nor" else
                    b4[2]["evidence_launches" if key in ("apply", "merge")
                          else "launches"].get(name, 0))
        if r is None or not launches:
            raise AssertionError(f"{name}: not launched on its path")
        per = r["launches_a_call"]
        regs = next(iter(reports[name + "_kernel"].values()))
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": src_line, "launches": launches,
            "max_abs_err": max(x["max_abs_err"] for x in rs.values()
                               if x is not None),
            "ms": r["device_ms"] / per, "plain_ms": r["plain_ms"] / per,
            "bound_ms": r["bound_ms"] / per, "bound_by": r["bound_by"],
            "library_ms": r["library_ms"] / per if key == "merge" else None,
            "tolerance": 0, "call_ms": r["call_ms"],
            "registers": regs.get("registers"), "also_replaces": also,
            "shape": shape, "shards_2": r,
            **({"shards_4": rs[4]} if key != "nor" else {}),
            **({"a5": a5_merge} if key == "merge" else {}),
            **({k: r[k] for k in ("sector_bound_ms", "sector_bytes")
                if k in r}),
            **({"one_kernel_a_call": b4["one_kernel_a_call"]}
               if key in ("merge", "fetch") else {})})
    line = {"kernels": kernels}
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(multihost_child(sys.argv[2])
             if sys.argv[1:2] == ["--multihost-child"] else main())
