"""Multi-chip mapping + calling over a device list, in one process: the
PyTorch port of mapcaller_tpu/parallel/mesh.py, the single-host form of
the multi-host deployment (parallel/multihost.py).

The reference shard_maps the production device stages over a `dp` mesh
axis and reduces over ICI. Here:

  * a Mesh is a list of devices: the first n cards, an explicit list
    with repeats ([cuda:0] * n on one card) or n CPU devices; each entry
    issues on a CUDA stream of its own, as the replicas of `-devices N`
    do, and the index tables are placed once per distinct device;
  * read batches are split over the entries, and each entry runs the
    main path's seed + chain kernels on its share (phase A): the occ3
    seed scan without prefix skip (ops/seed_scan_device.seed_scan3 on a
    DeviceFM3 built with pfx_k 0), or, when the caller asks for the 1-step
    route or the index keeps no full SA, the 1-step scan over the occ4
    rows (seed_scan1, has_n False: the reference's DeviceFMIndex branch);
    the hit expansion and SA resolve (by the inverse-Psi walk without a
    full SA) with H = hits_per_read * B (ops/chain_kernels
    chain_scan_seeds, chain_hits; hits past H are dropped, with no tier
    rerun), then
    chain_classify_pack with H2 = H, whose folded apply adds the FAST
    reads' evidence to freshly zeroed planes in single-end orientation:
    phase A's evidence partials (mesh.py:126-160 is
    ops/evidence.scatter_fast_evidence with b_first True);
  * the collectives are kernels on the card, not torch.distributed
    (ops/mesh_kernels.py): dp_reduce is the psum, dp_scatter_scan the
    genome-sharded coverage scan (psum_scatter, an all_gather of slice
    totals, cumsum); partials on other cards are read as peer memory;
  * results the reference replicates (P()) live on the first device;
    per-read outputs come back in device order, on the first device;
    the coverage slices stay on their devices;
  * SLOW reads go through a per-shard C++ host pipeline in ops mode,
    whose admit bitmasks drive phase B's evidence (ops/mesh_kernels.
    apply_bits), summed by dp_reduce; the merge and the caller are the
    reference's host code.

Each share is padded inside to a multiple of 32 reads (classify+pack's
tile of warps) with reads of length 0: such a read has no seed and no
hit, is NOCAND and adds no evidence, and the padding is cut off before
anything is returned.
"""
from __future__ import annotations

import collections
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..ops.chain_device import ChainCtx
from ..ops.chain_kernels import (chain_classify_pack, chain_hits,
                                 chain_scan_seeds)
from ..ops.device_util import device_list, issue_on, need, upload
from ..ops.fm3_device import DeviceFM3
from ..ops.fm_device import DeviceFMIndex
from ..ops.fm_search import MIN_SEED_LEN
from ..ops.mesh_kernels import (apply_bits, dp_reduce, dp_scatter_scan,
                                zero_planes)
from ..ops.routed import enable_peer_access
from ..ops.seed_scan_device import seed_scan1, seed_scan3

# phase A of build_multichip_pipeline. Per read, in device order, on the
# first device: cls, pd, mm, rplast, cscore int32[BG], mmp int32[BG, 4]
# (mm and rplast from classify+pack's meta word, as the main path reads
# them: exact wherever mm < 64, so on every read the host reads them of),
# slow_counts int32[BG] (each SLOW read's kept hits); per device, on it:
# slow_w and slow_loc int32[H] (the pack's rpos << 9 | len and position
# of the SLOW reads' kept hits, the first sum(slow_counts of the device)
# in read order, then hit order); the psum'd planes exact int32[L+2], fd
# [4, L+2], acgt [4, L+1] on the first device; cov_shard: slice i of the
# genome-sharded coverage, int32[Gp / n], on device i.
PhaseA = collections.namedtuple(
    "PhaseA", "cls pd mm rplast cscore mmp slow_counts slow_w slow_loc "
              "exact fd acgt cov_shard")


class Mesh:
    """A device list with a stream an entry; see make_mesh."""

    def __init__(self, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        self.streams = [torch.cuda.Stream(device=d) if d.type == "cuda"
                        else None for d in self.devices]
        self._tables: Dict[tuple, tuple] = {}
        enable_peer_access(self.devices)

    @property
    def n(self) -> int:
        return len(self.devices)

    def on(self, i: int):
        """Entry i's stream (and so its device) for the calls inside."""
        return issue_on(self.devices[i], self.streams[i])

    def tables(self, what: str, source, build) -> dict:
        """{device: build(device)} over the distinct devices, built once
        a mesh for each `what` of each host object `source` the tables
        are made from (kept here while its tables are)."""
        key = (what, id(source))
        if key not in self._tables:
            tabs = {}
            for d in dict.fromkeys(self.devices):
                with issue_on(d):
                    tabs[d] = build(d)
            self._tables[key] = (source, tabs)
        return self._tables[key][1]

    def chain_ctx(self, idx) -> dict:
        """{device: the chain context of idx's genome text}, built once a
        mesh for every index of that text (whatever SA it keeps: the
        context does not read it)."""
        return self.tables("ctx", idx.ref, lambda d: ChainCtx.from_host(
            idx, device=d))

    def begin(self) -> None:
        """Each entry's stream waits for the work queued so far on its
        device's current stream (where the caller's inputs were made)."""
        for d, s in zip(self.devices, self.streams):
            if s is not None:
                s.wait_stream(torch.cuda.current_stream(d))

    def join(self, tensors=()) -> None:
        """Every device's current stream waits for every entry's stream
        on the same device, and `tensors` (made on the entries' streams)
        keep their memory until that work ends."""
        for d in dict.fromkeys(self.devices):
            if d.type != "cuda":
                continue
            cur = torch.cuda.current_stream(d)
            for s in self.streams:
                if s.device == d:
                    cur.wait_stream(s)
            for t in tensors:
                if t.device == d:
                    t.record_stream(cur)


def make_mesh(n_devices: int, devices: Optional[Sequence] = None,
              device="cuda") -> Mesh:
    """A Mesh of n entries (ops/device_util.device_list): the explicit
    `devices` when given (repeats allowed), else on "cuda" the first n
    visible cards, raising when fewer are visible, and on "cpu" n CPU
    devices. It never moves to the CPU on its own."""
    return Mesh(device_list(device, n_devices, devices, flag="mesh"))


def _host(a, dtype) -> torch.Tensor:
    """A host array or tensor as a contiguous CPU tensor of `dtype`."""
    t = torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a)
    return t.to("cpu", dtype).contiguous()


def _padded(t: torch.Tensor, rows: int, device) -> torch.Tensor:
    """t's rows, zero rows after them up to `rows`, on `device` (through
    pinned memory on the card: ops/device_util.upload)."""
    out = torch.zeros((rows,) + tuple(t.shape[1:]), dtype=t.dtype)
    out[:t.shape[0]] = t
    return upload(out.numpy(), device)


def _shapes(max_len: int, B: int, hits_per_read: int):
    """(B padded to 32, H, seed slots a read) of an entry's share."""
    return (-(-B // 32) * 32, B * hits_per_read,
            max_len // (MIN_SEED_LEN + 1) + 2)


def _fm1_tables(idx, mesh: Mesh) -> dict:
    """The 1-step index of `idx` (its full SA when it keeps one) once per
    distinct device of the mesh."""
    return mesh.tables("fm1", idx, lambda d: DeviceFMIndex.from_host(
        idx, device=d))


def build_multichip_pipeline(idx, max_len: int, per_device_batch: int,
                             mesh: Mesh, hits_per_read: int = 8,
                             one_step: bool = False):
    """The production device pipeline over the mesh (phase A).

    -> step(packed uint8[n * B, max_len / 4], rlens int32[n * B]) ->
    PhaseA, with B = per_device_batch reads an entry (entry i takes reads
    [i * B, (i + 1) * B)). The tables, once per distinct device: the occ3
    index without prefix rows, or with one_step (forced when `idx` keeps
    no full SA) the 1-step index, and the chain context of `idx`. The
    reference picks the route by the type of the index it is given
    (mapcaller_tpu/parallel/mesh.py:86-92); here the argument says it."""
    n, L, B = mesh.n, idx.genome_size, per_device_batch
    need(B >= 1 and max_len % 16 == 0, "mesh: B >= 1 and max_len a "
                                       "multiple of 16")
    B32, H, max_seeds = _shapes(max_len, B, hits_per_read)
    one_step = one_step or idx.sa_full is None
    fms = (_fm1_tables(idx, mesh) if one_step else
           mesh.tables("fm3", idx, lambda d: DeviceFM3.from_host(
               idx, pfx_k=0, device=d)))
    ctxs = mesh.chain_ctx(idx)

    def shard(i: int, packed, rlens):
        d = mesh.devices[i]
        fm, ctx = fms[d], ctxs[d]
        pk = _padded(packed[i * B:(i + 1) * B], B32, d)
        rl = _padded(rlens[i * B:(i + 1) * B], B32, d)
        if one_step:
            seeds = seed_scan1(fm, pk, rl, max_len, max_seeds, has_n=False)
        else:
            seeds = seed_scan3(fm, pk, rl, max_len, max_seeds)
            fm = fm.fm
        n_seeds, s_rpos, s_len, s_x0, s_freq, overflow = seeds
        scan = chain_scan_seeds(s_freq, n_seeds, H)
        hits = chain_hits(fm, scan, n_seeds, s_rpos, s_len, s_x0, s_freq, H)
        planes = zero_planes(L, d)
        out = torch.empty(2 * B32 + 2 * H + B32 // 2 + B32 // 32 + 2,
                          dtype=torch.int32, device=d)
        mmp = chain_classify_pack(ctx, pk, rl, scan.off, hits, overflow,
                                  max_len, out, H, planes, pair_end=False)
        return out, mmp, planes

    def step(packed, rlens) -> PhaseA:
        packed, rlens = _host(packed, torch.uint8), _host(rlens, torch.int32)
        need(packed.shape == (n * B, max_len // 4)
             and rlens.shape == (n * B,),
             f"mesh: packed uint8[{n * B}, {max_len // 4}] and rlens "
             f"int32[{n * B}] expected")
        mesh.begin()
        parts = []
        for i in range(n):
            with mesh.on(i):
                parts.append(shard(i, packed, rlens))
        outs, mmps, planes = zip(*parts)
        # the evidence partials: psum'd onto the first device, and the
        # exact diff's first L entries as the genome-sharded coverage
        reduced = [dp_reduce([getattr(p, f) for p in planes], mesh.streams)
                   for f in ("exact_diff", "f_diff", "acgt")]
        cov = dp_scatter_scan([p.exact_diff for p in planes], n, L,
                              mesh.devices, mesh.streams)
        mesh.join([*outs, *mmps, *cov])
        dev0 = mesh.devices[0]

        def cat(parts_):
            return torch.cat([p.to(dev0) for p in parts_])

        meta = cat(o[:B] for o in outs)
        c2 = cat(o[2 * B32 + 2 * H:2 * B32 + 2 * H + B32 // 2] for o in outs)
        counts = torch.stack([c2 & 0xFFFF, (c2 >> 16) & 0xFFFF], 1)
        counts = counts.reshape(n, B32)[:, :B].reshape(-1)
        return PhaseA(
            meta & 3, cat(o[B32:B32 + B] for o in outs), (meta >> 2) & 0x3F,
            (meta >> 8) & 0x1FF, (meta >> 17) & 0x1FF, cat(m[:B] for m in mmps),
            counts, [o[2 * B32:2 * B32 + H] for o in outs],
            [o[2 * B32 + H:2 * B32 + 2 * H] for o in outs], *reduced, cov)

    return step


def slow_hits(res: PhaseA, i: int, B: int):
    """Entry i's SLOW reads' kept hits from phase A's pack, grouped by
    read in read order (the reference's stable sort of the slow hits by
    read, mesh.py:349-356) -> (counts int32[B], rpos int32, gpos int64,
    len int32), numpy."""
    counts = res.slow_counts[i * B:(i + 1) * B].cpu().numpy()
    k = int(counts.sum())
    w = res.slow_w[i][:k].cpu().numpy()
    return (counts, (w >> 9) & 0x1FF,
            res.slow_loc[i][:k].cpu().numpy().astype(np.int64), w & 0x1FF)


def build_multichip_evidence(L: int, per_device_batch: int, mesh: Mesh,
                             pair_end: bool):
    """Phase-B evidence over the mesh: the host decides admission
    (unique-mapped + dup gate) and sends back a bitmask a shard; each
    entry adds its admitted FAST reads' evidence to zeroed planes
    (apply_bits), which dp_reduce sums onto the first device.

    -> fn(pd int32[n * B], mmp int32[n * B, 4], rlens int32[n * B],
    fast_bits int32[n, >= ceil(B / 32)]) -> (exact_diff int32[L+2],
    f_diff [4, L+2], acgt [4, L+1]) on the first device. Inputs on any
    device or the host; entry i's share goes to its device."""
    n, B = mesh.n, per_device_batch

    def fn(pd, mmp, rlens, fast_bits):
        mesh.begin()
        planes = []
        for i, d in enumerate(mesh.devices):
            with mesh.on(i):
                def mine(a, rows=slice(i * B, (i + 1) * B)):
                    t = a if torch.is_tensor(a) else torch.as_tensor(
                        np.asarray(a))
                    return t[rows].to(d, torch.int32).contiguous()
                p = zero_planes(L, d)
                apply_bits(p, mine(pd), mine(mmp), mine(rlens),
                           mine(fast_bits, i), pair_end)
                planes.append(p)
        out = [dp_reduce([getattr(p, f) for p in planes], mesh.streams)
               for f in ("exact_diff", "f_diff", "acgt")]
        mesh.join()
        return tuple(out)

    return fn


def build_multichip_map_step(idx, max_len: int, per_device_batch: int,
                             mesh: Mesh, hits_per_read: int = 8):
    """Seeding + exact-coverage reduction only (the reference's round-1
    step, superseded by build_multichip_pipeline): the 1-step seed scan
    (has_n False) on each entry's share, the hits with H = hits_per_read
    * B, the forward hits' span diff over G_pad = ceil(L / n) * n, the
    genome-sharded coverage (dp_scatter_scan) and the psum'd hit count.
    Hit positions come from the full SA when `idx` keeps one, else from
    the inverse-Psi walk; a hit counts when it is valid, resolved (the
    hits kernel's per-slot flag, the reference's sa_resolve flag) and
    inside the genome.

    -> step(packed uint8[n * B, max_len / 4], rlens int32[n * B]) ->
    (cov_shard: slice i int32[G_pad / n] on device i, n_hits int32 0-d on
    the first device)."""
    n, G, B = mesh.n, idx.genome_size, per_device_batch
    B32, H, max_seeds = _shapes(max_len, B, hits_per_read)
    Gp = -(-G // n) * n
    tabs = _fm1_tables(idx, mesh)

    def shard(i: int, packed, rlens):
        d = mesh.devices[i]
        fm = tabs[d]
        pk = _padded(packed[i * B:(i + 1) * B], B32, d)
        rl = _padded(rlens[i * B:(i + 1) * B], B32, d)
        n_seeds, s_rpos, s_len, s_x0, s_freq, _ = seed_scan1(
            fm, pk, rl, max_len, max_seeds, has_n=False)
        scan = chain_scan_seeds(s_freq, n_seeds, H)
        resolved = torch.empty(H, dtype=torch.bool, device=d)
        hits = chain_hits(fm, scan, n_seeds, s_rpos, s_len, s_x0, s_freq, H,
                          resolved=resolved)
        ok = resolved & (hits.loc < G)
        loc = hits.loc.to(torch.int64)
        start = torch.where(ok, loc, Gp)
        end = torch.where(ok, torch.clamp(loc + hits.len, max=G), Gp)
        one = torch.ones(H, dtype=torch.int32, device=d)
        diff = torch.zeros(Gp + 1, dtype=torch.int32, device=d)
        diff.index_add_(0, start, one).index_add_(0, end, -one)
        return diff[:Gp].contiguous(), ok.sum(dtype=torch.int32).reshape(1)

    def step(packed, rlens):
        packed, rlens = _host(packed, torch.uint8), _host(rlens, torch.int32)
        need(packed.shape == (n * B, max_len // 4)
             and rlens.shape == (n * B,),
             f"mesh: packed uint8[{n * B}, {max_len // 4}] and rlens "
             f"int32[{n * B}] expected")
        mesh.begin()
        parts = []
        for i in range(n):
            with mesh.on(i):
                parts.append(shard(i, packed, rlens))
        diffs, oks = zip(*parts)
        cov = dp_scatter_scan(list(diffs), n, Gp, mesh.devices,
                              mesh.streams)
        total = dp_reduce(list(oks), mesh.streams)
        mesh.join(cov)
        return cov, total[0]

    return step


def pack_reads(mat: np.ndarray, max_len: int) -> np.ndarray:
    """2-bit codes uint8[BG, >= max_len] -> uint8[BG, max_len / 4], base
    q of a byte at bits 2q."""
    packed = np.zeros((mat.shape[0], max_len // 4), dtype=np.uint8)
    for j in range(4):
        packed |= (mat[:, j::4][:, :max_len // 4] & 3) << (2 * j)
    return packed


def run_mesh_pe_pipeline(idx, cfg, mat: np.ndarray, rlens: np.ndarray,
                         n_total: int, n_devices: int, max_len: int = 80,
                         mesh: Optional[Mesh] = None,
                         times: Optional[dict] = None,
                         one_step: bool = False):
    """Mesh-orchestrated paired-end mapping + calling with the production
    C++ host path per shard (the admit-bitmask round trip):

      phase A  classify every read on the mesh (seed -> chain ->
               classify, the index on every device, reads split over the
               entries),
      host     each shard's C++ pipeline (ops mode) runs pairing /
               rescue / slow alignment / SAM semantics and decides
               admission (unique-mapped + PCR-dup gate); admit bitmasks
               come back per shard,
      phase B  fast-read evidence partials build on the mesh from the
               bitmasks and are summed,
      merge    device planes + per-shard host diff arrays + sparse
               indel maps reduce (cap-after-sum), then the caller runs
               once over the merged evidence.

    Reads must be laid out shard-major in `mat` (codes uint8[BG, >=
    max_len], mates interleaved with mate 2 as the parser hands it on,
    pairs on one shard). Note the per-shard dup gates and fragment
    estimates: up to n_devices * max_duplicate same-start reads can be
    admitted on duplicate-heavy data, as in the reference. The mesh is
    make_mesh(n_devices, device=cfg.device) unless one is given. one_step:
    phase A's 1-step route (build_multichip_pipeline; taken anyway when
    `idx` keeps no full SA). With `times`, the seconds of phase A, the
    host step, phase B and the merge go into it. Returns (variants,
    merged_engine, shard_engines)."""
    from ..calling.caller import cal_block_read_depth, identify_variants
    from ..dna import decode
    from ..pipeline.engine import MappingEngine
    from ..pipeline.profile import MAX_ALLELE_COUNT

    t0 = time.perf_counter()
    L = idx.genome_size
    if mesh is None:
        mesh = make_mesh(n_devices, device=cfg.device)
    need(mesh.n == n_devices, f"mesh of {mesh.n} entries, {n_devices} asked")
    BG = mat.shape[0]
    need(BG % n_devices == 0, "mesh: reads not a multiple of the entries")
    B = BG // n_devices

    stepA = build_multichip_pipeline(idx, max_len, B, mesh,
                                     one_step=one_step)
    res = stepA(pack_reads(mat, max_len), rlens)
    cls = res.cls.cpu().numpy()
    pd0_h = res.pd.cpu().numpy()
    mm_h = res.mm.cpu().numpy()
    rplast = res.rplast.cpu().numpy()
    cscore = res.cscore.cpu().numpy()
    t1 = time.perf_counter()

    # per-shard host pipeline (production C++ in ops mode)
    shard_bits = np.zeros((n_devices, (B + 31) // 32), dtype=np.int32)
    shard_engines = []
    for d in range(n_devices):
        eng = MappingEngine(idx, cfg, backend=None, use_native=True)
        eng.enable_diff_profile()
        eng.native.set_ops_mode(True)
        lo = d * B
        n_here = min(B, max(0, n_total - lo))
        fq = []
        for i in range(lo, lo + n_here):
            fq.append(f"@r{i}\n{decode(mat[i, :rlens[i]])}\n+\n"
                      f"{'I' * int(rlens[i])}\n")
        eng.native.set_input("".join(fq).encode(), None, False)
        nn, _ = eng.native.next_batch(0, B)
        need(nn == n_here, f"mesh: shard {d} parsed {nn} of {n_here} reads",
             RuntimeError)
        # seeds for slow reads of this shard, grouped by read
        counts, rp, gp, ln = slow_hits(res, d, B)
        counts[n_here:] = 0
        stats_io = np.zeros(6, dtype=np.int64)
        stats_io[5] = 1000
        sl = slice(lo, lo + B)
        eng.native.process_batch_cls(
            0, True, True, cls[sl], pd0_h[sl], mm_h[sl], rplast[sl],
            cscore[sl], counts, rp.astype(np.int32), gp,
            ln.astype(np.int32), stats_io)
        fb = eng.native.fetch_fast_bits()
        shard_bits[d, :fb.size] = fb.view(np.int32)
        shard_engines.append(eng)
    t2 = time.perf_counter()

    # phase B: mesh evidence from the admit bitmasks
    stepB = build_multichip_evidence(L, B, mesh, pair_end=True)
    exact, fd, acgt_dev = (t.cpu().numpy() for t in stepB(
        res.pd, res.mmp, rlens, shard_bits))
    t3 = time.perf_counter()

    # merge device planes + per-shard host diffs (cap-after-sum)
    ref_codes = idx.ref.ref_sequence_codes()
    exact_d = exact[:L + 1].astype(np.int64)
    fd_d = fd[:, :L + 1].astype(np.int64)
    acgt = acgt_dev[:, :L].astype(np.int64)
    multi_d = np.zeros(L + 1, dtype=np.int64)
    for eng in shard_engines:
        p = eng.profile
        exact_d += p.exact_diff
        multi_d += p.multi_diff
        for k, nm in enumerate(("F1_diff", "R2_diff", "F2_diff", "R1_diff")):
            fd_d[k] += getattr(p, nm)
        acgt += p.acgt
    exact_cov = np.cumsum(exact_d[:L])
    for c in range(4):
        acgt[c] += np.where(ref_codes[:L] == c, exact_cov, 0)
    np.minimum(acgt, MAX_ALLELE_COUNT, out=acgt)
    F = np.cumsum(fd_d[:, :L], axis=1)

    merged = MappingEngine(idx, cfg, backend=None, use_native=False)
    merged.profile.acgt = acgt.astype(np.int32)
    merged.profile.multi_hit[:] = np.minimum(
        np.cumsum(multi_d[:L]), MAX_ALLELE_COUNT).astype(np.int32)
    for nm, k in (("F1", 0), ("R2", 1), ("F2", 2), ("R1", 3)):
        getattr(merged.profile, nm)[:] = F[k].astype(np.int32)
    for eng in shard_engines:
        for src, dst in ((eng.profile.insert_map, merged.profile.insert_map),
                         (eng.profile.delete_map, merged.profile.delete_map)):
            for posk, inner in src.items():
                dd = dst.setdefault(posk, {})
                for seq, cnt in inner.items():
                    dd[seq] = dd.get(seq, 0) + cnt
    bd = cal_block_read_depth(merged.profile, L)
    variants = identify_variants(cfg, merged.genome, merged.profile,
                                 ref_codes, bd)
    if times is not None:
        times.update(phase_a_s=t1 - t0, host_s=t2 - t1, phase_b_s=t3 - t2,
                     merge_s=time.perf_counter() - t3)
    return variants, merged, shard_engines
