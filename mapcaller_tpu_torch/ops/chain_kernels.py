"""The once-a-batch stages of the seed + chain dispatch on the card: the
CUDA kernels `csrc/chain.cu` and their plain PyTorch versions.

After the seed scan, a batch's seed tables become the chain kernel's
packed output vector (ops/fm_search.SeedChainKernel) in three launches on
the current stream, with no host sync:

  chain_scan_seeds     the exclusive prefix sum of each read's raw hits
                       (the sum of its valid seeds' freq) and the total,
                       with the hits kernel's start index, and the
                       unresolved flags zeroed (SeedScan);
  chain_hits           the seeds expanded by freq into H flat hit slots
                       (as jnp.repeat with total_repeat_length: truncated
                       at H, padded with the last seed slot) and resolved
                       through the SA, or by the inverse-Psi walk without
                       a full SA;
  chain_classify_pack  each read's class, pd, mm, rplast, cscore and
                       leftmost mismatches from its own hit range (the
                       meta1 and pd entries of the packed vector), with the
                       folded speculative evidence apply when planes are
                       given; then the SLOW reads' kept hits compacted at
                       their offsets (the prefix of their counts found
                       inside the kernel), the count and overflow words
                       and the totals: the rest of the packed vector.

chain_scan is the same scan kernel on int32 counts, which the main path
no longer launches (its scan of the slow counts is inside
chain_classify_pack). chain_hits_routed is the hits kernel over a
genome-sharded SA (`-shards N`, parallel/sharded_index.py): the routed
instantiation of the same kernel body. chain_hits_big and
chain_classify_pack_big are the 64-bit instantiations of the x64
big-genome path (big_x64 under `-shards N`, parallel/big_index.py): hit
rows, hit locations and diagonals int64, the SA int64 in shards, and the
packed output's pd and hit locations in an int64 side vector.

Each wrapper checks its inputs, then runs the plain version for CPU
tensors and launches its kernel for CUDA tensors, counting the launch in
STATS, or raises. There is no fallback between the two. The plain
versions are the port's PyTorch code of these stages (ops/fm_device.
sa_resolve, ops/chain_device.classify_reads, ops/evidence.
scatter_fast_evidence, and the pack); chip_smoke.py holds each kernel
equal to its plain version on the card, in every element.
"""
from __future__ import annotations

import collections
import ctypes as C

import torch

from .chain_device import (CLASS_FAST, CLASS_SLOW, MM_SLOTS, ChainCtx,
                           classify_reads)
from .device_util import KernelStats, need
from .evidence import first_mate_lanes, scatter_fast_evidence
from .fm_device import DeviceFMIndex, sa_resolve, to_i32

MAX_WALK = 192      # inverse-Psi steps before a hit is left to the host
# csrc/chain.cu: reads a scan tile, seed slots a read the seed-freq scan
# takes, hit slots a hits block (one start-index group)
SCAN_THREADS = 384
SCAN_MAX_S = 31
HITS_GROUP = 256
# csrc/chain.cu: reads a classify+pack tile, hits a block stages at a time
CP_READS = 256
CP_HIT_CAP = 2048
_EPOCHS = 1 << 30   # the scan's status-word tags: 1 .. 2^30 - 1

# hit arrays of a batch: read, rpos, len, loc int32[H]; valid, keep bool[H]
# (keep: valid and PosDiff = loc - rpos > 0); unresolved bool[B]
Hits = collections.namedtuple("Hits", "read rpos len loc valid keep "
                                      "unresolved")
# the seed-freq scan: off int32[B+1] (each read's first hit, the total
# last); start int32[ceil(H / HITS_GROUP), 2]: for hit slot g * HITS_GROUP,
# the flat seed slot that owns it (B*S at or past the total) and the hits
# before that seed; unresolved bool[B], all False, for chain_hits to set
SeedScan = collections.namedtuple("SeedScan", "off start unresolved")

STATS = KernelStats()
_lib = None
# per (device, stream): [scratch int64[1 + tiles], the last epoch] of the
# look-back of the scan and of classify+pack (csrc/chain.cu): allocated
# once, grown when a batch needs more tiles, allocated zeroed anew when the
# epochs run out. Launches that share it run one after another on its
# stream; launches on another stream of the same device (a second replica
# of -devices on one card) get their own scratch and epochs.
_scan_scratch = {}


def _load_kernel():
    global _lib
    if _lib is None:
        from ..toolchain import ensure_cuda
        lib = C.CDLL(ensure_cuda("chain"))
        P, I = C.c_void_p, C.c_int
        for name, args in (
                ("mc_chain_scan", [P, P, P, I, I, P, P, I, P, P, I, I, P]),
                ("mc_chain_hits", [P] * 7 + [I, I] + [P] * 4
                 + [I, I, I] + [P] * 9),
                ("mc_chain_hits_routed", [P] * 7 + [I, I, P, I, P, P, I, P,
                                                    I, I, I, I] + [P] * 8),
                ("mc_chain_hits_big", [P] * 7 + [I, I, P, C.c_longlong, I]
                 + [P] * 8),
                ("mc_chain_classify_pack", [P] * 9 + [I] * 4
                 + [P, I, P, I, I] + [P] * 3 + [I, I] + [P] * 3
                 + [I, I, P]),
                ("mc_chain_classify_pack_big", [P] * 9 + [I] * 4
                 + [P, I, P, I, C.c_longlong] + [P] * 4 + [I, I, P]),
                # K1 and K2 (ops/mesh_kernels.py)
                ("mc_dp_scatter_scan", [P, I, I, I, I, P, I, I, P, I, I, P,
                                        P, I, I, P]),
                ("mc_evidence_apply_bits", [P] * 5 + [I] + [P] * 3
                 + [I] * 3 + [P]),
                # K2's slice form and the host merge (ops/mesh_kernels.py)
                ("mc_evidence_apply_slice", [P] * 4 + [I] + [P] * 3
                 + [C.c_longlong] * 3 + [I, P]),
                ("mc_host_merge", [P, P, P, I, P, I] + [C.c_longlong] * 4 + [P])):
            fn = getattr(lib, name)
            fn.restype = C.c_int
            fn.argtypes = args
        _lib = lib
    return _lib


def _launch(name: str, dev: torch.device, *args, count: str = "",
            stats: KernelStats = STATS) -> None:
    """One launch on dev's current stream, counted in `stats` under
    `count` (default: name); raises if CUDA refused it."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = getattr(_load_kernel(), "mc_" + name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed (error {err})")
    stats.launches[count or name] += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


def _on_card(name: str, tensors) -> bool:
    """True for CUDA tensors, False for CPU ones; refuses a mix of
    devices, non-contiguous inputs and any other device."""
    devs = {t.device for t in tensors}
    need(len(devs) == 1, f"{name}: tensors on several devices {devs}")
    need(all(t.is_contiguous() for t in tensors),
          f"{name}: inputs must be contiguous")
    dev = devs.pop()
    need(dev.type in ("cpu", "cuda"), f"{name}: unsupported device {dev}")
    return dev.type == "cuda"


def _dtype(name: str, t, dtype, what: str) -> None:
    need(t.dtype == dtype, f"{name}: {what} must be {dtype}", TypeError)


def _check_hits(name: str, hits: Hits, B: int, loc) -> int:
    H = hits.read.shape[0]
    for what in ("read", "rpos", "len"):
        _dtype(name, getattr(hits, what), torch.int32, f"hits.{what}")
    _dtype(name, hits.loc, loc, "hits.loc")
    for what in ("valid", "keep", "unresolved"):
        _dtype(name, getattr(hits, what), torch.bool, f"hits.{what}")
    need(H >= 1 and all(getattr(hits, w).shape == (H,) for w in
                         ("read", "rpos", "len", "loc", "valid", "keep")),
          f"{name}: hit arrays must be [H], H >= 1")
    need(hits.unresolved.shape == (B,), f"{name}: hits.unresolved must "
                                         f"be [B]")
    return H


def _check_off(name: str, off, B: int) -> None:
    _dtype(name, off, torch.int32, "off")
    need(off.shape == (B + 1,), f"{name}: off must be int32[B+1]")


# ---- chain_scan_seeds and chain_scan ---------------------------------------

def chain_scan_plain(counts: torch.Tensor, n_valid=None) -> torch.Tensor:
    """Plain version of the scan (chain_scan, and the off of
    chain_scan_seeds) on any device."""
    if counts.dim() == 2:
        counts = _flat_freqs(counts, n_valid).reshape(counts.shape).sum(dim=1)
    csum = torch.cumsum(counts.to(torch.int64), 0)
    return torch.cat([torch.zeros(1, dtype=torch.int64, device=csum.device),
                      csum]).to(torch.int32)


def _flat_freqs(s_freq: torch.Tensor, n_valid) -> torch.Tensor:
    """int64[B*S]: each seed slot's freq, 0 at or past the read's n_valid
    (none masked without n_valid)."""
    if n_valid is not None:
        S = s_freq.shape[1]
        valid = (torch.arange(S, dtype=torch.int64, device=s_freq.device)
                 [None, :] < n_valid[:, None])
        s_freq = torch.where(valid, s_freq, 0)
    return s_freq.reshape(-1)


def _n_groups(H: int) -> int:
    """Start-index groups of H hit slots: the hits kernel's blocks."""
    return -(-H // HITS_GROUP)


def chain_scan_seeds_plain(s_freq: torch.Tensor, n_seeds: torch.Tensor,
                           H: int) -> SeedScan:
    """Plain version of chain_scan_seeds on any device: the start index
    by torch.searchsorted over the flat cumsum, as chain_hits_plain
    expands."""
    B, S = s_freq.shape
    freqs = _flat_freqs(s_freq, n_seeds)
    csum_incl = torch.cumsum(freqs, 0)
    gpos = torch.arange(_n_groups(H), dtype=torch.int64,
                        device=s_freq.device) * HITS_GROUP
    seed = torch.searchsorted(csum_incl, gpos, right=True)
    before = torch.where(seed < B * S, (csum_incl - freqs)[
        torch.clamp(seed, max=B * S - 1)], csum_incl[-1])
    return SeedScan(chain_scan_plain(s_freq, n_seeds),
                    torch.stack([seed, before], 1).to(torch.int32),
                    torch.zeros(B, dtype=torch.bool, device=s_freq.device))


def _scratch_key(dev: torch.device):
    """The look-back scratch's key: the device and its current stream (0
    off the card)."""
    if dev.type != "cuda":
        return dev, 0
    return dev, torch.cuda.current_stream(dev).cuda_stream


def _look_back_scratch(dev: torch.device, tiles: int):
    """(pointer, status words, epoch) of the look-back scratch of the
    device's current stream for a launch of `tiles` tiles, with the next
    epoch."""
    key = _scratch_key(dev)
    sc = _scan_scratch.get(key)
    if sc is None or sc[0].shape[0] - 1 < tiles or sc[1] + 1 >= _EPOCHS:
        # zeroed words hold epoch 0, which no launch uses
        sc = _scan_scratch[key] = [torch.zeros(
            1 + max(tiles, 1024), dtype=torch.int64, device=dev), 0]
    sc[1] += 1
    return sc[0].data_ptr(), sc[0].shape[0] - 1, sc[1]


def _scan_launch(name: str, dev: torch.device, freq, n, cnt, B: int, S: int,
                 out, start, ngroups: int, unresolved, count: str) -> None:
    """One chain_scan_kernel launch (pointer arguments) with the device's
    look-back scratch and the next epoch."""
    _launch(name, dev, freq, n, cnt, B, S, out, start, ngroups, unresolved,
            *_look_back_scratch(dev, -(-B // SCAN_THREADS)), count=count)


def chain_scan_seeds(s_freq: torch.Tensor, n_seeds: torch.Tensor,
                     H: int) -> SeedScan:
    """Each read's raw hits, the sum of its first min(n_seeds, S) seed
    freqs (s_freq int64[B, S], n_seeds int64[B]), scanned for chain_hits
    into H hit slots -> SeedScan. Counted as chain_scan_seeds."""
    name = "chain_scan_seeds"
    need(s_freq.dim() == 2 and s_freq.shape[0] >= 1 and s_freq.shape[1] >= 1
         and H >= 1, f"{name}: s_freq must be [B, S], B, S >= 1, and H >= 1")
    B, S = s_freq.shape
    _dtype(name, s_freq, torch.int64, "s_freq")
    _dtype(name, n_seeds, torch.int64, "n_seeds")
    need(n_seeds.shape == (B,), f"{name}: n_seeds must be [B]")
    if not _on_card(name, [s_freq, n_seeds]):
        return chain_scan_seeds_plain(s_freq, n_seeds, H)
    need(S <= SCAN_MAX_S and B * S < 2 ** 31,
         f"{name}: the kernel takes S <= {SCAN_MAX_S} and B*S < 2^31")
    dev = s_freq.device
    scan = SeedScan(torch.empty(B + 1, dtype=torch.int32, device=dev),
                    torch.empty((_n_groups(H), 2), dtype=torch.int32,
                                device=dev),
                    torch.empty(B, dtype=torch.bool, device=dev))
    _scan_launch("chain_scan", dev, _ptr(s_freq), _ptr(n_seeds), None, B, S,
                 _ptr(scan.off), _ptr(scan.start), scan.start.shape[0],
                 _ptr(scan.unresolved), count=name)
    return scan


def chain_scan(counts: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum of per-read counts (int32[B]) -> int32[B+1],
    the total last."""
    name = "chain_scan"
    need(counts.dim() == 1 and counts.shape[0] >= 1,
         f"{name}: counts must be int32[B], B >= 1")
    _dtype(name, counts, torch.int32, "counts")
    if not _on_card(name, [counts]):
        return chain_scan_plain(counts)
    B = counts.shape[0]
    out = torch.empty(B + 1, dtype=torch.int32, device=counts.device)
    _scan_launch(name, out.device, None, None, _ptr(counts), B, 1, _ptr(out),
                 None, 0, None, count=name)
    return out


# ---- chain_hits ------------------------------------------------------------

def _repeat_to(x: torch.Tensor, csum_incl: torch.Tensor,
               hpos: torch.Tensor) -> torch.Tensor:
    """jnp.repeat(x, reps, total_repeat_length=H), given the inclusive
    cumsum of reps and hpos = arange(H): truncated to H, or padded with
    x[-1] when sum(reps) < H."""
    src = torch.searchsorted(csum_incl, hpos, right=True)
    return x[torch.clamp(src, max=x.shape[0] - 1)]


def _expand_seeds(n_seeds, s_rpos, s_len, s_x0, s_freq, H: int):
    """The seeds expanded by freq into H hit slots (truncated, or padded
    with the last seed slot) by their own cumsum -> (read, rpos, len, SA
    row, valid), int64 and bool[H]."""
    B, S = s_freq.shape
    dev = s_freq.device
    i64 = torch.int64
    freqs = _flat_freqs(s_freq, n_seeds)
    csum_incl = torch.cumsum(freqs, 0)
    total_raw = csum_incl[-1]
    hpos = torch.arange(H, dtype=i64, device=dev)

    def rep(x):
        return _repeat_to(x, csum_incl, hpos)

    seg_start = rep(csum_incl - freqs)
    hit_row = rep(s_x0.reshape(-1)) + (hpos - seg_start)
    hit_rpos = rep(s_rpos.reshape(-1))
    hit_len = rep(s_len.reshape(-1))
    hit_read = rep(torch.arange(B, dtype=i64, device=dev)
                   .repeat_interleave(S))
    hit_valid = hpos < torch.clamp(total_raw, max=H)
    return hit_read, hit_rpos, hit_len, hit_row, hit_valid


def chain_hits_plain(fm: DeviceFMIndex, off, n_seeds, s_rpos, s_len, s_x0,
                     s_freq, H: int, max_walk: int = MAX_WALK,
                     resolved=None) -> Hits:
    """Plain version of chain_hits on any device; it expands by its own
    cumsum of the seeds and does not read off. resolved (bool[H] or
    None) gets each slot's resolved flag."""
    B = s_freq.shape[0]
    dev = s_freq.device
    i64 = torch.int64
    hit_read, hit_rpos, hit_len, hit_row, hit_valid = _expand_seeds(
        n_seeds, s_rpos, s_len, s_x0, s_freq, H)
    hit_loc, ok = sa_resolve(fm, torch.where(hit_valid, hit_row, 32),
                             hit_valid, max_walk)
    if resolved is not None:
        resolved.copy_(ok)
    unresolved = torch.zeros(B, dtype=i64, device=dev).scatter_reduce(
        0, hit_read, (hit_valid & ~ok).to(i64), "amax") > 0
    keep = hit_valid & ((hit_loc - hit_rpos) > 0)
    i32 = torch.int32
    return Hits(hit_read.to(i32), hit_rpos.to(i32), hit_len.to(i32),
                hit_loc.to(i32), hit_valid, keep, unresolved)


def _check_seeds(name: str, scan: SeedScan, n_seeds, s_rpos, s_len, s_x0,
                 s_freq, H: int, max_walk: int) -> None:
    """The inputs chain_hits and chain_hits_routed share."""
    B, S = s_freq.shape
    need(B >= 1 and S >= 1 and H >= 1 and max_walk >= 0,
         f"{name}: needs B, S, H >= 1 and max_walk >= 0")
    _check_off(name, scan.off, B)
    _dtype(name, scan.start, torch.int32, "scan.start")
    need(scan.start.shape == (_n_groups(H), 2),
         f"{name}: scan.start must be [ceil(H / {HITS_GROUP}), 2]")
    _dtype(name, scan.unresolved, torch.bool, "scan.unresolved")
    need(scan.unresolved.shape == (B,), f"{name}: scan.unresolved must be "
                                        f"[B]")
    _dtype(name, n_seeds, torch.int64, "n_seeds")
    need(n_seeds.shape == (B,), f"{name}: n_seeds must be [B]")
    for what, t in (("s_rpos", s_rpos), ("s_len", s_len), ("s_x0", s_x0),
                    ("s_freq", s_freq)):
        _dtype(name, t, torch.int64, what)
        need(t.shape == (B, S), f"{name}: {what} must be [B, S]")


def _hits_plain(fm, scan: SeedScan, n_seeds, s_rpos, s_len, s_x0, s_freq,
                H: int, max_walk: int, resolved=None) -> Hits:
    """chain_hits_plain with its unresolved flags set in scan.unresolved,
    as the kernels set them."""
    plain = chain_hits_plain(fm, scan.off, n_seeds, s_rpos, s_len, s_x0,
                             s_freq, H, max_walk, resolved)
    scan.unresolved.logical_or_(plain.unresolved)
    return plain._replace(unresolved=scan.unresolved)


def _hits_outputs(H: int, dev):
    return ([torch.empty(H, dtype=torch.int32, device=dev) for _ in range(4)],
            [torch.empty(H, dtype=torch.bool, device=dev) for _ in range(2)])


def chain_hits(fm: DeviceFMIndex, scan: SeedScan, n_seeds, s_rpos, s_len,
               s_x0, s_freq, H: int, max_walk: int = MAX_WALK,
               resolved=None) -> Hits:
    """The seeds (n_seeds int64[B], s_rpos/s_len/s_x0/s_freq int64[B, S])
    expanded by freq into H hit slots and resolved through fm's SA; scan
    is chain_scan_seeds(s_freq, n_seeds, H). Hits past the total are
    invalid copies of the last seed slot; a read with a hit still
    unresolved after max_walk inverse-Psi steps is flagged. On either
    device the flags are set in scan.unresolved, which the scan zeroed,
    and the Hits returned share it: one hits call a scan, or several with
    the same fm. resolved (bool[H] on the seeds' device, or None): gets
    each slot's own flag, valid and resolved (with a full SA: valid), the
    reference's per-hit sa_resolve flag."""
    name = "chain_hits"
    _check_seeds(name, scan, n_seeds, s_rpos, s_len, s_x0, s_freq, H,
                 max_walk)
    B, S = s_freq.shape
    if resolved is not None:
        _dtype(name, resolved, torch.bool, "resolved")
        need(resolved.shape == (H,), f"{name}: resolved must be [H]")
    tables = [fm.occ_rows, fm.L2, fm.sa_samp, fm.sa_full]
    if not _on_card(name, [*scan, n_seeds, s_rpos, s_len, s_x0, s_freq]
                    + tables + ([resolved] if resolved is not None else [])):
        return _hits_plain(fm, scan, n_seeds, s_rpos, s_len, s_x0, s_freq,
                           H, max_walk, resolved)
    need(fm.occ_rows.dtype == torch.int32 and fm.occ_rows.shape[1:] == (8,)
         and fm.occ_rows.data_ptr() % 16 == 0
         and fm.L2.dtype == torch.int64 and fm.sa_samp.dtype == torch.int64
         and fm.sa_full.dtype == torch.int32 and B * S < 2 ** 31,
         f"{name}: occ rows int32[n, 8] 16-byte aligned, L2 and sa_samp "
         f"int64, sa_full int32, B*S < 2^31")
    dev = s_freq.device
    hit, flags = _hits_outputs(H, dev)
    _launch(name, dev, _ptr(scan.off), _ptr(scan.start), _ptr(n_seeds),
            _ptr(s_rpos), _ptr(s_len), _ptr(s_x0), _ptr(s_freq), B, S,
            _ptr(fm.occ_rows), _ptr(fm.L2), _ptr(fm.sa_samp),
            _ptr(fm.sa_full) if fm.has_full_sa else None, int(fm.primary),
            max_walk, H, *map(_ptr, hit + flags), _ptr(scan.unresolved),
            _ptr(resolved))
    return Hits(*hit, *flags, scan.unresolved)


def chain_hits_routed(fm, scan: SeedScan, n_seeds, s_rpos, s_len, s_x0,
                      s_freq, H: int, max_walk: int = MAX_WALK) -> Hits:
    """chain_hits over a genome-sharded index (the `fm` of
    parallel/sharded_index.ShardedFM3): with a full SA, fm.sa_full is an
    ops/routed.Routed table and each hit reads its entry from its shard;
    without one, fm.occ_rows and fm.sa_samp are, and every inverse-Psi
    step reads its occ4 row from its shard. On the card the routed
    instantiation of the hits kernel; on the CPU chain_hits_plain over
    the routed tables. Counted as chain_hits_routed."""
    from .routed import Routed
    name = "chain_hits_routed"
    _check_seeds(name, scan, n_seeds, s_rpos, s_len, s_x0, s_freq, H,
                 max_walk)
    B, S = s_freq.shape
    full = fm.has_full_sa
    routed = [fm.sa_full] if full else [fm.occ_rows, fm.sa_samp]
    need(all(isinstance(t, Routed) for t in routed),
         f"{name}: the SA tables must be routed (ops/routed.Routed)",
         TypeError)
    if not _on_card(name, [*scan, n_seeds, s_rpos, s_len, s_x0, s_freq,
                           fm.L2]):
        need(all(sh.device.type == "cpu" for t in routed for sh in t.shards),
             f"{name}: CPU seeds and shards on a card")
        return _hits_plain(fm, scan, n_seeds, s_rpos, s_len, s_x0, s_freq,
                           H, max_walk)
    dev = s_freq.device
    need(fm.L2.dtype == torch.int64 and B * S < 2 ** 31,
         f"{name}: L2 int64 and B*S < 2^31")
    if full:
        fm.sa_full.check_card(name, dev, torch.int32)
        occ = samp = None
    else:
        occ, samp = fm.occ_rows, fm.sa_samp
        occ.check_card(name, dev, torch.int32, 8, align=16)
        samp.check_card(name, dev, torch.int64, align=8)

    def tab(t):
        return (None, 0) if t is None else (_ptr(t.pointers(dev)), t.per)

    hit, flags = _hits_outputs(H, dev)
    _launch(name, dev, _ptr(scan.off), _ptr(scan.start), _ptr(n_seeds),
            _ptr(s_rpos), _ptr(s_len), _ptr(s_x0), _ptr(s_freq), B, S,
            *tab(occ), _ptr(fm.L2), *tab(samp),
            *tab(fm.sa_full if full else None), int(fm.primary), max_walk,
            H, *map(_ptr, hit + flags), _ptr(scan.unresolved))
    return Hits(*hit, *flags, scan.unresolved)


# ---- chain_classify_pack ---------------------------------------------------

def read_words_bwa(packed: torch.Tensor, max_len: int) -> torch.Tensor:
    """uint8[B, max_len/4] 2-bit codes (base q of a byte at bits 2q) ->
    int64[B, max_len/16] words in bwa crumb order (base j at bits
    (15 - j%16)*2 of word j//16), for the diagonal compare."""
    B, W4 = packed.shape
    pb = packed.to(torch.int64)
    q = torch.arange(0, 8, 2, dtype=torch.int64, device=packed.device)
    crumb = ((pb[:, :, None] >> q) & 3).reshape(B, W4 * 4)[:, :max_len]
    j = torch.arange(max_len, dtype=torch.int64, device=packed.device)
    return (crumb << ((15 - (j & 15)) * 2)).reshape(B, -1, 16).sum(dim=2)


def chain_classify_plain(ctx: ChainCtx, packed, rlens, hits: Hits,
                         max_len: int, out: torch.Tensor, planes=None,
                         pair_end: bool = False):
    """The classify part of chain_classify_pack_plain: writes meta1 and
    pd into out[:B] and out[B:2B], applies the FAST reads' evidence to
    planes, and returns mmp int32[B, MM_SLOTS]. It takes each hit's read
    from hits.read."""
    B = packed.shape[0]
    i64 = torch.int64
    cls, pd0, mm, rplast, cscore, mmp = classify_reads(
        ctx, read_words_bwa(packed, max_len), rlens.to(i64),
        hits.read.to(i64), hits.rpos.to(i64), hits.len.to(i64),
        hits.loc, hits.keep, max_len)
    # per-read seed-table overflow forces the host-oracle path
    cls = torch.where(hits.unresolved, CLASS_SLOW, cls)
    out[:B] = to_i32(cls | (mm << 2) | (rplast << 8) | (cscore << 17))
    out[B:2 * B] = pd0.to(torch.int32)
    mmp = mmp.to(torch.int32)
    if planes is not None:
        scatter_fast_evidence(
            planes.exact_diff, planes.f_diff.view(-1), planes.acgt.view(-1),
            cls == CLASS_FAST, out[B:2 * B], mmp, rlens,
            first_mate_lanes(torch.arange(B, dtype=i64, device=packed.device),
                             pair_end), ctx.seq_len // 2, ctx.seq_len, sign=1)
    return mmp


def ovf_words(flags: torch.Tensor) -> torch.Tensor:
    """bool[B] -> int64[ceil(B/32)] words, read b at bit b % 32 of word
    b // 32."""
    f = torch.nn.functional.pad(flags.to(torch.int64),
                                (0, -flags.shape[0] % 32))
    return (f.reshape(-1, 32) << torch.arange(32, dtype=torch.int64,
                                              device=flags.device)).sum(dim=1)


def counts2(counts: torch.Tensor) -> torch.Tensor:
    """Per-read counts (B even), two 16-bit halves per word."""
    return (counts[0::2] & 0xFFFF) | (counts[1::2] << 16)


def chain_pack_plain(off, hits: Hits, overflow, out: torch.Tensor,
                     H2: int) -> torch.Tensor:
    """The pack part of chain_classify_pack_plain: fills out[2B:] from
    the classes in out[:B], compacting the SLOW reads' kept hits by a
    cumsum over the hits (the reference's, fm_search.py:752)."""
    B = overflow.shape[0]
    hit_w_c, hit_loc_c, tail = _pack_parts(off, hits, out[:B] & 3, overflow,
                                           H2)
    out[2 * B:] = to_i32(torch.cat([hit_w_c, hit_loc_c, tail]))
    return out


def _pack_parts(off, hits: Hits, cls, overflow, H2: int):
    """The pack's fields from the classes cls[B] -> (hit_w, hit_loc)
    int64[H2] of the SLOW reads' kept hits in hit order, and int64 counts2,
    the overflow words, the total kept and buffer_overflow end to end."""
    B = overflow.shape[0]
    H = hits.read.shape[0]
    dev = cls.device
    i64 = torch.int64
    read = hits.read.to(i64)
    keep_slow = hits.keep & (cls[torch.clamp(read, 0, B - 1)] == CLASS_SLOW)
    dest = torch.cumsum(keep_slow.to(i64), 0) - 1
    # dropped hits write the dump slot H2: no host sync for a count
    slot = torch.where(keep_slow & (dest < H2), dest, H2)
    hit_w_c = torch.zeros(H2 + 1, dtype=i64, device=dev).index_copy_(
        0, slot, (hits.rpos.to(i64) << 9) | hits.len.to(i64))[:H2]
    hit_loc_c = torch.zeros(H2 + 1, dtype=i64, device=dev).index_copy_(
        0, slot, hits.loc.to(i64))[:H2]
    counts = torch.zeros(B, dtype=i64, device=dev).index_add_(
        0, read, keep_slow.to(i64))
    total_kept = keep_slow.sum()
    buffer_overflow = (off[B] > H) | (total_kept > H2)
    return hit_w_c, hit_loc_c, torch.cat([
        counts2(counts), ovf_words(overflow | hits.unresolved),
        torch.stack([total_kept, buffer_overflow.to(i64)])])


def chain_classify_pack_plain(ctx: ChainCtx, packed, rlens, off, hits: Hits,
                              overflow, max_len: int, out: torch.Tensor,
                              H2: int, planes=None,
                              pair_end: bool = False) -> torch.Tensor:
    """Plain version of chain_classify_pack on any device: classify, then
    pack. Returns mmp."""
    mmp = chain_classify_plain(ctx, packed, rlens, hits, max_len, out,
                               planes, pair_end)
    chain_pack_plain(off, hits, overflow, out, H2)
    return mmp


def _check_cp(name: str, packed, rlens, off, hits: Hits, overflow,
              max_len: int, H2: int, loc) -> tuple:
    """The inputs both classify+pack kernels take (hits.loc of dtype
    loc) -> (B, H)."""
    B = packed.shape[0]
    need(B >= 32 and B % 32 == 0 and H2 >= 1,
         f"{name}: B must be a positive multiple of 32 and H2 >= 1")
    need(max_len >= 16 and max_len % 16 == 0 and max_len <= 511,
         f"{name}: max_len must be a multiple of 16 below 512")
    _dtype(name, packed, torch.uint8, "packed")
    _dtype(name, rlens, torch.int32, "rlens")
    need(packed.shape == (B, max_len // 4) and rlens.shape == (B,),
         f"{name}: packed must be uint8[B, max_len/4] and rlens int32[B]")
    _check_off(name, off, B)
    H = _check_hits(name, hits, B, loc)
    _dtype(name, overflow, torch.bool, "overflow")
    need(overflow.shape == (B,), f"{name}: overflow must be [B]")
    return B, H


def chain_classify_pack(ctx: ChainCtx, packed: torch.Tensor,
                        rlens: torch.Tensor, off: torch.Tensor, hits: Hits,
                        overflow: torch.Tensor, max_len: int,
                        out: torch.Tensor, H2: int, planes=None,
                        pair_end: bool = False) -> torch.Tensor:
    """Classify a batch of 2-bit reads (packed uint8[B, max_len/4], rlens
    int32[B]) from their hits (chain_hits; off = the scan it expanded)
    and pack the result into the packed output vector out int32[2B + 2H2
    + B/2 + B/32 + 2] (ops/fm_search.SeedChainKernel): meta1 (cls | mm<<2
    | rplast<<8 | cscore<<17) and pd; hit_w (rpos<<9 | len) and hit_loc of
    the SLOW reads' kept hits in hit order (slots >= H2 dropped, unused
    ones 0); counts2 of each read's SLOW kept hits; the overflow words of
    overflow | hits.unresolved; the total kept and buffer_overflow =
    total raw > H or total kept > H2. Returns mmp int32[B, MM_SLOTS]. With
    planes (pipeline/device_profile.DevicePlanes) every FAST read's
    evidence is added to them in place; pair_end picks the orientation
    plane by batch-index parity. B % 32 == 0. Counted as
    chain_classify_pack."""
    name = "chain_classify_pack"
    B, H = _check_cp(name, packed, rlens, off, hits, overflow, max_len, H2,
                     torch.int32)
    _dtype(name, out, torch.int32, "out")
    need(out.shape == (2 * B + 2 * H2 + B // 2 + B // 32 + 2,),
         f"{name}: out must be int32[2B + 2H2 + B/2 + B/32 + 2]")
    ts = [packed, rlens, off, overflow, out, ctx.text_words, ctx.bkeys,
          *hits]
    pl = []
    if planes is not None:
        pl = [planes.exact_diff, planes.f_diff, planes.acgt]
        for what, t in zip(("exact_diff", "f_diff", "acgt"), pl):
            _dtype(name, t, torch.int32, f"planes.{what}")
        L = ctx.seq_len // 2
        need(pl[0].shape == (L + 2,) and pl[1].shape == (4, L + 2)
             and pl[2].shape == (4, L + 1),
             f"{name}: planes of genome size {L} expected")
    if not _on_card(name, ts + pl):
        return chain_classify_pack_plain(ctx, packed, rlens, off, hits,
                                         overflow, max_len, out, H2, planes,
                                         pair_end)
    need(packed.data_ptr() % 4 == 0, f"{name}: packed must be 4-byte "
                                     f"aligned")
    _dtype(name, ctx.bkeys, torch.int64, "ctx.bkeys")
    _dtype(name, ctx.text_words, torch.int64, "ctx.text_words")
    dev = out.device
    mmp = torch.empty((B, MM_SLOTS), dtype=torch.int32, device=dev)
    _launch(name, dev, _ptr(off), _ptr(hits.rpos), _ptr(hits.len),
            _ptr(hits.loc), _ptr(hits.keep), _ptr(hits.unresolved),
            _ptr(overflow), _ptr(packed), _ptr(rlens), B, H, H2, max_len,
            _ptr(ctx.text_words), ctx.text_words.shape[0], _ptr(ctx.bkeys),
            ctx.bkeys.shape[0], ctx.seq_len,
            *(map(_ptr, pl) if pl else (None,) * 3), ctx.seq_len // 2,
            int(bool(pair_end)), _ptr(out), _ptr(mmp),
            *_look_back_scratch(dev, -(-B // CP_READS)))
    return mmp


# ---- the x64 big-genome forms ----------------------------------------------

def chain_hits_big_plain(bfm, off, n_seeds, s_rpos, s_len, s_x0, s_freq,
                         H: int) -> Hits:
    """Plain version of chain_hits_big on any device: the expansion of
    chain_hits_plain, every hit's int64 SA entry gathered from its shard
    (the routed gather of bfm.sa, the reference's _routed_rows64); loc
    stays int64. It does not read off."""
    B = s_freq.shape[0]
    hit_read, hit_rpos, hit_len, hit_row, hit_valid = _expand_seeds(
        n_seeds, s_rpos, s_len, s_x0, s_freq, H)
    hit_loc = bfm.sa[torch.where(hit_valid, hit_row, 32)]
    keep = hit_valid & ((hit_loc - hit_rpos) > 0)
    i32 = torch.int32
    return Hits(hit_read.to(i32), hit_rpos.to(i32), hit_len.to(i32),
                hit_loc, hit_valid, keep,
                torch.zeros(B, dtype=torch.bool, device=s_freq.device))


def chain_hits_big(bfm, scan: SeedScan, n_seeds, s_rpos, s_len, s_x0,
                   s_freq, H: int) -> Hits:
    """chain_hits over the x64 big-genome SA (parallel/big_index.
    BigShardedFM3: bfm.sa an ops/routed.Routed table of int64 shards):
    the seeds expanded by freq into H hit slots, each hit's row x0 + rank
    and its text position int64 (Hits.loc int64[H]). Full SA only: no hit
    is left unresolved, so scan.unresolved stays as the scan zeroed it.
    On the card the 64-bit instantiation of the hits kernel; on the CPU
    chain_hits_big_plain. Counted as chain_hits_big."""
    from .routed import Routed
    name = "chain_hits_big"
    _check_seeds(name, scan, n_seeds, s_rpos, s_len, s_x0, s_freq, H, 0)
    B, S = s_freq.shape
    need(isinstance(bfm.sa, Routed), f"{name}: the SA must be routed "
                                     f"(ops/routed.Routed)", TypeError)
    if not _on_card(name, [*scan, n_seeds, s_rpos, s_len, s_x0, s_freq]):
        need(all(sh.device.type == "cpu" for sh in bfm.sa.shards),
             f"{name}: CPU seeds and shards on a card")
        plain = chain_hits_big_plain(bfm, scan.off, n_seeds, s_rpos, s_len,
                                     s_x0, s_freq, H)
        return plain._replace(unresolved=scan.unresolved)
    dev = s_freq.device
    need(B * S < 2 ** 31, f"{name}: B*S < 2^31")
    bfm.sa.check_card(name, dev, torch.int64, align=8)
    hit = [torch.empty(H, dtype=torch.int32, device=dev) for _ in range(3)]
    loc = torch.empty(H, dtype=torch.int64, device=dev)
    flags = [torch.empty(H, dtype=torch.bool, device=dev) for _ in range(2)]
    _launch(name, dev, _ptr(scan.off), _ptr(scan.start), _ptr(n_seeds),
            _ptr(s_rpos), _ptr(s_len), _ptr(s_x0), _ptr(s_freq), B, S,
            _ptr(bfm.sa.pointers(dev)), bfm.sa.per, H,
            *map(_ptr, hit + [loc] + flags), _ptr(scan.unresolved))
    return Hits(*hit, loc, *flags, scan.unresolved)


def big_out_sizes(B: int, H2: int):
    """(int32 words, int64 words) of the big packed output: meta1[B],
    hit_w[H2], counts2[B/2], the overflow words[B/32], the total kept and
    buffer_overflow, padded to an even count so the int64 part that
    follows in the same buffer (pd[B], hit_loc[H2]) stays 8-byte
    aligned."""
    n32 = B + H2 + B // 2 + B // 32 + 2
    return n32 + (n32 & 1), B + H2


def chain_classify_pack_big_plain(ctx: ChainCtx, packed, rlens, off,
                                  hits: Hits, overflow, max_len: int,
                                  out: torch.Tensor, wide: torch.Tensor,
                                  H2: int) -> torch.Tensor:
    """Plain version of chain_classify_pack_big on any device: classify
    with int64 locations, then the pack. Returns mmp."""
    B = packed.shape[0]
    i64 = torch.int64
    cls, pd0, mm, rplast, cscore, mmp = classify_reads(
        ctx, read_words_bwa(packed, max_len), rlens.to(i64),
        hits.read.to(i64), hits.rpos.to(i64), hits.len.to(i64), hits.loc,
        hits.keep, max_len)
    cls = torch.where(hits.unresolved, CLASS_SLOW, cls)
    out[:B] = to_i32(cls | (mm << 2) | (rplast << 8) | (cscore << 17))
    wide[:B] = pd0
    hit_w_c, hit_loc_c, tail = _pack_parts(off, hits, cls, overflow, H2)
    out[B:B + H2] = to_i32(hit_w_c)
    out[B + H2:B + H2 + tail.shape[0]] = to_i32(tail)
    wide[B:] = hit_loc_c
    return mmp.to(torch.int32)


def chain_classify_pack_big(ctx: ChainCtx, packed: torch.Tensor,
                            rlens: torch.Tensor, off: torch.Tensor,
                            hits: Hits, overflow: torch.Tensor, max_len: int,
                            out: torch.Tensor, wide: torch.Tensor,
                            H2: int) -> torch.Tensor:
    """chain_classify_pack for the x64 big-genome path: hits.loc int64
    (chain_hits_big), ctx.seq_len a Python int that may pass 2^31, no
    evidence apply. pd and the packed hits' locations are int64 and go to
    the side output wide int64[B + H2] (pd, then hit_loc); out
    int32[big_out_sizes(B, H2)[0]] holds meta1, hit_w, counts2, the
    overflow words, the total kept and buffer_overflow (and a pad word
    when the count is odd, which nothing writes). Returns mmp int32[B,
    MM_SLOTS]. B % 32 == 0. Counted as chain_classify_pack_big."""
    name = "chain_classify_pack_big"
    B, H = _check_cp(name, packed, rlens, off, hits, overflow, max_len, H2,
                     torch.int64)
    n32, n64 = big_out_sizes(B, H2)
    _dtype(name, out, torch.int32, "out")
    _dtype(name, wide, torch.int64, "wide")
    need(out.shape == (n32,) and wide.shape == (n64,),
         f"{name}: out must be int32[{n32}] and wide int64[B + H2]")
    ts = [packed, rlens, off, overflow, out, wide, ctx.text_words,
          ctx.bkeys, *hits]
    if not _on_card(name, ts):
        return chain_classify_pack_big_plain(ctx, packed, rlens, off, hits,
                                             overflow, max_len, out, wide,
                                             H2)
    need(packed.data_ptr() % 4 == 0 and wide.data_ptr() % 8 == 0,
         f"{name}: packed must be 4-byte and wide 8-byte aligned")
    _dtype(name, ctx.bkeys, torch.int64, "ctx.bkeys")
    _dtype(name, ctx.text_words, torch.int64, "ctx.text_words")
    dev = out.device
    mmp = torch.empty((B, MM_SLOTS), dtype=torch.int32, device=dev)
    _launch(name, dev, _ptr(off), _ptr(hits.rpos), _ptr(hits.len),
            _ptr(hits.loc), _ptr(hits.keep), _ptr(hits.unresolved),
            _ptr(overflow), _ptr(packed), _ptr(rlens), B, H, H2, max_len,
            _ptr(ctx.text_words), ctx.text_words.shape[0], _ptr(ctx.bkeys),
            ctx.bkeys.shape[0], int(ctx.seq_len), _ptr(out), _ptr(wide),
            _ptr(mmp), *_look_back_scratch(dev, -(-B // CP_READS)))
    return mmp
