"""Batched greedy-MEM seeding + device chaining (PyTorch port of
mapcaller_tpu/ops/fm_search.py).

Device equivalent of BWT_Search + IdentifySimplePairs
(ref: src/bwt_search.cpp:121-164, src/ReadMapping.cpp:125-158): every
read of a batch advances one state-machine step per iteration of a
lockstep loop. Three scans give the same seed sets:

  _seed_scan3          the occ3 table (ops/fm3_device.py): 3 bases per
                       iteration, one lane per read;
  _seed_scan3_compact  the same steps on fewer lanes, which stream through
                       the batch and are refilled from a queue after every
                       block (compact_factor > 1), so a batch costs about
                       the mean read's iterations instead of the most;
  _seed_scan           the 1-step occ4 rows (ops/fm_device.py): when the
                       occ3 table does not fit or the index has no full
                       SA, and for byte codes with ambiguous bases (the
                       non-native path).

Hits are then expanded by seed frequency into a flat buffer and resolved
through the SA (ops/chain_kernels.chain_scan_seeds and chain_hits). Three
kernels pack them for the host, each a class whose __call__ runs on the
tables' device and whose collect decodes on the host:

  SeedChainKernel   classifies the reads on the card (ops/chain_kernels:
                    chain_classify_pack): the stream's default
  SeedKernelPacked  every kept hit grouped by read, for host chaining
                    (device_chain=False)
  SeedKernel        byte codes in, every hit out (the non-native path)

These scans are the plain PyTorch versions: Python loops of fixed-size
blocks with one host sync per block for the early exit. The kernels
call them through ops/seed_scan_device.py, which runs them for CPU
tensors and launches the CUDA scan kernels (csrc/seed_scan.cu) for CUDA
ones. On the card the chain kernel's call is four kernel launches (the
seed scan, then ops/chain_kernels.py's csrc/chain.cu: the seed-freq scan,
the hits, classify+pack) and never waits for the device.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .chain_device import ChainCtx
from .chain_kernels import (chain_classify_pack, chain_hits, chain_scan_seeds,
                            counts2, ovf_words)
from .fm3_device import DeviceFM3, gather3, step1_update, step3_update
from .fm_device import M32, DeviceFMIndex, occ4, to_i32
from .seed_scan_device import seed_scan1, seed_scan3

OCC_THR = 50
MIN_SEED_LEN = 16
UNROLL = 8          # lockstep occ3 scan steps between early-exit checks
# steps between early-exit checks of the 1-step scan, and between the
# flush/refill passes of the compacted scan
UNROLL16 = 16
_SEED_KEYS = ("n_seeds", "s_rpos", "s_len", "s_x0", "s_freq", "overflow")


def _pfx_entry(cnt64, key):
    """Extract the packed prefix entry (x0, x1, x2) for prefix key `key`
    from a gathered row whose 64 count slots hold 16 packed 4-int32
    entries (ops/fm3_device._embed_pfx): component j at slot
    (key & 15) * 4 + j."""
    base = ((key & 15) << 2)[:, None]
    return (cnt64.gather(1, base)[:, 0], cnt64.gather(1, base + 1)[:, 0],
            cnt64.gather(1, base + 2)[:, 0])


def _word_codes(words: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The 2-bit code at pos (int64[R]) of each row of little-endian read
    words (int64[R, nwords] holding uint32, base j at bits 2*(j%16) of
    word j//16)."""
    w = words.gather(1, (pos >> 4)[:, None])[:, 0]
    return (w >> ((pos & 15) * 2)) & 3


def _word_key(words: torch.Tensor, pos: torch.Tensor, K: int) -> torch.Tensor:
    """The K bases at pos of each row as a prefix-table key, first base
    most significant; bases past the last word read as 0."""
    nwords = words.shape[1]
    wi = pos >> 4
    w0 = words.gather(1, wi[:, None])[:, 0]
    w1 = torch.where(wi + 1 < nwords, words.gather(
        1, torch.clamp(wi + 1, max=nwords - 1)[:, None])[:, 0], 0)
    sh = (pos & 15) * 2
    comb = (w0 >> sh) | torch.where(sh > 0, (w1 << (32 - sh)) & M32, 0)
    key = torch.zeros_like(pos)
    for j in range(K):
        key = key | (((comb >> (2 * j)) & 3) << (2 * (K - 1 - j)))
    return key


def _scan_state(R: int, max_seeds: int, dev) -> dict:
    """Initial state of R scan lanes: idle at position 0, no seeds."""
    z = torch.zeros(R, dtype=torch.int64, device=dev)
    zb = torch.zeros(R, dtype=torch.bool, device=dev)
    zs = torch.zeros((R, max_seeds), dtype=torch.int64, device=dev)
    return dict(pos=z, in_ext=zb, replay=zb, start=z, ext_pos=z, x0=z, x1=z,
                x2=z, n_seeds=z, s_rpos=zs, s_len=zs, s_x0=zs, s_freq=zs,
                overflow=zb)


def _record_seed(s: dict, finalize, slen, slot_ids) -> dict:
    """Seed bookkeeping shared by the scans: a finalized extension of at
    least MIN_SEED_LEN bases and at most OCC_THR hits goes to slot
    n_seeds (to the last slot again once the table is full, which flags
    overflow)."""
    max_seeds = slot_ids.shape[1]
    n_seeds = s["n_seeds"]
    good = finalize & (slen >= MIN_SEED_LEN) & (s["x2"] <= OCC_THR)
    slot = torch.clamp(n_seeds, max=max_seeds - 1)
    onehot = (slot_ids == slot[:, None]) & good[:, None]

    def put(arr, val):
        return torch.where(onehot, val[:, None], arr)

    return dict(
        n_seeds=torch.where(good, torch.clamp(n_seeds + 1, max=max_seeds),
                            n_seeds),
        s_rpos=put(s["s_rpos"], s["start"]), s_len=put(s["s_len"], slen),
        s_x0=put(s["s_x0"], s["x0"]), s_freq=put(s["s_freq"], s["x2"]),
        overflow=s["overflow"] | (good & (n_seeds >= max_seeds)))


def _step3(fm3: DeviceFM3, s: dict, rlens, codes_fn, key_fn, max_len: int,
           slot_ids, gather_fn=gather3) -> dict:
    """One iteration of the occ3 state machine for every lane (see
    _seed_scan3). rlens int64[R] per lane; codes_fn / key_fn map
    positions int64[R] to codes / prefix keys (key_fn None: no fused
    prefix skip); gather_fn(fm3, i) fetches the rows (gather3)."""
    L2 = fm3.L2
    pos, in_ext, replay = s["pos"], s["in_ext"], s["replay"]
    start, ext_pos = s["start"], s["ext_pos"]
    x0, x1, x2 = s["x0"], s["x1"], s["x2"]
    active = in_ext | (pos < rlens - MIN_SEED_LEN)

    cpos = codes_fn(torch.clamp(pos, max=max_len - 1))
    start_new = active & (~in_ext)
    x0_init = L2[cpos & 3] + 1
    x1_init = L2[(3 - cpos) & 3] + 1
    x2_init = L2[(cpos & 3) + 1] - L2[cpos & 3]
    ext_init = pos + 1

    ext_active = active & in_ext
    at_end = ext_active & (ext_pos >= rlens)
    extending = ext_active & ~at_end
    use3 = extending & (~replay) & (ext_pos + 3 <= rlens)
    use1 = extending & ~use3

    e0 = codes_fn(torch.clamp(ext_pos, max=max_len - 1))
    e1 = codes_fn(torch.clamp(ext_pos + 1, max=max_len - 1))
    e2 = codes_fn(torch.clamp(ext_pos + 2, max=max_len - 1))

    k = torch.where(extending, x1, 0)
    l = torch.where(extending, x1 + x2, 0)
    if key_fn is not None:
        # start lanes fetch the embedded prefix row for the K-mer at pos
        # instead of a dummy row (key >> 4 = row, key & 15 = entry)
        key = key_fn(torch.clamp(pos, max=max_len - 1))
        k = torch.where(start_new, (int(fm3.pfx_base) << 4) + key, k)
    gk = gather_fn(fm3, k)
    gl = gather_fn(fm3, l)
    if key_fn is not None:
        p_x0, p_x1, p_x2 = _pfx_entry(gk[0], key)
        jump = start_new & (p_x2 > 0)
        x0_init = torch.where(jump, p_x0, x0_init)
        x1_init = torch.where(jump, p_x1, x1_init)
        x2_init = torch.where(jump, p_x2, x2_init)
        ext_init = torch.where(jump, pos + fm3.pfx_k, ext_init)
    n3_x0, n3_x1, n3_x2 = step3_update(fm3, x0, k, x2, e0, e1, e2, gk, gl)
    n1_x0, n1_x1, n1_x2 = step1_update(fm3, x0, k, x2, e0, gk, gl)

    fail3 = use3 & (n3_x2 <= 0)     # exact end within these 3 bases
    ok3 = use3 & ~fail3
    fail1 = use1 & (n1_x2 <= 0)
    ok1 = use1 & ~fail1

    finalize = at_end | fail1
    slen = ext_pos - start

    def pick(init, n3, n1, keep):
        return torch.where(start_new, init, torch.where(
            ok3, n3, torch.where(ok1, n1, keep)))

    return dict(
        pos=torch.where(finalize, start + slen + 1, pos),
        in_ext=torch.where(start_new, True,
                           torch.where(finalize, False, in_ext)),
        replay=torch.where(finalize, False,
                           torch.where(start_new, False, replay | fail3)),
        start=torch.where(start_new, pos, start),
        ext_pos=pick(ext_init, ext_pos + 3, ext_pos + 1, ext_pos),
        x0=pick(x0_init, n3_x0, n1_x0, x0),
        x1=pick(x1_init, n3_x1, n1_x1, x1),
        x2=pick(x2_init, n3_x2, n1_x2, x2),
        **_record_seed(s, finalize, slen, slot_ids))


def _seed_scan3(fm3: DeviceFM3, codes_fn, rlens, B: int, max_len: int,
                max_seeds: int, key_fn=None, with_iters: bool = False,
                gather_fn=gather3):
    """Greedy-MEM state machine on the 3-step occ table: extensions
    advance 3 bases per iteration (2 gathers) while >= 3 bases remain; on
    a 3-step failure the lane replays from the saved state with derived
    1-steps to find the exact MEM end; tail bases (< 3 left) use derived
    1-steps too. The seed set equals BWT_Search's (ref: bwt_search.cpp:
    121-164).

    With fm3.pfx_base > 0 and a key_fn, every extension START jumps
    pfx_k bases in its single iteration through the embedded prefix row
    its (otherwise dummy) first gather fetches; an empty entry falls back
    to the 1-base init and the replay walk finds the exact end, so the
    seed set does not depend on pfx_k.

    Returns (n_seeds, s_rpos, s_len, s_x0, s_freq, overflow):
    int64[B], int64[B, max_seeds] x4, bool[B]; with_iters also each
    lane's step count int64[B] (the reference's with_iters) and the occ3
    rows it gathered, two a step that extends or tries to (int64[B]).

    gather_fn(fm3, i) fetches the occ3 rows of indices i: gather3, or
    parallel/sharded_index.routed_gather3 over a genome-sharded table
    (the reference's hook, mapcaller_tpu/ops/fm_search.py:125-126)."""
    dev = rlens.device
    rlens = rlens.to(torch.int64)
    slot_ids = torch.arange(max_seeds, dtype=torch.int64, device=dev)[None, :]
    if not fm3.pfx_base:
        key_fn = None
    st = _scan_state(B, max_seeds, dev)
    iters = torch.zeros((2, B), dtype=torch.int64, device=dev)
    for _ in range(scan3_cap(max_len, max_seeds) // UNROLL):
        # one host sync per block: stop once every lane is done
        if not bool((st["in_ext"] | (st["pos"] < rlens - MIN_SEED_LEN)).any()):
            break
        for _ in range(UNROLL):
            if with_iters:
                iters[0] += st["in_ext"] | (st["pos"] < rlens - MIN_SEED_LEN)
                iters[1] += 2 * (st["in_ext"] & (st["ext_pos"] < rlens))
            st = _step3(fm3, st, rlens, codes_fn, key_fn, max_len, slot_ids,
                        gather_fn)
    return tuple(st[k] for k in _SEED_KEYS) + (tuple(iters) if with_iters
                                               else ())


def scan3_cap(max_len: int, max_seeds: int) -> int:
    """Steps the occ3 scan runs at most: whole UNROLL blocks covering the
    worst case of ~1.5 iterations a base (len-1 MEMs: init + 3-fail +
    1-replay-fail per 2-base advance) + 2 a seed to finalize."""
    n_iters = (3 * max_len) // 2 + 2 * max_seeds + 8
    return -(-n_iters // UNROLL) * UNROLL


def scan1_cap(max_len: int, max_seeds: int) -> int:
    """Steps the 1-step scan runs at most, in whole UNROLL16 blocks."""
    return -(-(max_len + 2 * max_seeds + 2) // UNROLL16) * UNROLL16


def _seed_scan3_compact(fm3: DeviceFM3, words_all, rlens_all, B_total: int,
                        lanes: int, max_len: int, max_seeds: int):
    """Lane-compacted greedy-MEM scan: `lanes` lanes stream through
    B_total reads, so the batch costs about the MEAN read's iterations
    instead of the most any read needs (ref hot loop: src/bwt_search.cpp:
    121-164).

    The UNROLL16 steps of a block are _seed_scan3's, on per-lane read
    words and per-lane seed tables. After each block one pass flushes the
    finished lanes' seed rows into the per-read tables (a masked lane
    writes the dump row B_total) and refills those lanes from the queue
    of unread reads; a read whose lane is refilled is never seen again.
    The fused prefix skip engages when fm3.pfx_base is set.

    words_all: int64[B_total, nwords] little-endian read words (as
    _read_words_le); rlens_all: int[B_total]. Returns _seed_scan3's
    per-read outputs, equal to them."""
    dev = words_all.device
    i64 = torch.int64
    slot_ids = torch.arange(max_seeds, dtype=i64, device=dev)[None, :]
    # dump row B_total: length 0, so a lane holding it is done at once
    # and never emits
    words_pad = torch.cat([words_all, words_all.new_zeros((1,) +
                                                          words_all.shape[1:])])
    rlens_pad = torch.cat([rlens_all.to(i64),
                           torch.zeros(1, dtype=i64, device=dev)])
    rd = torch.clamp(torch.arange(lanes, dtype=i64, device=dev), max=B_total)
    lane = dict(rd=rd, rlen=rlens_pad[rd], words=words_pad[rd])
    qhead = torch.tensor(min(lanes, B_total), dtype=i64, device=dev)
    st = _scan_state(lanes, max_seeds, dev)
    out = {k: torch.zeros((B_total + 1,) + v.shape[1:], dtype=v.dtype,
                          device=dev)
           for k, v in st.items() if k in _SEED_KEYS}

    def codes_fn(p):
        return _word_codes(lane["words"], p)

    def key_fn(p):
        return _word_key(lane["words"], p, fm3.pfx_k)

    def compact(st, qhead):
        """Flush the finished lanes' seed rows into the per-read tables,
        then refill those lanes from the queue."""
        done = ~st["in_ext"] & (st["pos"] >= lane["rlen"] - MIN_SEED_LEN)
        flush = done & (lane["rd"] < B_total)
        wb = torch.where(flush, lane["rd"], B_total)
        for k, table in out.items():
            table.index_copy_(0, wb, st[k])
        newrd = qhead + torch.cumsum(flush.to(i64), 0) - 1
        take = flush & (newrd < B_total)
        nr = torch.clamp(newrd, 0, B_total)
        lane["rd"] = torch.where(take, newrd,
                                 torch.where(flush, B_total, lane["rd"]))
        lane["rlen"] = torch.where(take, rlens_pad[nr],
                                   torch.where(flush, 0, lane["rlen"]))
        lane["words"] = torch.where(take[:, None], words_pad[nr],
                                    lane["words"])
        tk = take[:, None]
        st = dict(st, pos=torch.where(take, 0, st["pos"]),
                  in_ext=st["in_ext"] & ~take, replay=st["replay"] & ~take,
                  n_seeds=torch.where(take, 0, st["n_seeds"]),
                  overflow=st["overflow"] & ~take,
                  **{k: torch.where(tk, 0, st[k])
                     for k in ("s_rpos", "s_len", "s_x0", "s_freq")})
        return st, qhead + take.sum()

    kf = key_fn if fm3.pfx_base else None
    base = (3 * max_len) // 2 + 2 * max_seeds + 8
    n_iters = base * (-(-B_total // lanes)) + base
    for _ in range(-(-n_iters // UNROLL16)):
        # one host sync per block: stop once no lane is busy and the
        # queue is empty
        busy = (st["in_ext"] | (st["pos"] < lane["rlen"] - MIN_SEED_LEN)).any()
        if not bool(busy | (qhead < B_total)):
            break
        for _ in range(UNROLL16):
            st = _step3(fm3, st, lane["rlen"], codes_fn, kf, max_len,
                        slot_ids)
        st, qhead = compact(st, qhead)
    compact(st, qhead)          # lanes that finished in the last block
    return tuple(out[k][:B_total] for k in _SEED_KEYS)


def _seed_scan(fm: DeviceFMIndex, codes_fn, rlens, B: int, max_len: int,
               max_seeds: int, has_n: bool, with_iters: bool = False):
    """Greedy-MEM state machine on the 1-step occ4 rows: one base per
    extension iteration (two occ4 lookups). codes_fn maps positions
    int64[B] to codes; with has_n a code above 3 (N) ends an extension
    and is skipped as a start, without it the input is 2-bit. Returns
    _seed_scan3's outputs; a lane never needs more than max_len +
    2 * max_seeds + 2 iterations, and a finished lane stays unchanged, so
    the early exit gives the reference's fixed trip count's result.
    with_iters: as _seed_scan3 (the rows are occ4 rows)."""
    dev = rlens.device
    i64 = torch.int64
    L2 = fm.L2
    primary = fm.primary
    rlens = rlens.to(i64)
    stop_pos = rlens - MIN_SEED_LEN
    slot_ids = torch.arange(max_seeds, dtype=i64, device=dev)[None, :]

    def step(s):
        pos, in_ext, start, ext_pos = (s["pos"], s["in_ext"], s["start"],
                                       s["ext_pos"])
        x0, x1, x2 = s["x0"], s["x1"], s["x2"]
        idle = ~in_ext & (pos < stop_pos)
        cpos = codes_fn(torch.clamp(pos, max=max_len - 1))
        start_new = idle & (cpos <= 3) if has_n else idle
        cext = codes_fn(torch.clamp(ext_pos, max=max_len - 1))
        at_end = in_ext & ((ext_pos >= rlens) | (cext > 3) if has_n
                           else ext_pos >= rlens)
        extending = in_ext & ~at_end

        tkl = occ4(fm, torch.stack([torch.where(extending, x1 - 1, 0),
                                    torch.where(extending, x1 - 1 + x2, 0)]))
        tk, tl = tkl[0], tkl[1]
        ok_x1 = L2[:4][None, :] + 1 + tk
        ok_x2 = tl - tk
        adj = ((x1 <= primary) & (x1 + x2 - 1 >= primary)).to(i64)
        ok3_x0 = x0 + adj
        ok2_x0 = ok3_x0 + ok_x2[:, 3]
        ok1_x0 = ok2_x0 + ok_x2[:, 2]
        ok0_x0 = ok1_x0 + ok_x2[:, 1]
        ok_x0 = torch.stack([ok0_x0, ok1_x0, ok2_x0, ok3_x0], dim=-1)
        ci = torch.where(extending, 3 - cext, 0)[:, None]
        new_x0 = ok_x0.gather(1, ci)[:, 0]
        new_x1 = ok_x1.gather(1, ci)[:, 0]
        new_x2 = ok_x2.gather(1, ci)[:, 0]
        ext_fail = extending & (new_x2 == 0)
        ext_ok = extending & (new_x2 != 0)

        finalize = at_end | ext_fail
        slen = ext_pos - start
        new_pos = torch.where(finalize, start + slen + 1, pos)
        if has_n:         # skip an ambiguous base at an extension start
            new_pos = torch.where(idle & (cpos > 3), pos + 1, new_pos)
        return dict(
            s, pos=new_pos,
            in_ext=torch.where(start_new, True,
                               torch.where(finalize, False, in_ext)),
            start=torch.where(start_new, pos, start),
            ext_pos=torch.where(start_new, pos + 1, torch.where(
                ext_ok, ext_pos + 1, ext_pos)),
            x0=torch.where(start_new, L2[cpos & 3] + 1,
                           torch.where(ext_ok, new_x0, x0)),
            x1=torch.where(start_new, L2[(3 - cpos) & 3] + 1,
                           torch.where(ext_ok, new_x1, x1)),
            x2=torch.where(start_new, L2[(cpos & 3) + 1] - L2[cpos & 3],
                           torch.where(ext_ok, new_x2, x2)),
            **_record_seed(s, finalize, slen, slot_ids))

    st = _scan_state(B, max_seeds, dev)
    iters = torch.zeros((2, B), dtype=i64, device=dev)
    for _ in range(scan1_cap(max_len, max_seeds) // UNROLL16):
        if not bool((st["in_ext"] | (st["pos"] < stop_pos)).any()):
            break
        for _ in range(UNROLL16):
            if with_iters:
                iters[0] += st["in_ext"] | (st["pos"] < stop_pos)
                ext = st["in_ext"] & (st["ext_pos"] < rlens)
                if has_n:
                    ext &= codes_fn(torch.clamp(st["ext_pos"],
                                                max=max_len - 1)) <= 3
                iters[1] += 2 * ext
            st = step(st)
    return tuple(st[k] for k in _SEED_KEYS) + (tuple(iters) if with_iters
                                               else ())


def _read_words_le(packed: torch.Tensor) -> torch.Tensor:
    """uint8[B, W4] 2-bit codes (4 per byte, base q of a byte at bits 2q)
    -> int64[B, W4/4] little-endian 32-bit words (base j at bits
    2*(j%16) of word j//16)."""
    B, W4 = packed.shape
    pb = packed.to(torch.int64).reshape(B, W4 // 4, 4)
    sh = torch.arange(0, 32, 8, dtype=torch.int64, device=packed.device)
    return (pb << sh).sum(dim=2)


def _decode_counts_ovf(c2: np.ndarray, ovf_bits: np.ndarray, B: int):
    counts = np.empty(B, dtype=np.int32)
    counts[0::2] = c2 & 0xFFFF
    counts[1::2] = (c2 >> 16) & 0xFFFF
    bit = np.arange(B) & 31
    overflow = ((ovf_bits[np.arange(B) >> 5] >> bit) & 1).astype(bool)
    return counts, overflow


def _check_shape(batch: int, max_len: int) -> None:
    if batch % 32 or max_len > 511 or max_len % 16:
        raise ValueError("batch must be a multiple of 32 and max_len a "
                         "multiple of 16 below 512")


class _SeedKernelBase:
    """What the three kernels share: the seed scan their tables and
    options call for, and the expansion of the seeds into a flat buffer
    of H hits resolved through the SA.

    fm: a DeviceFM3 (the occ3 scans; lane compaction when 0 <
    compact_lanes < batch) or a DeviceFMIndex (the 1-step scan)."""

    def __init__(self, fm, max_len: int, batch: int, H: int,
                 compact_lanes: int = 0):
        self.fm = fm
        self.use_occ3 = isinstance(fm, DeviceFM3)
        self.fm1 = fm.fm if self.use_occ3 else fm
        self.max_len = max_len
        self.batch = batch
        self.H = H
        self.max_seeds = max_len // (MIN_SEED_LEN + 1) + 2
        self.compact_lanes = (compact_lanes if self.use_occ3
                              and 0 < compact_lanes < batch else 0)

    def _scan_packed(self, packed: torch.Tensor, rlens: torch.Tensor):
        """Seed tables of a batch of 2-bit reads (uint8[B, max_len/4],
        rlens int32[B]): one scan kernel launch on the card, the plain
        scan on the CPU (ops/seed_scan_device.py)."""
        if self.use_occ3:
            return seed_scan3(self.fm, packed, rlens, self.max_len,
                              self.max_seeds, lanes=self.compact_lanes)
        return seed_scan1(self.fm, packed, rlens, self.max_len,
                          self.max_seeds, has_n=False)

    def _hits(self, n_seeds, s_rpos, s_len, s_x0, s_freq):
        """Expand each seed by its frequency into a flat buffer of H hits
        (truncated or padded, as jnp.repeat with total_repeat_length) and
        resolve them through the SA: a scan and a hits kernel launch on
        the card (ops/chain_kernels.py). Returns (off int32[B+1], each
        read's first hit and the total last; chain_kernels.Hits)."""
        scan = chain_scan_seeds(s_freq, n_seeds, self.H)
        return scan.off, chain_hits(self.fm1, scan, n_seeds, s_rpos, s_len,
                                    s_x0, s_freq, self.H)


class SeedChainKernel(_SeedKernelBase):
    """Seeding + SA resolve + classification for one (bucket, batch,
    tier) shape. Call with (packed uint8[B, max_len/4], rlens int32[B])
    on the tables' device -> (packed_out int32, pd int32[B],
    mmp int32[B, 4]). Output vector layout:

      [meta1[B]  : cls | mm<<2 | rplast<<8 | cscore<<17,
       pd[B]     : the single diagonal of FAST reads,
       hit_w[H2] : rpos<<9|len for SLOW reads' hits only,
       hit_loc[H2], counts2[B/2] (slow reads; fast/nocand get 0),
       ovfbits[B/32], total_slow_kept, buffer_overflow]

    Fast/nocand reads transfer 8 bytes instead of their hits, and the
    host skips chaining + alignment for them entirely.

    With `planes` (pipeline/device_profile.DevicePlanes) the call also
    applies every device-classified FAST read's evidence to them, in
    place and speculatively: the host later retracts the few it rejects
    (duplicate gate, oracle splices) with device_profile's correct
    kernel. pair_end picks the orientation plane by batch-index parity
    (mates interleave even/odd)."""

    def __init__(self, fm, ctx: ChainCtx, max_len: int, batch: int,
                 slow_hits_x4: int = 5, compact_lanes: int = 0):
        _check_shape(batch, max_len)
        super().__init__(fm, max_len, batch,
                         batch * max(9, slow_hits_x4) // 4, compact_lanes)
        self.ctx = ctx
        self.H2 = batch * slow_hits_x4 // 4          # compacted slow hits
        self.out_size = 2 * batch + 2 * self.H2 + batch // 2 + batch // 32 + 2

    def __call__(self, packed: torch.Tensor, rlens: torch.Tensor,
                 planes=None, pair_end: bool = False, out=None):
        """out: the int32[out_size] vector to write the packed output
        into (a slice of a transfer group's buffer), else a new one."""
        B, H2 = self.batch, self.H2
        # three steps, one or two kernel launches each on the card, which
        # a profiler trace names (classify: the fused classify+pack)
        (n_seeds, s_rpos, s_len, s_x0, s_freq,
         overflow) = self._scan_packed(packed, rlens)
        off, hits = self._hits(n_seeds, s_rpos, s_len, s_x0, s_freq)
        packed_out = (out if out is not None else
                      torch.empty(self.out_size, dtype=torch.int32,
                                  device=packed.device))
        mmp = chain_classify_pack(self.ctx, packed, rlens, off, hits,
                                  overflow, self.max_len, packed_out, H2,
                                  planes, pair_end)
        # pd/mmp stay device-resident for the evidence stage; only
        # packed_out is downloaded
        return packed_out, packed_out[B:2 * B], mmp

    def collect(self, dev_packed: torch.Tensor):
        """Host decode of the packed vector -> (cls, pd, mm, rplast,
        cscore, counts, rpos, gpos, slen, overflow, buffer_overflow)."""
        p = dev_packed.cpu().numpy()
        B, H2 = self.batch, self.H2
        meta1 = p[0:B]
        pd0 = p[B:2 * B]
        o = 2 * B
        hit_w = p[o:o + H2]
        hit_loc = p[o + H2:o + 2 * H2]
        o += 2 * H2
        counts, overflow = _decode_counts_ovf(p[o:o + B // 2],
                                              p[o + B // 2:o + B // 2 + B // 32],
                                              B)
        total = int(p[-2])
        buf_ovf = bool(p[-1])
        n = min(total, H2)
        rpos = (hit_w[:n] >> 9) & 0x1FF
        lens = hit_w[:n] & 0x1FF
        cls = meta1 & 3
        mm = (meta1 >> 2) & 0x3F
        rplast = (meta1 >> 8) & 0x1FF
        cscore = (meta1 >> 17) & 0x1FF
        return (cls, pd0, mm, rplast, cscore, counts, rpos,
                hit_loc[:n].astype(np.int64), lens, overflow, buf_ovf)


class SeedKernelPacked(_SeedKernelBase):
    """Seeding + SA resolve for host chaining (device_chain=False). Call
    with (packed uint8[B, max_len/4], rlens int32[B]) on the tables'
    device -> one int32 vector:

      [hit_w[H]    : rpos<<9 | len (0 => empty slot),
       hit_loc[H]  : text position of the hit,
       counts2[B/2]: per-read kept-hit counts, 2 x int16 per word,
       ovfbits[B/32], total_kept, buffer_overflow]

    Hits are filtered on the card (PosDiff > 0, exactly the host filter)
    and compacted grouped by read, so the host hands them straight to
    the native chainer. H = B * hits_per_read_x4 / 4 pooled across the
    batch; an overflow reruns at a larger tier."""

    def __init__(self, fm, max_len: int, batch: int,
                 hits_per_read_x4: int = 9, compact_lanes: int = 0):
        _check_shape(batch, max_len)
        super().__init__(fm, max_len, batch, batch * hits_per_read_x4 // 4,
                         compact_lanes)

    def __call__(self, packed: torch.Tensor, rlens: torch.Tensor):
        B, H = self.batch, self.H
        i64 = torch.int64
        (n_seeds, s_rpos, s_len, s_x0, s_freq,
         overflow) = self._scan_packed(packed, rlens)
        off, hits = self._hits(n_seeds, s_rpos, s_len, s_x0, s_freq)
        overflow = overflow | hits.unresolved
        # device-side PosDiff > 0 filter (hits.keep: ReadMapping.cpp:136
        # keeps only hits right of the read origin) + stable compaction
        # by hit order; dropped hits write the dump slot H
        keep = hits.keep
        slot = torch.where(keep, torch.cumsum(keep.to(i64), 0) - 1, H)
        hit_w_c = torch.zeros(H + 1, dtype=i64, device=packed.device)
        hit_w_c.index_copy_(0, slot, (hits.rpos.to(i64) << 9)
                            | hits.len.to(i64))
        hit_loc_c = torch.zeros_like(hit_w_c).index_copy_(
            0, slot, hits.loc.to(i64))
        counts = torch.zeros(B, dtype=i64, device=packed.device
                             ).index_add_(0, hits.read.to(i64),
                                          keep.to(i64))
        return to_i32(torch.cat([
            hit_w_c[:H], hit_loc_c[:H], counts2(counts),
            ovf_words(overflow),
            torch.stack([keep.sum(), (off[B] > H).to(i64)])]))

    def collect(self, dev_packed: torch.Tensor):
        """Host decode -> (counts, rpos, gpos, slen, overflow,
        buffer_overflow), hits grouped by read."""
        p = dev_packed.cpu().numpy()
        B, H = self.batch, self.H
        hit_w = p[0:H]
        hit_loc = p[H:2 * H]
        o = 2 * H
        counts, overflow = _decode_counts_ovf(p[o:o + B // 2],
                                              p[o + B // 2:o + B // 2 + B // 32],
                                              B)
        total = int(p[-2])
        buf_ovf = bool(p[-1])
        n = min(total, H)
        rpos = (hit_w[:n] >> 9) & 0x1FF
        lens = hit_w[:n] & 0x1FF
        return (counts, rpos, hit_loc[:n].astype(np.int64), lens, overflow,
                buf_ovf)


class SeedKernel(_SeedKernelBase):
    """The non-native path's seeding over the 1-step index. Call with
    (codes uint8[B, max_len] with ambiguous bases and padding as 4,
    rlens int32[B]) on the tables' device -> one int32 vector:

      [meta[H]   : read << 18 | rpos << 9 | len (len 0 <=> empty slot),
       hit_loc[H], ovfbits[ceil(B/32)], total hits, buffer_overflow]

    H = B * hits_per_read; every hit is returned, the PosDiff filter is
    the host's."""

    def __init__(self, fm: DeviceFMIndex, max_len: int, batch: int,
                 hits_per_read: int = 8):
        if batch > 8192 or max_len > 511:
            raise ValueError("meta packing limits: batch <= 8192 and "
                             "max_len <= 511")
        super().__init__(fm, max_len, batch, batch * hits_per_read)

    def __call__(self, codes: torch.Tensor, rlens: torch.Tensor):
        i64 = torch.int64
        (n_seeds, s_rpos, s_len, s_x0, s_freq, overflow) = seed_scan1(
            self.fm, codes, rlens, self.max_len, self.max_seeds,
            has_n=True)
        off, hits = self._hits(n_seeds, s_rpos, s_len, s_x0, s_freq)
        # reads owning an unresolved hit fall back to the host oracle
        overflow = overflow | hits.unresolved
        meta = torch.where(hits.valid, (hits.read.to(i64) << 18)
                           | (hits.rpos.to(i64) << 9) | hits.len.to(i64), 0)
        total = off[-1].to(i64)
        return to_i32(torch.cat([
            meta, hits.loc.to(i64), ovf_words(overflow),
            torch.stack([total, (total > self.H).to(i64)])]))

    def collect(self, dev_packed: torch.Tensor):
        """Host decode -> (hit_read, hit_rpos, hit_len, hit_loc,
        hit_valid, total, overflow, buffer_overflow)."""
        packed = dev_packed.cpu().numpy()
        B, H = self.batch, self.H
        meta = packed[0:H]
        hit_loc = packed[H:2 * H]
        nov = (B + 31) // 32
        ovf_bits = packed[2 * H:2 * H + nov]
        total = int(packed[2 * H + nov])
        buf_ovf = bool(packed[2 * H + nov + 1])
        hit_len = meta & 0x1FF
        hit_rpos = (meta >> 9) & 0x1FF
        hit_read = meta >> 18
        bit = np.arange(B) & 31
        overflow = ((ovf_bits[np.arange(B) >> 5] >> bit) & 1).astype(bool)
        return (hit_read, hit_rpos, hit_len, hit_loc, hit_len > 0, total,
                overflow, buf_ovf)


def build_seed_chain_kernel(fm, chain_ctx: ChainCtx, max_len: int,
                            batch: int, slow_hits_x4: int = 5,
                            compact_lanes: int = 0) -> SeedChainKernel:
    return SeedChainKernel(fm, chain_ctx, max_len, batch, slow_hits_x4,
                           compact_lanes)


def build_seed_kernel_packed(fm, max_len: int, batch: int,
                             hits_per_read_x4: int = 9,
                             compact_lanes: int = 0) -> SeedKernelPacked:
    return SeedKernelPacked(fm, max_len, batch, hits_per_read_x4,
                            compact_lanes)


def build_seed_kernel(fm: DeviceFMIndex, max_len: int, batch: int,
                      hits_per_read: int = 8) -> SeedKernel:
    return SeedKernel(fm, max_len, batch, hits_per_read)


def seeds_to_frag_pairs(hit_read: np.ndarray, hit_rpos: np.ndarray,
                        hit_len: np.ndarray, hit_loc: np.ndarray,
                        hit_valid: np.ndarray, batch: int,
                        two_genome_size: int) -> List[list]:
    """Host post-processing: per-read sorted FragPair lists with sentinel
    (mirrors IdentifySimplePairs ordering, ReadMapping.cpp:152-155)."""
    from ..pipeline.seeding import FragPair
    out: List[list] = [[] for _ in range(batch)]
    pd = hit_loc.astype(np.int64) - hit_rpos
    keep = hit_valid & (pd > 0)
    for b, rpos, ln, loc, d in zip(hit_read[keep], hit_rpos[keep],
                                   hit_len[keep], hit_loc[keep], pd[keep]):
        out[b].append(FragPair(True, int(rpos), int(loc), int(ln), int(ln),
                               int(d)))
    for b in range(batch):
        out[b].sort(key=lambda f: (f.PosDiff, f.rPos))
        out[b].append(FragPair(True, 0, two_genome_size, 0, 0,
                               two_genome_size))
    return out
