"""Batched greedy-MEM seeding + device chaining (PyTorch port of
mapcaller_tpu/ops/fm_search.py: `_seed_scan3` and
`build_seed_chain_kernel`, whose with_planes branch is the `planes`
argument of SeedChainKernel.__call__).

Device equivalent of BWT_Search + IdentifySimplePairs
(ref: src/bwt_search.cpp:121-164, src/ReadMapping.cpp:125-158): every
read in the batch advances one state-machine step per iteration of a
lockstep loop over the occ3 table (ops/fm3_device.py). Hits are then
expanded by seed frequency into a flat buffer, resolved through the SA,
and classified per read (ops/chain_device.py); one packed int32 vector
per batch carries everything the host needs.

This slice runs all of it as PyTorch tensor code: the loop is a Python
loop of 8-step blocks with one host sync per block for the early exit.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from .chain_device import CLASS_FAST, CLASS_SLOW, ChainCtx, classify_reads
from .evidence import first_mate_lanes, scatter_fast_evidence
from .fm3_device import DeviceFM3, gather3, step1_update, step3_update
from .fm_device import M32, sa_resolve, to_i32

OCC_THR = 50
MIN_SEED_LEN = 16
UNROLL = 8          # scan steps between early-exit checks


def _pfx_entry(cnt64, key):
    """Extract the packed prefix entry (x0, x1, x2) for prefix key `key`
    from a gathered row whose 64 count slots hold 16 packed 4-int32
    entries (ops/fm3_device._embed_pfx): component j at slot
    (key & 15) * 4 + j."""
    base = ((key & 15) << 2)[:, None]
    return (cnt64.gather(1, base)[:, 0], cnt64.gather(1, base + 1)[:, 0],
            cnt64.gather(1, base + 2)[:, 0])


def _seed_scan3(fm3: DeviceFM3, codes_fn, rlens, B: int, max_len: int,
                max_seeds: int, key_fn=None):
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
    int64[B], int64[B, max_seeds] x4, bool[B]."""
    dev = rlens.device
    i64 = torch.int64
    L2 = fm3.L2
    FUSE = bool(fm3.pfx_base) and key_fn is not None
    K = fm3.pfx_k if FUSE else 0
    PFXI = (int(fm3.pfx_base) << 4) if FUSE else 0
    rlens = rlens.to(i64)
    stop_pos = rlens - MIN_SEED_LEN
    slot_ids = torch.arange(max_seeds, dtype=i64, device=dev)[None, :]

    z = torch.zeros(B, dtype=i64, device=dev)
    zb = torch.zeros(B, dtype=torch.bool, device=dev)
    zs = torch.zeros((B, max_seeds), dtype=i64, device=dev)
    st = dict(pos=z, in_ext=zb, replay=zb, start=z, ext_pos=z, x0=z, x1=z,
              x2=z, n_seeds=z, s_rpos=zs, s_len=zs, s_x0=zs, s_freq=zs,
              overflow=zb)

    def step(s):
        pos, in_ext, replay = s["pos"], s["in_ext"], s["replay"]
        start, ext_pos = s["start"], s["ext_pos"]
        x0, x1, x2, n_seeds = s["x0"], s["x1"], s["x2"], s["n_seeds"]
        active = in_ext | (pos < stop_pos)

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
        if FUSE:
            # start lanes fetch the embedded prefix row for the K-mer at
            # pos instead of a dummy row (key >> 4 = row, key & 15 = entry)
            key = key_fn(torch.clamp(pos, max=max_len - 1))
            k = torch.where(start_new, PFXI + key, k)
        gk = gather3(fm3, k)
        gl = gather3(fm3, l)
        if FUSE:
            p_x0, p_x1, p_x2 = _pfx_entry(gk[0], key)
            jump = start_new & (p_x2 > 0)
            x0_init = torch.where(jump, p_x0, x0_init)
            x1_init = torch.where(jump, p_x1, x1_init)
            x2_init = torch.where(jump, p_x2, x2_init)
            ext_init = torch.where(jump, pos + K, ext_init)
        n3_x0, n3_x1, n3_x2 = step3_update(fm3, x0, k, x2, e0, e1, e2, gk, gl)
        n1_x0, n1_x1, n1_x2 = step1_update(fm3, x0, k, x2, e0, gk, gl)

        fail3 = use3 & (n3_x2 <= 0)     # exact end within these 3 bases
        ok3 = use3 & ~fail3
        fail1 = use1 & (n1_x2 <= 0)
        ok1 = use1 & ~fail1

        finalize = at_end | fail1
        slen = ext_pos - start
        good = finalize & (slen >= MIN_SEED_LEN) & (x2 <= OCC_THR)
        slot = torch.clamp(n_seeds, max=max_seeds - 1)
        overflow = s["overflow"] | (finalize & good & (n_seeds >= max_seeds))
        onehot = (slot_ids == slot[:, None]) & good[:, None]

        def put(arr, val):
            return torch.where(onehot, val[:, None], arr)

        def pick(init, n3, n1, keep):
            return torch.where(start_new, init, torch.where(
                ok3, n3, torch.where(ok1, n1, keep)))

        return dict(
            pos=torch.where(finalize, start + slen + 1, pos),
            in_ext=torch.where(start_new, True,
                               torch.where(finalize, False, in_ext)),
            replay=torch.where(finalize, False,
                               torch.where(start_new, False,
                                           replay | fail3)),
            start=torch.where(start_new, pos, start),
            ext_pos=pick(ext_init, ext_pos + 3, ext_pos + 1, ext_pos),
            x0=pick(x0_init, n3_x0, n1_x0, x0),
            x1=pick(x1_init, n3_x1, n1_x1, x1),
            x2=pick(x2_init, n3_x2, n1_x2, x2),
            n_seeds=torch.where(good, torch.clamp(n_seeds + 1,
                                                  max=max_seeds), n_seeds),
            s_rpos=put(s["s_rpos"], start), s_len=put(s["s_len"], slen),
            s_x0=put(s["s_x0"], x0), s_freq=put(s["s_freq"], x2),
            overflow=overflow)

    # worst case ~1.5 iterations/base (len-1 MEMs: init + 3-fail +
    # 1-replay-fail per 2-base advance) + 2/seed finalize
    n_iters = (3 * max_len) // 2 + 2 * max_seeds + 8
    n_blocks = (n_iters + UNROLL - 1) // UNROLL
    for _ in range(n_blocks):
        # one host sync per block: stop once every lane is done
        if not bool((st["in_ext"] | (st["pos"] < stop_pos)).any()):
            break
        for _ in range(UNROLL):
            st = step(st)
    return (st["n_seeds"], st["s_rpos"], st["s_len"], st["s_x0"],
            st["s_freq"], st["overflow"])


def _read_words_le(packed: torch.Tensor) -> torch.Tensor:
    """uint8[B, W4] 2-bit codes (4 per byte, base q of a byte at bits 2q)
    -> int64[B, W4/4] little-endian 32-bit words (base j at bits
    2*(j%16) of word j//16)."""
    B, W4 = packed.shape
    pb = packed.to(torch.int64).reshape(B, W4 // 4, 4)
    sh = torch.arange(0, 32, 8, dtype=torch.int64, device=packed.device)
    return (pb << sh).sum(dim=2)


def _read_words_bwa(packed: torch.Tensor, max_len: int) -> torch.Tensor:
    """The same reads in bwa crumb order (base j at bits
    (15 - j%16)*2 of word j//16), for the diagonal compare."""
    B, W4 = packed.shape
    pb = packed.to(torch.int64)
    q = torch.arange(0, 8, 2, dtype=torch.int64, device=packed.device)
    crumb = ((pb[:, :, None] >> q) & 3).reshape(B, W4 * 4)[:, :max_len]
    j = torch.arange(max_len, dtype=torch.int64, device=packed.device)
    return (crumb << ((15 - (j & 15)) * 2)).reshape(B, -1, 16).sum(dim=2)


def _repeat_to(x: torch.Tensor, csum_incl: torch.Tensor,
               hpos: torch.Tensor) -> torch.Tensor:
    """jnp.repeat(x, reps, total_repeat_length=H), given the inclusive
    cumsum of reps and hpos = arange(H): truncated to H, or padded with
    x[-1] when sum(reps) < H."""
    src = torch.searchsorted(csum_incl, hpos, right=True)
    return x[torch.clamp(src, max=x.shape[0] - 1)]


class SeedChainKernel:
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

    def __init__(self, fm3: DeviceFM3, ctx: ChainCtx, max_len: int,
                 batch: int, slow_hits_x4: int = 5):
        if batch % 32 or max_len > 511 or max_len % 16:
            raise ValueError("batch must be a multiple of 32 and max_len a "
                             "multiple of 16 below 512")
        self.fm3 = fm3
        self.ctx = ctx
        self.max_len = max_len
        self.batch = batch
        self.max_seeds = max_len // (MIN_SEED_LEN + 1) + 2
        self.H = batch * max(9, slow_hits_x4) // 4   # raw hit capacity
        self.H2 = batch * slow_hits_x4 // 4          # compacted slow hits

    def __call__(self, packed: torch.Tensor, rlens: torch.Tensor,
                 planes=None, pair_end: bool = False):
        fm3, B, max_len = self.fm3, self.batch, self.max_len
        max_seeds = self.max_seeds
        dev = packed.device
        i64 = torch.int64
        words_le = _read_words_le(packed)                 # [B, nwords]
        nwords = words_le.shape[1]
        bidx = torch.arange(B, dtype=i64, device=dev)

        def codes_fn(pos):
            w = words_le[bidx, pos >> 4]
            return (w >> ((pos & 15) * 2)) & 3

        def key_fn(pos):
            wi = pos >> 4
            w0 = words_le[bidx, wi]
            w1 = torch.where(wi + 1 < nwords,
                             words_le[bidx, torch.clamp(wi + 1,
                                                        max=nwords - 1)], 0)
            sh = (pos & 15) * 2
            comb = (w0 >> sh) | torch.where(sh > 0, (w1 << (32 - sh)) & M32,
                                            0)
            KK = fm3.pfx_k
            key = torch.zeros_like(pos)
            for j in range(KK):
                key = key | (((comb >> (2 * j)) & 3) << (2 * (KK - 1 - j)))
            return key

        # named ranges for profiler traces (trace_main_path.py)
        with record_function("seed_scan"):
            (n_seeds, s_rpos, s_len, s_x0, s_freq, overflow) = _seed_scan3(
                fm3, codes_fn, rlens, B, max_len, max_seeds,
                key_fn=key_fn if fm3.pfx_k else None)
        with record_function("hits_sa_resolve"):
            (hit_read, hit_rpos, hit_len, hit_loc, keep, unresolved_read,
             buffer_overflow) = self._hits(n_seeds, s_rpos, s_len, s_x0,
                                           s_freq)
            overflow = overflow | (unresolved_read > 0)
        with record_function("classify"):
            words_bwa = _read_words_bwa(packed, max_len)
            cls, pd0, mm, rplast, cscore, mmp = classify_reads(
                self.ctx, words_bwa, rlens.to(i64), hit_read, hit_rpos,
                hit_len, hit_loc, keep, max_len)
            # per-read seed-table overflow forces the host-oracle path
            cls = torch.where(unresolved_read > 0, CLASS_SLOW, cls)
        with record_function("pack"):
            packed_out = self._pack(cls, pd0, mm, rplast, cscore, hit_read,
                                    hit_rpos, hit_len, hit_loc, keep,
                                    overflow, buffer_overflow)
        pd0, mmp = pd0.to(torch.int32), mmp.to(torch.int32)
        if planes is not None:
            with record_function("evidence_apply"):
                scatter_fast_evidence(
                    planes.exact_diff, planes.f_diff.view(-1),
                    planes.acgt.view(-1), cls == CLASS_FAST, pd0, mmp, rlens,
                    first_mate_lanes(bidx, pair_end), self.ctx.seq_len // 2,
                    self.ctx.seq_len, sign=1)
        # pd/mmp stay device-resident for the evidence stage; only
        # packed_out is downloaded
        return packed_out, pd0, mmp

    def _hits(self, n_seeds, s_rpos, s_len, s_x0, s_freq):
        """Expand each seed by its frequency into a flat hit buffer
        (padded/truncated to H, as jnp.repeat with total_repeat_length)
        and resolve the hits through the SA."""
        B, H, max_seeds = self.batch, self.H, self.max_seeds
        dev = n_seeds.device
        i64 = torch.int64
        seed_valid = (torch.arange(max_seeds, dtype=i64, device=dev)[None, :]
                      < n_seeds[:, None])
        freqs = torch.where(seed_valid, s_freq, 0).reshape(-1)
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
                       .repeat_interleave(max_seeds))
        hit_valid = hpos < torch.clamp(total_raw, max=H)

        hit_loc, resolved = sa_resolve(
            self.fm3.fm, torch.where(hit_valid, hit_row, 32), hit_valid)
        unresolved_read = torch.zeros(B, dtype=i64, device=dev).scatter_reduce(
            0, hit_read, (hit_valid & ~resolved).to(i64), "amax")
        keep = hit_valid & ((hit_loc - hit_rpos) > 0)
        return (hit_read, hit_rpos, hit_len, hit_loc, keep, unresolved_read,
                total_raw > H)

    def _pack(self, cls, pd0, mm, rplast, cscore, hit_read, hit_rpos,
              hit_len, hit_loc, keep, overflow, buffer_overflow):
        """The packed output vector (layout in the class docstring):
        SLOW reads' kept hits compacted in order, slots >= H2 dropped."""
        B, H2 = self.batch, self.H2
        dev = cls.device
        i64 = torch.int64
        meta1 = cls | (mm << 2) | (rplast << 8) | (cscore << 17)
        keep_slow = keep & (cls[torch.clamp(hit_read, 0, B - 1)] == CLASS_SLOW)
        dest = torch.cumsum(keep_slow.to(i64), 0) - 1
        sel = (keep_slow & (dest < H2)).nonzero()[:, 0]
        hit_w_c = torch.zeros(H2, dtype=i64, device=dev)
        hit_w_c[dest[sel]] = ((hit_rpos << 9) | hit_len)[sel]
        hit_loc_c = torch.zeros(H2, dtype=i64, device=dev)
        hit_loc_c[dest[sel]] = hit_loc[sel]
        counts = torch.zeros(B, dtype=i64, device=dev).index_add_(
            0, hit_read, keep_slow.to(i64))
        counts2 = (counts[0::2] & 0xFFFF) | (counts[1::2] << 16)
        total_kept = keep_slow.sum()
        buffer_overflow = buffer_overflow | (total_kept > H2)
        ovf_bits = (overflow.to(i64).reshape(B // 32, 32)
                    << torch.arange(32, dtype=i64, device=dev)).sum(dim=1)
        return to_i32(torch.cat([
            meta1, pd0, hit_w_c, hit_loc_c, counts2, ovf_bits,
            torch.stack([total_kept, buffer_overflow.to(i64)])]))

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
        c2 = p[o:o + B // 2]
        counts = np.empty(B, dtype=np.int32)
        counts[0::2] = c2 & 0xFFFF
        counts[1::2] = (c2 >> 16) & 0xFFFF
        o += B // 2
        ovf_bits = p[o:o + B // 32]
        total = int(p[-2])
        buf_ovf = bool(p[-1])
        bit = (np.arange(B) & 31)
        overflow = ((ovf_bits[np.arange(B) >> 5] >> bit) & 1).astype(bool)
        n = min(total, H2)
        rpos = (hit_w[:n] >> 9) & 0x1FF
        lens = hit_w[:n] & 0x1FF
        cls = meta1 & 3
        mm = (meta1 >> 2) & 0x3F
        rplast = (meta1 >> 8) & 0x1FF
        cscore = (meta1 >> 17) & 0x1FF
        return (cls, pd0, mm, rplast, cscore, counts, rpos,
                hit_loc[:n].astype(np.int64), lens, overflow, buf_ovf)


def build_seed_chain_kernel(fm3: DeviceFM3, chain_ctx: ChainCtx,
                            max_len: int, batch: int,
                            slow_hits_x4: int = 5) -> SeedChainKernel:
    return SeedChainKernel(fm3, chain_ctx, max_len, batch, slow_hits_x4)
