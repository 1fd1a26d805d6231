"""Device chaining + fast-path classification (PyTorch port of
mapcaller_tpu/ops/chain_device.py).

After seeding, the reference chains seeds by diagonal, aligns, and
accumulates evidence on the CPU (ref: src/ReadMapping.cpp:194-226
SimplePairClustering, src/ReadAlignment.cpp:306-430). Here each read is
classified right after SA resolution, on the device:

  FAST   — every kept hit lies on ONE diagonal pd, the single cluster
           passes the score threshold, the whole span [pd, pd+rlen)
           stays inside one chromosome block, and no uncovered gap along
           the diagonal triggers the gapped DP of ProcessNormalPair
           (ref: ReadAlignment.cpp:184-188, mis > 1 && mis >=
           int(len*0.2), with int(n*0.2) == n//5 exactly). The host needs
           only (pd, mismatch count, last-block start, cluster score).
  NOCAND — no kept hits, or the single-diagonal cluster fails
           score > rlen/4: the host would produce zero candidates.
  SLOW   — everything else: hits are compacted and downloaded for the
           host pipeline.

The head/tail quality vetoes (ref: ReadAlignment.cpp:193-232) cannot
fire on a read passing the gap conditions: mg >= 3 && mg >= int(0.3*lg)
contradicts NOT(mg > 1 && mg >= int(0.2*lg)).

Words (text and read) are int64 holding uint32 bit patterns (see
ops/fm_device.py); positions are computed in int64. classify_reads is
dtype-generic as the reference's (chain_device.py:115-117): the hit
locations' dtype sets the empty-slot diagonal, its largest value (int32
on the main path, int64 on the x64 big-genome path), and everything else
is the same.

classify_reads is the plain PyTorch version of the classify part of the
classify+pack kernel (ops/chain_kernels.chain_classify_pack,
csrc/chain.cu), which the chain dispatch launches on the card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .fm_device import M32

K_HITS = 8          # per-read hit window; more => slow path
MAX_GAPS = 10       # K_HITS + head + tail
MM_SLOTS = 4        # mismatch positions carried for device evidence
CLASS_NOCAND = 0
CLASS_FAST = 1
CLASS_SLOW = 2
INT32_MAX = 0x7FFFFFFF


@dataclasses.dataclass
class ChainCtx:
    text_words: torch.Tensor   # int64[nw+2]: packed 2-bit text, bwa order
    bkeys: torch.Tensor        # int64[nb]: sorted chrom end positions
    seq_len: int               # 2L

    @classmethod
    def from_host(cls, idx, device="cuda") -> "ChainCtx":
        from .fm3_device import packed_text_words
        genome = idx.ref
        two_l = idx.seq_len
        # chrom end positions, both strands (mirrors Ctx.bkeys in C++)
        keys = [off + ln for off, ln in zip(genome.offsets, genome.lengths)]
        keys += [two_l - off for off in reversed(genome.offsets)]
        return cls(text_words=packed_text_words(idx, device),
                   bkeys=torch.as_tensor(np.asarray(sorted(keys),
                                                    dtype=np.int64),
                                         device=torch.device(device)),
                   seq_len=int(two_l))


def _sort_slots(pd, rpos, ln):
    """Odd-even transposition sort over the K_HITS axis by (pd, rpos);
    empty slots carry the largest pd and sink to the end."""
    pd, rpos, ln = pd.clone(), rpos.clone(), ln.clone()
    K = pd.shape[-1]
    for phase in range(K):
        for i in range(phase & 1, K - 1, 2):
            a_pd, b_pd = pd[:, i].clone(), pd[:, i + 1].clone()
            a_rp, b_rp = rpos[:, i].clone(), rpos[:, i + 1].clone()
            a_ln, b_ln = ln[:, i].clone(), ln[:, i + 1].clone()
            swap = (a_pd > b_pd) | ((a_pd == b_pd) & (a_rp > b_rp))
            pd[:, i] = torch.where(swap, b_pd, a_pd)
            pd[:, i + 1] = torch.where(swap, a_pd, b_pd)
            rpos[:, i] = torch.where(swap, b_rp, a_rp)
            rpos[:, i + 1] = torch.where(swap, a_rp, b_rp)
            ln[:, i] = torch.where(swap, b_ln, a_ln)
            ln[:, i + 1] = torch.where(swap, a_ln, b_ln)
    return pd, rpos, ln


def _crumb_shifts(max_len: int, dev) -> tuple:
    jpos = torch.arange(max_len, dtype=torch.int64, device=dev)
    return jpos, jpos >> 4, (15 - (jpos & 15)) * 2


def read_base(read_words: torch.Tensor, max_len: int) -> torch.Tensor:
    """Expand bwa-order packed read words to per-position codes
    int64[B, max_len]."""
    _, wsel, sh = _crumb_shifts(max_len, read_words.device)
    return (read_words[:, wsel] >> sh[None, :]) & 3


def classify_reads(ctx: ChainCtx, read_words: torch.Tensor,
                   rlens: torch.Tensor, hit_read, hit_rpos, hit_len, hit_loc,
                   keep, max_len: int):
    """All inputs are flat hit arrays (grouped by read) + per-read data.
    Returns (cls, pd, mm, rplast, cscore, mmp), int64[B] each and
    mmp int64[B, MM_SLOTS], with pd = the single diagonal of FAST reads
    (for reads without kept hits the largest value of hit_loc's dtype:
    INT32_MAX for int32 locations, INT64_MAX for int64 ones)."""
    B = read_words.shape[0]
    dev = read_words.device
    i64 = torch.int64
    pd_empty = torch.iinfo(hit_loc.dtype).max
    hit_loc = hit_loc.to(i64)
    keep_i = keep.to(i64)

    # ---- scatter kept hits into per-read K-slot windows ------------------
    dest = torch.cumsum(keep_i, 0) - 1
    first = torch.full((B,), INT32_MAX, dtype=i64, device=dev).scatter_reduce(
        0, hit_read, torch.where(keep, dest, INT32_MAX), "amin")
    within = dest - first[torch.clamp(hit_read, 0, B - 1)]
    nkept = torch.zeros(B, dtype=i64, device=dev).index_add_(0, hit_read,
                                                             keep_i)
    ok_slot = keep & (within >= 0) & (within < K_HITS)
    # other hits write the dump row B: no host sync for a count
    flat = (torch.where(ok_slot, hit_read, B) * K_HITS
            + torch.where(ok_slot, within, 0))

    def slots(fill, val):
        out = torch.full(((B + 1) * K_HITS,), fill, dtype=i64, device=dev)
        out.index_copy_(0, flat, val)
        return out.reshape(B + 1, K_HITS)[:B]

    s_pd = slots(pd_empty, hit_loc - hit_rpos)
    s_rp = slots(0, hit_rpos)
    s_ln = slots(0, hit_len)
    s_pd, s_rp, s_ln = _sort_slots(s_pd, s_rp, s_ln)

    has_hits = nkept > 0
    too_many = nkept > K_HITS
    valid_slot = s_pd != pd_empty
    pd0 = s_pd[:, 0]
    same_diag = s_pd == pd0[:, None]
    one_diag = (torch.where(valid_slot, s_pd, pd0[:, None])
                == pd0[:, None]).all(dim=1)
    cscore = torch.where(valid_slot, s_ln, 0).sum(dim=1)
    has_can = cscore > (rlens >> 2)

    # ---- chromosome containment of the full span [pd, pd+rlen) ----------
    span_ok = (pd0 + rlens) <= ctx.seq_len
    # lower_bound semantics, matching the reference's PosChrIdMap lookups
    # (tools.cpp:132-164)
    b1 = torch.searchsorted(ctx.bkeys, torch.clamp(pd0, 0, ctx.seq_len - 1))
    b2 = torch.searchsorted(ctx.bkeys, torch.clamp(pd0 + rlens - 1, 0,
                                                   ctx.seq_len - 1))
    span_ok = span_ok & (b1 == b2)

    # ---- diagonal mismatch mask ------------------------------------------
    nwords = read_words.shape[1]
    pds = torch.where(span_ok & has_hits, pd0, 0)
    sh = ((pds & 15) * 2)[:, None]
    widx = torch.arange(nwords + 1, dtype=i64, device=dev)[None, :]
    tw = ctx.text_words[torch.clamp((pds >> 4)[:, None] + widx, 0,
                                    ctx.text_words.shape[0] - 1)]
    lo = torch.where(sh > 0, tw[:, 1:] >> (32 - sh), 0)
    aligned = ((tw[:, :-1] << sh) & M32) | lo              # [B, nwords]
    x = aligned ^ read_words
    y = (x | (x >> 1)) & 0x55555555                       # crumb-mismatch bits
    jpos, wsel, bit = _crumb_shifts(max_len, dev)
    inlen = jpos[None, :] < rlens[:, None]
    mmask = ((y[:, wsel] >> bit[None, :]) & 1).bool() & inlen

    # ---- coverage mask + per-gap conditions ------------------------------
    sk = torch.where(same_diag, s_rp, max_len)               # [B, K]
    ek = sk + torch.where(same_diag, s_ln, 0)
    cov = ((jpos[None, None, :] >= sk[:, :, None])
           & (jpos[None, None, :] < ek[:, :, None])).any(dim=1)
    uncov = (~cov) & inlen
    gap_start = uncov & torch.cat(
        [torch.ones((B, 1), dtype=torch.bool, device=dev), cov[:, :-1]],
        dim=1)
    gapidx = torch.cumsum(gap_start.to(i64), dim=1) - 1
    dp_any = torch.zeros(B, dtype=torch.bool, device=dev)
    for g in range(MAX_GAPS):
        mask_g = uncov & (gapidx == g)
        lg = mask_g.sum(dim=1)
        mg = (mask_g & mmask).sum(dim=1)
        dp_any = dp_any | ((lg > 0) & (mg > 1) & (mg >= lg // 5))
    many_gaps = (uncov & (gapidx >= MAX_GAPS)).any(dim=1)
    mm_total = (mmask & uncov).sum(dim=1)

    # last alignment block start: tail gap start if the read end is
    # uncovered, else the last seed's rPos (feeds frags[0].gPos of
    # reverse-strand candidates, ref: SamReport.cpp:121-170)
    on_diag = valid_slot & same_diag
    seed_end = torch.where(on_diag, s_rp + s_ln, 0).max(dim=1).values
    seed_last_rp = torch.where(on_diag, s_rp, -1).max(dim=1).values
    rplast = torch.where(seed_end < rlens, seed_end, seed_last_rp)

    # packed mismatch positions for the evidence kernel: up to MM_SLOTS
    # of (read_pos << 2 | read_base), -1 = empty, leftmost first. Keys
    # of mismatch positions are distinct, so topk's order among the
    # equal zero keys never reaches the output.
    key = torch.where(mmask, max_len - jpos[None, :], 0)
    mmi = torch.topk(key, MM_SLOTS, dim=1).indices
    mrow = mmask.gather(1, mmi)
    rbase = read_base(read_words, max_len).gather(1, mmi)
    mmp = torch.where(mrow, (mmi << 2) | rbase, -1)

    fast = (has_hits & ~too_many & one_diag & has_can & span_ok
            & ~dp_any & ~many_gaps & (mm_total <= MM_SLOTS))
    nocand = (~has_hits) | (has_hits & ~too_many & one_diag & ~has_can)
    cls = torch.where(fast, CLASS_FAST,
                      torch.where(nocand, CLASS_NOCAND, CLASS_SLOW))
    return (cls, pd0, mm_total, torch.clamp(rplast, 0, 511),
            torch.clamp(cscore, 0, 511), mmp)
