"""The port's ksw2 DP (mapcaller_tpu_torch/ops/ksw2_device.py) against
the reference package: the plain PyTorch version's flags and packed op
words equal the reference's XLA fill and backtrack exactly at the tiers
the stream path uses; a scalar mirror of the CUDA kernel csrc/ksw2.cu, as
its groups, lanes and chunks run it, computes the same words; the batch
aligner's strings equal the host oracle's; and the `-alg ksw2` stream with
device DP writes the reference's SAM and VCF and the port's own scalar
run's. On CPU tensors `ksw2_ops` runs its plain version, the same function
the kernel computes on the card."""
import functools
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mapcaller_tpu import runner as jax_runner
from mapcaller_tpu.config import Config as JaxConfig
from mapcaller_tpu.index.fmindex import build_index
from mapcaller_tpu.ops import ksw2_device as jax_ksw2
from mapcaller_tpu.ops.ksw2_host import ksw2_alignment
from mapcaller_tpu_torch import runner
from mapcaller_tpu_torch.config import Config
from mapcaller_tpu_torch.dna import decode
from mapcaller_tpu_torch.ops import ksw2_device
from mapcaller_tpu_torch.ops.nw_device import _encode_side

torch.set_num_threads(1)   # small tensor ops: see test_torch_e2e.py

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mutated_pair(rng, m):
    """A random query of m bases and a target with substitutions,
    insertions and deletions (tests/test_ksw2_device.py's generator)."""
    base = rng.integers(0, 4, size=m).astype(np.uint8)
    s2 = []
    for b in base:
        r = rng.random()
        if r < 0.08:
            continue
        if r < 0.16:
            s2.append(int(rng.integers(0, 4)))
        s2.append((int(b) + 1) % 4 if r < 0.24 else int(b))
    return decode(base), decode(np.array(s2 or [0], dtype=np.uint8))


def _tier_pairs(tier, n, seed):
    """n pairs with both sides in 1..tier and about 5% N bases, plus the
    edges: single bases, sides at the tier's edge, very unequal sides."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        a, b = _mutated_pair(rng, int(rng.integers(1, tier + 1)))
        a, b = a[:tier], b[:tier]
        a = "".join("N" if rng.random() < 0.05 else c for c in a)
        b = "".join("N" if rng.random() < 0.05 else c for c in b)
        pairs.append((a, b))
    edge = decode(rng.integers(0, 4, size=tier).astype(np.uint8))
    pairs += [("A", "A"), ("A", "C"), ("N", "G"), (edge, edge),
              (edge, edge[::-1]), (edge, edge[:1]), (edge[:1], edge),
              (edge[: tier // 3], edge), ("ACGTNACGT", "ACGTACGT")]
    return pairs


def _encode(pairs, tier):
    """(qbuf, target, qlen, tlen) numpy arrays of pairs at a square tier,
    in ksw2_ops's layout."""
    B = len(pairs)
    qbuf, ql = _encode_side([a for a, _ in pairs], tier, B, reverse=True,
                            pad=0)
    tgt, tl = _encode_side([b for _, b in pairs], tier + 16, B, pad=0)
    return qbuf, tgt, ql, tl


@functools.lru_cache(maxsize=None)
def _reference(tier):
    """_tier_pairs(tier, 60) encoded, and the reference's flags and words
    on them (build_ksw2_kernel + build_ksw2_traceback, XLA on the CPU)."""
    enc = _encode(_tier_pairs(tier, 60, seed=tier), tier)
    qbuf, tgt, ql, tl = (jnp.asarray(a) for a in enc)
    want_p = jax_ksw2.build_ksw2_kernel(tier, tier)(qbuf, tgt, ql, tl)
    want_w = np.asarray(jax_ksw2.build_ksw2_traceback(tier, tier)(
        want_p, ql, tl))
    return enc, np.asarray(want_p), want_w


@pytest.mark.parametrize("tier", [32, 48, 96])
def test_ops_flags_and_words_equal_reference(tier):
    """The reference's build_ksw2_kernel + build_ksw2_traceback (XLA on
    the CPU) and the port's plain fill and backtrack, on the same encoded
    pairs: the flag tensor and the packed words equal exactly."""
    enc, want_p, want_w = _reference(tier)
    args = [torch.from_numpy(a) for a in enc]
    flags = ksw2_device.ksw2_flags_plain(*args)
    np.testing.assert_array_equal(flags.numpy(), want_p)
    words = ksw2_device.ksw2_ops(*args)          # CPU tensors: plain
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want_w)


def test_align_batch_equal_host_oracle(rng):
    """tests/test_ksw2_device.py's random and edge pairs, the wildcard
    pair included, at tier 96: the strings equal ksw2_alignment's."""
    pairs = []
    for _ in range(150):
        m = int(rng.integers(1, 60))
        pairs.append(_mutated_pair(rng, m))
    pairs += [("A", "A"), ("A", "C"), ("ACGT", "ACGT"), ("AAAA", "AA"),
              ("AC", "ACGTACGT"), ("G", "TTTT"), ("ACGTNACGT", "ACGTACGT")]
    got = ksw2_device.ksw2_align_batch(pairs, M=96, N=96, device="cpu")
    for (s1, s2), (a1, a2) in zip(pairs, got):
        assert (a1, a2) == ksw2_alignment(s1, s2), (s1, s2)


def test_align_batch_limits():
    with pytest.raises(ValueError, match="multiple of 16"):
        ksw2_device.ksw2_align_batch([("A", "A")], M=40, N=40, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        ksw2_device.ksw2_align_batch([("", "A")], M=32, N=32, device="cpu")


def test_kernel_limits_equal_cuda_source():
    """The wrapper's limits are the ones csrc/ksw2.cu checks and builds
    with."""
    with open(os.path.join(REPO, "mapcaller_tpu_torch", "csrc",
                           "ksw2.cu")) as f:
        src = f.read()
    for name, want in (("GROUP", ksw2_device.KERNEL_GROUP),
                       ("MAX_CHUNK", ksw2_device.KERNEL_MAX_CHUNK),
                       ("MAX_THREADS", ksw2_device.KERNEL_MAX_THREADS),
                       ("MAX_SMEM", ksw2_device.KERNEL_MAX_SMEM)):
        assert int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1)) == want, name


# ---- the kernel's mirror: csrc/ksw2.cu as its groups and lanes run it ------

_POISON = 0xEE      # shared memory is not cleared: a byte no flag has


def _windows(r, ql, tl):
    """(st0, en0, st, en, blk_end) of diagonal r per pair, as the kernel
    computes them."""
    w = np.maximum(ql, tl)
    st0 = np.maximum(np.maximum(0, r - ql + 1), (r - w + 1) >> 1)
    en0 = np.minimum(np.minimum(tl - 1, r), (r + w) >> 1)
    blk_end = st0 + (((en0 - st0) >> 4) + 1) * 16
    return st0, en0, st0 & ~15, ((en0 + 16) & ~15) - 1, blk_end


def _row_width(M, N):
    """Cells of the widest window row [st, en] of any pair of an M x N
    tier, the stride of fixed rows: at most N (en <= ceil16(tlen) - 1)
    and at most ceil16(min(qlen, tlen) + 15)."""
    return min(N, (min(M, N) + 30) // 16 * 16)


def mirror_ksw2(qbuf, tgt, qlen, tlen, group=ksw2_device.KERNEL_GROUP,
                packed=True, flag_bits=4, stats=None):
    """ksw2_ops_kernel in numpy, pair by pair along the batch axis: a
    group of `group` lanes a pair, lane l holding the columns k*group + l
    (state [B, chunk, lane]). On each diagonal the live chunks run right
    to left; chunk k takes the previous diagonal one column to the left
    by shuffle: lane l-1's x, v of chunk k, and for lane 0 lane
    group-1's of chunk k-1, live or not (not yet updated: it comes after
    chunk k). The flags go to a per-pair buffer of window-relative rows
    (packed with an offset table as the kernel has them, or at the widest
    row's stride), a nibble a cell joined in pairs of lanes as in the
    kernel, or a byte (the layouts ksw2_variants.py builds); then lane 0's
    backtrack over that buffer. Returns words uint32[B, ceil16(M+N)/16];
    `stats`, a dict, gets the chunks issued, the diagonals whose live
    range passes en's chunk or whose first live chunk's left neighbour
    lies in a chunk that is not live, and the score registers s8 after
    the fill by column (int64[B, NC])."""
    B, M = qbuf.shape
    NC = tgt.shape[1]
    N = NC - 16
    G = group
    nch = -(-NC // G)
    W = _row_width(M, N)
    cap = (ksw2_device.ksw2_pair_cells(M, N) if packed
           else (M + N - 1) * W)
    fl = np.full((B, cap * flag_bits // 8), _POISON, dtype=np.int64)
    rows = np.zeros((B, M + N - 1), dtype=np.int64)
    lane = np.arange(G)[None, :]
    bi = np.arange(B)[:, None]
    ql = np.clip(qlen.astype(np.int64), 0, M)
    tl = np.clip(tlen.astype(np.int64), 0, N)
    t_all = np.arange(nch)[:, None] * G + lane               # [chunk, lane]
    tg = np.where(t_all < NC, tgt.astype(np.int64)[:, np.minimum(t_all,
                                                                 NC - 1)], 0)
    q = qbuf.astype(np.int64)
    u, v, x, y, s8 = (np.zeros((B, nch, G), dtype=np.int64) for _ in range(5))
    w8 = lambda a: ((a + 128) & 255) - 128  # noqa: E731
    nd = np.where((ql > 0) & (tl > 0), ql + tl - 1, 0)
    last_st = np.full(B, -1)
    last_en = np.full(B, -1)
    row = np.zeros(B, dtype=np.int64)
    st_ = stats if stats is not None else {}
    st_.update(chunks=0, past_en=0, left_not_live=0)
    c = lambda a: a[:, None]  # noqa: E731
    for r in range(int(nd.max(initial=0))):
        act = r < nd
        st0, en0, st, en, blk_end = _windows(r, ql, tl)
        fresh = ~((st > 0) & (last_st <= st - 1) & (st - 1 <= last_en))
        hi = np.maximum(en, blk_end - 1)
        klo, khi = st // G, hi // G
        base = (row if packed else r * W) - st
        if packed:
            rows[act, r] = row[act] >> 4
            row = np.where(act, row + en - st + 1, row)
        st_["past_en"] += int((act & (hi // G > en // G)).sum())
        st_["left_not_live"] += int((act & ~fresh & (klo > 0)
                                     & (st % G == 0)).sum())
        for k in range(nch - 1, -1, -1):
            live = act & (klo <= k) & (k <= khi)
            if not live.any():
                continue
            st_["chunks"] += int(live.sum())
            t = t_all[k][None, :]
            # __shfl_sync from lane (l - 1) mod G, and lane 0 from lane
            # G-1 of chunk k-1
            xt1, vt1 = np.roll(x[:, k], 1, axis=1), np.roll(v[:, k], 1, axis=1)
            xt1[:, 0] = x[:, k - 1, G - 1] if k else 0
            vt1[:, 0] = v[:, k - 1, G - 1] if k else 0
            inj = (t == c(st)) & c(fresh)
            xt1 = np.where(inj, 0, xt1)
            vt1 = np.where(inj, np.where(c(st) > 0, 0,
                                         _Q_OPEN if r > 0 else 0), vt1)
            reset = (t == r) & c(en >= r)
            yk = np.where(reset, 0, y[:, k])
            uk = np.where(reset, _Q_OPEN if r > 0 else 0, u[:, k])
            qv = q[bi, np.clip(M - 1 - r + t, 0, M - 1)]
            sc = np.where((tg[:, k] == 4) | (qv == 4), 0,
                          np.where(tg[:, k] == qv, 1, -1))
            sk = np.where((t >= c(st0)) & (t < c(blk_end)), sc, s8[:, k])
            z = sk + 6
            a = w8(xt1 + vt1)
            b = w8(yk + uk)
            d = (a > z).astype(np.int64)
            z = np.maximum(z, a)
            d = np.where(b > z, 2, d)
            z = np.minimum(np.maximum(z & 255, b & 255), 7)
            un, vn = w8(z - vt1), w8(z - uk)
            z = z - _Q_OPEN
            a, b = w8(a - z), w8(b - z)
            d = d | np.where(a > 0, 8, 0) | np.where(b > 0, 16, 0)
            inw = c(live) & (t >= c(st)) & (t <= c(en))
            L = c(live)
            s8[:, k] = np.where(L, sk, s8[:, k])
            u[:, k] = np.where(inw, un, np.where(L, uk, u[:, k]))
            v[:, k] = np.where(inw, vn, v[:, k])
            x[:, k] = np.where(inw, np.maximum(a, 0), x[:, k])
            y[:, k] = np.where(inw, np.maximum(b, 0), np.where(L, yk,
                                                                y[:, k]))
            cell = c(base) + t
            if flag_bits == 8:
                bb, cc = np.nonzero(inw)
                fl[bb, cell[bb, cc]] = d[bb, cc]
            else:
                nib = (d & 3) | ((d >> 1) & 0xC)
                odd = np.concatenate([nib[:, 1:], nib[:, -1:]], axis=1)
                bb, cc = np.nonzero(inw & (lane % 2 == 0))
                fl[bb, cell[bb, cc] >> 1] = (nib | (odd << 4))[bb, cc]
        last_st = np.where(act, st, last_st)
        last_en = np.where(act, en, last_en)
    st_["s8"] = s8.reshape(B, -1)[:, :NC]        # column k * G + l
    st_["flags"] = _mirror_flags(fl, rows, ql, tl, M, N, W, packed,
                                 flag_bits)
    return _mirror_backtrack(fl, rows, ql, tl, M, N, W, packed, flag_bits)


def _mirror_flags(fl, rows, ql, tl, M, N, W, packed, flag_bits):
    """The flag buffer read back at (pair, diagonal, column) inside each
    diagonal's window, zeros elsewhere: ksw2_flags_plain's layout."""
    B = len(ql)
    out = np.zeros((B, M + N - 1, N + 16), dtype=np.int64)
    for p in range(B):
        for r in range(int(ql[p] + tl[p] - 1)):
            _, _, st, en = ksw2_device._bounds(int(ql[p]), int(tl[p]), r)
            cell = (int(rows[p, r]) << 4 if packed else r * W) + \
                np.arange(en - st + 1)
            if flag_bits == 8:
                out[p, r, st:en + 1] = fl[p, cell]
            else:
                nib = (fl[p, cell >> 1] >> ((cell & 1) * 4)) & 15
                out[p, r, st:en + 1] = (nib & 3) | ((nib << 1) & 0x18)
    return out


def _mirror_backtrack(fl, rows, ql, tl, M, N, W, packed, flag_bits):
    """Lane 0's walk of each pair over its flag buffer."""
    nwords = (M + N + 15) // 16
    out = np.zeros((len(ql), nwords), dtype=np.uint32)
    for p in range(len(ql)):
        i, j, state = int(tl[p]) - 1, int(ql[p]) - 1, 0
        for wd in range(nwords):
            if i < 0 and j < 0:
                out[p, wd] = 0xFFFFFFFF
                continue
            word = 0
            for k in range(16):
                if i >= 0 and j >= 0:
                    r = i + j
                    _, _, st, en = ksw2_device._bounds(int(ql[p]),
                                                       int(tl[p]), r)
                    if i < st:
                        s = 2
                    elif i > en:
                        s = 1
                    else:
                        cell = (int(rows[p, r]) << 4 if packed
                                else r * W) + i - st
                        if flag_bits == 8:
                            tmp = int(fl[p, cell])
                        else:
                            nib = (int(fl[p, cell >> 1])
                                   >> ((cell & 1) * 4)) & 15
                            tmp = (nib & 3) | ((nib << 1) & 0x18)
                        assert tmp != _POISON, (p, r, i)
                        s = (tmp & 7) if state == 0 else (
                            state if (tmp >> (state + 2)) & 1 else 0)
                        if s == 0:
                            s = tmp & 7
                    state = s
                    op = 0 if s == 0 else (1 if s in (1, 3) else 2)
                else:
                    op = 1 if i >= 0 else (2 if j >= 0 else 3)
                if op in (0, 1):
                    i -= 1
                if op in (0, 2):
                    j -= 1
                word |= op << (2 * k)
            out[p, wd] = word
    return out


_Q_OPEN = 2


def _plain_words(enc):
    return ksw2_device.ksw2_ops_plain(
        *(torch.from_numpy(a) for a in enc)).numpy().view(np.uint32)


@pytest.mark.parametrize("group", [16, 32])
@pytest.mark.parametrize("tier", [32, 48, 96])
def test_mirror_equal_plain_and_reference(tier, group):
    """The kernel's mirror at 16 and 32 lanes a pair: its words equal
    ksw2_ops_plain's and the reference's fill + traceback on the tier's
    random and edge pairs; only the chunks a window needs issue."""
    enc, _, want_w = _reference(tier)
    stats = {}
    got = mirror_ksw2(*enc, group=group, stats=stats)
    np.testing.assert_array_equal(got, want_w)
    np.testing.assert_array_equal(got, _plain_words(enc))
    nd = (enc[2] + enc[3] - 1).sum()
    assert stats["chunks"] < nd * -(-(tier + 16) // group)


@pytest.mark.parametrize("packed,flag_bits", [(False, 4), (True, 4),
                                              (False, 8), (True, 8)])
def test_mirror_flag_layouts_equal_plain(packed, flag_bits):
    """Every flag layout ksw2_variants.py builds the kernel with (fixed or
    packed rows, nibbles or bytes) gives the same words at tier 48."""
    enc, _, want_w = _reference(48)
    got = mirror_ksw2(*enc, packed=packed, flag_bits=flag_bits)
    np.testing.assert_array_equal(got, want_w)


def test_mirror_tier192_equal_plain():
    """Tier 192 at 32 lanes (7 chunks a lane): a few pairs, the edges
    among them, against the plain version."""
    pairs = _tier_pairs(192, 4, seed=192)
    enc = _encode(pairs, 192)
    np.testing.assert_array_equal(mirror_ksw2(*enc), _plain_words(enc))


def _pitfall_pairs(tier, group, want, n, seed):
    """Random pairs at the tier that have a diagonal of the kind `want`
    asks for: "past_en", a live range whose score block reaches a chunk
    past en's (st0 not 16-aligned); "left_not_live", a window whose st
    starts a chunk while the chunk to its left, not live, holds x1, v1."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        a, b = _mutated_pair(rng, int(rng.integers(tier // 3, tier + 1)))
        a, b = a[:tier], b[:tier]
        ql, tl = np.array([len(a)]), np.array([len(b)])
        for r in range(len(a) + len(b) - 1):
            st0, en0, st, en, blk_end = _windows(r, ql, tl)
            if want == "past_en":
                hit = (max(en[0], blk_end[0] - 1) // group > en[0] // group)
            else:
                _, _, pst, pen, _ = _windows(r - 1, ql, tl)
                hit = (st[0] > 0 and st[0] % group == 0
                       and pst[0] <= st[0] - 1 <= pen[0])
            if hit:
                out.append((a, b))
                break
    return out


@pytest.mark.parametrize("group", [16, 32])
@pytest.mark.parametrize("want", ["past_en", "left_not_live"])
def test_mirror_pitfalls_equal_plain(want, group):
    """Pairs whose diagonals hit the design's two pitfalls: a score block
    past en in a chunk of its own (the live range must reach blk_end - 1),
    and a window starting a chunk whose left neighbour is not live (its
    x, v shuffled all the same). The words, and every flag the fill
    stores, equal the plain version's."""
    enc = _encode(_pitfall_pairs(96, group, want, 24, seed=len(want)), 96)
    stats = {}
    got = mirror_ksw2(*enc, group=group, stats=stats)
    assert stats[want] >= 24
    np.testing.assert_array_equal(got, _plain_words(enc))
    want = ksw2_device.ksw2_flags_plain(*(torch.from_numpy(a) for a in enc))
    nd = enc[2] + enc[3] - 1        # the plain fill runs every diagonal
    want = np.where(np.arange(want.shape[1])[None, :, None] < nd[:, None, None],
                    want.numpy(), 0)
    np.testing.assert_array_equal(stats["flags"], want)


def _score_state(qbuf, tgt, qlen, tlen):
    """The scores s8 after each pair's last diagonal as the reference
    keeps them (ksw2_alignment.cpp:167-176): column c holds the score of
    the last diagonal whose blocks [st0, blk_end) covered it, else 0."""
    B, M = qbuf.shape
    NC = tgt.shape[1]
    ql, tl = qlen.astype(np.int64), tlen.astype(np.int64)
    cols = np.arange(NC)[None, :]
    bi = np.arange(B)[:, None]
    out = np.zeros((B, NC), dtype=np.int64)
    for r in range(int((ql + tl - 1).max())):
        st0, en0, _, _, blk_end = (a[:, None] for a in _windows(r, ql, tl))
        qv = qbuf[bi, np.clip(M - 1 - r + cols, 0, M - 1)]
        tv = tgt[bi, cols]
        sc = np.where((tv == 4) | (qv == 4), 0, np.where(tv == qv, 1, -1))
        out = np.where((r < ql + tl - 1)[:, None] & (st0 <= en0)
                       & (cols >= st0) & (cols < blk_end), sc, out)
    return out


@pytest.mark.parametrize("group", [16, 32])
def test_mirror_scores_past_en_kept(group):
    """The score registers after the fill equal the reference's scores,
    written over whole 16-blocks from st0 even past en: the live range
    reaches blk_end - 1. (Within a fill no later diagonal reads a score
    past en before rewriting it, for any pair of lengths at the tiers, so
    the words alone would not show a range cut at en.)"""
    enc = _encode(_pitfall_pairs(96, group, "past_en", 24, seed=7), 96)
    stats = {}
    mirror_ksw2(*enc, group=group, stats=stats)
    np.testing.assert_array_equal(stats["s8"], _score_state(*enc))


@pytest.mark.parametrize("tier", [32, 96])
def test_mirror_edges_equal_plain(tier):
    """Lengths 1 and tier, very unequal sides, all-N and mostly-N sides."""
    rng = np.random.default_rng(tier + 1)
    s = decode(rng.integers(0, 4, size=tier).astype(np.uint8))
    pairs = [("A", "A"), ("A", s), (s, "A"), (s, s), (s, s[::-1]),
             (s[:2], s), (s, s[-3:]), ("N" * tier, s), (s, "N" * tier),
             ("N", "N"), (s[:tier // 2] + "N" * (tier // 2), s),
             (s[: tier - 17], s[5:])]
    enc = _encode(pairs, tier)
    for group in (16, 32):
        np.testing.assert_array_equal(mirror_ksw2(*enc, group=group),
                                      _plain_words(enc))


def _max_window(M, N):
    """Brute force over every pair of lengths of the tier: (the widest
    window row, the most window cells of one pair)."""
    tl = np.arange(1, N + 1)[:, None]
    r = np.arange(M + N - 1)[None, :]
    widest, most = 0, 0
    for ql in range(1, M + 1):
        _, _, st, en, _ = _windows(r, np.full_like(tl, ql), tl)
        width = np.where(r < ql + tl - 1, en - st + 1, 0)
        widest = max(widest, int(width.max()))
        most = max(most, int(width.sum(axis=1).max()))
    return widest, most


@pytest.mark.parametrize("M,N", [(32, 32), (48, 48), (96, 96), (32, 96),
                                 (96, 32)])
def test_ksw2_geometry_within_kernel_limits(M, N):
    """ksw2_geometry's launch fits the kernel: chunks hold the N + 16
    columns, whole warps, at most KERNEL_MAX_THREADS threads and
    KERNEL_MAX_SMEM bytes; the packed cells (and the mirror's fixed row
    width) are the most any pair of the tier needs."""
    widest, most = _max_window(M, N)
    assert _row_width(M, N) == widest
    assert ksw2_device.ksw2_pair_cells(M, N) == most
    g = ksw2_device.KERNEL_GROUP
    chunk, pairs, smem = ksw2_device.ksw2_geometry(M, N)
    assert (chunk - 1) * g < N + 16 <= chunk * g
    assert chunk <= ksw2_device.KERNEL_MAX_CHUNK
    assert (g * pairs) % 32 == 0
    assert g * pairs <= ksw2_device.KERNEL_MAX_THREADS
    assert smem == pairs * ksw2_device.ksw2_pair_bytes(M, N)
    assert smem <= ksw2_device.KERNEL_MAX_SMEM


def test_ksw2_geometry_tiers():
    """The DP tiers: 4 pairs a block up to tier 96, two at tier 192,
    where a pair takes its query, 39,744 nibbles and a uint16 offset a
    diagonal (fixed rows would take 383 rows of 192 nibbles)."""
    geo = {t: ksw2_device.ksw2_geometry(t, t) for t in (32, 48, 96, 192)}
    assert [g[1] for g in geo.values()] == [4, 4, 4, 2]
    assert geo[192][0] == 7 and geo[96][0] == 4
    assert ksw2_device.ksw2_pair_bytes(192, 192) == 192 + 39744 // 2 + 768
    assert geo[192][2] == 2 * (192 + 39744 // 2 + 768)
    assert 192 + 383 * _row_width(192, 192) // 2 == 192 + 383 * 96


@pytest.mark.parametrize("M,N", [(32, 40), (32, 8), (0, 32), (-5, 32),
                                 (32, 256), (2000, 240)])
def test_ksw2_geometry_refuses(M, N):
    """What the kernel cannot take: N not a multiple of 16 or under 16, M
    under 1, N + 16 past KERNEL_GROUP * KERNEL_MAX_CHUNK, one pair's
    shared memory past KERNEL_MAX_SMEM."""
    with pytest.raises(ValueError):
        ksw2_device.ksw2_geometry(M, N)


@pytest.fixture(scope="module")
def divergent(tmp_path_factory):
    """tests/test_device_extension.py's divergent reads (dense mismatch
    blocks, 4-bp deletions, 5-bp insertions) as files, and the reference
    package's SAM and VCF with its device ksw2 DP (XLA on the CPU)."""
    d = str(tmp_path_factory.mktemp("torch_ksw2"))
    rng = np.random.default_rng(5)
    L = 30000
    codes = rng.integers(0, 4, size=L).astype(np.uint8)
    fa = os.path.join(d, "g.fa")
    with open(fa, "w") as f:
        f.write(f">chr1\n{decode(codes)}\n")
    fq = os.path.join(d, "d.fq")
    RL = 100
    with open(fq, "w") as f:
        for k, p in enumerate(range(100, L - 200, 37)):
            c = codes[p:p + RL].copy()
            if k % 3 == 0:
                j = 30 + (k % 25)
                c[j:j + 6] = (c[j:j + 6] + 1 + rng.integers(0, 3, 6)) % 4
            elif k % 3 == 1:
                c = np.concatenate([codes[p:p + 40],
                                    codes[p + 44:p + 44 + RL - 40]])[:RL]
            else:
                ins = rng.integers(0, 4, 5).astype(np.uint8)
                c = np.concatenate([codes[p:p + 50], ins,
                                    codes[p + 50:p + RL - 5]])[:RL]
            f.write(f"@d{k}\n{decode(c)}\n+\n{'I' * RL}\n")
    prefix = os.path.join(d, "idx")
    build_index(fa, prefix)
    inputs = dict(index_prefix=prefix, read_files1=[fq], use_nw=False,
                  batch_size=512, stream_batch_size=512, max_read_len=128,
                  prefix_skip_k=6, compact_factor=1)
    cfg = JaxConfig(device_extension=True, sam_file=os.path.join(d, "j.sam"),
                    vcf_file=os.path.join(d, "j.vcf"),
                    log_file=os.path.join(d, "j.log"), **inputs)
    assert jax_runner.run_pipeline(cfg, "mapcaller") == 0
    with open(cfg.sam_file) as f, open(cfg.vcf_file) as g:
        return d, inputs, (f.read(), g.read())


@pytest.mark.parametrize("device_extension", [True, False])
def test_ksw2_stream_equal_reference(divergent, monkeypatch,
                                     device_extension):
    """-alg ksw2 through the port's stream on the CPU: with device DP
    every DP batch goes through ksw2_ops (its plain version here), with
    scalar DP none does; both write the reference's SAM and VCF."""
    d, inputs, want = divergent
    pairs = []
    plain = ksw2_device.ksw2_ops_plain

    def counted(qbuf, *a):
        pairs.append(qbuf.shape[0])
        return plain(qbuf, *a)

    monkeypatch.setattr(ksw2_device, "ksw2_ops_plain", counted)
    tag = f"t{device_extension}"
    cfg = Config(device="cpu", device_extension=device_extension,
                 sam_file=os.path.join(d, f"{tag}.sam"),
                 vcf_file=os.path.join(d, f"{tag}.vcf"),
                 log_file=os.path.join(d, f"{tag}.log"), **inputs)
    assert runner.run_pipeline(cfg, "mapcaller") == 0
    with open(cfg.sam_file) as f, open(cfg.vcf_file) as g:
        assert (f.read(), g.read()) == want
    assert (sum(pairs) > 100) == device_extension
