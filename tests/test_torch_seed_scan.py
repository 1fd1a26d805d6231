"""The seed-scan kernels of the port (mapcaller_tpu_torch/csrc/seed_scan.cu,
wrapped by ops/seed_scan_device.py) on the CPU, where no kernel runs:

  * a scalar mirror of each kernel's thread, written branch for branch as
    the .cu thread runs one read over the same occ3 / occ4 row arrays, is
    held equal (outputs and step counts) to the reference package's
    _seed_scan3(with_iters=True) and _seed_scan, and (row gathers too) to
    the port's plain scans, with and without the
    fused prefix skip, at two read widths, with short reads, full-length
    reads, N bases and a seed table small enough to overflow; the lane-group
    form of the routed scans (mirror_scan3_group) is defined here and held
    to the thread mirrors in test_torch_shards.py and test_torch_big.py;
  * the wrappers refuse what the kernels do not take, run the plain scans
    for CPU tensors without counting a launch, and the plain scan's
    outputs do not depend on the lanes of the compacted form;
  * the backend's prefix-skip depth charges the evidence planes once."""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mapcaller_tpu.index.fmindex import build_index
from mapcaller_tpu.index.packer import PackedReference
from mapcaller_tpu.ops import fm_search as jfs
from mapcaller_tpu.ops.fm3_device import DeviceFM3 as JaxFM3
from mapcaller_tpu.ops.fm_device import DeviceFMIndex as JaxFM
from mapcaller_tpu_torch.config import Config
from mapcaller_tpu_torch.ops import fm_search as tfs
from mapcaller_tpu_torch.ops import seed_scan_device as ssd
from mapcaller_tpu_torch.ops.fm3_device import DeviceFM3
from mapcaller_tpu_torch.ops.fm_device import DeviceFMIndex
from mapcaller_tpu_torch.parallel import big_index as tbig
from mapcaller_tpu_torch.pipeline import device_backend
from mapcaller_tpu_torch.pipeline.device_backend import DeviceBackend

torch.set_num_threads(1)   # small tensor ops: see test_torch_e2e.py

B = 96
MIN, OCC_THR = tfs.MIN_SEED_LEN, tfs.OCC_THR
_D = np.arange(64)
REV3 = 63 - ((_D & 3) * 16 + (_D & 12) + (_D >> 4))


@pytest.fixture(scope="module")
def genome():
    """A 9 kb random genome with a 200-bp block repeated 4 times (seeds
    with several hits), the reference's and the port's 1-step tables and
    occ3 tables without and with a K=7 fused prefix skip."""
    rng = np.random.default_rng(31)
    codes = rng.integers(0, 4, size=9000).astype(np.uint8)
    for k in range(4):
        codes[3000 + 600 * k:3200 + 600 * k] = codes[1000:1200]
    idx = build_index(None, packed=PackedReference(["chr1"], [len(codes)],
                                                   [0], codes, []))
    jfm = JaxFM.from_host(idx)
    tfm = DeviceFMIndex.from_host(idx, device="cpu")
    return dict(idx=idx, jfm=jfm, tfm=tfm,
                j3={k: JaxFM3.from_host(idx, jfm, pfx_k=k) for k in (0, 7)},
                t3={k: DeviceFM3.from_host(idx, tfm, pfx_k=k)
                    for k in (0, 7)})


def _reads(idx, seed, n, maxlen, n_rate=0.0, max_sub=2):
    """n reads of the fwd+rc text with 0..max_sub substitutions (a share
    n_rate of bases turned to N, code 4), every 4th at full length, every
    11th too short to seed -> (codes uint8[n, maxlen] padded with 4,
    rlens int32[n], packed uint8[n, maxlen/4])."""
    rng = np.random.default_rng(seed)
    text = idx.ref.fwd_rc_codes()
    mat = np.full((n, maxlen), 4, dtype=np.uint8)
    rlens = np.zeros(n, dtype=np.int32)
    for b in range(n):
        ln = int(rng.integers(20, maxlen + 1)) if b % 4 else maxlen
        if b % 11 == 0:
            ln = int(rng.integers(4, MIN + 2))
        p = int(rng.integers(0, idx.genome_size - maxlen))
        r = text[p:p + ln].copy()
        for _ in range(int(rng.integers(0, max_sub + 1))):
            j = int(rng.integers(0, ln))
            r[j] = (r[j] + 1 + rng.integers(0, 3)) % 4
        r[rng.random(ln) < n_rate] = 4
        mat[b, :ln] = r
        rlens[b] = ln
    packed = np.zeros((n, maxlen // 4), dtype=np.uint8)
    for j in range(4):
        packed |= (mat[:, j::4] & 3) << (2 * j)
    return mat, rlens, packed


def _jax_words_fns(packed, K):
    """The reference kernels' code and prefix-key lookups over packed
    reads (mapcaller_tpu/ops/fm_search.py build_seed_kernel_packed)."""
    n, W4 = packed.shape
    pb = jnp.asarray(packed).astype(jnp.uint32).reshape(n, W4 // 4, 4)
    sh = (jnp.arange(4, dtype=jnp.uint32) * 8)[None, None, :]
    words = (pb << sh).sum(axis=2, dtype=jnp.uint32)
    widx = jnp.arange(W4 // 4, dtype=jnp.int32)[None, :]

    def word(wi):
        return jnp.where(widx == wi[:, None], words, 0).sum(axis=1,
                                                          dtype=jnp.uint32)

    def codes_fn(row, pos):
        return ((word(pos >> 4) >> ((pos.astype(jnp.uint32) & 15) * 2)) & 3
                ).astype(jnp.int32)

    def key_fn(row, pos):
        wi = pos >> 4
        s = ((pos & 15) * 2).astype(jnp.uint32)
        comb = (word(wi) >> s) | jnp.where(
            s > 0, word(wi + 1) << (jnp.uint32(32) - s), jnp.uint32(0))
        key = jnp.zeros_like(pos)
        for j in range(K):
            key = key | (((comb >> jnp.uint32(2 * j)) & 3).astype(jnp.int32)
                         << (2 * (K - 1 - j)))
        return key

    return codes_fn, key_fn if K else None


# ---- scalar mirrors of the kernels' threads (csrc/seed_scan.cu) ----------

class _Tables:
    """Seed tables of a batch, written as the kernel writes them."""

    def __init__(self, n, S):
        self.S = S
        self.n_seeds = np.zeros(n, np.int64)
        self.tab = np.full((4, n, S), -1, np.int64)   # every slot is written
        self.overflow = np.zeros(n, bool)
        self.iters = np.zeros(n, np.int64)
        self.rows = np.zeros(n, np.int64)

    def finalize(self, r, st):
        """finalize(): x0 and x2 of the state before the step."""
        slen = st["ext_pos"] - st["start"]
        if slen >= MIN and st["x2"] <= OCC_THR:
            slot = min(st["ns"], self.S - 1)
            self.tab[:, r, slot] = (st["start"], slen, st["x0"], st["x2"])
            if st["ns"] >= self.S:
                st["ovf"] = True
            st["ns"] = min(st["ns"] + 1, self.S)
        st["pos"] = st["ext_pos"] + 1
        st["in_ext"] = st["replay"] = False

    def store(self, r, st, it):
        """store(): slots at or past n_seeds are 0."""
        self.n_seeds[r], self.overflow[r], self.iters[r], self.rows[r] = (
            st["ns"], st["ovf"], it, st["g"])
        self.tab[:, r, st["ns"]:] = 0

    def result(self):
        return (self.n_seeds, *self.tab, self.overflow, self.iters,
                self.rows)


def _state():
    return dict(pos=0, start=0, ext_pos=0, x0=0, x1=0, x2=0, ns=0, g=0,
                in_ext=False, replay=False, ovf=False)


def _row3(rows, i):
    """(64 counts, 16 symbol bytes, m) of occ3 index i."""
    row = rows[i >> 4]
    return (row[:64].astype(np.int64),
            np.ascontiguousarray(row[64:68]).view(np.uint8).astype(np.int64),
            i & 15)


def _sums3(rows, i, d, w):
    """sums3(): Occ3(d, i) and the rev3 order sum for w."""
    cnt, syms, m = _row3(rows, i)
    base, rs = int(cnt[d]), int(cnt[REV3 < w].sum())
    for q in range(m):
        sym = int(syms[q])
        base += sym == d
        r3 = 63 - ((sym & 3) * 16 + (sym & 12) + (sym >> 4))
        rs += sym < 64 and r3 < w
    return base, rs


def _occ1_4(rows, t3, i):
    """occ1_4(): derived 1-step counts of the 4 bases at occ3 index i."""
    cnt, syms, m = _row3(rows, i)
    g = [int(cnt[c::4].sum()) for c in range(4)]
    for q in range(m):
        if syms[q] < 64:
            g[int(syms[q]) & 3] += 1
    g[t3.t0] += i > t3.row_p1
    g[t3.t1] += i > t3.row_p2
    return g


def _word_code(words, p):
    return (int(words[p >> 4]) >> ((p & 15) * 2)) & 3


def _word_key(words, p, K):
    wi = p >> 4
    w0 = int(words[wi])
    w1 = int(words[wi + 1]) if wi + 1 < len(words) else 0
    sh = (p & 15) * 2
    comb = ((w0 >> sh) | ((w1 << (32 - sh)) if sh else 0)) & 0xFFFFFFFF
    key = 0
    for j in range(K):
        key |= ((comb >> (2 * j)) & 3) << (2 * (K - 1 - j))
    return key


def mirror_scan3(t3, packed, rlens, max_len, S):
    """seed_scan3_kernel's thread, one read after another."""
    rows = t3.occ3_rows.numpy()
    c3 = t3.c3_first.numpy().astype(np.int64)
    L2 = [int(x) for x in t3.fm.L2.numpy()]
    primary = t3.primary
    # the packed batch read as uint32: the little-endian read words
    all_words = packed.view("<u4")
    cap = tfs.scan3_cap(max_len, S)
    out = _Tables(packed.shape[0], S)
    last = max_len - 1
    for r in range(packed.shape[0]):
        words, rlen, st = all_words[r], int(rlens[r]), _state()
        it = 0
        while it < cap:
            if not st["in_ext"]:
                if st["pos"] >= rlen - MIN:
                    break
                p = min(st["pos"], last)
                jump = False
                if t3.pfx_base > 0:
                    key = _word_key(words, p, t3.pfx_k)
                    e = rows[t3.pfx_base + (key >> 4)][
                        4 * (key & 15):4 * (key & 15) + 3].astype(np.int64)
                    if e[2] > 0:
                        st.update(x0=int(e[0]), x1=int(e[1]), x2=int(e[2]),
                                  ext_pos=st["pos"] + t3.pfx_k)
                        jump = True
                if not jump:
                    c = _word_code(words, p)
                    st.update(x0=L2[c] + 1, x1=L2[3 - c] + 1,
                              x2=L2[c + 1] - L2[c], ext_pos=st["pos"] + 1)
                st.update(start=st["pos"], in_ext=True, replay=False)
            elif st["ext_pos"] >= rlen:
                out.finalize(r, st)
            else:
                ep, x0, x1, x2 = st["ext_pos"], st["x0"], st["x1"], st["x2"]
                e0 = _word_code(words, min(ep, last))
                if not st["replay"] and ep + 3 <= rlen:
                    e1 = _word_code(words, min(ep + 1, last))
                    e2 = _word_code(words, min(ep + 2, last))
                    d = (3 - e2) * 16 + (3 - e1) * 4 + (3 - e0)
                    w = e0 * 16 + e1 * 4 + e2
                    tk, rk = _sums3(rows, x1, d, w)
                    tl, rl = _sums3(rows, x1 + x2, d, w)
                    st["g"] += 2
                    if tl - tk <= 0:
                        st["replay"] = True
                    else:
                        lo, hi = x1, x1 + x2
                        cmp1 = t3.tail1 <= e0
                        cmp2 = (t3.tail2a < e0
                                or (t3.tail2a == e0 and t3.tail2b <= e1))
                        adj = ((lo <= primary < hi)
                               + ((lo <= t3.row_p1 < hi) and cmp1)
                               + ((lo <= t3.row_p2 < hi) and cmp2))
                        st.update(x0=x0 + adj + (rl - rk),
                                  x1=int(c3[d]) + tk, x2=tl - tk,
                                  ext_pos=ep + 3)
                else:
                    tk = _occ1_4(rows, t3, x1)
                    tl = _occ1_4(rows, t3, x1 + x2)
                    st["g"] += 2
                    ok2 = [tl[c] - tk[c] for c in range(4)]
                    ci = 3 - e0
                    if ok2[ci] <= 0:
                        out.finalize(r, st)
                    else:
                        adj = x1 <= primary and x1 + x2 - 1 >= primary
                        st.update(x0=x0 + adj + sum(ok2[ci + 1:]),
                                  x1=L2[ci] + 1 + tk[ci], x2=ok2[ci],
                                  ext_pos=ep + 1)
            it += 1
        out.store(r, st, it)
    return out.result()


M32 = 0xFFFFFFFF


class RoutedFetch:
    """A routed scan's row fetch (ShardRows / ShardRows64): occ3 index i
    -> (the row's 64 counts, its 16 symbol bytes, i & 15, its shard's base
    table row or None), row i >> 4 read from shard (i >> 4) // per; counts
    the fetches of a shard's first or last row."""

    def __init__(self, shards, per, base3x=None):
        self.shards, self.per, self.base3x = shards, per, base3x
        self.edge_rows = 0

    def __call__(self, i):
        w = i >> 4
        s = w // self.per
        self.edge_rows += w % self.per in (0, self.per - 1)
        row = self.shards[s][w - s * self.per]
        return (row[:64].astype(np.int64),
                np.ascontiguousarray(row[64:68]).view(np.uint8).astype(
                    np.int64), i & 15,
                None if self.base3x is None else self.base3x[s])


def scan3_consts(t):
    """The routed scans' constants of a ShardedFM3 / BigShardedFM3."""
    return types.SimpleNamespace(
        L2=[int(x) for x in t.L2.numpy()],
        c3_first=[int(x) for x in t.c3_first.numpy()],
        **{c: int(getattr(t, c)) for c in (
            "primary", "row_p1", "row_p2", "t0", "t1", "tail1", "tail2a",
            "tail2b")})


def _group_sums(fetch, ik, il, sel, G):
    """group_sums(): each lane's partials (A, N, X) of a two-row step
    from its count vectors and symbols (lane j: v = j, j + G, ... of the
    two rows' 32, row v // 16), wrapped to 32 bits, then the xor-shuffle
    tree (offsets G/2, ..., 1), after which every lane holds the same
    totals. sel: (vmask, vval, sel, thr)."""
    vmask, vval, q, thr = sel
    rows = (fetch(ik), fetch(il))
    lanes = []
    for lane in range(G):
        a = n = x = 0
        for t in range(32 // G):
            second = lane + t * G >= 16
            v = (lane + t * G) & 15
            cnt, syms, m, _ = rows[second]
            vm = (v & vmask) == vval
            kv = (v & 3) * 4 + (v >> 2)
            ca = sum(int(cnt[4 * v + e]) for e in range(4)
                     if vm and e == q)
            cx = sum(int(cnt[4 * v + e]) for e in range(4)
                     if 16 * e + kv > thr)
            sym = int(syms[v])
            if v < m and sym < 64:
                sv, se = sym >> 2, sym & 3
                ca += (sv & vmask) == vval and se == q
                cx += 16 * se + (sv & 3) * 4 + (sv >> 2) > thr
            if second:
                n, x = n + ca, x + cx
            else:
                a, n, x = a + ca, n - ca, x - cx
        lanes.append([a & M32, n & M32, x & M32])
    off = G // 2
    while off:
        lanes = [[(p + o) & M32 for p, o in zip(lanes[j], lanes[j ^ off])]
                 for j in range(G)]
        off //= 2
    assert all(ln == lanes[0] for ln in lanes)
    return [v - (1 << 32) if v >> 31 else v for v in lanes[0]]


def mirror_scan3_group(fetch, k, packed, rlens, max_len, S, G):
    """scan3_group's G lanes of a read (seed_scan3_routed_kernel and
    seed_scan3_big_kernel), one read after another: the state is the
    group's (every lane holds it), a gathering step's row sums come from
    _group_sums, and the per-row terms are added after the reduction: the
    1-step corrections for rows p = 1, 2 and, with a base table, the
    shards' base counts. No prefix skip. fetch: RoutedFetch-like; k: the
    constants (scan3_consts)."""
    def base(i):
        return fetch(i)[3]

    all_words = packed.view("<u4")
    cap = tfs.scan3_cap(max_len, S)
    out = _Tables(packed.shape[0], S)
    last = max_len - 1
    L2 = k.L2
    for r in range(packed.shape[0]):
        words, rlen, st = all_words[r], int(rlens[r]), _state()
        it = 0
        while it < cap:
            if not st["in_ext"]:
                if st["pos"] >= rlen - MIN:
                    break
                c = _word_code(words, min(st["pos"], last))
                st.update(x0=L2[c] + 1, x1=L2[3 - c] + 1,
                          x2=L2[c + 1] - L2[c], ext_pos=st["pos"] + 1,
                          start=st["pos"], in_ext=True, replay=False)
            elif st["ext_pos"] >= rlen:
                out.finalize(r, st)
            else:
                ep, x0, x1, x2 = st["ext_pos"], st["x0"], st["x1"], st["x2"]
                ik, il = x1, x1 + x2
                e0 = _word_code(words, min(ep, last))
                ci = 3 - e0
                three = not st["replay"] and ep + 3 <= rlen
                if three:
                    e1 = _word_code(words, min(ep + 1, last))
                    e2 = _word_code(words, min(ep + 2, last))
                    d = (3 - e2) * 16 + (3 - e1) * 4 + (3 - e0)
                    w = e0 * 16 + e1 * 4 + e2
                    sel = (15, d >> 2, d & 3, 63 - w)
                    bA = bN = bX = 0
                    if base(ik) is not None:
                        bk, bl = base(ik), base(il)
                        bA, bN = int(bk[d]), int(bl[d]) - int(bk[d])
                        bX = (int(bl[tbig.B3X_REV + w])
                              - int(bk[tbig.B3X_REV + w]))
                else:
                    sel = (0, 0, ci, 16 * ci + 15)
                    gk = [(k.t0 == c and ik > k.row_p1)
                          + (k.t1 == c and ik > k.row_p2) for c in range(4)]
                    gl = [(k.t0 == c and il > k.row_p1)
                          + (k.t1 == c and il > k.row_p2) for c in range(4)]
                    if base(ik) is not None:
                        bk, bl = base(ik), base(il)
                        gk = [g + int(bk[tbig.B3X_GRP + c])
                              for c, g in enumerate(gk)]
                        gl = [g + int(bl[tbig.B3X_GRP + c])
                              for c, g in enumerate(gl)]
                    bA, bN = gk[ci], gl[ci] - gk[ci]
                    bX = sum(gl[c] - gk[c] for c in range(ci + 1, 4))
                A, N, X = _group_sums(fetch, ik, il, sel, G)
                st["g"] += 2
                n2 = N + bN
                if three and n2 <= 0:
                    st["replay"] = True
                elif three:
                    lo, hi = x1, x1 + x2
                    cmp1 = k.tail1 <= e0
                    cmp2 = (k.tail2a < e0
                            or (k.tail2a == e0 and k.tail2b <= e1))
                    adj = ((lo <= k.primary < hi)
                           + ((lo <= k.row_p1 < hi) and cmp1)
                           + ((lo <= k.row_p2 < hi) and cmp2))
                    st.update(x0=x0 + adj + X + bX,
                              x1=k.c3_first[d] + A + bA, x2=n2,
                              ext_pos=ep + 3)
                elif n2 <= 0:
                    out.finalize(r, st)
                else:
                    adj = x1 <= k.primary and x1 + x2 - 1 >= k.primary
                    st.update(x0=x0 + adj + X + bX,
                              x1=L2[ci] + 1 + A + bA, x2=n2, ext_pos=ep + 1)
            it += 1
        out.store(r, st, it)
    return out.result()


def _occ4(occ, primary, k):
    """occ4(): counts of each base in BWT rows [0, k]."""
    if k < 0:
        return [0, 0, 0, 0]
    kadj = k - (k >= primary)
    row = occ[kadj >> 4]
    word = int(row[4]) & 0xFFFFFFFF
    crumb = (~kadj) & 15
    keep = ~((1 << (2 * crumb)) - 1) & 0x55555555
    out = []
    for c in range(4):
        nx = ~(word ^ (c * 0x55555555)) & 0xFFFFFFFF
        out.append(int(row[c]) + bin(nx & (nx >> 1) & keep).count("1"))
    return out


def mirror_scan1(tfm, codes, rlens, max_len, S, has_n):
    """seed_scan1_kernel's thread: byte codes with has_n, else packed."""
    occ = tfm.occ_rows.numpy()
    L2 = [int(x) for x in tfm.L2.numpy()]
    primary = tfm.primary
    cap = tfs.scan1_cap(max_len, S)
    out = _Tables(codes.shape[0], S)
    last = max_len - 1

    def code(row, p):
        return (int(row[p]) if has_n
                else (int(row[p >> 2]) >> ((p & 3) * 2)) & 3)

    for r in range(codes.shape[0]):
        row, rlen, st = codes[r], int(rlens[r]), _state()
        it = 0
        while it < cap:
            if not st["in_ext"]:
                if st["pos"] >= rlen - MIN:
                    break
                c = code(row, min(st["pos"], last))
                if c > 3:
                    st["pos"] += 1
                else:
                    st.update(x0=L2[c] + 1, x1=L2[3 - c] + 1,
                              x2=L2[c + 1] - L2[c], start=st["pos"],
                              ext_pos=st["pos"] + 1, in_ext=True)
            else:
                ep, x0, x1, x2 = st["ext_pos"], st["x0"], st["x1"], st["x2"]
                ce = code(row, min(ep, last))
                n2 = 0
                if ep < rlen and ce <= 3:
                    tk = _occ4(occ, primary, x1 - 1)
                    tl = _occ4(occ, primary, x1 - 1 + x2)
                    st["g"] += 2
                    ok2 = [tl[c] - tk[c] for c in range(4)]
                    ci = 3 - ce
                    n2 = ok2[ci]
                if n2 != 0:
                    adj = x1 <= primary and x1 + x2 - 1 >= primary
                    st.update(x0=x0 + adj + sum(ok2[ci + 1:]),
                              x1=L2[ci] + 1 + tk[ci], x2=n2, ext_pos=ep + 1)
                else:
                    out.finalize(r, st)
            it += 1
        out.store(r, st, it)
    return out.result()


def _equal(got, want, names=tfs._SEED_KEYS + ("iters", "rows")):
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(np.asarray(g).astype(np.int64),
                                      np.asarray(w).astype(np.int64),
                                      err_msg=name)


SCAN3_CASES = [(0, 64, None), (7, 64, None), (0, 128, None), (7, 128, None),
               (7, 128, 2)]


@pytest.mark.parametrize("pfx_k, max_len, max_seeds", SCAN3_CASES)
def test_scan3_mirror_equal_reference(genome, pfx_k, max_len, max_seeds):
    """The occ3 thread's mirror, the reference's _seed_scan3 with its
    step counts and the port's plain scan through the CPU wrapper agree,
    the mirror and the plain scan on the rows gathered too; max_seeds 2
    with up to 6 substitutions a read overflows."""
    S = max_seeds or max_len // (MIN + 1) + 2
    mat, rlens, packed = _reads(genome["idx"], 100 + max_len + pfx_k, B,
                                max_len, max_sub=6 if max_seeds else 2)
    codes_j, key_j = _jax_words_fns(packed, pfx_k)
    want = jax.jit(lambda fm3, rl: jfs._seed_scan3(
        fm3, codes_j, rl, B, max_len, S, key_fn=key_j, with_iters=True))(
        genome["j3"][pfx_k], jnp.asarray(rlens))
    assert genome["t3"][pfx_k].pfx_k == pfx_k
    got = mirror_scan3(genome["t3"][pfx_k], packed, rlens, max_len, S)
    _equal(got, want)
    plain = ssd.seed_scan3(genome["t3"][pfx_k], torch.from_numpy(packed),
                           torch.from_numpy(rlens), max_len, S,
                           with_iters=True)
    _equal(plain, got)
    assert len(plain) == len(got) == 8
    n_seeds, overflow = np.asarray(want[0]), np.asarray(want[5])
    assert n_seeds.sum() > B // 2 and (rlens < MIN).any()
    assert (rlens == max_len).any()
    assert overflow.any() == bool(max_seeds)


SCAN1_CASES = [(False, 64, None), (True, 64, None), (False, 128, None),
               (True, 128, None), (True, 128, 2)]


@pytest.mark.parametrize("has_n, max_len, max_seeds", SCAN1_CASES)
def test_scan1_mirror_equal_reference(genome, has_n, max_len, max_seeds):
    """The 1-step thread's mirror equals the reference's _seed_scan (on
    2-bit packed codes, or byte codes with ~3% N), and the port's plain
    scan through the CPU wrapper equals both, step counts (and, with the
    mirror, rows gathered) included."""
    S = max_seeds or max_len // (MIN + 1) + 2
    mat, rlens, packed = _reads(genome["idx"], 200 + max_len + has_n, B,
                                max_len, n_rate=0.03 if has_n else 0.0,
                                max_sub=6 if max_seeds else 2)
    if has_n:
        cj = jnp.asarray(mat)

        def codes_j(row, pos):
            return cj[row, pos].astype(jnp.int32)
    else:
        codes_j, _ = _jax_words_fns(packed, 0)
    want = jax.jit(lambda fm, rl: jfs._seed_scan(
        fm, codes_j, rl, B, max_len, S, has_n))(genome["jfm"],
                                                jnp.asarray(rlens))
    codes = mat if has_n else packed
    got = mirror_scan1(genome["tfm"], codes, rlens, max_len, S, has_n)
    _equal(got[:6], want)
    plain = ssd.seed_scan1(genome["tfm"], torch.from_numpy(codes),
                           torch.from_numpy(rlens), max_len, S, has_n,
                           with_iters=True)
    _equal(plain, got)
    assert len(plain) == len(got) == 8
    assert np.asarray(want[0]).sum() > B // 2
    assert np.asarray(want[5]).any() == bool(max_seeds)
    assert has_n == bool((mat[np.arange(max_len)[None, :]
                              < rlens[:, None]] == 4).any())


def _inputs(genome, n=64, max_len=64):
    _, rlens, packed = _reads(genome["idx"], 7, n, max_len)
    return torch.from_numpy(packed), torch.from_numpy(rlens)


@pytest.mark.parametrize("bad", ["rlens_dtype", "codes_dtype", "width",
                                 "batch", "max_len", "strided", "rows"])
def test_wrapper_refusals(genome, bad):
    """Each wrapper raises on what its kernel does not take, on CPU
    tensors too (the checks run before the dispatch)."""
    t3 = genome["t3"][7]
    packed, rlens = _inputs(genome)
    max_len, S = 64, 5
    if bad == "rlens_dtype":
        rlens = rlens.to(torch.int64)
    elif bad == "codes_dtype":
        packed = packed.to(torch.int32)
    elif bad == "width":
        packed = packed[:, :8].contiguous()
    elif bad == "batch":
        rlens = rlens[:-1]
    elif bad == "max_len":
        max_len = 60
    elif bad == "strided":
        packed = torch.cat([packed, packed], dim=1)[:, ::2]
    elif bad == "rows":
        t3 = types.SimpleNamespace(occ3_rows=t3.occ3_rows[:, :64])
    with pytest.raises((TypeError, ValueError)):
        ssd.seed_scan3(t3, packed, rlens, max_len, S)
    fm = (genome["tfm"] if bad != "rows" else types.SimpleNamespace(
        occ_rows=genome["tfm"].occ_rows[:, :4]))
    with pytest.raises((TypeError, ValueError)):
        ssd.seed_scan1(fm, packed, rlens, max_len, S, has_n=False)


def test_cpu_dispatch_runs_plain_scans(genome, monkeypatch):
    """A CPU tensor reaches the plain scans (fm_search._seed_scan3,
    _seed_scan3_compact, _seed_scan), never the kernel library, and the
    launch counters stay 0."""
    calls = []
    for name in ("_seed_scan3", "_seed_scan3_compact", "_seed_scan"):
        orig = getattr(tfs, name)
        monkeypatch.setattr(tfs, name, lambda *a, _o=orig, _n=name, **k:
                            calls.append(_n) or _o(*a, **k))

    def no_kernel():
        raise AssertionError("kernel library loaded for a CPU tensor")

    monkeypatch.setattr(ssd, "_load_kernel", no_kernel)
    ssd.STATS.reset()
    packed, rlens = _inputs(genome)
    ssd.seed_scan3(genome["t3"][7], packed, rlens, 64, 5)
    ssd.seed_scan3(genome["t3"][7], packed, rlens, 64, 5, lanes=16)
    ssd.seed_scan1(genome["tfm"], packed, rlens, 64, 5, has_n=False)
    assert calls == ["_seed_scan3", "_seed_scan3_compact", "_seed_scan"]
    assert sum(ssd.STATS.launches.values()) == 0


@pytest.mark.parametrize("lanes", ["B", "B/4", "B/4+1", 32])
def test_lanes_equal_lockstep(genome, lanes):
    """The lanes form's contract: per-read outputs equal one lane per
    read, at B lanes (lockstep), B/4, B/4 + 1 (a ragged last round) and
    32 lanes."""
    n = 128
    packed, rlens = _inputs(genome, n=n, max_len=128)
    L = {"B": n, "B/4": n // 4, "B/4+1": n // 4 + 1}.get(lanes, lanes)
    t3 = genome["t3"][7]
    want = ssd.seed_scan3(t3, packed, rlens, 128, 9)
    got = ssd.seed_scan3(t3, packed, rlens, 128, 9, lanes=L)
    _equal(got, want)
    assert int(want[0].sum()) > n // 2


def test_prefix_skip_depth_charges_planes_once(monkeypatch):
    """A 500 Mb genome (10^9 text rows) on a card with 74 GB free once the
    1-step rows and the full SA are placed: 18 GB of occ3 rows, 44 GB of
    evidence working set (88 B a base), 2 GB of workspace and reserve
    leave ~10 GB, so the prefix-skip depth is 14. The evidence planes'
    40 B a base are allocated after the backend is made; the depth the
    occ3 build uses must not charge them a second time."""
    n, L = 10 ** 9, 5 * 10 ** 8
    placed = {"planes": 0}
    monkeypatch.setattr(DeviceBackend, "_mem_bytes",
                        lambda self: 74 * 10 ** 9 - placed["planes"])
    monkeypatch.setattr(device_backend, "DeviceFMIndex",
                        types.SimpleNamespace(from_host=lambda idx, device:
                                              None))
    built = {}
    monkeypatch.setattr(device_backend, "DeviceFM3", types.SimpleNamespace(
        from_host=lambda idx, fm, pfx_k, text_words: built.update(
            pfx_k=pfx_k)))
    big = types.SimpleNamespace(seq_len=n, genome_size=L, sa_full=object())
    be = DeviceBackend(big, Config(device="cpu", device_chain=False))
    assert be._fm3_ok and be.device_evidence_ok
    placed["planes"] = 40 * L            # make_device_evidence's planes
    be.fm3
    assert built["pfx_k"] == 14
