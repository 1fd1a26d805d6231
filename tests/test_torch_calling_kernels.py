"""The calling kernels of csrc/calling.cu (ops/calling_kernels.py) on the
CPU: numpy mirrors of each kernel's tiling (tiles and threads, the
look-back over tiles published in any state, the compaction by counts,
the NOR tile's staged breaks, warp segments and slot minima) against the
JAX package's programs and the port's plain versions; the scan's
truncation order past CAND_CAP; the slice forms of the plain finalize and
scan against the JAX package's genome-sharded programs
(mapcaller_tpu/pipeline/big_profile.py) on its CPU mesh; and which entry
point each DeviceEvidence and BigDeviceEvidence step reaches for card
and CPU tensors. Inputs are made from numpy seeds; every comparison is
exact integer equality."""
import os
import re
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from mapcaller_tpu.calling import scan_device as jsd
from mapcaller_tpu.parallel.mesh import make_mesh
from mapcaller_tpu.pipeline import big_profile as jbp
from mapcaller_tpu.pipeline import device_profile as jdp
from mapcaller_tpu_torch.calling import scan_device as tsd
from mapcaller_tpu_torch.ops import calling_kernels as ck
from mapcaller_tpu_torch.pipeline import device_profile as tdp
from mapcaller_tpu_torch.pipeline.big_profile import (BigDeviceEvidence,
                                                      ShardPlanes)

torch.set_num_threads(1)   # small tensor ops: see test_torch_e2e.py

L = 9137              # not a multiple of any tile below
LOOKBACK = 32         # csrc/calling.cu: predecessors a look-back step reads
MAXC = ck.MAX_ALLELE_COUNT
I32_MAX = ck.INT32_MAX


def _i32(a):
    """int64 values wrapped to int32, as int64."""
    a = np.asarray(a, dtype=np.int64) & 0xFFFFFFFF
    return np.where(a >= 1 << 31, a - (1 << 32), a)


def calling_constants():
    """Every namespace-scope `constexpr int NAME = expr;` of
    csrc/calling.cu, evaluated in order -> {NAME: value}."""
    path = os.path.join(os.path.dirname(ck.__file__), os.pardir, "csrc",
                        "calling.cu")
    with open(path) as f:
        src = f.read()
    env = {}
    for decls in re.findall(r"^constexpr int (\w+ = [^;]+);", src, re.M):
        for d in decls.split(","):
            name, expr = (x.strip() for x in d.split("=", 1))
            env[name] = eval(expr.replace("/", "//"), {}, dict(env))
    return env


def test_constants_match_source():
    """The tile sizes, slot words and look-back step that the wrappers
    and these mirrors copy by hand equal csrc/calling.cu's."""
    c = calling_constants()
    assert (c["FIN_TILE"], c["SCAN_TILE"], c["SLOT_WORDS"]) == (
        ck.FIN_TILE, ck.SCAN_TILE, ck.SLOT_WORDS)
    assert c["LOOKBACK"] == LOOKBACK
    assert (c["MAX_ALLELE"], c["BLOCK_SIZE"], c["CAND_CAP"], c["RUN_CAP"]) \
        == (MAXC, ck.BLOCK_SIZE, ck.CAND_CAP, ck.RUN_CAP)
    # a tile's slot holds chain A (flag, 6 + 6 words) and chain B (flag,
    # 1 + 1) in SLOT_WORDS words
    assert c["CHAIN_B"] >= 1 + 2 * 6 and c["CHAIN_B"] + 3 <= c["SLOT_WORDS"]


def look_back_mirror(aggs, rng, window=None):
    """The decoupled look-back over tiles in ticket order: tile k reads
    its predecessors `window` (default LOOKBACK) at a time, each published
    as an aggregate or (at random; tile 0 always) as its inclusive prefix,
    and adds the aggregates after the nearest prefix to it. aggs [T, K] ->
    each tile's exclusive prefix."""
    window = window or LOOKBACK
    T = aggs.shape[0]
    incl = np.zeros_like(aggs)
    excl = np.zeros_like(aggs)
    incl[0] = aggs[0]
    for k in range(1, T):
        prefix = rng.random(k) < 0.4
        prefix[0] = True
        acc = np.zeros(aggs.shape[1], dtype=aggs.dtype)
        top = k - 1
        while True:
            idx = np.arange(max(top - window + 1, 0), top + 1)
            pre = idx[prefix[idx]]
            if pre.size:
                acc += incl[pre[-1]] + aggs[pre[-1] + 1:top + 1].sum(0)
                break
            acc += aggs[idx].sum(0)
            top -= window
        excl[k], incl[k] = acc, acc + aggs[k]
    return excl


# ---- the finalize ----------------------------------------------------------

def finalize_mirror(acgt, exact_diff, f_diff, multi_diff, n, codes, tile,
                    items, rng, carry=None, cov_in=0, lead=True, window=None):
    """evidence_finalize_kernel's arithmetic as its tiles and threads run
    it: each thread's sums of the six diff rows, the block's exclusive
    scan, the look-back; the running prefixes modulo 2^32; then the
    coverage's int64 chain the same way. -> (acgt, F, multi, cov,
    cov_prefix, carry) as int64 arrays."""
    T = -(-n // tile)
    N, threads = T * tile, tile // items

    def row(a):
        out = np.zeros(N, dtype=np.int64)
        out[:n] = np.asarray(a)[:n]
        return out & 0xFFFFFFFF

    u = np.stack([row(exact_diff)] + [row(f_diff[k]) for k in range(4)]
                 + [row(multi_diff)]).reshape(6, T, threads, items)
    th = u.sum(-1)
    ex_tile = look_back_mirror(th.sum(-1).T, rng, window).T
    c_in = np.zeros(6, np.int64) if carry is None else \
        np.asarray(carry[:6], np.int64) & 0xFFFFFFFF
    start = ex_tile[:, :, None] + np.cumsum(th, -1) - th + c_in[:, None,
                                                                None]
    pref = _i32(start[..., None] + np.cumsum(u, -1)).reshape(6, N)[:, :n]
    exact, F, cm = pref[0], pref[1:5], pref[5]
    add = np.where(np.arange(4)[:, None] == np.asarray(codes)[None, :n],
                   exact[None, :], 0)
    a = np.minimum(_i32(np.asarray(acgt, np.int64)[:, :n] + add), MAXC)
    cov = _i32(a.sum(0))
    cz = np.zeros(N, dtype=np.int64)
    cz[:n] = cov
    cz = cz.reshape(T, threads, items)
    cth = cz.sum(-1)
    cex = look_back_mirror(cth.sum(-1)[:, None], rng, window)[:, 0]
    cpre = (cov_in + cex[:, None, None] + (np.cumsum(cth, -1) - cth)[..., None]
            + np.cumsum(cz, -1)).reshape(N)[:n]
    return (a, F, np.minimum(cm, MAXC), cov,
            np.concatenate([[cov_in], cpre]) if lead else cpre,
            np.concatenate([[exact[-1]], F[:, -1], [cm[-1]], [cpre[-1]]]))


def _planes(seed, n, wrap=False):
    """Evidence planes of genome length n in the DevicePlanes layout:
    coverage walks, orientation and multi-hit endpoints, point adds past
    the cap at some positions; with `wrap`, the exact prefix passes 2^31
    over ten positions."""
    rng = np.random.default_rng(seed)
    walk = np.abs(np.cumsum(rng.integers(-3, 4, n))) % 70
    ex = np.zeros(n + 2, np.int64)
    ex[:n] = np.diff(np.concatenate([[0], walk]))
    ex[n] = -walk[-1]
    if wrap:
        ex[100] += 2 ** 31 - 5
        ex[110] -= 2 ** 31 - 5
    acgt = np.zeros((4, n + 1), np.int64)
    hit = np.nonzero(rng.random(n) < 0.1)[0]
    acgt[rng.integers(0, 4, hit.size), hit] = rng.integers(0, 60, hit.size)
    acgt[2, 300:310] = 4100
    fd = rng.integers(-3, 4, (4, n + 2))
    md = np.zeros(n + 2, np.int64)
    md[0] = 4100
    md[rng.integers(0, n, n // 40)] += 1
    md[rng.integers(0, n, n // 40)] -= 1
    return dict(acgt=acgt.astype(np.int32), exact_diff=_i32(ex).astype(
        np.int32), f_diff=fd.astype(np.int32), multi_diff=md.astype(
        np.int32)), rng.integers(0, 4, n).astype(np.int32)


@pytest.mark.parametrize("tile,items", [(2048, 8), (256, 8), (96, 3),
                                        (1024, 4), (2560, 10), (1536, 6)])
@pytest.mark.parametrize("wrap", [False, True])
def test_finalize_mirror(tile, items, wrap):
    """The finalize's tiling at several tile sizes, L not a multiple of
    any, against the JAX package's build_finalize_kernel (its int32
    coverage prefix is the mirror's int64 one wrapped) and the port's
    plain version; with the exact prefix wrapping past 2^31."""
    arrs, rc = _planes(3 + wrap, L, wrap)
    rng = np.random.default_rng(tile)
    got = finalize_mirror(arrs["acgt"], arrs["exact_diff"], arrs["f_diff"],
                          arrs["multi_diff"], L, rc, tile, items, rng)
    want = jdp.build_finalize_kernel(L)(
        jdp.DevicePlanes(L=L, **{k: jnp.asarray(v) for k, v in arrs.items()}),
        jnp.asarray(rc))
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, np.asarray(w))
    np.testing.assert_array_equal(_i32(got[4]), np.asarray(want[4]))
    plain = ck.evidence_finalize_plain(
        *(torch.from_numpy(arrs[k]) for k in ("acgt", "exact_diff",
                                               "f_diff", "multi_diff")),
        L, codes=torch.from_numpy(rc))
    for g, p in zip(got, plain[:5] + (plain.carry,)):
        np.testing.assert_array_equal(g, p.numpy())
    if wrap:
        assert (got[3] < -(1 << 30)).any()
    assert (got[0] == MAXC).any() and (got[2] == MAXC).any()


def test_finalize_slice_mirror():
    """The slice form's arithmetic (carries in, cov_in, the local prefix)
    in the mirror equals the plain version's, and two slices chained by
    their carries equal the whole."""
    arrs, rc = _planes(9, L)
    t = {k: torch.from_numpy(v) for k, v in arrs.items()}
    whole = ck.evidence_finalize_plain(t["acgt"], t["exact_diff"],
                                       t["f_diff"], t["multi_diff"], L,
                                       codes=torch.from_numpy(rc))
    cut = 4000
    first = ck.evidence_finalize_plain(t["acgt"], t["exact_diff"],
                                       t["f_diff"], t["multi_diff"], cut,
                                       codes=torch.from_numpy(rc))
    rest = {k: v[..., cut:].contiguous() for k, v in t.items()}
    second = ck.evidence_finalize_plain(
        rest["acgt"], rest["exact_diff"], rest["f_diff"], rest["multi_diff"],
        L - cut, codes=torch.from_numpy(rc[cut:]), carry=first.carry,
        cov_in=int(first.carry[6]), lead=False)
    for k in range(4):
        np.testing.assert_array_equal(
            torch.cat([first[k], second[k]], dim=-1).numpy(),
            whole[k].numpy())
    np.testing.assert_array_equal(second.cov_prefix.numpy(),
                                  whole.cov_prefix[cut + 1:].numpy())
    np.testing.assert_array_equal(second.carry.numpy(), whole.carry.numpy())
    got = finalize_mirror(*(rest[k].numpy() for k in (
        "acgt", "exact_diff", "f_diff", "multi_diff")), L - cut, rc[cut:],
        512, 8, np.random.default_rng(1), carry=first.carry.numpy(),
        cov_in=int(first.carry[6]), lead=False)
    for g, p in zip(got, second[:5] + (second.carry,)):
        np.testing.assert_array_equal(g, p.numpy())


@pytest.mark.parametrize("window", [8, LOOKBACK, 128])
def test_look_back_step(window):
    """The look-back at a step of 8, LOOKBACK and 128 predecessors (the
    variants' lb4), over 96 tiles of the finalize and 305 of the scan:
    each tile's carry walks back one or many steps to the nearest
    inclusive prefix, and the outputs equal the JAX package's at every
    step."""
    arrs, rc = _planes(4, L)
    got = finalize_mirror(arrs["acgt"], arrs["exact_diff"], arrs["f_diff"],
                          arrs["multi_diff"], L, rc, 96, 3,
                          np.random.default_rng(window), window=window)
    want = jdp.build_finalize_kernel(L)(
        jdp.DevicePlanes(L=L, **{k: jnp.asarray(v) for k, v in arrs.items()}),
        jnp.asarray(rc))
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, np.asarray(w))
    np.testing.assert_array_equal(_i32(got[4]), np.asarray(want[4]))
    acgt, multi, cov, rc = _finalized(5)
    fb = np.float32(0.2)
    sgot = scan_mirror(acgt, multi, cov, rc, 3, fb, False,
                       np.random.default_rng(window + 1), blocks=1,
                       items=5, window=window)
    _assert_scan(sgot, _jax_scan(acgt, multi, cov, rc, 3, fb, False))


# ---- the scan ----------------------------------------------------------------

def scan_mirror(acgt, multi, cov, rc, ad, fb, somatic, rng, valid=None,
                seam=None, blocks=32, items=5, window=None):
    """caller_scan_kernel as its tiles of `blocks` 100-base blocks and
    threads of `items` positions run it: block sums from the threads'
    partials, each thread's candidate and run-start counts, the block's
    exclusive scan and the look-back, each position written at its rank
    below the cap. -> (block_depth, cand_idx, run_start, run_val, small,
    seam)."""
    n = cov.size
    v = n if valid is None else max(0, min(valid, n))
    tile = blocks * ck.BLOCK_SIZE
    T = -(-n // tile)
    N, threads = T * tile, tile // items
    pos = np.arange(N)

    def row(a):          # the kernel reads every row below v only
        out = np.zeros(N, dtype=np.int64)
        out[:v] = np.asarray(a)[:v]
        return out

    cv, mu, cd = row(cov), row(multi), row(rc)
    bsum = cv.reshape(-1, items).sum(1).reshape(-1, ck.BLOCK_SIZE // items
                                                ).sum(1)
    bd = np.where(bsum > 0, bsum // ck.BLOCK_SIZE, 0)
    thr = np.full(N, ad) if somatic else np.maximum(
        bd[pos // ck.BLOCK_SIZE] >> 1, ad)
    nrm = np.full(N, -1)
    for k in range(4):
        nrm = np.where(cd != k, np.maximum(nrm, row(acgt[k])), nrm)
    sup = np.maximum(np.trunc(cv.astype(np.float32) * np.float32(fb)).astype(
        np.int64) - 1, ad)
    live = pos < v
    cand = live & (cv >= thr) & (nrm >= sup)
    st = np.where(cv > 0, 2, np.where(mu > 0, 1, 0))
    prev = np.concatenate([[-1 if seam is None else seam], st[:-1]])
    newrun = live & (st != prev)
    small = [int(cand.sum()), int(newrun.sum()), int((cv > 0).sum()),
             int(cv[cv > 0].sum())]
    tables = []
    for mask, cap in ((cand, ck.CAND_CAP), (newrun, ck.RUN_CAP)):
        m = mask.reshape(T, threads, items)
        th = m.sum(-1)
        ex = look_back_mirror(th.sum(-1)[:, None], rng, window)[:, 0]
        rank = (ex[:, None, None] + (np.cumsum(th, -1) - th)[..., None]
                + np.cumsum(m, -1) - m).reshape(N)
        keep = mask & (rank < cap)
        idx = np.full(cap, -1)
        idx[rank[keep]] = pos[keep]
        vals = np.zeros(cap, dtype=np.int64)
        vals[rank[keep]] = st[keep]
        tables.append((idx, vals))
    return (bd[:-(-n // ck.BLOCK_SIZE)], tables[0][0], tables[1][0],
            tables[1][1], small, int(st[n - 1]) if n - 1 < v else 0)


def _finalized(seed, n=L):
    """(acgt, multi, cov, rc) finalized int32 planes with coverage in
    stretches, runs of multi-hits inside and across gaps, alternative
    alleles at some positions."""
    rng = np.random.default_rng(seed)
    rc = rng.integers(0, 4, n).astype(np.int32)
    depth = rng.integers(0, 60, n)
    for s in rng.integers(0, n - 600, 6):
        depth[s:s + rng.integers(50, 600)] = 0
    depth[1150:1450] = 0                  # a gap across 1,200
    acgt = np.zeros((4, n), np.int32)
    acgt[rc, np.arange(n)] = depth
    alt = np.nonzero(rng.random(n) < 0.1)[0]
    acgt[(rc[alt] + rng.integers(1, 4, alt.size)) % 4, alt] = \
        rng.integers(0, 40, alt.size)
    multi = np.zeros(n, np.int32)
    for s in rng.integers(0, n - 400, 8):
        multi[s:s + rng.integers(20, 400)] = rng.integers(1, 3)
    return acgt, multi, acgt.sum(0, dtype=np.int32), rc


def _jax_scan(acgt, multi, cov, rc, ad, fb, somatic):
    bd, cand, rs, rv, small = jsd.build_scan_kernel(cov.size, somatic)(
        *(jnp.asarray(x) for x in (acgt, multi, cov, rc)), jnp.int32(ad),
        jnp.float32(fb))
    return (np.asarray(bd), np.asarray(cand), np.asarray(rs), np.asarray(rv),
            list(jsd.unpack_small(np.asarray(small))))


def _assert_scan(got, want):
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert [int(x) for x in got[4]] == [int(x) for x in want[4]]


@pytest.mark.parametrize("blocks", [32, 3, 1, 16])
@pytest.mark.parametrize("somatic", [False, True])
def test_scan_mirror(blocks, somatic):
    """The scan's tiling with tiles of 32, 3 and 1 100-base blocks (runs
    cross many tile seams) against the JAX package's build_scan_kernel
    and the port's plain version."""
    acgt, multi, cov, rc = _finalized(5)
    fb = np.float32(0.01 if somatic else 0.2)
    got = scan_mirror(acgt, multi, cov, rc, 3, fb, somatic,
                      np.random.default_rng(blocks), blocks=blocks)
    want = _jax_scan(acgt, multi, cov, rc, 3, fb, somatic)
    _assert_scan(got, want)
    assert got[4][0] > 50 and got[4][1] > 20
    plain = ck.caller_scan_plain(*(torch.from_numpy(x) for x in (
        acgt, multi, cov, rc)), 3, fb, somatic)
    _assert_scan(plain, want)
    assert int(plain.seam) == got[5]


@pytest.mark.parametrize("blocks,items", [(32, 10), (24, 5), (16, 10),
                                          (1, 2)])
def test_scan_mirror_geometry(blocks, items):
    """The scan's tiling at 5 positions a thread (the kernel's), at 10 (the
    design before) and at other tiles and threads against the JAX
    package's build_scan_kernel."""
    acgt, multi, cov, rc = _finalized(15)
    fb = np.float32(0.2)
    got = scan_mirror(acgt, multi, cov, rc, 3, fb, False,
                      np.random.default_rng(blocks * items), blocks=blocks,
                      items=items)
    _assert_scan(got, _jax_scan(acgt, multi, cov, rc, 3, fb, False))


@pytest.mark.parametrize("cut", [1200, 1300, 2000])
def test_scan_slices_mirror(cut):
    """Two slices of the scan, the second with the first's run state at
    the seam (inside a run at 1,300 and 2,000, at a gap's end at 1,200),
    equal the whole scan in counts, tables and block depths; the mirror
    of each slice equals the plain version's."""
    acgt, multi, cov, rc = _finalized(6)
    fb = np.float32(0.2)
    whole = _jax_scan(acgt, multi, cov, rc, 2, fb, False)
    a = ck.caller_scan_plain(*(torch.from_numpy(np.ascontiguousarray(
        x[..., :cut])) for x in (acgt, multi, cov, rc)), 2, fb, False)
    b = ck.caller_scan_plain(*(torch.from_numpy(np.ascontiguousarray(
        x[..., cut:])) for x in (acgt, multi, cov, rc)), 2, fb, False,
        seam=a.seam)
    na, nb_ = (int(x.small[0]) for x in (a, b))
    ra, rb = (int(x.small[1]) for x in (a, b))
    np.testing.assert_array_equal(
        np.concatenate([a.cand_idx[:na], b.cand_idx[:nb_] + cut]),
        whole[1][:whole[4][0]])
    np.testing.assert_array_equal(
        np.concatenate([a.run_start[:ra], b.run_start[:rb] + cut]),
        whole[2][:whole[4][1]])
    np.testing.assert_array_equal(
        np.concatenate([a.run_val[:ra], b.run_val[:rb]]),
        whole[3][:whole[4][1]])
    assert [int(x) + int(y) for x, y in zip(a.small, b.small)] == whole[4]
    if cut % ck.BLOCK_SIZE == 0:
        np.testing.assert_array_equal(
            np.concatenate([a.block_depth, b.block_depth]), whole[0])
    if cut != 1200:
        assert multi[cut - 1] > 0 or cov[cut - 1] > 0   # inside a run
    for part, lo, hi, seam in ((a, 0, cut, None), (b, cut, L, int(a.seam))):
        got = scan_mirror(*(np.ascontiguousarray(x[..., lo:hi]) for x in (
            acgt, multi, cov, rc)), 2, fb, False, np.random.default_rng(lo),
            seam=seam, blocks=3)
        _assert_scan(got, part)
        assert got[5] == int(part.seam)


@pytest.mark.parametrize("somatic", [False, True])
def test_scan_overflow_order(somatic):
    """Every one of 150,000 positions a candidate: the table holds the
    first CAND_CAP in position order and the count all of them, in the
    JAX package's scan, the port's scan and the mirror."""
    n = 150_000
    rc = np.zeros(n, np.int32)
    acgt = np.zeros((4, n), np.int32)
    acgt[1] = 50
    acgt[3, ::7] = 9
    multi = np.zeros(n, np.int32)
    cov = acgt.sum(0, dtype=np.int32)
    fb = np.float32(0.2)
    want = _jax_scan(acgt, multi, cov, rc, 2, fb, somatic)
    assert want[4][0] == n > ck.CAND_CAP
    np.testing.assert_array_equal(want[1], np.arange(ck.CAND_CAP))
    got = tsd.build_scan_kernel(n, somatic)(
        *(torch.from_numpy(x) for x in (acgt, multi, cov, rc)), 2, fb)
    _assert_scan([x.numpy() for x in got[:4]] + [got[4].tolist()], want)
    _assert_scan(scan_mirror(acgt, multi, cov, rc, 2, fb, somatic,
                             np.random.default_rng(2)), want)


# ---- the NOR blocks ------------------------------------------------------

def nor_mirror(cov, em, brk, nseg, threads=256, rounds=16, stage=1024):
    """nor_blocks_kernel and nor_finish_kernel: tiles of rounds x threads
    positions, the tile's breaks and exclusions found by search (staged
    when at most `stage`), a warp's 32 consecutive positions reduced over
    runs of equal segment to its first lane, which takes the minima into
    the tile's slot of the segment (or straight into acc when not
    staged); acc holds INT32_MAX - minimum, 0 for none."""
    n = cov.size
    em = np.clip(np.sort(em), 0, n - 1)
    brk = np.sort(brk)
    tile = threads * rounds
    acc = np.zeros(2 * nseg, dtype=np.int64)
    for base in range(0, n, tile):
        end = min(base + tile, n)
        kb, ke = np.searchsorted(brk, [base, end], "left")
        eb, ee = np.searchsorted(em, [base, end], "left")
        staged = ke - kb <= stage
        sb = min(kb, nseg - 1)
        slots = np.full((2, ke - kb + 1), I32_MAX, dtype=np.int64)
        for r in range(rounds):
            p = base + r * threads + np.arange(threads)
            inside = p < end
            pc = np.minimum(p, n - 1)
            key = kb + np.searchsorted(brk[kb:ke], p, "right")
            excl = np.isin(p, em[eb:ee])
            normal = inside & (cov[pc] > 0) & ~excl
            seg = np.where(inside, np.minimum(key, nseg - 1), I32_MAX)
            a = np.where(normal, p, I32_MAX)
            c = np.where(normal, cov[pc], I32_MAX)
            for w in range(0, threads, 32):
                s, aw, cw = seg[w:w + 32], a[w:w + 32], c[w:w + 32]
                heads = np.concatenate([[0], np.nonzero(s[1:] != s[:-1])[0]
                                        + 1])
                am = np.minimum.reduceat(aw, heads)
                cm = np.minimum.reduceat(cw, heads)
                for h, x, y in zip(heads, am, cm):
                    if x == I32_MAX:
                        continue
                    if staged:
                        slots[0, s[h] - sb] = min(slots[0, s[h] - sb], x)
                        slots[1, s[h] - sb] = min(slots[1, s[h] - sb], y)
                    else:
                        acc[s[h]] = max(acc[s[h]], I32_MAX - x)
                        acc[nseg + s[h]] = max(acc[nseg + s[h]], I32_MAX - y)
        if staged:
            for j in range(ke - kb + 1):
                if sb + j < nseg and slots[0, j] != I32_MAX:
                    acc[sb + j] = max(acc[sb + j], I32_MAX - slots[0, j])
                    acc[nseg + sb + j] = max(acc[nseg + sb + j],
                                             I32_MAX - slots[1, j])
    first = I32_MAX - acc[:nseg]
    return np.concatenate([first, I32_MAX - acc[nseg:],
                           cov[np.clip(first, 0, n - 1)]])


def _nor_inputs(case, cov, rng):
    if case == "breaks":
        em = np.concatenate([[-4, 5, 6, 7, L + 9], rng.integers(0, L, 60)])
        # 1,160 and 1,190 enclose only uncovered positions: an empty key
        brk = np.concatenate([[7, 1160, 1190, L - 1],
                              rng.integers(0, L, 80)])
    elif case == "dense":         # a tile with more breaks than staged
        em = np.arange(2000, 2600, 3)
        brk = np.concatenate([np.arange(2100, 2500, 2), [5000, 5000]])
    else:                         # no breaks: DeviceEvidence's [L]
        em, brk = np.zeros(0, np.int64), np.array([L])
    return em.astype(np.int64), brk.astype(np.int64)


@pytest.mark.parametrize("case", ["breaks", "dense", "no_breaks"])
@pytest.mark.parametrize("geometry", [(256, 16, 1024), (32, 4, 16)])
def test_nor_mirror(case, geometry):
    """The NOR tiling (the kernel's geometry, then small tiles whose
    breaks overflow the stage) against the JAX package's
    build_nor_kernel and the port's plain version: empty segments hold
    INT32_MAX and the coverage at L - 1."""
    rng = np.random.default_rng(8)
    _, _, cov, _ = _finalized(7)
    em, brk = _nor_inputs(case, cov, rng)
    K = brk.size if case != "no_breaks" else 0
    nseg = K + 2
    got = nor_mirror(cov, em, brk, nseg, *geometry)
    jseg = next(t for t in jsd.NOR_SEG_TIERS if t > K + 1)
    jbk = np.full(max(K, 1), L, np.int32)
    jbk[:K] = np.sort(brk[:K])
    want = jsd.build_nor_kernel(L, jseg)(
        jnp.asarray(cov), jnp.asarray(em.astype(np.int32)),
        jnp.int32(em.size), jnp.asarray(jbk), jnp.int32(K))
    k = K + 1
    for i, w in enumerate(want):
        np.testing.assert_array_equal(got[i * nseg:i * nseg + k],
                                      np.asarray(w)[:k])
    plain = ck.nor_blocks_plain(torch.from_numpy(cov), torch.from_numpy(em),
                                torch.from_numpy(np.sort(brk)), nseg)
    np.testing.assert_array_equal(got, plain.numpy())
    if case == "breaks":
        first = got[:nseg]
        assert (first == I32_MAX).sum() >= 1 and (first < L).sum() > 40


def test_nor_mirror_clamped_segments():
    """Fewer segments than keys: every key past nseg - 2 lands in the
    last, in the mirror and the plain version alike."""
    rng = np.random.default_rng(9)
    _, _, cov, _ = _finalized(7)
    em = rng.integers(0, L, 50).astype(np.int64)
    brk = np.sort(rng.integers(0, L, 120)).astype(np.int64)
    for nseg in (1, 7, 40):
        plain = ck.nor_blocks_plain(torch.from_numpy(cov),
                                    torch.from_numpy(em),
                                    torch.from_numpy(brk), nseg)
        np.testing.assert_array_equal(nor_mirror(cov, em, brk, nseg, 64, 4,
                                                 8), plain.numpy())


# ---- the slice forms against the JAX package's sharded programs ----------

def _sharded_pair(n, seed):
    """A JAX BigDeviceEvidence stand-in on n mesh devices and the port's
    shard planes, both holding the same planes of genome length L (zero
    past L + 1, the exact prefix back to 0 at L, as a run leaves them)."""
    Pl = -(-(L + 2) // (n * jbp._GRAN)) * jbp._GRAN
    Pg = n * Pl
    arrs, _ = _planes(seed, L)
    full = {}
    for k, v in arrs.items():
        z = np.zeros(v.shape[:-1] + (Pg,), np.int32)
        z[..., :v.shape[-1]] = v
        full[k] = z
    words = np.random.default_rng(seed).integers(
        0, 1 << 32, (2 * L + 15) // 16, dtype=np.int64)
    jev = jbp.BigDeviceEvidence.__new__(jbp.BigDeviceEvidence)
    jev.L, jev.n, jev.Pl, jev.Pg, jev._kern = L, n, Pl, Pg, {}
    jev.mesh = make_mesh(n)

    def put(a, *spec):
        return jax.device_put(jnp.asarray(a), NamedSharding(jev.mesh,
                                                            P(*spec)))
    w = np.zeros(Pg // 16, np.uint32)
    w[:min(words.size, w.size)] = words[:w.size]
    with jax.enable_x64(True):
        jplanes = (put(full["acgt"], None, "dp"), put(full["exact_diff"],
                                                      "dp"),
                   put(full["f_diff"], None, "dp"),
                   put(full["multi_diff"], "dp"), put(w, None))
    # the port's codes a shard: the text words' crumbs, 0 past L
    codes = ck.ref_codes_plain(torch.from_numpy(words), L)
    codes = torch.cat([codes, torch.zeros(Pg - L, dtype=torch.int32)])
    shards = [ShardPlanes(*(torch.from_numpy(np.ascontiguousarray(
        full[k][..., s * Pl:(s + 1) * Pl])) for k in (
        "acgt", "exact_diff", "f_diff", "multi_diff")), s * Pl)
        for s in range(n)]
    return jev, jplanes, shards, [codes[s * Pl:(s + 1) * Pl] for s in
                                  range(n)], Pl


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("somatic", [False, True])
def test_slice_forms_equal_sharded_reference(n, somatic):
    """The plain finalize a shard with the carry of the shard before (a
    local coverage prefix) and the plain scan a shard with its valid
    length and the seam's run state against the JAX package's
    _finalize_kernel and _scan_kernel on its n-device CPU mesh, shard by
    shard: every output word, the coverage totals and the per-shard
    counts."""
    jev, jplanes, shards, codes, Pl = _sharded_pair(n, 10 + n)
    with jax.enable_x64(True):
        jfin = [np.asarray(x) for x in jev._finalize_kernel()(*jplanes)]
    carry, fins = None, []
    for s, sp in enumerate(shards):
        fin = ck.evidence_finalize_plain(sp.acgt, sp.exact_diff, sp.f_diff,
                                         sp.multi_diff, Pl, codes=codes[s],
                                         carry=carry, lead=False)
        sl = slice(s * Pl, (s + 1) * Pl)
        for g, w in zip(fin[:5], jfin[:5]):
            np.testing.assert_array_equal(g.numpy(), w[..., sl])
        assert int(fin.carry[6]) == int(jfin[5][s])
        carry = fin.carry
        fins.append(fin)
    fb = 0.01 if somatic else 0.2
    with jax.enable_x64(True):
        jsc = [np.asarray(x) for x in jev._scan_kernel(somatic)(
            *(jnp.asarray(jfin[i]) for i in (0, 2, 3)), jplanes[4],
            jnp.int32(3), jnp.float32(fb))]
    bd, cand, ncand, runs, rvals, nruns, nal, hi, lo = jsc
    npart = hi.size // n
    seam = None
    for s, fin in enumerate(fins):
        r = ck.caller_scan_plain(fin.acgt, fin.multi, fin.cov, codes[s], 3,
                                 np.float32(fb), somatic, valid=L - s * Pl,
                                 seam=seam)
        seam = r.seam
        nbl = Pl // ck.BLOCK_SIZE
        np.testing.assert_array_equal(r.block_depth.numpy(),
                                      bd[s * nbl:(s + 1) * nbl])
        np.testing.assert_array_equal(r.cand_idx.numpy(), cand[s])
        np.testing.assert_array_equal(r.run_start.numpy(), runs[s])
        np.testing.assert_array_equal(r.run_val.numpy(), rvals[s])
        hs, ls = hi[s * npart:(s + 1) * npart], lo[s * npart:(s + 1) * npart]
        assert r.small.tolist() == [int(ncand[s]), int(nruns[s]),
                                    int(nal[s]), (int(hs.sum()) << 8)
                                    + int(ls.sum())]
    assert int(ncand.sum()) > 20 and int(nruns.sum()) > 10


# ---- which entry point each step reaches -------------------------------

ENTRIES = ("_finalize_kernel", "_scan_kernel", "_fetch_kernel",
           "_nor_kernel")
PLAINS = ("evidence_finalize_plain", "caller_scan_plain",
          "caller_fetch_plain", "nor_blocks_plain")


def _spy(monkeypatch, on_card):
    """Record each kernel entry and plain version called; with on_card,
    every tensor counts as a card tensor and each kernel entry runs the
    plain version in its place."""
    calls = []
    for entry, plain in zip(ENTRIES, PLAINS):
        real = getattr(ck, plain)

        def rec(*a, _name=entry, _real=real, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        def rec_plain(*a, _name=plain, _real=real, **kw):
            calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(ck, entry, rec)
        monkeypatch.setattr(ck, plain, rec_plain)
    if on_card:
        monkeypatch.setattr(ck, "_on_card", lambda name, tensors: True)
    return calls


def _device_evidence():
    arrs, _ = _planes(12, L)
    words = torch.from_numpy(np.random.default_rng(12).integers(
        0, 1 << 32, (2 * L + 15) // 16, dtype=np.int64))
    be = types.SimpleNamespace(
        idx=types.SimpleNamespace(genome_size=L, seq_len=2 * L),
        device="cpu", chain_ctx=types.SimpleNamespace(text_words=words))
    cfg = types.SimpleNamespace(somatic=False, frequency_thr=0.2,
                                min_allele_depth=3)
    ev = tdp.DeviceEvidence(be, cfg, types.SimpleNamespace(
        any_host_evidence=lambda: False))
    ev.planes = tdp.DevicePlanes(L=L, **{k: torch.from_numpy(v)
                                         for k, v in arrs.items()})
    return ev


def _big_evidence(n):
    _, _, shards, codes, Pl = _sharded_pair(n, 20 + n)
    ev = BigDeviceEvidence.__new__(BigDeviceEvidence)
    ev.L, ev.n, ev.Pl, ev.Pg = L, n, Pl, n * Pl
    ev.devs = [torch.device("cpu")] * n
    ev.planes, ev._codes = shards, codes
    ev.cfg = types.SimpleNamespace(somatic=False, frequency_thr=0.2,
                                   min_allele_depth=3)
    ev.host_profile = types.SimpleNamespace(any_host_evidence=lambda: False)
    ev._final = ev._scan = ev._scan_pending = None
    return ev


@pytest.mark.parametrize("on_card", [False, True])
def test_evidence_steps_reach_calling_kernels(monkeypatch, on_card):
    """DeviceEvidence's finalize, start_scan / scan, fetch_columns and
    nor_blocks each reach one calling_kernels entry: the kernel entry
    for card tensors, the plain version for CPU tensors; the results are
    the same either way."""
    outs = {}
    for card in (False, on_card):
        calls = _spy(monkeypatch, card)
        ev = _device_evidence()
        fin = ev.finalize()
        assert calls == [ENTRIES[0] if card else PLAINS[0]]
        np.testing.assert_array_equal(
            ev._ref_codes.numpy(), ev._ref_codes_dev().numpy())
        ev.start_scan()
        scan = ev.scan()
        assert calls[1:] == [ENTRIES[1] if card else PLAINS[1]]
        pos = np.array([-2, 0, 17, L - 1, L + 3], np.int64)
        cols, pref = ev.fetch_columns(pos, np.array([0, 5, L], np.int64),
                                      bd_blocks=np.array([0, 3, 99999]))
        assert calls[2:] == [ENTRIES[2] if card else PLAINS[2]]
        first, mincov, covf = ev.nor_blocks(np.array([9, 3, 40], np.int64),
                                            np.array([500, 20, 7000]))
        assert calls[3:] == [ENTRIES[3] if card else PLAINS[3]]
        outs[card] = (fin, scan, cols, pref, first, mincov, covf)
        monkeypatch.undo()
    a, b = outs[False], outs[on_card]
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)
    for x, y in zip(a[1][1:], b[1][1:]):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a[2:], b[2:]):
        np.testing.assert_array_equal(x, y)
    assert (a[2][:, 9] >= 0).all() and a[3][-1] == int(a[0][4][L])


@pytest.mark.parametrize("on_card", [False, True])
@pytest.mark.parametrize("n", [2, 3])
def test_big_fold_scan_reach_calling_kernels(monkeypatch, on_card, n):
    """B4's fold and scan take evidence_finalize and caller_scan once a
    shard each (the kernel entries for card tensors, the plain versions
    for CPU tensors), and agree with one shard's single-card scan of the
    joined planes."""
    calls = _spy(monkeypatch, on_card)
    ev = _big_evidence(n)
    outs, tots = ev.finalize()
    assert calls == [ENTRIES[0] if on_card else PLAINS[0]] * n
    bd, cand, runs, rvals, scal = ev.scan()
    assert calls[n:] == [ENTRIES[1] if on_card else PLAINS[1]] * n
    monkeypatch.undo()
    # the joined shards against one card's finalize and scan
    joined = {k: torch.cat([getattr(sp, k) for sp in ev.planes], dim=-1)
              for k in ("acgt", "exact_diff", "f_diff", "multi_diff")}
    codes = torch.cat(ev._codes)
    one = ck.evidence_finalize_plain(joined["acgt"], joined["exact_diff"],
                                     joined["f_diff"], joined["multi_diff"],
                                     L, codes=codes)
    np.testing.assert_array_equal(
        tots, [int(o[4][-1]) for o in outs])
    np.testing.assert_array_equal(
        torch.cat([o[3] for o in outs])[:L].numpy(), one.cov.numpy())
    s = ck.caller_scan_plain(one.acgt, one.multi, one.cov, codes, 3,
                             np.float32(0.2), False)
    k1, k2 = int(s.small[0]), int(s.small[1])
    np.testing.assert_array_equal(cand, s.cand_idx[:k1].numpy())
    np.testing.assert_array_equal(runs, s.run_start[:k2].numpy())
    np.testing.assert_array_equal(rvals, s.run_val[:k2].numpy())
    assert scal.tolist() == s.small.tolist()
    np.testing.assert_array_equal(bd.dense(), s.block_depth.numpy())
