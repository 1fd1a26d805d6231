"""The calling kernels of csrc/calling.cu (ops/calling_kernels.py) on the
CPU: numpy mirrors of each kernel's tiling (tiles and threads, the
look-back over tiles published in any state, the compaction by counts,
the NOR's 32-ary searches, staged breaks, zeroed exclusions, two-run
fold, warp segments, slots and edges through epoch-tagged words in any
tile order, launches sharing one scratch) against the JAX package's
programs and the port's plain versions; the NOR scratch's epochs and
growth; calling_variants' NOR tokens; the scan's
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
    # the NOR mirror's geometry is the kernel's
    assert (c["NOR_THREADS"], c["NOR_ITEMS"], c["NOR_STAGE"]) == NOR_GEOMETRY
    assert c["NOR_TILE"] == c["NOR_THREADS"] * c["NOR_ITEMS"]
    # the fetch's tile and table, and the mirror's warps: 8 warps, two a
    # group of 32 positions, FETCH_PITCH odd
    assert (c["FETCH_TILE"], c["FETCH_MAX_SHARDS"]) == (
        ck.FETCH_TILE, ck.FETCH_MAX_SHARDS)
    assert c["FETCH_THREADS"] == 256 and c["FETCH_TILE"] == 4 * 32
    assert c["FETCH_PITCH"] == 11


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

NONE = 1 << 62        # csrc/calling.cu nor_tile: the breaks' clamp
NOR_GEOMETRY = (256, 28, 256)   # NOR_THREADS, NOR_ITEMS, NOR_STAGE


def warp_count_below(a, x, lo, hi):
    """csrc/calling.cu warp_count_below: the entries of the sorted a whose
    value clamped to [lo, hi] is below x, by a 32-ary search (each step
    32 lanes read the last entry of their 1/32 of the range, the ballot
    of those below keeps one part) -> (count, dependent steps)."""
    l, r, steps = 0, len(a), 0
    while l < r:
        step = (r - l + 31) >> 5
        i = l + (np.arange(32) + 1) * step - 1
        below = np.zeros(32, bool)
        ok = i < r
        below[ok] = np.clip(a[i[ok]], lo, hi) < x
        c = int(below.sum())
        assert below[:c].all()          # a prefix of the lanes
        r = min(l + (c + 1) * step - 1, r)
        l += c * step
        steps += 1
    return l, steps


def _seg_min_lanes(f):
    """The shuffle-down segmented minima of nor_tile over one warp's
    first runs f [32, 3] (segment, position, coverage), in place."""
    for d in (1, 2, 4, 8, 16):
        g = f.copy()
        for lane in range(32 - d):
            if g[lane + d, 0] == g[lane, 0]:
                f[lane, 1] = min(f[lane, 1], g[lane + d, 1])
                f[lane, 2] = min(f[lane, 2], g[lane + d, 2])


def nor_mirror(cov, em, brk, nseg, threads=NOR_GEOMETRY[0],
               items=NOR_GEOMETRY[1], stage=NOR_GEOMETRY[2], off=0,
               valid=None, words=None, epoch=1, rng=None, stats=None):
    """nor_blocks_kernel, and with off / valid its slice form
    nor_blocks_slice_kernel, as its blocks run: tiles of threads x items
    positions taken in any order (rng's, else in order); a tile's breaks
    and excluded positions found by the 32-ary searches, the breaks
    staged when at most `stage`, the excluded positions zeroed in the
    tile's staged coverage; a thread's consecutive positions folded into
    runs (the first, runs inside the thread emitted, the last; with at
    most one break position among them, two runs read from the last to
    the first); lane - 1's last run joined to lane's first or emitted;
    the segmented minima of
    the lanes' first runs emitted by each run's first lane; emitted runs
    into the tile's slots, or straight into the launch's words past
    `stage` breaks. Then the tile writes the segments strictly inside
    its range sb .. se; tile 0 those before its first, the last tile
    those after se; an edge (sb when it has a position in the tile, and
    se) adds its slot to the words and counts the tile's arrival, and the
    arrival that completes the tiles its positions span writes it from
    the words, but for its first position and the coverage there, which
    the first of its tiles writes when it holds a normal position of it.
    words: the scratch (int64 [>= 3 * nseg], updated in place; zeros for
    a new one): first, minimum (epoch << 32 | INT32_MAX - minimum,
    combined by max) and arrivals (epoch << 32 | count); a word of
    another epoch reads as empty. Every output word is written, and
    words written twice agree. stats["stale"] counts the reads of a word
    of an earlier launch. -> int64[3 * nseg]."""
    L = cov.size if valid is None else valid
    em = np.sort(np.asarray(em, np.int64))
    brk = np.sort(np.asarray(brk, np.int64))
    K = brk.size
    if words is None:
        words = np.zeros(3 * nseg, np.int64)
    tag = epoch << 32
    tile = threads * items
    ntiles = -(-L // tile)
    order = rng.permutation(ntiles) if rng is not None else range(ntiles)
    out = np.full(3 * nseg, -1, np.int64)
    cl = int(cov[L - 1])

    def add(i, v):
        words[i] = max(int(words[i]), tag | (I32_MAX - int(v)))

    def put(s, f=None, m=None, c=None):
        for i, v in enumerate((f, m, c)):
            if v is not None:
                assert out[i * nseg + s] in (-1, v)
                out[i * nseg + s] = v

    def word(i):
        w = int(words[i])
        if stats is not None and 0 < w >> 32 < epoch:
            stats["stale"] = stats.get("stale", 0) + 1
        return I32_MAX - (w & 0xFFFFFFFF) if w >> 32 == epoch else I32_MAX

    def put_words(s, head):
        f = word(s)
        put(s, m=word(nseg + s))
        if f == I32_MAX or f // tile != head:
            put(s, f=f, c=int(cov[min(max(f, 0), L - 1)]))

    def tiles(s):
        st = 0 if s == 0 else min(max(brk[s - 1] - off, 0), L)
        en = L if s >= K or s == nseg - 1 else min(max(brk[s] - off, 0), L)
        return st // tile, (en - 1) // tile

    for tl in order:
        base = int(tl) * tile
        n = min(tile, L - base)
        kb = warp_count_below(brk, off + base, -NONE, NONE)[0]
        ke = warp_count_below(brk, off + base + n, -NONE, NONE)[0]
        eb = warp_count_below(em, off + base, off, off + L - 1)[0]
        ee = warp_count_below(em, off + base + n, off, off + L - 1)[0]
        nk = ke - kb
        staged = nk <= stage
        sb, se = min(kb, nseg - 1), min(kb + nk, nseg - 1)
        brel = brk[kb:ke] - off - base
        tcov = cov[base:base + n].astype(np.int64)
        tcov[np.clip(em[eb:ee] - off, 0, L - 1) - base] = 0
        slots = np.full((2, nk + 1), I32_MAX, np.int64)

        def emit(seg, a, c):
            if staged:
                slots[0, seg - sb] = min(slots[0, seg - sb], a)
                slots[1, seg - sb] = min(slots[1, seg - sb], c)
            else:
                add(seg, a)
                add(nseg + seg, c)

        first = np.full((threads, 3), I32_MAX, np.int64)
        last = np.full((threads, 3), I32_MAX, np.int64)
        last[:, 0] = -1
        for t in range(threads):
            q0 = t * items
            if q0 >= n:
                continue
            ki = int(np.searchsorted(brel, q0, "right"))
            nb = brel[ki] if ki < nk else I32_MAX
            s, a, c, one = min(kb + ki, nseg - 1), I32_MAX, I32_MAX, True
            if t == 0:
                sf = s
            k2, n2 = ki, nb
            if nb < q0 + items:           # the break position after nb
                while n2 <= nb:
                    k2 += 1
                    n2 = brel[k2] if k2 < nk else I32_MAX
            if q0 + items <= n and n2 >= q0 + items:
                # at most one break position, nb: two runs, [q0, nb) of s
                # and [nb, ..) of s2, from the last position to the first
                s2, a2, c2 = min(kb + k2, nseg - 1), I32_MAX, I32_MAX
                for q in range(q0 + items - 1, q0 - 1, -1):
                    if tcov[q] > 0 and q >= nb:
                        a2, c2 = base + q, min(c2, int(tcov[q]))
                    elif tcov[q] > 0:
                        a, c = base + q, min(c, int(tcov[q]))
                if s2 == s:
                    first[t] = (s, min(a, a2), min(c, c2))
                else:
                    first[t], last[t] = (s, a, c), (s2, a2, c2)
                continue
            for q in range(q0, min(q0 + items, n)):
                if q >= nb:
                    while nb <= q:
                        ki += 1
                        nb = brel[ki] if ki < nk else I32_MAX
                    s2 = min(kb + ki, nseg - 1)
                    if s2 != s:
                        if one:
                            first[t], one = (s, a, c), False
                        elif a != I32_MAX:
                            emit(s, a, c)
                        s, a, c = s2, I32_MAX, I32_MAX
                cv = int(tcov[q])
                if cv > 0:
                    a, c = min(a, base + q), min(c, cv)
            if one:
                first[t] = (s, a, c)
            else:
                last[t] = (s, a, c)
        for w in range(0, threads, 32):
            f, lr = first[w:w + 32], last[w:w + 32]
            for lane in range(1, 32):
                ps, pa, pc = lr[lane - 1]
                if ps >= 0 and ps == f[lane, 0]:
                    f[lane, 1] = min(f[lane, 1], pa)
                    f[lane, 2] = min(f[lane, 2], pc)
                elif ps >= 0 and pa != I32_MAX:
                    emit(ps, pa, pc)
            if lr[31, 0] >= 0 and lr[31, 1] != I32_MAX:
                emit(*lr[31])
            _seg_min_lanes(f)
            for lane in range(32):
                if (lane == 0 or f[lane - 1, 0] != f[lane, 0]) \
                        and f[lane, 1] != I32_MAX:
                    emit(*f[lane])
        for s in range(sb + 1, se):           # inside the tile
            if staged:
                fs = slots[0, s - sb]
                put(s, fs, slots[1, s - sb],
                    int(cov[fs]) if fs != I32_MAX else cl)
            else:
                put_words(s, -1)
        if tl == 0:
            for s in range(sf):
                put(s, I32_MAX, I32_MAX, cl)
        if tl == ntiles - 1:
            for s in range(se + 1, nseg):
                put(s, I32_MAX, I32_MAX, cl)
        for es in ([sb] if sf == sb else []) + ([se] if se != sb else []):
            j, (ta, tb) = es - sb, tiles(es)
            if ta == tb and staged:
                fs = slots[0, j]
                put(es, fs, slots[1, j], int(cov[fs]) if fs != I32_MAX
                    else cl)
                continue
            if staged and slots[0, j] != I32_MAX:
                add(es, slots[0, j])
                add(nseg + es, slots[1, j])
                if tl == ta:            # the edge's first position is here
                    put(es, f=slots[0, j], c=int(cov[slots[0, j]]))
            elif not staged and tl == ta:
                fs = word(es)
                if fs != I32_MAX and fs // tile == tl:
                    put(es, f=fs, c=int(cov[fs]))
            if ta != tb:
                cnt = max(int(words[2 * nseg + es]), tag) + 1
                words[2 * nseg + es] = cnt
                if cnt & 0xFFFFFFFF != tb - ta + 1:
                    continue
            put_words(es, ta if ta != tb else -1)
    assert (out >= 0).all(), "an output word no tile wrote"
    return out


def _nor_inputs(case, cov, rng):
    if case == "breaks":
        em = np.concatenate([[-4, 5, 6, 7, L + 9], rng.integers(0, L, 60)])
        # 1,160 and 1,190 enclose only uncovered positions: an empty key
        brk = np.concatenate([[7, 1160, 1190, L - 1],
                              rng.integers(0, L, 80)])
    elif case == "dense":         # a tile with more breaks than staged
        em = np.arange(2000, 2600, 3)
        brk = np.concatenate([np.arange(2100, 2500, 2), [5000, 5000]])
    elif case == "edge_positions":   # breaks and exclusions at 0, L - 1
        em = np.array([0, 1, L - 1, L - 2, 4000])
        brk = np.array([0, 1, 2, 600, L - 2, L - 1])
    elif case == "duplicate_breaks":  # empty keys between equal breaks
        em = rng.integers(0, L, 40)
        brk = np.array([30, 30, 30, 31, 2000, 2000, 7000, 7000, 7000, 7000])
    else:                         # no breaks: DeviceEvidence's [L]
        em, brk = np.zeros(0, np.int64), np.array([L])
    return em.astype(np.int64), brk.astype(np.int64)


def _jax_nor(cov, em, brk, K):
    """The JAX package's build_nor_kernel over the first K sorted breaks
    (padded with L), at its smallest segment tier above K + 1."""
    jseg = next(t for t in jsd.NOR_SEG_TIERS if t > K + 1)
    jbk = np.full(max(K, 1), L, np.int32)
    jbk[:K] = np.sort(brk[:K])
    return [np.asarray(w) for w in jsd.build_nor_kernel(L, jseg)(
        jnp.asarray(cov), jnp.asarray(em.astype(np.int32)),
        jnp.int32(em.size), jnp.asarray(jbk), jnp.int32(K))]


def _assert_nor(got, cov, em, brk, nseg, K):
    """got against the JAX kernel (keys 0..K) and the plain version."""
    for i, w in enumerate(_jax_nor(cov, em, brk, K)):
        np.testing.assert_array_equal(got[i * nseg:i * nseg + K + 1],
                                      w[:K + 1])
    plain = ck.nor_blocks_plain(torch.from_numpy(cov), torch.from_numpy(em),
                                torch.from_numpy(np.sort(brk)), nseg)
    np.testing.assert_array_equal(got, plain.numpy())


@pytest.mark.parametrize("case", ["breaks", "dense", "no_breaks"])
@pytest.mark.parametrize("geometry", [NOR_GEOMETRY, (128, 4, 8)])
def test_nor_mirror(case, geometry):
    """The NOR tiling (the kernel's geometry, then small tiles whose
    breaks overflow the stage), its tiles in any order, against the JAX
    package's build_nor_kernel and the port's plain version: empty
    segments hold INT32_MAX and the coverage at L - 1."""
    rng = np.random.default_rng(8)
    _, _, cov, _ = _finalized(7)
    em, brk = _nor_inputs(case, cov, rng)
    K = brk.size if case != "no_breaks" else 0
    nseg = K + 2
    got = nor_mirror(cov, em, brk, nseg, *geometry,
                     rng=np.random.default_rng(K))
    _assert_nor(got, cov, em, brk, nseg, K)
    if case == "breaks":
        first = got[:nseg]
        assert (first == I32_MAX).sum() >= 1 and (first < L).sum() > 40


@pytest.mark.parametrize("case", ["no_breaks_no_excluded",
                                  "edge_positions", "duplicate_breaks"])
@pytest.mark.parametrize("geometry", [NOR_GEOMETRY, (128, 4, 8)])
def test_nor_mirror_edges(case, geometry):
    """K = 0 and E = 0 (empty break and exclusion lists, one segment
    holding every covered position), breaks and excluded positions at 0
    and L - 1, and duplicate breaks (empty keys between them): the mirror
    against the JAX kernel and the plain version."""
    rng = np.random.default_rng(10)
    _, _, cov, _ = _finalized(7)
    if case == "no_breaks_no_excluded":
        em = brk = np.zeros(0, np.int64)
    else:
        em, brk = _nor_inputs(case, cov, rng)
    K = brk.size
    nseg = K + 2
    got = nor_mirror(cov, em, brk, nseg, *geometry,
                     rng=np.random.default_rng(3))
    _assert_nor(got, cov, em, brk, nseg, K)
    if case == "no_breaks_no_excluded":
        assert got[0] == np.nonzero(cov > 0)[0][0] and got[1] == I32_MAX
    elif case == "duplicate_breaks":
        assert (got[:nseg] == I32_MAX).sum() >= 5


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
        np.testing.assert_array_equal(nor_mirror(cov, em, brk, nseg, 128, 4,
                                                 8), plain.numpy())


def test_nor_mirror_shared_scratch():
    """Launches in a row on one scratch, each with the next epoch and no
    clearing: nseg shrinks, grows, shrinks. Launch 2's segment 30 spans
    tiles 0 and 1 with no normal position, over launch 1's word of its
    own segment 30 (an edge across the same tiles, covered): it reads as
    empty. Then launches of random breaks."""
    rng = np.random.default_rng(11)
    _, _, cov, _ = _finalized(7)
    cov = cov.copy()
    cov[4000:9000] = np.maximum(cov[4000:9000], 1)
    cov2 = cov.copy()
    cov2[4000:9000] = 0
    tile = NOR_GEOMETRY[0] * NOR_GEOMETRY[1]
    assert 4000 < tile < 9000
    low = np.sort(rng.choice(3990, 30, replace=False))
    words = np.zeros(3 * 400, np.int64)
    launches = [(cov, np.append(low, 9000)),
                (cov2, np.concatenate([low[:29], [4000, 9000]]))]
    for nb in (300, 120):
        launches.append((cov, np.sort(rng.integers(0, L, nb))))
    for epoch, (c, brk) in enumerate(launches, start=1):
        em = rng.integers(0, L, 30).astype(np.int64)
        brk = brk.astype(np.int64)
        nseg = brk.size + 2
        stats = {}
        got = nor_mirror(c, em, brk, nseg, *NOR_GEOMETRY, words=words,
                         epoch=epoch, rng=rng, stats=stats)
        _assert_nor(got, c, em, brk, nseg, brk.size)
        assert (words[:3 * nseg] >> 32 <= epoch).all()
        if epoch == 1:
            assert words[30] >> 32 == 1
        if epoch == 2:
            assert stats["stale"] >= 1 and got[30] == got[nseg + 30] \
                == I32_MAX and words[30] >> 32 == 1


def test_nor_words_scratch():
    """_nor_words: one scratch a device and stream, the next epoch each
    launch; a new zeroed scratch when nseg outgrows it or the epochs
    (1 .. 2^30 - 1) run out."""
    ck._nor_scratch.clear()
    cpu = torch.device("cpu")
    p1, cap, e1 = ck._nor_words(cpu, 10)
    assert ck._nor_scratch[cpu, 0][0].shape == (3 * cap,)
    p2, cap2, e2 = ck._nor_words(cpu, cap)
    assert (p2, cap2, e1, e2) == (p1, cap, 1, 2) and cap >= 10
    _, cap3, e3 = ck._nor_words(cpu, cap + 1)
    assert cap3 >= cap + 1 and e3 == 1
    sc = ck._nor_scratch[cpu, 0]
    sc[0][5] = 7
    sc[1] = (1 << 30) - 2
    assert ck._nor_words(cpu, 1)[2] == (1 << 30) - 1
    _, _, e = ck._nor_words(cpu, 1)
    assert e == 1 and int(ck._nor_scratch[cpu, 0][0].abs().sum()) == 0
    ck._nor_scratch.clear()


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 1024, 6484, 40000])
def test_warp_search_mirror(n):
    """The 32-ary search counts as np.searchsorted over the clamped
    values (duplicates, values outside the clamp, x at and beside every
    kind of entry) in ceil(log32(n + 1)) steps or fewer: 3 for the main
    data's 6,484 breaks."""
    rng = np.random.default_rng(n)
    a = np.sort(rng.integers(-50, 3 * n + 50, n)).astype(np.int64)
    lo, hi = 0, 3 * n
    c = np.clip(a, lo, hi)
    xs = np.concatenate([[-NONE, -1, 0, 1, hi, hi + 1, NONE],
                         rng.integers(-60, 3 * n + 60, 40), a[:50],
                         a[:50] + 1])
    most = 0
    while 32 ** most < n + 1:
        most += 1
    for x in xs:
        got, steps = warp_count_below(a, int(x), lo, hi)
        assert got == np.searchsorted(c, x, "left") and steps <= most
    if n == 6484:
        assert warp_count_below(a, int(a[3000]), -NONE, NONE)[1] == 3


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


def fetch_mirror(shards, offs, before, idx, P, Q, L, bds,
                       single=False, tile=128):
    """caller_fetch_slice_kernel (with `single`: caller_fetch_kernel, one
    shard whose prefix is exclusive) as its blocks run: a tile of `tile`
    positions a block, two warps a group of 32 positions, a lane one
    position (clamped, its shard by the kernel's search over the shards'
    first positions, its index local to the shard), each warp five
    columns, staged at an odd pitch and written out two words a store
    in the [P, 10] layout; then a point or block a thread."""
    n = len(shards)
    nbd = idx.size - P - Q
    out = np.full(10 * P + Q + nbd, -7, np.int64)
    offs = np.asarray(offs, np.int64)
    boffs = offs // 100
    lens = [sh[3].size for sh in shards]

    def shard(firsts, x):
        s, step = 0, ck.FETCH_MAX_SHARDS // 2
        while step:
            if s + step < n and firsts[s + step] <= x:
                s += step
            step >>= 1
        return s

    rows = [[a[0], a[1], a[2], a[3], m, F[0], F[1], F[2], F[3], c]
            for a, F, m, c, _ in shards]
    pitch = 11
    for blk in range(-(-P // tile)):
        t0 = blk * tile
        npos = min(tile, P - t0)
        stage = np.zeros(tile * pitch, np.int64)
        for warp in range(8):
            for lane in range(32):
                j, c0 = (warp >> 1) * 32 + lane, (warp & 1) * 5
                if j < npos:
                    p = min(max(int(idx[t0 + j]), 0), L - 1)
                    s = shard(offs, p)
                    lp = min(max(p - int(offs[s]), 0), lens[s] - 1)
                    for c in range(5):
                        stage[j * pitch + c0 + c] = rows[s][c0 + c][lp]
        for i in range(5 * npos):
            a, b = divmod(i, 5)
            out[10 * t0 + 2 * i] = stage[a * pitch + 2 * b]
            out[10 * t0 + 2 * i + 1] = stage[a * pitch + 2 * b + 1]
    for i in range(Q + nbd):
        x = int(idx[P + i])
        if i < Q:
            q = min(max(x, 0), L)
            s = shard(offs, q)
            lq = min(max(q - int(offs[s]), 0), lens[s])
            cpre = shards[s][4]
            r = int(cpre[lq]) if single else int(before[s]) + (
                0 if lq == 0 else int(cpre[lq - 1]))
        else:
            s = shard(boffs, x)
            r = int(bds[s][x - int(boffs[s])])
        out[10 * P + i] = r
    return out

def test_fetch_mirror():
    """The single-card fetch (caller_fetch_kernel: the fetch body over one
    shard at 0, its exclusive coverage prefix) as its tiles run equals
    caller_fetch_plain and the JAX package's build_fetch_kernel on
    finalized planes: positions in any order, more than two tiles, at 0,
    L - 1 and clamped on both sides; points at 0, L and clamped; block
    depths in the same buffer."""
    rng = np.random.default_rng(31)
    arrs, _ = _planes(31, L)
    fin = ck.evidence_finalize_plain(*(torch.from_numpy(arrs[k]) for k in (
        "acgt", "exact_diff", "f_diff", "multi_diff")), L,
        codes=torch.from_numpy(rng.integers(0, 4, L).astype(np.int32)))
    acgt, F, multi, cov, cpre = (x.numpy() for x in tuple(fin)[:5])
    p = rng.permutation(np.concatenate([[0, L - 1, -3, L + 8],
                                        rng.integers(0, L, 290)]))
    q = rng.permutation(np.concatenate([[0, L, L + 2, -1],
                                        rng.integers(0, L + 1, 40)]))
    bd = rng.integers(0, 500, (L + 99) // 100).astype(np.int32)
    b = rng.integers(0, bd.size, 25)
    idx = np.concatenate([p, q, b]).astype(np.int64)
    P, Q = p.size, q.size
    want = ck.caller_fetch_plain(fin.acgt, fin.multi, fin.F, fin.cov,
                                 fin.cov_prefix, torch.from_numpy(idx), P, Q,
                                 torch.from_numpy(bd)).numpy()
    got = fetch_mirror([(acgt, F, multi, cov, cpre)], [0], [0], idx, P, Q, L,
                       [bd], single=True)
    np.testing.assert_array_equal(got, want)
    jcols, jpref = jsd.build_fetch_kernel(L)(
        jnp.asarray(acgt), jnp.asarray(multi), jnp.asarray(F),
        jnp.asarray(cov), jnp.asarray(cpre), jnp.asarray(p), jnp.asarray(q))
    np.testing.assert_array_equal(got[:10 * P].reshape(P, 10),
                                  np.asarray(jcols))
    np.testing.assert_array_equal(got[10 * P:10 * P + Q], np.asarray(jpref))
    np.testing.assert_array_equal(got[10 * P + Q:], bd[b])


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


@pytest.mark.parametrize("variant,consts", [
    ("Nt128_Ni12", dict(NOR_THREADS=128, NOR_ITEMS=12)),
    ("Ns64_Nm4", dict(NOR_STAGE=64, NOR_MIN_BLOCKS=4)),
    ("Nb1", dict(NOR_BULK=1)),
    ("Nb0_Ni20_Nm8", dict(NOR_BULK=0, NOR_ITEMS=20, NOR_MIN_BLOCKS=8))])
def test_calling_variants_nor_tokens(variant, consts):
    """calling_variants' NOR tokens set their constants of csrc/calling.cu
    and nothing else (the tile follows the threads and items)."""
    from mapcaller_tpu_torch import calling_variants as cv
    with open(cv.SRC) as f:
        src = f.read()
    before = calling_constants()
    edited = cv.variant_source(variant, src)
    env = {}
    for decls in re.findall(r"^constexpr int (\w+ = [^;]+);", edited, re.M):
        for d in decls.split(","):
            name, expr = (x.strip() for x in d.split("=", 1))
            env[name] = eval(expr.replace("/", "//"), {}, dict(env))
    want = dict(before, **consts)
    want["NOR_TILE"] = want["NOR_THREADS"] * want["NOR_ITEMS"]
    assert env == want
