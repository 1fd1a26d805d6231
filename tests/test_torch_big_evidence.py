"""B4's programs of the x64 big-genome path (pipeline/big_profile.
BigDeviceEvidence: the apply, the host-delta merge, the column fetch and
the gVCF NOR blocks over genome-sharded planes) and A5's host merge
(pipeline/device_profile.py) on the CPU, where their kernels' plain
versions run:

  * each B4 program against the reference package's BigDeviceEvidence
    program (mapcaller_tpu/pipeline/big_profile.py) on its CPU mesh of
    2, 4 and 8 devices, on the same planes and inputs: reads whose spans
    straddle a seam, positions at 0, at L - 1 and in the padded tail;
    the NOR blocks also against the single-card NOR of the joined
    coverage, and with shards wholly in the padded tail;
  * A5's merge against the reference's build_host_merge_kernel;
  * which wrapper each step reaches (one apply a shard; one merge and
    one fetch a device, also with the shards on two devices);
  * a scalar mirror of each kernel form's threads (csrc/chain.cu
    evidence_apply_slice_kernel; host_merge_kernel's segment split,
    blocks, walks and units of 8 entries at 1, 2, 4 and 8 shards;
    csrc/calling.cu caller_fetch_slice_kernel's tiles, warps and shard
    search over shuffled elements) and the NOR tiling's mirror of
    nor_blocks_slice_kernel (shards sharing the scratch too) against its
    plain version, in coordinates shifted past 2^31;
  * the wrappers' refusals.

Inputs are made from numpy seeds; every comparison is exact integer
equality."""
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from mapcaller_tpu.parallel.mesh import make_mesh
from mapcaller_tpu.pipeline import big_profile as jbp
from mapcaller_tpu.pipeline import device_profile as jdp
from mapcaller_tpu.pipeline.profile import Profile as JaxProfile
from mapcaller_tpu_torch.ops import calling_kernels as cal
from mapcaller_tpu_torch.ops import chain_kernels as chk
from mapcaller_tpu_torch.ops import mesh_kernels as mk
from mapcaller_tpu_torch.pipeline import device_profile as tdp
from mapcaller_tpu_torch.pipeline.big_profile import (BigDeviceEvidence,
                                                      ShardPlanes)
from mapcaller_tpu_torch.pipeline.profile import Profile
from test_torch_calling_kernels import NOR_GEOMETRY, fetch_mirror, nor_mirror

torch.set_num_threads(1)   # small tensor ops: see test_torch_e2e.py

L = 9137              # Pl 4800 / 2400 / 1200 at n = 2 / 4 / 8, Pg 9600
I32_MAX = 0x7FFFFFFF
I64_MAX = 0x7FFFFFFFFFFFFFFF
NS = [2, 4, 8]
PLANES = ("acgt", "exact_diff", "f_diff", "multi_diff")


def _pl(n, g=L):
    return -(-(g + 2) // (n * jbp._GRAN)) * jbp._GRAN


def _put(mesh, a, *spec):
    return jax.device_put(jnp.asarray(a), NamedSharding(mesh, P(*spec)))


def _jax_ev(n, g=L, planes=None):
    """A reference BigDeviceEvidence on n mesh devices with the planes
    `planes` (numpy, [.., Pg]; zero by default)."""
    jev = jbp.BigDeviceEvidence.__new__(jbp.BigDeviceEvidence)
    jev.L, jev.two_l, jev.n = g, 2 * g, n
    jev.Pl = _pl(n, g)
    jev.Pg = n * jev.Pl
    jev._kern, jev._final, jev._scan = {}, None, None
    jev.mesh = make_mesh(n)
    if planes is None:
        planes = {k: np.zeros((4, jev.Pg) if k in ("acgt", "f_diff")
                              else (jev.Pg,), np.int32) for k in PLANES}
    with jax.enable_x64(True):
        jev.planes = jdp.DevicePlanes(L=g, **{
            k: _put(jev.mesh, v, *((None, "dp") if v.ndim == 2 else ("dp",)))
            for k, v in planes.items()})
    return jev


def _port_ev(n, g=L, planes=None):
    """The port's BigDeviceEvidence on n CPU shards holding `planes`."""
    ev = BigDeviceEvidence.__new__(BigDeviceEvidence)
    ev.L, ev.two_l, ev.n = g, 2 * g, n
    ev.Pl = _pl(n, g)
    ev.Pg = n * ev.Pl
    ev.devs = [torch.device("cpu")] * n
    if planes is None:
        ev.planes = [ShardPlanes.zeros(ev.Pl, s * ev.Pl, "cpu")
                     for s in range(n)]
    else:
        Pl = ev.Pl
        ev.planes = [ShardPlanes(*(torch.from_numpy(np.ascontiguousarray(
            planes[k][..., s * Pl:(s + 1) * Pl])) for k in PLANES), s * Pl)
            for s in range(n)]
    ev.host_profile = types.SimpleNamespace(any_host_evidence=lambda: False)
    ev._final = ev._scan = ev._scan_pending = None
    return ev


def _joined(ev):
    return {k: np.concatenate([getattr(sp, k).numpy() for sp in ev.planes],
                              axis=-1) for k in PLANES}


def _assert_planes(ev, jev):
    for k in PLANES:
        np.testing.assert_array_equal(_joined(ev)[k],
                                      np.asarray(getattr(jev.planes, k)),
                                      err_msg=k)


def _random_planes(rng, n, g=L, lo=-40, hi=40):
    """Planes of a run's shape: values in [0, L + 2) (the reference's
    single-card layout), zero in the padded tail past it."""
    Pg = n * _pl(n, g)
    out = {}
    for k in PLANES:
        shape = (4, Pg) if k in ("acgt", "f_diff") else (Pg,)
        a = rng.integers(lo, hi, size=shape).astype(np.int32)
        a[..., g + 2:] = 0
        out[k] = a
    return out


def _spy(monkeypatch, names, mod):
    calls = []
    for name in names:
        real = getattr(mod, name)

        def rec(*a, _name=name, _real=real, **kw):
            calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, rec)
    return calls


# ---- the apply ----------------------------------------------------------------

def _batch(n, seed, B=256):
    """pd int64 / mmp / read lengths / admit words of B reads as the x64
    chain stage gives them: forward and reverse diagonals, a read across
    each seam in each orientation, reads clipped at 0 and at L - 1, reads
    without hits (pd INT64_MAX, never admitted)."""
    rng = np.random.default_rng(seed)
    Pl, two = _pl(n), 2 * L
    rl = rng.integers(40, 121, size=B).astype(np.int32)
    pd = rng.integers(0, two - 40, size=B).astype(np.int64)
    special = []
    for s in range(1, n):
        seam = s * Pl
        if seam < L:
            special += [seam - 20, two - seam - 20]   # forward, reverse
    special += [0, 3, L - 30, L + 2, two - 50, two - 5]
    pd[:len(special)] = special
    rl[:len(special)] = 60
    none = rng.random(B) < 0.05
    none[:len(special)] = False
    pd[none] = I64_MAX
    mmp = np.full((B, 4), -1, dtype=np.int32)
    for b in range(B):
        k = int(rng.integers(0, 5))
        r = np.sort(rng.choice(int(rl[b]), size=k, replace=False))
        mmp[b, :k] = (r << 2) | rng.integers(0, 4, size=k)
    words = rng.integers(0, 1 << 32, size=(B + 31) // 32, dtype=np.int64)
    bits = np.unpackbits(words.astype("<u4").view(np.uint8),
                         bitorder="little")[:B].astype(bool)
    bits[:len(special)] = True
    bits[none] = False
    w = np.packbits(bits.astype(np.uint8), bitorder="little").view("<u4")
    fast = np.zeros((B + 31) // 32, np.uint32)
    fast[:w.size] = w[:fast.size]
    return pd, mmp, rl, fast, len(special)


@pytest.mark.parametrize("n", NS)
def test_apply_equals_reference(monkeypatch, n):
    """apply_batch: one apply_slice a shard (its plain version here), the
    planes equal the reference's _apply_kernel's on its n-device mesh in
    every word, over three batches, the second one single-end, the third
    with int32 pd (the single-card kernels' routes under big_x64), each
    with a read across every seam in each orientation (its start added in
    one shard, its end in the next) and reads clipped at 0 and L - 1;
    nothing lands past L."""
    jev, ev = _jax_ev(n), _port_ev(n)
    calls = _spy(monkeypatch, ["apply_slice", "apply_slice_plain"], mk)
    for seed, pe, i32 in ((n, True, False), (n + 50, False, False),
                          (n + 90, True, True)):
        pd, mmp, rl, fast, nsp = _batch(n, seed)
        if i32:     # the single-card kernels' pd, INT32_MAX without a hit
            pd = np.where(pd == I64_MAX, I32_MAX, pd).astype(np.int32)
        with jax.enable_x64(True):
            tok = [None] * 9
            tok[6] = _put(jev.mesh, pd, "dp")
            tok[7] = _put(jev.mesh, mmp, "dp", None)
            tok[8] = _put(jev.mesh, rl, "dp")
            jev.apply_batch(tok, fast, pe)
        ev.apply_batch(types.SimpleNamespace(
            pd=torch.from_numpy(pd), mmp=torch.from_numpy(mmp),
            rl_dev=torch.from_numpy(rl)), fast, pe)
        _assert_planes(ev, jev)
    assert calls == ["apply_slice", "apply_slice_plain"] * (3 * n)
    assert not _joined(ev)["exact_diff"][L + 1:].any()


# ---- the host-delta merges ----------------------------------------------------

def _host_profiles(seed, g=L):
    """The reference's and the port's host profiles with the same sparse
    slow-read deltas, at positions 0, L - 1 and L too."""
    rng = np.random.default_rng(seed)
    profs = (JaxProfile(g), Profile(g))
    for p in profs:
        p.alloc_diffs()
    for name, shape in (("acgt", (4, g)), ("exact_diff", (g + 1,)),
                        ("F1_diff", (g + 1,)), ("R2_diff", (g + 1,)),
                        ("F2_diff", (g + 1,)), ("R1_diff", (g + 1,)),
                        ("multi_diff", (g + 1,))):
        vals = rng.integers(-3, 4, size=shape) * (rng.random(shape) < 0.05)
        vals[..., 0] = 2
        vals[..., g - 1] = -1
        if shape[-1] > g:
            vals[..., g] = 3
        for p in profs:
            getattr(p, name)[...] = vals
    return profs, rng


@pytest.mark.parametrize("n", NS)
def test_merge_equals_reference(monkeypatch, n):
    """_merge_host_deltas: one host_merge a device over its shards (the
    CPU shards share one device; its plain version here); the planes
    equal the reference's _merge_kernel's in every word and the host
    copies are zeroed."""
    (jprof, tprof), rng = _host_profiles(n)
    planes = _random_planes(rng, n)
    jev, ev = _jax_ev(n, planes=planes), _port_ev(n, planes=planes)
    jev.host_profile, ev.host_profile = jprof, tprof
    calls = _spy(monkeypatch, ["host_merge", "host_merge_plain"], mk)
    jev._merge_host_deltas()
    ev._merge_host_deltas()
    _assert_planes(ev, jev)
    assert calls == ["host_merge", "host_merge_plain"]
    for name in ("acgt", "exact_diff", "F1_diff", "R2_diff", "F2_diff",
                 "R1_diff", "multi_diff"):
        assert not getattr(tprof, name).any()
        np.testing.assert_array_equal(getattr(tprof, name),
                                      getattr(jprof, name))


def test_a5_merge_equals_reference(monkeypatch):
    """A5: the four lists of device_profile.host_delta_lists through
    build_host_merge_kernel (one host_merge) equal the reference's
    build_host_merge_kernel on the same lists, and DeviceEvidence.
    _merge_host_deltas reaches host_merge once."""
    (jprof, tprof), rng = _host_profiles(3)
    Ls = L
    arrs = dict(acgt=rng.integers(-50, 50, (4, Ls + 1)),
                exact_diff=rng.integers(-50, 50, Ls + 2),
                f_diff=rng.integers(-50, 50, (4, Ls + 2)),
                multi_diff=rng.integers(-50, 50, Ls + 2))
    deltas, ends = tdp.host_delta_lists(tprof, Ls)
    assert tdp.merge_strides(Ls) == (Ls + 1, Ls + 2, Ls + 2, Ls + 2)
    idx, val = mk.unpack_deltas(torch.from_numpy(deltas), ends[-1])
    jl = []
    for k in range(4):
        lo = ends[k - 1] if k else 0
        jl += [jnp.asarray(idx[lo:ends[k]].numpy().astype(np.int32)),
               jnp.asarray(val[lo:ends[k]].numpy()), jnp.int32(ends[k] - lo)]
    sizes = [max(int(x[2]), 1) for x in (jl[0:3], jl[3:6], jl[6:9],
                                         jl[9:12])]
    jl = [jnp.pad(a, (0, s - a.shape[0])) if i % 3 < 2 else a
          for i, (a, s) in enumerate(zip(jl, np.repeat(sizes, 3)))]
    want = jdp.build_host_merge_kernel(Ls, *sizes)(
        jdp.DevicePlanes(L=Ls, **{k: jnp.asarray(v.astype(np.int32))
                                  for k, v in arrs.items()}), *jl)
    got = tdp.DevicePlanes(L=Ls, **{k: torch.from_numpy(v.astype(np.int32))
                                    for k, v in arrs.items()})
    calls = _spy(monkeypatch, ["host_merge"], mk)
    tdp.build_host_merge_kernel(Ls)(got, torch.from_numpy(deltas), ends)
    for k in PLANES:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)))
    ev = tdp.DeviceEvidence.__new__(tdp.DeviceEvidence)
    ev.L, ev.device, ev.host_profile = Ls, torch.device("cpu"), tprof
    ev.planes = tdp.DevicePlanes.zeros(Ls, "cpu")
    ev._merge_host_deltas()
    assert calls == ["host_merge"] * 2 and not tprof.acgt.any()


# ---- the fetch and the NOR blocks on finalized shards ------------------------

def _port_finalized(n, seed, g=L):
    """The port's evidence of n shards over a genome of g, finalized: the
    plain fold of random planes -> (evidence, its outputs and totals,
    the rng)."""
    rng = np.random.default_rng(seed)
    planes = _random_planes(rng, n, g, 0, 30)
    # the exact coverage of a run: >= 0, its diff back to 0 at L, with
    # uncovered runs (no exact coverage, no point adds) at random
    exact = rng.integers(0, 20, g)
    for a in rng.integers(0, g, 12):
        exact[a:a + int(rng.integers(1, 300))] = 0
    planes["exact_diff"][:] = 0
    planes["exact_diff"][:g] = np.diff(exact, prepend=0)
    planes["exact_diff"][g] = -exact[-1]
    planes["acgt"][:, g:] = 0
    planes["acgt"][:, :g][:, (exact == 0)
                          | (rng.random(g) < 0.05)] = 0
    ev = _port_ev(n, g, planes)
    ev._codes = [torch.from_numpy(rng.integers(0, 4, ev.Pl).astype(
        np.int32)) for _ in range(n)]
    ev.cfg = types.SimpleNamespace(somatic=False, frequency_thr=0.2,
                                   min_allele_depth=3)
    return ev, ev.finalize(), rng


def _finalized(n, seed, g=L):
    """The port's and the reference's evidence holding the same
    finalized shards: the port's plain fold of random planes (held
    against the reference's fold in test_torch_calling_kernels.py), set as
    the reference's finalize outputs."""
    ev, (outs, tots), rng = _port_finalized(n, seed, g)
    jev = _jax_ev(n, g)
    cat = [np.concatenate([o[i].numpy() for o in outs], axis=-1)
           for i in range(5)]
    with jax.enable_x64(True):
        jev._final = (_put(jev.mesh, cat[0], None, "dp"),
                      _put(jev.mesh, cat[1], None, "dp"),
                      _put(jev.mesh, cat[2], "dp"),
                      _put(jev.mesh, cat[3], "dp"),
                      _put(jev.mesh, cat[4], "dp"),
                      _put(jev.mesh, tots.astype(np.int64), None))
    return ev, jev, cat[3], rng


@pytest.mark.parametrize("n", NS)
def test_fetch_equals_reference(monkeypatch, n):
    """fetch_columns: one caller_fetch_slice a device (the CPU shards
    share one; its plain version here); the columns and the global
    coverage prefix equal the reference's _fetch_kernel's at positions
    at 0, at L - 1, in the padded tail, on each side of every seam and at
    random; with bd_blocks after the scan the block depths ride the same
    calls and equal the shards' depths, as ShardedBlockDepth.gather
    does."""
    ev, jev, cov, rng = _finalized(n, 30 + n)
    Pl = ev.Pl
    seams = [s * Pl + d for s in range(1, n) for d in (-1, 0)]
    pos = np.concatenate([[0, L - 1, L + 3, ev.Pg - 1, -5], seams,
                          rng.integers(0, L, 40)]).astype(np.int64)
    pref = np.concatenate([[0, 1, L, L + 9, -2], seams,
                           rng.integers(0, L + 1, 30)]).astype(np.int64)
    with jax.enable_x64(True):
        jcols, jpref = jev.fetch_columns(pos, pref)
    calls = _spy(monkeypatch, ["caller_fetch_slice"], cal)
    cols, got_pref = ev.fetch_columns(pos, pref)
    np.testing.assert_array_equal(cols, np.asarray(jcols))
    np.testing.assert_array_equal(got_pref, np.asarray(jpref))
    assert len(calls) == 1 and got_pref[2] == int(cov[:L].sum())
    # block depths: the scan's, through the same launches and gather
    bd = ev.scan()[0]
    calls.clear()
    blocks = np.clip(pos, 0, L - 1) // 100
    cols2, _ = ev.fetch_columns(pos, pref, bd_blocks=blocks)
    np.testing.assert_array_equal(cols2, cols)
    assert len(calls) == 1
    dense = np.concatenate([p.numpy() for p in bd._parts]).astype(np.int64)
    for b in np.unique(blocks):
        assert bd._cache[int(b)] == dense[b]
    some = np.array([0, bd.nb - 1, Pl // 100, 7], np.int64) % bd.nb
    np.testing.assert_array_equal(bd.gather(some), dense[some])


def _nor_case(rng, n, g, Pl):
    seams = [s * Pl + d for s in range(1, n) for d in (-1, 0)
             if s * Pl < g]
    em = np.concatenate([[0, g - 1, g + 4, -3], seams,
                         rng.integers(0, g, 60)]).astype(np.int64)
    brk = np.concatenate([[5, g - 1, g + 30], seams[::2],
                          rng.integers(0, g, 70)]).astype(np.int64)
    return em, brk


@pytest.mark.parametrize("n,g", [(2, L), (4, L), (8, L), (8, 3201)])
def test_nor_equals_reference(monkeypatch, n, g):
    """nor_blocks: a nor_blocks_slice a shard holding a position below L
    (its plain version here; at L = 3201 over 8 shards, shards 4-7 lie
    wholly in the padded tail and take none); every word equals the
    single-card NOR of the joined coverage, and the reference's
    _nor_kernel on its mesh in each segment's first position and least
    coverage (its empty segment: INT64_MAX, the port's INT32_MAX, the
    single-card contract) and in the coverage at each nonempty
    segment's first position."""
    ev, jev, cov, rng = _finalized(n, 60 + n, g)
    em, brk = _nor_case(rng, n, g, ev.Pl)
    calls = _spy(monkeypatch, ["nor_blocks_slice"], cal)
    first, mincov, covf = ev.nor_blocks(em, brk)
    assert len(calls) == -(-g // ev.Pl)
    nseg = brk.size + 2
    one = cal.nor_blocks_plain(torch.from_numpy(cov[:g]),
                               torch.from_numpy(em),
                               torch.from_numpy(np.sort(brk)), nseg).numpy()
    np.testing.assert_array_equal(first, one[:nseg])
    np.testing.assert_array_equal(mincov, one[nseg:2 * nseg])
    np.testing.assert_array_equal(covf, one[2 * nseg:])
    with jax.enable_x64(True):
        jf, jm, jc = (np.asarray(x) for x in jev.nor_blocks(em, brk))
    k = brk.size + 1
    empty = first[:k] == I32_MAX
    assert empty.any() and (~empty).sum() > 20
    np.testing.assert_array_equal(np.where(jf[:k] == I64_MAX, I32_MAX,
                                           jf[:k]), first[:k])
    np.testing.assert_array_equal(jm[:k], mincov[:k])
    np.testing.assert_array_equal(jc[:k][~empty], covf[:k][~empty])


# ---- scalar mirrors of the new kernel forms, past 2^31 -----------------------

SHIFT = 3_000_000_123          # a genome past 2^31: human scale


def mirror_apply_slice(planes, off, pd, mmp, rl, bits, g, pair_end,
                       lanes=4):
    """evidence_apply_slice_kernel: a warp an admit word of 32 reads,
    groups of `lanes` lanes, lane q slot q of each admitted read of its
    group (lane 0 its span too), apply_fast_evidence's arithmetic in
    64 bits, each add kept where the slice [off, off + Pl) holds it."""
    B = pd.size
    Pl = planes["exact_diff"].size
    two = 2 * g

    def add(name, row, p, v):
        li = p - off
        if 0 <= li < Pl:
            planes[name].reshape(-1)[row * Pl + li] += v

    groups = 32 // lanes
    for w in range(-(-B // 32)):
        b0 = w * 32
        word = int(bits[w]) & 0xFFFFFFFF
        if B - b0 < 32:
            word &= (1 << (B - b0)) - 1
        for lane in range(32):
            gq, q = divmod(lane, lanes)
            for it in range(32 // groups):
                r = gq + groups * it
                b = b0 + r
                if not (word >> r) & 1:
                    continue
                p, rlen, e = int(pd[b]), int(rl[b]), int(mmp[b, q])
                ori = p < g
                if q == 0:
                    gs = min(max(p if ori else two - p - rlen, 0), g - 1)
                    end = min(gs + rlen, g)
                    first = not pair_end or b % 2 == 0
                    row = (0 if ori else 3) if first else (1 if ori else 2)
                    add("exact_diff", 0, gs, 1)
                    add("exact_diff", 0, end, -1)
                    add("f_diff", row, gs, 1)
                    add("f_diff", row, end, -1)
                if e >= 0:
                    at = p + (e >> 2)
                    pp = min(max(at if ori else two - 1 - at, 0), g - 1)
                    base = (e & 3) if ori else 3 - (e & 3)
                    add("exact_diff", 0, pp, -1)
                    add("exact_diff", 0, pp + 1, 1)
                    add("acgt", base, pp, 1)
    return planes


@pytest.mark.parametrize("g,off", [(L, 2400), (SHIFT, SHIFT - 1200),
                                   (SHIFT, (1 << 31) + 800)])
def test_apply_slice_mirror(g, off):
    """The apply slice kernel's warps and lanes equal apply_slice_plain on
    one shard's slice of 1,200 positions; the genome past 2^31 (pd, the
    clipped ends and the mismatch positions in 64 bits), the slice at its
    end (reads clipped at L - 1 and L) and in its middle, with reads
    straddling both its edges in both orientations."""
    rng = np.random.default_rng(g % 97 + off % 89)
    Pl, B, two = 1200, 200, 2 * g
    rl = rng.integers(40, 121, B).astype(np.int32)
    gs = rng.integers(off - 150, off + Pl + 30, B)
    gs = np.clip(gs, 0, g - 1)
    fwd = rng.random(B) < 0.5
    pd = np.where(fwd, gs, two - gs - rl).astype(np.int64)
    pd[:4] = [off - 30, two - off - 30, g - 5, two - 3]
    pd[4] = I64_MAX
    mmp = np.full((B, 4), -1, np.int32)
    for b in range(B):
        k = int(rng.integers(0, 5))
        r = np.sort(rng.choice(int(rl[b]), size=k, replace=False))
        mmp[b, :k] = (r << 2) | rng.integers(0, 4, size=k)
    bits = rng.integers(-(1 << 31), 1 << 31, (B + 31) // 32).astype(np.int32)
    bits[0] |= 0xF
    bits[0] &= ~np.int32(1 << 4)
    for pe in (True, False):
        want = ShardPlanes.zeros(Pl, off, "cpu")
        mk.apply_slice_plain(want, off, torch.from_numpy(pd),
                             torch.from_numpy(mmp), torch.from_numpy(rl),
                             torch.from_numpy(bits), g, pe)
        got = mirror_apply_slice(
            {k: np.zeros_like(getattr(want, k).numpy(), dtype=np.int64)
             for k in ("exact_diff", "f_diff", "acgt")},
            off, pd, mmp, rl, bits, g, pe)
        for k, v in got.items():
            np.testing.assert_array_equal(v, getattr(want, k).numpy())
        assert np.abs(got["exact_diff"]).sum() > 100
        assert got["f_diff"].any() and got["acgt"].any()


MERGE_BLOCK = 256      # csrc/chain.cu MERGE_THREADS


def _merge_layout(shards):
    """The (off, rows, lstrides) of each numpy shard, as host_merge gives
    them to merge_segments."""
    return [(off, [pl[k].shape[0] if pl[k].ndim == 2 else 1 for k in PLANES],
             [pl[k].shape[-1] for k in PLANES]) for pl, off in shards]


def _last_at_or_before(keys, x):
    """The kernel's merge_find: the last of the sorted keys at or before
    x, 0 if none."""
    lo, hi = 0, len(keys) - 1
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if keys[mid] <= x:
            lo = mid
        else:
            hi = mid - 1
    return lo


def mirror_host_merge(shards, deltas, ends, gstrides, block=MERGE_BLOCK,
                      cap=mk.MERGE_MAX_SEGS):
    """host_merge_kernel as its blocks and threads run over the shards of
    one call [(planes, numpy int64, off)]: the segments, launches (of at
    most `cap` segments) and runs as the wrapper builds them
    (mk.merge_segments, mk.merge_launches, a plane's base address plane
    id << 40, so an address names its plane and word); in each launch a
    thread's run (run 0 from the parameters, else a search over the runs'
    first units), its unit's 8 entries read from the padded lists; the
    block's first segment by a binary search over the segment starts for
    its first thread's first entry; each thread's walk from it, entry by
    entry, each added at base + 4 (x - sub) when it lies in its run and
    segment. -> the entries added."""
    N = ends[-1]
    Np = mk._padded(N)
    idx, _ = mk.unpack_deltas(deltas, N)
    pidx, pval = deltas[:Np], deltas[Np:Np + Np // 2].view(np.int32)
    layout = _merge_layout(shards)
    segs = mk.merge_segments(idx, ends, gstrides, layout)
    flat, bases = [], []
    for (pl, _), (_, rows, _) in zip(shards, layout):
        for k, r in zip(PLANES, rows):
            bases += [len(flat) << 40] * r
            flat.append(pl[k].reshape(-1))
    added = 0
    for seg, runs, W in mk.merge_launches(segs, np.array(bases, np.int64),
                                          cap):
        assert 1 <= len(seg) <= cap and W > 0
        added += _mirror_launch(flat, pidx, pval, seg, runs, W, block)
    return added


def _mirror_launch(flat, pidx, pval, seg, runs, W, block):
    """One launch of mirror_host_merge -> the entries it added."""
    added = 0
    for b in range(-(-W // block)):
        first = None
        for t in range(block):
            w = b * block + t
            if w >= W:
                break
            r = runs[0] if len(runs) == 1 else runs[_last_at_or_before(
                runs[:, 0], w)]
            _, ubase, ra, rb = (int(q) for q in r)
            g = (w + ubase) * mk.MERGE_ITEMS
            if first is None:      # thread 0: the block's first segment
                first = _last_at_or_before(seg[:, 0], max(g, ra))
            s = first
            for e in range(g, g + mk.MERGE_ITEMS):
                while s + 1 < len(seg) and seg[s + 1, 0] <= e:
                    s += 1
                g0, g1, sub, base = (int(q) for q in seg[s])
                if ra <= e < rb and g0 <= e < g1:
                    addr = base + 4 * (int(pidx[e]) - sub)
                    flat[addr >> 40][(addr & ((1 << 40) - 1)) // 4] += \
                        int(pval[e])
                    added += 1
    return added


def _plain_merge(shards, deltas, ends, gstrides):
    """host_merge_plain on torch copies of numpy shards -> numpy."""
    N = ends[-1]
    idx, val = mk.unpack_deltas(torch.from_numpy(deltas), N)
    ts = [(types.SimpleNamespace(**{k: torch.from_numpy(pl[k].astype(
        np.int32)) for k in PLANES}), off) for pl, off in shards]
    mk.host_merge_plain(ts, idx, val, ends, gstrides)
    return [{k: getattr(t, k).numpy().astype(np.int64) for k in PLANES}
            for t, _ in ts]


def test_merge_constants_match_source():
    """The merge's unit, segment cap, block and record width that the
    wrapper and the mirror copy by hand equal csrc/chain.cu's."""
    path = os.path.join(os.path.dirname(mk.__file__), os.pardir, "csrc",
                        "chain.cu")
    with open(path) as f:
        src = f.read()
    c = {k: int(v) for k, v in re.findall(
        r"^constexpr int (MERGE_\w+) = (\d+);", src, re.M)}
    assert (c["MERGE_THREADS"], c["MERGE_ITEMS"], c["MERGE_MAX_SEGS"]) == (
        MERGE_BLOCK, mk.MERGE_ITEMS, mk.MERGE_MAX_SEGS)
    seg = re.search(r"struct MergeSeg \{\s*long long ([^;]+);", src)
    assert len(seg.group(1).split(",")) == mk.SEG_WORDS


@pytest.mark.parametrize("g,off", [(L, 0), (L, 4800), (SHIFT, SHIFT - 1600),
                                   (SHIFT, (1 << 31) + 400)])
def test_host_merge_mirror(g, off):
    """The host-merge kernel's blocks and threads equal host_merge_plain
    on a slice of 1,600 positions (off 0 with rows of L + 1 / L + 2: the
    single-card planes' form), with the four lists' indices at the
    single-card strides of a genome past 2^31, strictly increasing as the
    host profile's nonzero scans give them, some outside the slice, some
    at its edges, empty lists too; every entry the slice holds added
    once."""
    rng = np.random.default_rng(off % 101)
    single = off == 0
    ls = [g + 1, g + 2, g + 2, g + 2] if single else [1600] * 4
    gstr = (g + 1, g + 2, g + 2, g + 2)
    lists = []
    held = 0
    for k, (rows, n) in enumerate(zip((4, 1, 4, 1), (300, 0, 250, 80))):
        pos = rng.integers(max(off - 100, 0), min(off + ls[k] + 100,
                                                  gstr[k]), n)
        pos[:2] = [off, off + ls[k] - 1][:n] if n else pos[:0]
        r = rng.integers(0, rows, n)
        x, first = np.unique((r * gstr[k] + pos).astype(np.int64),
                             return_index=True)
        lists.append((x, rng.integers(-3, 4, n).astype(np.int32)[first]))
        p = x % gstr[k]
        held += int(((p >= off) & (p < off + ls[k])).sum())
    buf = mk.pack_deltas(lists)
    ends = np.cumsum([i.size for i, _ in lists]).tolist()
    shapes = [(4, ls[0]), (ls[1],), (4, ls[2]), (ls[3],)]
    zero = {k: np.zeros(s, np.int64) for k, s in zip(PLANES, shapes)}
    want = _plain_merge([(zero, off)], buf, ends, gstr)[0]
    got = {k: v.copy() for k, v in zero.items()}
    assert mirror_host_merge([(got, off)], buf, ends, gstr) == held
    for k in PLANES:
        np.testing.assert_array_equal(got[k], want[k])
    assert np.abs(got["acgt"]).sum() > 50


def _merge_case(case, n, seed, g=L):
    """A host profile's deltas (device_profile.host_delta_lists) over a
    genome of g and the shards of one call: n B4 shards of Pl
    positions, or ("a5") the single-card planes at off 0. Entries at
    every shard's first and last positions in every row; "empty": the
    first (acgt) and exact lists and R2's row empty; "tiny": three
    entries in all; "half": every other shard, as one device of two holds
    them (runs with gaps between them)."""
    rng = np.random.default_rng(seed)
    p = Profile(g)
    p.alloc_diffs()
    names = ("acgt", "exact_diff", "F1_diff", "R2_diff", "F2_diff",
             "R1_diff", "multi_diff")
    for name in names:
        a = getattr(p, name)
        a[...] = rng.integers(-3, 4, a.shape) * (rng.random(a.shape) < 0.04)
    Pl = _pl(n, g) if case != "a5" else g + 2
    for s in range(n):
        for e in (s * Pl - 1, s * Pl, s * Pl + Pl - 1):
            for name in names:
                a = getattr(p, name)
                if 0 <= e < a.shape[-1]:
                    a[..., e] = 2
    if case == "empty":
        p.acgt[:] = 0
        p.exact_diff[:] = 0
        p.R2_diff[:] = 0
    if case == "tiny":
        for name in names:
            getattr(p, name)[...] = 0
        p.acgt[1, 5] = p.F2_diff[g] = p.multi_diff[0] = 1
    deltas, ends = tdp.host_delta_lists(p, g)
    if case == "a5":
        shapes = [(4, g + 1), (g + 2,), (4, g + 2), (g + 2,)]
        shards = [({k: np.asarray(rng.integers(-9, 9, s), np.int64)
                    for k, s in zip(PLANES, shapes)}, 0)]
    else:
        shards = [({k: np.asarray(rng.integers(-9, 9, (4, Pl) if k in (
            "acgt", "f_diff") else (Pl,)), np.int64) for k in PLANES},
            s * Pl) for s in range(n)]
    if case == "half":          # one device's shards of two: 0, 2, ...
        shards = shards[::2]
    return deltas, ends, shards


@pytest.mark.parametrize("case,n", [("a5", 1), ("b4", 1), ("b4", 2),
                                    ("b4", 4), ("b4", 8), ("empty", 4),
                                    ("tiny", 2), ("half", 4)])
def test_host_merge_segments_mirror(case, n):
    """The merge's segment split (one np.searchsorted a list over every
    (shard, row) boundary) and the kernel's blocks, walks and units of 8
    entries, applied entry by entry over one launch's n shards, equal
    host_merge_plain over the same shards and the wrapper on the CPU, in
    every word: A5's single-card planes, B4's shards at n = 1, 2, 4 and 8
    with entries on every shard boundary, empty lists (the first one too)
    and an empty row, fewer entries than a unit, one device's half of
    the shards; every entry a launch's shards hold is added once, by the
    shard that holds it."""
    deltas, ends, shards = _merge_case(case, n, 40 + n)
    gstr = tdp.merge_strides(L)
    want = _plain_merge(shards, deltas, ends, gstr)
    segs = mk.merge_segments(mk.unpack_deltas(deltas, ends[-1])[0], ends,
                             gstr, _merge_layout(shards))
    owned = int((segs[:, 1] - segs[:, 0]).sum())
    assert segs.shape == (10 * len(shards), 4)
    assert (owned == ends[-1]) == (case != "half") and owned > 0
    got = [({k: v.copy() for k, v in pl.items()}, off) for pl, off in shards]
    assert mirror_host_merge(got, deltas, ends, gstr) == owned
    # blocks of 16 units: many blocks start inside a segment
    small = [({k: v.copy() for k, v in pl.items()}, off)
             for pl, off in shards]
    assert mirror_host_merge(small, deltas, ends, gstr, block=16) == owned
    ts = [(types.SimpleNamespace(**{k: torch.from_numpy(pl[k].astype(
        np.int32)) for k in PLANES}), off) for pl, off in shards]
    mk.host_merge(ts, torch.from_numpy(deltas), ends, gstr)
    for (g, _), (sm, _), w, (t, _) in zip(got, small, want, ts):
        for k in PLANES:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            np.testing.assert_array_equal(sm[k], w[k], err_msg=k)
            np.testing.assert_array_equal(getattr(t, k).numpy(), w[k])
    if case == "empty":
        assert ends[1] == ends[0] == 0 and (segs[:, 1] == segs[:, 0]).any()


@pytest.mark.parametrize("n,g,cap", [(60, 60 * 400 - 450, None),
                                     (4, L, 7), (8, L, 1)])
def test_host_merge_many_launches(n, g, cap):
    """Past MERGE_MAX_SEGS nonempty segments (60 shards of 400 positions
    on one device, 590 of them) the merge is more than one launch, each of
    at most MERGE_MAX_SEGS segments with its own runs, and every launch's
    blocks and threads together (the mirror) equal host_merge_plain in
    every word, every entry added once; so with launches of 7 segments
    and of one (the cap only cuts the work)."""
    deltas, ends, shards = _merge_case("b4", n, 60 + n, g)
    gstr = tdp.merge_strides(g)
    cap = cap or mk.MERGE_MAX_SEGS
    want = _plain_merge(shards, deltas, ends, gstr)
    segs = mk.merge_segments(mk.unpack_deltas(deltas, ends[-1])[0], ends,
                             gstr, _merge_layout(shards))
    nonempty = int((segs[:, 1] > segs[:, 0]).sum())
    launches = mk.merge_launches(segs, np.arange(len(segs)) << 40, cap)
    assert nonempty > cap and len(launches) == -(-nonempty // cap)
    assert sum(len(t[0]) for t in launches) == nonempty
    got = [({k: v.copy() for k, v in pl.items()}, off) for pl, off in shards]
    assert mirror_host_merge(got, deltas, ends, gstr, cap=cap) == ends[-1]
    for (gp, _), w in zip(got, want):
        for k in PLANES:
            np.testing.assert_array_equal(gp[k], w[k], err_msg=k)


def _fetch_shards(rng, n, Pl=1200):
    """n finalized shards of Pl positions (numpy): acgt, F, multi, cov,
    the inclusive coverage prefix; their block depths."""
    shards, bds = [], []
    for _ in range(n):
        acgt, F = (rng.integers(0, 4096, (4, Pl)).astype(np.int32)
                   for _ in range(2))
        multi, cov = (rng.integers(0, 4096, Pl).astype(np.int32)
                      for _ in range(2))
        shards.append((acgt, F, multi, cov, np.cumsum(cov.astype(np.int64))))
        bds.append(rng.integers(0, 99, Pl // 100).astype(np.int32))
    return shards, bds


def _t(shards):
    return [tuple(torch.from_numpy(a) for a in sh) for sh in shards]


@pytest.mark.parametrize("base", [0, 7_777_777_777_777])
def test_fetch_slice_mirror(base):
    """The fetch slice kernel's tiles equal caller_fetch_slice_plain on
    one shard's finalized slice at off 0: positions at 0, at Pl - 1 and
    clamped, points at 0, 1 and Pl, block depths; a coverage prefix past
    2^31 before the shard; more positions than a tile."""
    rng = np.random.default_rng(5)
    Pl = 1200
    shards, bds = _fetch_shards(rng, 1, Pl)
    ccov = shards[0][4]
    idx = np.concatenate([[0, Pl - 1, Pl + 5, -1], rng.integers(0, Pl, 150),
                          [0, 1, Pl, Pl + 3], rng.integers(0, Pl + 1, 10),
                          [0, Pl // 100 - 1, 3]]).astype(np.int64)
    P, Q = 154, 14
    want = cal.caller_fetch_slice_plain(_t(shards), [0], [base],
                                        torch.from_numpy(idx), P, Q, Pl,
                                        [torch.from_numpy(bds[0])])
    got = fetch_mirror(shards, [0], [base], idx, P, Q, Pl, bds)
    np.testing.assert_array_equal(got, want.numpy())
    assert got[10 * P] == base and got[10 * P + 2] == base + ccov[-1]


def _per_shard_fetch(shards, bds, before, p, q, b, Pl, L):
    """The fetch as the parent ran it: each shard answers its own
    elements (p // Pl, q // Pl, b // (Pl / 100)) through a one-shard
    caller_fetch_slice_plain at local coordinates (positions clamped
    to [0, Pl), points to [0, Pl]) -> (cols, pref, depths)."""
    p, q = np.clip(p, 0, L - 1), np.clip(q, 0, L)
    cols = np.zeros((p.size, 10), np.int64)
    pref = np.zeros(q.size, np.int64)
    depths = np.zeros(b.size, np.int64)
    for s, sh in enumerate(_t(shards)):
        sp, sq = np.nonzero(p // Pl == s)[0], np.nonzero(q // Pl == s)[0]
        sb = np.nonzero(b // (Pl // 100) == s)[0]
        loc = np.concatenate([p[sp] - s * Pl, q[sq] - s * Pl,
                              b[sb] - s * (Pl // 100)]).astype(np.int64)
        o = cal.caller_fetch_slice_plain(
            [sh], [0], [before[s]], torch.from_numpy(loc), sp.size, sq.size,
            Pl, [torch.from_numpy(bds[s])]).numpy()
        cols[sp] = o[:10 * sp.size].reshape(-1, 10)
        pref[sq] = o[10 * sp.size:10 * sp.size + sq.size]
        depths[sb] = o[10 * sp.size + sq.size:]
    return cols, pref, depths


@pytest.mark.parametrize("n", [2, 3, 4])
def test_fetch_slice_search_mirror(n):
    """The one-launch fetch over n shards (its tiles, warps and shard
    search, elements in shuffled order, global positions and blocks)
    equals each shard answering its own elements through the per-shard
    caller_fetch_slice_plain, and so do the multi-shard plain version
    and the wrapper on the CPU: positions at 0, Pl - 1, Pl, each seam,
    L - 1 and clamped below 0 and past L; points at 0, each seam, L and
    clamped; blocks of every shard."""
    rng = np.random.default_rng(70 + n)
    Pl = 1200
    L = n * Pl - 150
    shards, bds = _fetch_shards(rng, n, Pl)
    before = np.concatenate([[0], np.cumsum([int(sh[4][-1]) for sh in
                                             shards])])[:n] + 10 ** 12
    seams = [s * Pl + d for s in range(1, n) for d in (-1, 0, 1)]
    p = rng.permutation(np.concatenate([
        [0, Pl - 1, Pl, L - 1, -4, L + 9], seams,
        rng.integers(0, L, 300)])).astype(np.int64)
    q = rng.permutation(np.concatenate([
        [0, L, L + 3, -1], seams, rng.integers(0, L + 1, 60)])).astype(
            np.int64)
    b = rng.permutation(np.concatenate([
        [0, L // 100, Pl // 100 - 1, Pl // 100],
        rng.integers(0, n * Pl // 100, 40)])).astype(np.int64)
    want = _per_shard_fetch(shards, bds, before, p, q, b, Pl, L)
    idx = np.concatenate([p, q, b])
    offs = [s * Pl for s in range(n)]
    P, Q = p.size, q.size
    got = fetch_mirror(shards, offs, before, idx, P, Q, L, bds)
    tb = [torch.from_numpy(x) for x in bds]
    for out in (got, cal.caller_fetch_slice_plain(
            _t(shards), offs, before, torch.from_numpy(idx), P, Q, L,
            tb).numpy(),
                cal.caller_fetch_slice(_t(shards), offs, before,
                                       torch.from_numpy(idx), P, Q, L,
                                       tb).numpy()):
        np.testing.assert_array_equal(out[:10 * P].reshape(P, 10), want[0])
        np.testing.assert_array_equal(out[10 * P:10 * P + Q], want[1])
        np.testing.assert_array_equal(out[10 * P + Q:], want[2])
    assert want[1][list(q).index(L)] == before[-1] + int(shards[-1][4][
        L - (n - 1) * Pl - 1])


def test_two_devices_one_call_each(monkeypatch):
    """B4 with its shards on two devices (the CPU as two devices: shards
    0 and 2 on one, 1 and 3 on the other): fetch_columns and the block
    depths make one caller_fetch_slice a device over its own elements
    and _merge_lists one host_merge a device, each over its own shards;
    every word equals the one-device run's."""
    n = 4
    ev, _, _, rng = _finalized(n, 88)
    Pl = ev.Pl
    pos = rng.permutation(np.concatenate([[0, L - 1, Pl, 2 * Pl - 1],
                                          rng.integers(0, L, 50)]))
    pref = rng.permutation(np.concatenate([[0, L, 3 * Pl],
                                           rng.integers(0, L + 1, 20)]))
    blocks = rng.integers(0, L // 100, 30).astype(np.int64)
    bds = ev.scan()[0]._parts
    want = ev._fetch(pos, pref, blocks, bds)
    one = ev.devs
    ev.devs = [torch.device("cpu"), torch.device("cpu", 0)] * 2
    calls = _spy(monkeypatch, ["caller_fetch_slice"], cal)
    got = ev._fetch(pos, pref, blocks, bds)
    assert len(calls) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    (_, tprof), rng = _host_profiles(9)
    lists = tdp.host_delta_lists(tprof, L)
    planes = _random_planes(rng, n)
    a, b = _port_ev(n, planes=planes), _port_ev(n, planes=planes)
    b.devs = ev.devs
    a._merge_lists(*lists)
    calls = _spy(monkeypatch, ["host_merge"], mk)
    b._merge_lists(*lists)
    assert len(calls) == 2 and one == [torch.device("cpu")] * n
    for k in PLANES:
        np.testing.assert_array_equal(_joined(a)[k], _joined(b)[k])


def test_fetch_many_shards_one_device(monkeypatch):
    """17 shards on one device, more than a fetch launch's table holds
    (FETCH_MAX_SHARDS = 16): _fetch makes one caller_fetch_slice of the
    first 16 shards and one of the last, each over its own elements, and
    every word equals one call over all 17 (the table's cap raised) and
    each shard answering its own elements: shuffled positions at 0, each
    seam, L - 1; points at 0, each seam and L; blocks of every shard."""
    n = 17
    g = n * 400 - 52              # Pl 400: shard 16 holds L - 1
    ev, (outs, tots), rng = _port_finalized(n, 17, g)
    Pl = ev.Pl
    assert Pl == 400 and cal.FETCH_MAX_SHARDS == 16
    seams = [s * Pl + d for s in range(1, n) for d in (-1, 0)]
    pos = rng.permutation(np.concatenate([[0, g - 1], seams,
                                          rng.integers(0, g, 200)]))
    pref = rng.permutation(np.concatenate([[0, g], seams,
                                           rng.integers(0, g + 1, 50)]))
    blocks = rng.permutation(np.concatenate([
        np.arange(0, g // 100, 4), [g // 100 - 1]])).astype(np.int64)
    bds = ev.scan()[0]._parts
    shards = []
    calls = []
    real = cal.caller_fetch_slice

    def rec(sh, *a, **kw):
        calls.append(len(sh))
        return real(sh, *a, **kw)
    monkeypatch.setattr(cal, "caller_fetch_slice", rec)
    got = ev._fetch(pos, pref, blocks, bds)
    assert calls == [16, 1]
    monkeypatch.setattr(cal, "FETCH_MAX_SHARDS", n)
    calls.clear()
    want = ev._fetch(pos, pref, blocks, bds)
    assert calls == [n]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for acgt, F, multi, cov, ccov in outs:
        shards.append(tuple(t.numpy() for t in (acgt, F, multi, cov, ccov)))
    before = np.concatenate([[0], np.cumsum(tots)])[:n]
    each = _per_shard_fetch(shards, [b.numpy() for b in bds], before, pos,
                            pref, blocks, Pl, g)
    for a, b in zip(got, each):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("off", [0, (1 << 31) + 1600, SHIFT - 2000])
@pytest.mark.parametrize("geometry", [NOR_GEOMETRY, (128, 4, 8)])
def test_nor_slice_mirror(off, geometry):
    """The NOR slice kernel's tiles (test_torch_calling_kernels.nor_mirror
    with off and valid: its geometry, then small tiles whose breaks
    overflow the stage; tiles in any order) equal nor_blocks_slice_plain
    on a shard of 5,000 positions, 4,700 of them valid, at offsets past
    2^31: keys from global breaks before, inside and after the shard, the
    shard's own excluded positions at its edges, empty segments."""
    rng = np.random.default_rng(off % 113)
    Pl, valid = 5000, 4700
    cov = rng.integers(0, 30, Pl).astype(np.int32)
    cov[rng.random(Pl) < 0.2] = 0
    cov[1000:1100] = 0
    em = np.concatenate([[off, off + valid - 1],
                         off + rng.integers(0, valid, 80)]).astype(np.int64)
    brk = np.concatenate([[max(off - 7, 0), off + 1020, off + 1050,
                           off + valid + 3],
                          off + rng.integers(-500, valid + 500, 120),
                          off + np.arange(3000, 3400, 2)]).astype(np.int64)
    brk = np.sort(np.clip(brk, 0, None))
    nseg = brk.size + 2
    t = torch.from_numpy
    want = cal.nor_blocks_slice_plain(t(cov), valid, t(np.sort(em)), t(brk),
                                      nseg, off).numpy()
    got = nor_mirror(cov, em, brk, nseg, *geometry, off=off, valid=valid,
                     rng=rng)
    np.testing.assert_array_equal(got, want)
    first = want[:nseg]
    assert (first == I32_MAX).sum() >= 2 and (first < valid).sum() > 40


@pytest.mark.parametrize("case", ["no_breaks_no_excluded", "edge_positions",
                                  "duplicate_breaks", "nseg_below_keys"])
def test_nor_slice_mirror_edges(case):
    """The slice form at SHIFT (a shard past 2^31, 3,000 valid of 3,200
    positions): K = 0 and E = 0, breaks and excluded positions at the
    shard's first and last valid positions and just outside them,
    duplicate breaks, fewer segments than keys; each against
    nor_blocks_slice_plain, at the kernel's geometry and at small
    tiles."""
    rng = np.random.default_rng(17)
    off, Pl, valid = SHIFT, 3200, 3000
    cov = rng.integers(0, 20, Pl).astype(np.int32)
    cov[rng.random(Pl) < 0.15] = 0
    em = np.concatenate([[off, off + 1, off + valid - 1],
                         off + rng.integers(0, valid, 30)])
    nseg = None
    if case == "no_breaks_no_excluded":
        em = brk = np.zeros(0, np.int64)
    elif case == "edge_positions":
        brk = off + np.array([-1, 0, 1, 700, valid - 2, valid - 1, valid])
    elif case == "duplicate_breaks":
        brk = off + np.array([-5, -5, 40, 40, 40, 41, 2000, 2000])
    else:
        brk = np.sort(off + rng.integers(-100, valid + 100, 90))
        nseg = 25
    em, brk = np.sort(em).astype(np.int64), np.sort(brk).astype(np.int64)
    nseg = nseg or brk.size + 2
    t = torch.from_numpy
    want = cal.nor_blocks_slice_plain(t(cov), valid, t(em), t(brk), nseg,
                                      off).numpy()
    for geometry in (NOR_GEOMETRY, (128, 4, 8)):
        got = nor_mirror(cov, em, brk, nseg, *geometry, off=off,
                         valid=valid, rng=rng)
        np.testing.assert_array_equal(got, want)
    if case == "duplicate_breaks":
        assert (want[:nseg] == I32_MAX).sum() >= 4


def test_nor_slice_mirror_shards_share_scratch():
    """B4's shards launch one after another on one device's stream and
    share its scratch, an epoch each: the per-shard mirrors on one words
    array (at the kernel's tiles, then at small tiles that span several a
    shard), combined as BigDeviceEvidence.nor_blocks combines them, equal
    the single-card NOR of the joined coverage, here placed past 2^31
    (every position, break and exclusion shifted by SHIFT)."""
    rng = np.random.default_rng(19)
    n, Pl = 3, 2048
    g = 5500
    cov = rng.integers(0, 25, n * Pl).astype(np.int32)
    cov[rng.random(n * Pl) < 0.2] = 0
    cov[2000:2900] = 0
    em = np.sort(rng.integers(0, g, 70)).astype(np.int64)
    brk = np.sort(rng.integers(0, g, 60)).astype(np.int64)
    brk = brk[(brk < 1900) | (brk > 3000)]
    nseg = brk.size + 2
    one = cal.nor_blocks_plain(torch.from_numpy(cov[:g]),
                               torch.from_numpy(em), torch.from_numpy(brk),
                               nseg).numpy()
    words = np.zeros(3 * nseg, np.int64)
    epoch = 0
    for geometry in (NOR_GEOMETRY, (128, 4, 8)):
        first = np.full(nseg, I32_MAX, np.int64)
        mincov = np.full(nseg, I32_MAX, np.int64)
        covf = np.zeros(nseg, np.int64)
        found = np.zeros(nseg, bool)
        for s in range(n):
            off = s * Pl
            valid = min(g - off, Pl)
            mine = em[(em >= off) & (em < off + valid)]
            epoch += 1
            r = nor_mirror(cov[off:off + Pl], SHIFT + mine, SHIFT + brk,
                           nseg, *geometry, off=SHIFT + off, valid=valid,
                           words=words, epoch=epoch, rng=rng)
            f, m, c = r[:nseg], r[nseg:2 * nseg], r[2 * nseg:]
            take = ~found & (f != I32_MAX)
            first[take] = off + f[take]
            covf[take] = c[take]
            found |= take
            mincov = np.minimum(mincov, m)
            if s == (g - 1) // Pl:
                covf[~found] = c[~found]
        np.testing.assert_array_equal(
            np.concatenate([first, mincov, covf]), one)


# ---- refusals ----------------------------------------------------------------

def _apply_args(B=64, Pl=800):
    return dict(planes=ShardPlanes.zeros(Pl, 0, "cpu"), off=0,
                pd=torch.zeros(B, dtype=torch.int64),
                mmp=torch.full((B, 4), -1, dtype=torch.int32),
                rlens=torch.full((B,), 50, dtype=torch.int32),
                bits=torch.zeros(2, dtype=torch.int32), L=700,
                pair_end=True)


def _card(monkeypatch):
    """Every tensor counts as a card tensor and no launch happens: the
    card-side checks run up to the launch, which records its name."""
    launched = []
    monkeypatch.setattr(mk, "_on_card", lambda name, ts: True)
    monkeypatch.setattr(cal, "_on_card", lambda name, ts: True)
    monkeypatch.setattr(chk, "_launch",
                        lambda name, *a, **kw: launched.append(name))
    monkeypatch.setattr(cal, "_launch",
                        lambda name, *a, **kw: launched.append(name))
    return launched


@pytest.mark.parametrize("bad,exc", [
    ("pd_int32", TypeError), ("mmp_shape", ValueError),
    ("bits_short", ValueError), ("plane_shape", ValueError),
    ("devices", ValueError), ("misaligned", ValueError), (None, None)])
def test_apply_slice_refuses(monkeypatch, bad, exc):
    """apply_slice refuses a wrong dtype or shape, a short admit word
    array, planes of another slice length, tensors on several devices and,
    on the card, mmp rows off 16 bytes, before any launch; a valid call on
    the card launches once."""
    a = _apply_args()
    launched = _card(monkeypatch)
    if bad == "pd_int32":
        a["pd"] = a["pd"].to(torch.int32)
    elif bad == "mmp_shape":
        a["mmp"] = a["mmp"][:, :3].contiguous()
    elif bad == "bits_short":
        a["bits"] = a["bits"][:1]
    elif bad == "plane_shape":
        a["planes"].acgt = torch.zeros(4, 801, dtype=torch.int32)
    elif bad == "devices":
        a["rlens"] = a["rlens"].to("meta")
    elif bad == "misaligned":
        buf = torch.full((64 * 4 + 1,), -1, dtype=torch.int32)
        a["mmp"] = buf[1:].view(64, 4)
    if exc is None:
        mk.apply_slice(**a)
        assert launched == ["evidence_apply_slice"]
        return
    with pytest.raises(exc):
        mk.apply_slice(**a)
    assert not launched


@pytest.mark.parametrize("bad,exc", [
    ("idx_int32", TypeError), ("val_len", ValueError), ("ends", ValueError),
    ("gstride", ValueError), ("devices", ValueError),
    ("unsorted", ValueError), ("duplicate", ValueError), (None, None)])
def test_host_merge_refuses(monkeypatch, bad, exc):
    """host_merge refuses a buffer of another dtype than pack_deltas',
    one short of the values, ends that do not end at N or go down, a row
    stride below 1, planes on several devices and a list that is not
    strictly increasing (out of order, or an index twice), before any
    launch; a valid call launches once."""
    planes = ShardPlanes.zeros(400, 0, "cpu")
    lists = [(np.arange(a, b, dtype=np.int64), np.ones(b - a, np.int32))
             for a, b in ((0, 3), (3, 5), (5, 8), (8, 10))]
    deltas = torch.from_numpy(mk.pack_deltas(lists))
    ends, gs = [3, 5, 8, 10], [401, 402, 402, 402]
    launched = _card(monkeypatch)
    if bad == "idx_int32":
        deltas = deltas.to(torch.int32)
    elif bad == "val_len":
        deltas = deltas[:-1]
    elif bad == "ends":
        ends = [3, 2, 8, 10]
    elif bad == "gstride":
        gs = [0, 402, 402, 402]
    elif bad == "devices":
        planes.multi_diff = planes.multi_diff.to("meta")
    elif bad in ("unsorted", "duplicate"):
        lists[2] = (np.array([5, 7 if bad == "unsorted" else 6, 6]),
                    lists[2][1])
        deltas = torch.from_numpy(mk.pack_deltas(lists))
    if exc is None:
        mk.host_merge([(planes, 0)], deltas, ends, gs)
        assert launched == ["host_merge"]
        return
    with pytest.raises(exc):
        mk.host_merge([(planes, 0)], deltas, ends, gs)
    assert not launched


def _fetch_args(Pl=400):
    z = torch.zeros

    def shard():
        return [z(4, Pl, dtype=torch.int32), z(4, Pl, dtype=torch.int32),
                z(Pl, dtype=torch.int32), z(Pl, dtype=torch.int32),
                z(Pl, dtype=torch.int64)]
    return [[shard(), shard()], [0, Pl], [5, 9],
            torch.arange(6, dtype=torch.int64), 2, 2, 2 * Pl - 7,
            [z(4, dtype=torch.int32), z(4, dtype=torch.int32)]]


@pytest.mark.parametrize("bad,exc", [
    ("ccov_int32", TypeError), ("F_shape", ValueError),
    ("ccov_lead", ValueError), ("blocks_without_depths", ValueError),
    ("devices", ValueError), ("overlap", ValueError),
    ("off_block", ValueError), ("shards", ValueError), (None, None)])
def test_fetch_slice_refuses(bad, exc, monkeypatch):
    """caller_fetch_slice refuses a wrong dtype, a plane of another
    length, a coverage prefix with its lead (the single-card form's
    [Pl + 1]), blocks without block depths, tensors on several devices,
    shards that overlap or start off a block, and (on the card) more
    shards than a launch's table holds, before any launch; a valid call
    launches once."""
    a = _fetch_args()
    if bad == "devices":
        a[3] = a[3].to("meta")
        with pytest.raises(exc):
            cal.caller_fetch_slice(*a)
        return
    launched = _card(monkeypatch)
    if bad == "ccov_int32":
        a[0][1][4] = a[0][1][4].to(torch.int32)
    elif bad == "F_shape":
        a[0][0][1] = a[0][0][1][:3]
    elif bad == "ccov_lead":
        a[0][1][4] = torch.zeros(401, dtype=torch.int64)
    elif bad == "blocks_without_depths":
        a[7] = None
    elif bad == "overlap":
        a[1] = [0, 300]
    elif bad == "off_block":
        a[1] = [0, 450]
    elif bad == "shards":
        n = cal.FETCH_MAX_SHARDS + 1
        a[0] = [a[0][0]] * n
        a[1] = [400 * s for s in range(n)]
        a[2] = [0] * n
        a[7] = [a[7][0]] * n
    if exc is None:
        cal.caller_fetch_slice(*a)
        assert launched == ["caller_fetch_slice"]
        return
    with pytest.raises(exc):
        cal.caller_fetch_slice(*a)
    assert not launched


@pytest.mark.parametrize("bad,exc", [
    ("cov_int64", TypeError), ("brk_int32", TypeError),
    ("valid", ValueError), ("valid_zero", ValueError),
    ("devices", ValueError), (None, None)])
def test_nor_slice_refuses(bad, exc, monkeypatch):
    """nor_blocks_slice refuses a wrong dtype, a valid length outside [1,
    Pl] and tensors on several devices, before any launch; a valid call
    launches once."""
    cov = torch.ones(400, dtype=torch.int32)
    em = torch.tensor([3, 9], dtype=torch.int64)
    brk = torch.tensor([5, 50], dtype=torch.int64)
    valid = 380
    if bad == "devices":
        with pytest.raises(exc):
            cal.nor_blocks_slice(cov, valid, em.to("meta"), brk, 4, 0)
        return
    launched = _card(monkeypatch)
    if bad == "cov_int64":
        cov = cov.to(torch.int64)
    elif bad == "brk_int32":
        brk = brk.to(torch.int32)
    elif bad == "valid":
        valid = 401
    elif bad == "valid_zero":
        valid = 0
    if exc is None:
        cal.nor_blocks_slice(cov, valid, em, brk, 4, 0)
        assert launched == ["nor_blocks_slice"]
        return
    with pytest.raises(exc):
        cal.nor_blocks_slice(cov, valid, em, brk, 4, 0)
    assert not launched
