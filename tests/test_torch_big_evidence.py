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
  * which wrapper each step reaches (one apply and one merge a shard);
  * a scalar mirror of each new kernel form's thread (csrc/chain.cu
    evidence_apply_slice_kernel and host_merge_kernel, csrc/calling.cu
    caller_fetch_slice_kernel) and the NOR tiling's mirror of
    nor_blocks_slice_kernel (shards sharing the scratch too) against its
    plain version, in coordinates shifted past 2^31;
  * the wrappers' refusals.

Inputs are made from numpy seeds; every comparison is exact integer
equality."""
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
from test_torch_calling_kernels import NOR_GEOMETRY, nor_mirror

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
    """_merge_host_deltas: the lists uploaded once a device, one
    host_merge a shard (its plain version here); the planes equal the
    reference's _merge_kernel's in every word and the host copies are
    zeroed."""
    (jprof, tprof), rng = _host_profiles(n)
    planes = _random_planes(rng, n)
    jev, ev = _jax_ev(n, planes=planes), _port_ev(n, planes=planes)
    jev.host_profile, ev.host_profile = jprof, tprof
    calls = _spy(monkeypatch, ["host_merge", "host_merge_plain"], mk)
    jev._merge_host_deltas()
    ev._merge_host_deltas()
    _assert_planes(ev, jev)
    assert calls == ["host_merge", "host_merge_plain"] * n
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

def _finalized(n, seed, g=L):
    """The port's and the reference's evidence holding the same
    finalized shards: the port's plain fold of random planes (held
    against the reference's fold in test_torch_calling_kernels.py), set as
    the reference's finalize outputs."""
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
    outs, tots = ev.finalize()
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
    """fetch_columns: a caller_fetch_slice a shard that owns any asked
    position (its plain version here); the columns and the global
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
    owners = {int(s) for s in np.clip(pos, 0, L - 1) // Pl} | {
        int(s) for s in np.clip(pref, 0, L) // Pl}
    assert len(calls) == len(owners) and got_pref[2] == int(cov[:L].sum())
    # block depths: the scan's, through the same launches and gather
    bd = ev.scan()[0]
    calls.clear()
    blocks = np.clip(pos, 0, L - 1) // 100
    cols2, _ = ev.fetch_columns(pos, pref, bd_blocks=blocks)
    np.testing.assert_array_equal(cols2, cols)
    assert len(calls) == len(owners)
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


def mirror_host_merge(planes, idx, val, ends, gstrides, off):
    """host_merge_kernel: a thread an entry, its list by its index
    against the ends, row = x // gstride, position x - row * gstride,
    added at row * ls + position - off when the slice holds it."""
    names = PLANES
    for i in range(idx.size):
        k = sum(i >= e for e in ends[:3])
        plane = planes[names[k]]
        ls = plane.shape[-1]
        x = int(idx[i])
        row = x // gstrides[k]
        li = x - row * gstrides[k] - off
        if 0 <= li < ls:
            plane.reshape(-1)[row * ls + li] += int(val[i])
    return planes


@pytest.mark.parametrize("g,off", [(L, 0), (L, 4800), (SHIFT, SHIFT - 1600),
                                   (SHIFT, (1 << 31) + 400)])
def test_host_merge_mirror(g, off):
    """The host-merge kernel's threads equal host_merge_plain on a slice
    of 1,600 positions (off 0 with rows of L + 1 / L + 2: the single-card
    planes' form), with the four lists' indices at the single-card
    strides of a genome past 2^31, some outside the slice, some at its
    edges, empty lists too."""
    rng = np.random.default_rng(off % 101)
    single = off == 0
    ls = [g + 1, g + 2, g + 2, g + 2] if single else [1600] * 4
    gstr = (g + 1, g + 2, g + 2, g + 2)
    lists = []
    for k, (rows, n) in enumerate(zip((4, 1, 4, 1), (300, 0, 250, 80))):
        pos = rng.integers(max(off - 100, 0), min(off + ls[k] + 100,
                                                  gstr[k]), n)
        pos[:2] = [off, off + ls[k] - 1][:n] if n else pos[:0]
        r = rng.integers(0, rows, n)
        lists.append(((r * gstr[k] + pos).astype(np.int64),
                      rng.integers(-3, 4, n).astype(np.int32)))
    buf = mk.pack_deltas(lists)
    ends = np.cumsum([i.size for i, _ in lists]).tolist()
    idx, val = mk.unpack_deltas(torch.from_numpy(buf), ends[-1])
    shapes = [(4, ls[0]), (ls[1],), (4, ls[2]), (ls[3],)]
    want = types.SimpleNamespace(**{k: torch.zeros(s, dtype=torch.int32)
                                    for k, s in zip(PLANES, shapes)})
    mk.host_merge_plain(want, idx, val, ends, gstr, off)
    got = mirror_host_merge({k: np.zeros(s, np.int64)
                             for k, s in zip(PLANES, shapes)},
                            idx.numpy(), val.numpy(), ends, gstr, off)
    for k in PLANES:
        np.testing.assert_array_equal(got[k], getattr(want, k).numpy())
    assert np.abs(got["acgt"]).sum() > 50


def mirror_fetch_slice(acgt, multi, F, cov, ccov, base, idx, P, Q, bd):
    """caller_fetch_slice_kernel: output word i a thread: a position's
    column (i / 10, i % 10), a point's base + ccov[q - 1] (base at 0),
    a block's depth."""
    Pl = cov.size
    out = np.zeros(10 * P + Q + idx.size - P - Q, np.int64)
    rows = [acgt[0], acgt[1], acgt[2], acgt[3], multi, F[0], F[1], F[2],
            F[3], cov]
    for i in range(out.size):
        if i < 10 * P:
            p = min(max(int(idx[i // 10]), 0), Pl - 1)
            out[i] = rows[i % 10][p]
        elif i < 10 * P + Q:
            q = min(max(int(idx[P + i - 10 * P]), 0), Pl)
            out[i] = base + (0 if q == 0 else int(ccov[q - 1]))
        else:
            out[i] = bd[int(idx[P + Q + i - 10 * P - Q])]
    return out


@pytest.mark.parametrize("base", [0, 7_777_777_777_777])
def test_fetch_slice_mirror(base):
    """The fetch slice kernel's threads equal caller_fetch_slice_plain on
    a shard's finalized slice: positions at 0, at Pl - 1 and clamped,
    points at 0, 1 and Pl, block depths; a coverage prefix past 2^31
    before the shard."""
    rng = np.random.default_rng(5)
    Pl = 1200
    acgt, F = (rng.integers(0, 4096, (4, Pl)).astype(np.int32)
               for _ in range(2))
    multi, cov = (rng.integers(0, 4096, Pl).astype(np.int32)
                  for _ in range(2))
    ccov = np.cumsum(cov.astype(np.int64))
    bd = rng.integers(0, 99, Pl // 100).astype(np.int32)
    idx = np.concatenate([[0, Pl - 1, Pl + 5, -1], rng.integers(0, Pl, 20),
                          [0, 1, Pl, Pl + 3], rng.integers(0, Pl + 1, 10),
                          [0, Pl // 100 - 1, 3]]).astype(np.int64)
    P, Q = 24, 14
    t = torch.from_numpy
    want = cal.caller_fetch_slice_plain(t(acgt), t(multi), t(F), t(cov),
                                        t(ccov), base, t(idx), P, Q, t(bd))
    got = mirror_fetch_slice(acgt, multi, F, cov, ccov, base, idx, P, Q, bd)
    np.testing.assert_array_equal(got, want.numpy())
    assert got[10 * P] == base and got[10 * P + 2] == base + ccov[-1]


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
    ("gstride", ValueError), ("devices", ValueError), (None, None)])
def test_host_merge_refuses(monkeypatch, bad, exc):
    """host_merge refuses a buffer of another dtype than pack_deltas',
    one short of the values, ends that do not end at N or go down, a row
    stride below 1 and tensors on several devices, before any launch; a
    valid call launches once."""
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
    if exc is None:
        mk.host_merge(planes, deltas, ends, gs)
        assert launched == ["host_merge"]
        return
    with pytest.raises(exc):
        mk.host_merge(planes, deltas, ends, gs)
    assert not launched


def _fetch_args(Pl=400):
    z = torch.zeros
    return [z(4, Pl, dtype=torch.int32), z(Pl, dtype=torch.int32),
            z(4, Pl, dtype=torch.int32), z(Pl, dtype=torch.int32),
            z(Pl, dtype=torch.int64), 5, torch.arange(6, dtype=torch.int64),
            2, 2, z(4, dtype=torch.int32)]


@pytest.mark.parametrize("bad,exc", [
    ("ccov_int32", TypeError), ("F_shape", ValueError),
    ("ccov_lead", ValueError), ("blocks_without_depths", ValueError),
    ("devices", ValueError), (None, None)])
def test_fetch_slice_refuses(bad, exc, monkeypatch):
    """caller_fetch_slice refuses a wrong dtype, a plane of another
    length, a coverage prefix with its lead (the single-card form's
    [Pl + 1]), blocks without block depths and tensors on several
    devices, before any launch; a valid call launches once."""
    a = _fetch_args()
    if bad == "devices":
        a[6] = a[6].to("meta")
        with pytest.raises(exc):
            cal.caller_fetch_slice(*a)
        return
    launched = _card(monkeypatch)
    if bad == "ccov_int32":
        a[4] = a[4].to(torch.int32)
    elif bad == "F_shape":
        a[2] = a[2][:3]
    elif bad == "ccov_lead":
        a[4] = torch.zeros(401, dtype=torch.int64)
    elif bad == "blocks_without_depths":
        a[9] = None
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
