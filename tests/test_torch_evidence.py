"""The port's evidence planes (mapcaller_tpu_torch/ops/evidence.py,
pipeline/device_profile.py) against the reference package's on the same
inputs, made from a numpy seed at a few kb: the scatter, the apply from
bits and from the chain kernel's output, the reject correction and the
dense undo, the host merge, the finalize fold with its 4095 saturation,
the reference codes from the text words, the download, and the memory
gate. All integer: the tolerance is exact equality."""
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mapcaller_tpu.index.fmindex import build_index
from mapcaller_tpu.index.packer import PackedReference
from mapcaller_tpu.ops.chain_device import ChainCtx as JaxChainCtx
from mapcaller_tpu.ops.evidence import scatter_fast_evidence as jax_scatter
from mapcaller_tpu.pipeline import device_profile as jdp
from mapcaller_tpu.pipeline.device_backend import DeviceBackend as JaxBackend
from mapcaller_tpu.pipeline.profile import Profile as JaxProfile
from mapcaller_tpu_torch.ops.chain_device import (CLASS_FAST, INT32_MAX,
                                                   MM_SLOTS, ChainCtx)
from mapcaller_tpu_torch.ops import mesh_kernels as mk
from mapcaller_tpu_torch.ops.evidence import scatter_fast_evidence
from mapcaller_tpu_torch.pipeline import device_profile as tdp
from mapcaller_tpu_torch.pipeline.device_backend import (ChainToken,
                                                         DeviceBackend)
from mapcaller_tpu_torch.pipeline.profile import Profile

torch.set_num_threads(1)   # small tensor ops: see test_torch_e2e.py

L, B = 3001, 128
TWO_L = 2 * L


def _chain_outputs(seed):
    """pd / mmp / rlens / meta of a batch as the chain kernel gives them:
    forward and reverse diagonals (some at the genome ends, so the
    clipping runs), INT32_MAX for reads without hits, up to MM_SLOTS
    mismatches per read (-1 empty), classes in the meta's low bits."""
    rng = np.random.default_rng(seed)
    rl = rng.integers(60, 121, size=B).astype(np.int32)
    fwd = rng.integers(0, L - 60, size=B)
    rev = L + rng.integers(0, L - 60, size=B)
    pd = np.where(rng.random(B) < 0.5, fwd, rev).astype(np.int32)
    pd[:4] = [L - 70, TWO_L - 130, 0, L]
    pd[rng.random(B) < 0.1] = INT32_MAX
    mmp = np.full((B, MM_SLOTS), -1, dtype=np.int32)
    for b in range(B):
        k = int(rng.integers(0, MM_SLOTS + 1))
        r = np.sort(rng.choice(int(rl[b]), size=k, replace=False))
        mmp[b, :k] = (r << 2) | rng.integers(0, 4, size=k)
    cls = rng.integers(0, 3, size=B).astype(np.int32)
    cls[pd == INT32_MAX] = 0
    meta = np.concatenate([cls | (rng.integers(0, 64, size=B) << 2)
                           .astype(np.int32),
                           rng.integers(-99, 99, size=40).astype(np.int32)])
    return pd, mmp, rl, meta, rng


def _random_planes(rng, lo=-50, hi=50):
    return dict(acgt=rng.integers(lo, hi, size=(4, L + 1)),
                exact_diff=rng.integers(lo, hi, size=L + 2),
                f_diff=rng.integers(lo, hi, size=(4, L + 2)),
                multi_diff=rng.integers(lo, hi, size=L + 2))


def _jax_planes(arrs):
    return jdp.DevicePlanes(L=L, **{k: jnp.asarray(v.astype(np.int32))
                                     for k, v in arrs.items()})


def _torch_planes(arrs):
    return tdp.DevicePlanes(L=L, **{k: torch.from_numpy(v.astype(np.int32))
                                     for k, v in arrs.items()})


def _assert_planes_equal(got, want):
    for name in ("acgt", "exact_diff", "f_diff", "multi_diff"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.mark.parametrize("sign", [1, -1])
@pytest.mark.parametrize("pair_end", [False, True])
def test_scatter_fast_evidence(sign, pair_end):
    pd, mmp, rl, _, rng = _chain_outputs(1)
    adm = rng.random(B) < 0.7
    adm &= pd != INT32_MAX
    b_first = ((np.arange(B) & 1) == 0) if pair_end else np.ones(B, bool)
    arrs = _random_planes(rng)
    want = jax_scatter(
        jnp.asarray(arrs["exact_diff"].astype(np.int32)),
        jnp.asarray(arrs["f_diff"].astype(np.int32).reshape(-1)),
        jnp.asarray(arrs["acgt"].astype(np.int32).reshape(-1)),
        jnp.asarray(adm), jnp.asarray(pd), jnp.asarray(mmp), jnp.asarray(rl),
        jnp.asarray(b_first), L, TWO_L, sign)
    tp = _torch_planes(arrs)
    got = scatter_fast_evidence(
        tp.exact_diff, tp.f_diff.view(-1), tp.acgt.view(-1),
        torch.from_numpy(adm), torch.from_numpy(pd), torch.from_numpy(mmp),
        torch.from_numpy(rl), torch.from_numpy(b_first), L, TWO_L, sign)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # in place, on the planes' own storage
    assert got[0].data_ptr() == tp.exact_diff.data_ptr()


@pytest.mark.parametrize("source", ["bits", "meta"])
def test_apply_kernel(source):
    pd, mmp, rl, meta, rng = _chain_outputs(2)
    if source == "bits":
        # admit bits in int32 words, bit 31 included
        sel = rng.integers(-(1 << 31), 1 << 31, size=B // 32,
                           dtype=np.int64).astype(np.int32)
        sel[0] |= np.int32(-(1 << 31))
    else:
        sel = meta
    arrs = _random_planes(rng)
    for pair_end in (False, True):
        want = jdp.build_apply_kernel(L, TWO_L, B, pair_end, source=source)(
            _jax_planes(arrs), jnp.asarray(pd), jnp.asarray(mmp),
            jnp.asarray(rl), jnp.asarray(sel))
        got = tdp.build_apply_kernel(L, TWO_L, B, pair_end, source=source)(
            _torch_planes(arrs), torch.from_numpy(pd), torch.from_numpy(mmp),
            torch.from_numpy(rl), torch.from_numpy(sel))
        _assert_planes_equal(got, want)


def _selection(source, rng, meta):
    """sel of a K2 call: admit bits in int32 words (bit 31 of the first and
    of the last word set: reads 31 and B - 1), or the chain kernel's
    packed output (its FAST reads admitted)."""
    if source == "meta":
        return meta
    sel = rng.integers(-(1 << 31), 1 << 31, size=B // 32,
                       dtype=np.int64).astype(np.int32)
    sel[[0, -1]] |= np.int32(-(1 << 31))
    return sel


@pytest.mark.parametrize("sign", [1, -1])
@pytest.mark.parametrize("source", ["bits", "meta"])
def test_k2_plain_matches_jax(source, sign):
    """K2's wrapper on the CPU (its plain version, ops/mesh_kernels.
    apply_bits) in both sources and both signs, on planes with evidence
    already in them, against the reference's build_apply_kernel(source,
    sign); no launch is counted."""
    pd, mmp, rl, meta, rng = _chain_outputs(5 + sign)
    sel = _selection(source, rng, meta)
    arrs = _random_planes(rng)
    for pair_end in (False, True):
        want = jdp.build_apply_kernel(L, TWO_L, B, pair_end, source=source,
                                      sign=sign)(
            _jax_planes(arrs), jnp.asarray(pd), jnp.asarray(mmp),
            jnp.asarray(rl), jnp.asarray(sel))
        got = mk.apply_bits(_torch_planes(arrs), torch.from_numpy(pd),
                            torch.from_numpy(mmp), torch.from_numpy(rl),
                            torch.from_numpy(sel), pair_end, sign, source)
        _assert_planes_equal(got, want)
    assert not mk.STATS.launches


@pytest.mark.parametrize("pair_end", [False, True])
def test_correct_kernel(pair_end):
    """The sparse retraction (build_correct_kernel: the rejects set as
    admit bits, bit 31 of a word among them, one K2 call with sign -1)
    against the reference's gather of the rejected lanes, padded with B."""
    pd, mmp, rl, meta, rng = _chain_outputs(8 + pair_end)
    rej = np.unique(np.concatenate([[31, B - 1], rng.choice(B, 20)]))
    R = 32
    pad = np.full(R, B, dtype=np.int32)
    pad[:rej.size] = rej
    arrs = _random_planes(rng)
    want = jdp.build_correct_kernel(L, TWO_L, B, pair_end, R)(
        _jax_planes(arrs), jnp.asarray(pd), jnp.asarray(mmp),
        jnp.asarray(rl), jnp.asarray(pad))
    got = tdp.build_correct_kernel(L, TWO_L, B, pair_end)(
        _torch_planes(arrs), torch.from_numpy(pd), torch.from_numpy(mmp),
        torch.from_numpy(rl), torch.from_numpy(rej.astype(np.int32)))
    _assert_planes_equal(got, want)


@pytest.mark.parametrize("call", ["apply", "undo", "correct"])
def test_evidence_calls_reach_k2(monkeypatch, call):
    """DeviceEvidence's three per-batch device steps each reach K2's
    wrapper (mesh_kernels.apply_bits, spied on as the module attribute
    that device_profile calls) exactly once, with the source and sign of
    the step and the batch's own pd, mmp and read lengths: the apply with
    the host's admit bits and +1, the dense undo with the speculative
    dispatch's packed output (source "meta") and -1, the sparse correction
    with the rejects' bits and -1. The planes still equal the
    reference's."""
    monkeypatch.setattr(jdp.DeviceEvidence, "CORRECT_CAP", 8)
    monkeypatch.setattr(tdp.DeviceEvidence, "CORRECT_CAP", 8)
    pd, mmp, rl, meta, rng = _chain_outputs(11)
    fast_ix = np.nonzero((meta[:B] & 3) == CLASS_FAST)[0]
    rej = rng.choice(fast_ix, size=5, replace=False)
    adm = np.zeros(B, bool)
    adm[fast_ix] = True
    adm[rej] = False
    fbits = np.zeros(B // 32, dtype=np.uint32)
    for i in np.nonzero(adm)[0]:
        fbits[i >> 5] |= np.uint32(1 << (i & 31))
    calls = []
    real = mk.apply_bits

    def spy(planes, pd_, mmp_, rl_, sel, pair_end, sign=1, source="bits"):
        calls.append((pd_, mmp_, rl_, sel.clone(), pair_end, sign, source))
        return real(planes, pd_, mmp_, rl_, sel, pair_end, sign, source)

    monkeypatch.setattr(mk, "apply_bits", spy)
    jev, tev = _evidence_pair()
    t_args = [torch.from_numpy(x) for x in (meta, pd, mmp, rl)]
    j_args = [jnp.asarray(x) for x in (meta, pd, mmp, rl)]
    ttok = ChainToken(None, t_args[0], None, None, t_args[3], 128, rl,
                      t_args[1], t_args[2], cls0=meta & 3,
                      spec=(t_args[0], t_args[1], t_args[2]))
    jtok = [None, j_args[0], None, None, 128, rl, j_args[1], j_args[2],
            j_args[3], (j_args[0], j_args[1], j_args[2])]
    if call == "apply":
        jev.apply_batch(jtok, fbits, True)
        tev.apply_batch(ttok, fbits, True)
        want_sel, want = fbits.view(np.int32), (1, "bits")
    elif call == "undo":
        jev.planes = jdp.build_apply_kernel(L, TWO_L, B, True, source="meta",
                                            sign=-1)(jev.planes, *j_args[1:],
                                                     j_args[0])
        tev._undo_speculation(ttok, True)
        want_sel, want = meta, (-1, "meta")
    else:
        jev.planes = jdp.build_apply_kernel(L, TWO_L, B, True, source="meta")(
            jev.planes, *j_args[1:], j_args[0])
        tev.planes = tdp.build_apply_kernel(L, TWO_L, B, True, source="meta")(
            tev.planes, *t_args[1:], t_args[0])
        calls.clear()
        jev.reconcile_batch(jtok, fbits, True)
        tev.reconcile_batch(ttok, fbits, True)
        want_sel = np.zeros(B // 32, dtype=np.uint32)
        for i in rej:
            want_sel[i >> 5] |= np.uint32(1 << (i & 31))
        want_sel, want = want_sel.view(np.int32), (-1, "bits")
    assert len(calls) == 1
    pd_, mmp_, rl_, sel, pair_end, sign, source = calls[0]
    assert (sign, source, pair_end) == (*want, True)
    assert pd_ is t_args[1] and mmp_ is t_args[2] and rl_ is t_args[3]
    np.testing.assert_array_equal(sel.numpy()[:want_sel.size], want_sel)
    _assert_planes_equal(tev.planes, jev.planes)


def _evidence_pair():
    """A reference DeviceEvidence and the port's on a stand-in backend
    (genome size and text length are all the per-batch steps read)."""
    idx = types.SimpleNamespace(genome_size=L, seq_len=TWO_L)
    cfg = types.SimpleNamespace(somatic=False, frequency_thr=0.2,
                                min_allele_depth=5)
    jev = jdp.DeviceEvidence(types.SimpleNamespace(idx=idx), cfg, None)
    tev = tdp.DeviceEvidence(types.SimpleNamespace(idx=idx, device="cpu"),
                             cfg, None)
    return jev, tev


@pytest.mark.parametrize("case", ["classic", "sparse", "dense", "rerun"])
def test_reconcile_batch(monkeypatch, case):
    """Folded tokens: the speculative meta apply, then the host's admit
    bits reconcile it — sparse correction below CORRECT_CAP rejects, the
    dense undo + classic apply above it and after a tier rerun; a classic
    token runs the bits apply."""
    monkeypatch.setattr(jdp.DeviceEvidence, "CORRECT_CAP", 8)
    monkeypatch.setattr(tdp.DeviceEvidence, "CORRECT_CAP", 8)
    pd, mmp, rl, meta, rng = _chain_outputs(3)
    fast_ix = np.nonzero((meta[:B] & 3) == CLASS_FAST)[0]
    n_rej = {"classic": 5, "sparse": 5, "dense": 20, "rerun": 3}[case]
    rej = rng.choice(fast_ix, size=n_rej, replace=False)
    adm = np.zeros(B, bool)
    adm[fast_ix] = True
    adm[rej] = False
    fbits = np.zeros(B // 32, dtype=np.uint32)
    for i in np.nonzero(adm)[0]:
        fbits[i >> 5] |= np.uint32(1 << (i & 31))
    jev, tev = _evidence_pair()
    j_args = [jnp.asarray(x) for x in (meta, pd, mmp, rl)]
    t_args = [torch.from_numpy(x) for x in (meta, pd, mmp, rl)]
    spec = case != "classic"
    if spec:
        jev.planes = jdp.build_apply_kernel(L, TWO_L, B, True, source="meta")(
            jev.planes, j_args[1], j_args[2], j_args[3], j_args[0])
        tev.planes = tdp.build_apply_kernel(L, TWO_L, B, True, source="meta")(
            tev.planes, t_args[1], t_args[2], t_args[3], t_args[0])
        _assert_planes_equal(tev.planes, jev.planes)
    jtok = [None, j_args[0], None, None, 128, rl, j_args[1], j_args[2],
            j_args[3]]
    ttok = ChainToken(None, t_args[0], None, None, t_args[3], 128, rl,
                      t_args[1], t_args[2], cls0=meta & 3)
    if spec:
        jtok.append(tuple(jtok[i] for i in (1, 6, 7)))
        ttok.spec = (ttok.dev, ttok.pd, ttok.mmp)
    if case == "rerun":
        # collect_chain swapped in the rerun's outputs (here: the same
        # values in new arrays, so only the identity test tells)
        jtok[1], jtok[6] = jnp.asarray(meta), jnp.asarray(pd)
        ttok.dev, ttok.pd = torch.from_numpy(meta.copy()), \
            torch.from_numpy(pd.copy())
    stats = tdp.STATS
    before = (stats.applies, stats.corrections, stats.undos)
    jev.reconcile_batch(jtok, fbits, True)
    tev.reconcile_batch(ttok, fbits, True)
    _assert_planes_equal(tev.planes, jev.planes)
    delta = tuple(a - b for a, b in zip(
        (stats.applies, stats.corrections, stats.undos), before))
    assert delta == {"classic": (1, 0, 0), "sparse": (0, 1, 0),
                     "dense": (1, 0, 1), "rerun": (1, 0, 1)}[case]


def _host_profiles(seed):
    rng = np.random.default_rng(seed)
    profs = (JaxProfile(L), Profile(L))
    for p in profs:
        p.alloc_diffs()
    for name, shape in (("acgt", (4, L)), ("exact_diff", (L + 1,)),
                        ("F1_diff", (L + 1,)), ("R2_diff", (L + 1,)),
                        ("F2_diff", (L + 1,)), ("R1_diff", (L + 1,)),
                        ("multi_diff", (L + 1,))):
        vals = rng.integers(-3, 4, size=shape) * (rng.random(shape) < 0.05)
        for p in profs:
            getattr(p, name)[...] = vals
    return profs, rng


@pytest.mark.parametrize("dirty", [True, False])
def test_merge_host_deltas(dirty):
    """Slow-read deltas add into the planes once and the host copies are
    zeroed; a run whose dirtiness probe says no host evidence skips it."""
    (jprof, tprof), rng = _host_profiles(4)
    jev, tev = _evidence_pair()
    jev.host_profile, tev.host_profile = jprof, tprof
    for p in (jprof, tprof):
        p.dirty_probes.append(lambda: dirty)
    arrs = _random_planes(rng)
    jev.planes, tev.planes = _jax_planes(arrs), _torch_planes(arrs)
    jev._merge_host_deltas()
    tev._merge_host_deltas()
    _assert_planes_equal(tev.planes, jev.planes)
    for name in ("acgt", "exact_diff", "F1_diff", "R2_diff", "F2_diff",
                 "R1_diff", "multi_diff"):
        np.testing.assert_array_equal(getattr(tprof, name),
                                      getattr(jprof, name))
        assert (getattr(tprof, name) == 0).all() == dirty


def test_finalize_kernel():
    """Coverage and multi counts past 4095 saturate; F does not."""
    rng = np.random.default_rng(5)
    arrs = _random_planes(rng, 0, 3000)
    arrs["exact_diff"] = rng.integers(-40, 45, size=L + 2)
    arrs["exact_diff"][:3] = [3000, 2000, -100]
    arrs["multi_diff"] = rng.integers(-40, 45, size=L + 2)
    arrs["multi_diff"][0] = 4000
    rc = rng.integers(0, 4, size=L).astype(np.int32)
    want = jdp.build_finalize_kernel(L)(_jax_planes(arrs), jnp.asarray(rc))
    got = tdp.build_finalize_kernel(L)(_torch_planes(arrs),
                                       torch.from_numpy(rc))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0] == tdp.MAX_ALLELE_COUNT).any()
    assert (got[2] == tdp.MAX_ALLELE_COUNT).any()
    assert (got[1] > tdp.MAX_ALLELE_COUNT).any()
    assert got[4].dtype == torch.int64


def test_ref_codes_dev():
    """Two chromosomes, a genome length that is not a multiple of 16."""
    rng = np.random.default_rng(6)
    codes = rng.integers(0, 4, size=L).astype(np.uint8)
    idx = build_index(None, packed=PackedReference(
        ["c1", "c2"], [1200, L - 1200], [0, 1200], codes, []))
    want = jdp.DeviceEvidence._ref_codes_dev(types.SimpleNamespace(
        be=types.SimpleNamespace(chain_ctx=JaxChainCtx.from_host(idx)), L=L))
    got = tdp.DeviceEvidence._ref_codes_dev(types.SimpleNamespace(
        be=types.SimpleNamespace(chain_ctx=ChainCtx.from_host(idx, "cpu")),
        L=L))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  idx.ref.ref_sequence_codes()[:L])


def test_download_raw_into():
    rng = np.random.default_rng(7)
    arrs = _random_planes(rng)
    jev, tev = _evidence_pair()
    jev.planes, tev.planes = _jax_planes(arrs), _torch_planes(arrs)
    (jprof, tprof), _ = _host_profiles(8)
    jev.download_into(jprof)
    tev.download_into(tprof)
    for name in ("acgt", "exact_diff", "F1_diff", "R2_diff", "F2_diff",
                 "R1_diff", "multi_diff"):
        np.testing.assert_array_equal(getattr(tprof, name),
                                      getattr(jprof, name))


def test_device_evidence_fits(monkeypatch):
    """The memory gate of the reference's test_hbm_budget_predicates: the
    reference charges the whole card (16 GB), the port the free memory
    left once the 1-step rows and the full SA are placed, so the same
    genomes pass. On the CPU no budget applies."""
    hbm = 16_000_000_000
    jbe = JaxBackend.__new__(JaxBackend)
    monkeypatch.setattr(JaxBackend, "_hbm_bytes", staticmethod(lambda: hbm))
    be = DeviceBackend.__new__(DeviceBackend)
    for mb, occ3_ok, ev_ok in ((4.6, True, True), (60, True, True),
                               (100, True, True), (110, True, False),
                               (200, True, False), (500, False, False)):
        i = types.SimpleNamespace(genome_size=int(mb * 1e6))
        i.seq_len = 2 * i.genome_size
        free = hbm - 2 * i.seq_len - min(4 * (i.seq_len + 1), 2 << 30)
        be._mem_bytes = lambda free=free: free
        assert be._occ3_fits(i) == occ3_ok, mb
        # both charge the occ3 rows only when the occ3 scan runs
        jbe._fm3_ok = be._fm3_ok = occ3_ok
        assert jbe._device_evidence_fits(i, None) == ev_ok, mb
        assert be._device_evidence_fits(i) == ev_ok, mb
    be._mem_bytes = lambda: None
    assert be._device_evidence_fits(i)
