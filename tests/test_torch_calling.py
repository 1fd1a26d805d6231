"""The port's caller scan, column fetch, gVCF NOR reduction and lazy block
depths (mapcaller_tpu_torch/calling/scan_device.py through
pipeline/device_profile.DeviceEvidence) against the reference package's
on the same finalized planes, made from a numpy seed at a few kb. All
integer (the float32 candidate threshold is compared through the
candidate indices): the tolerance is exact equality."""
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mapcaller_tpu.calling import scan_device as jsd
from mapcaller_tpu.pipeline import device_profile as jdp
from mapcaller_tpu_torch.calling import scan_device as tsd
from mapcaller_tpu_torch.pipeline import device_profile as tdp

torch.set_num_threads(1)   # small tensor ops: see test_torch_e2e.py

L = 4537    # not a multiple of the 100-bp block


def _finalized(seed, mismatches=True):
    """(acgt, F, multi, cov, cov_prefix, ref_codes) as numpy: coverage in
    stretches with gaps, multi-hit runs, alternative alleles at some
    positions (none when `mismatches` is False), depths up to the 4095
    cap so the float32 thresholds meet large products."""
    rng = np.random.default_rng(seed)
    rc = rng.integers(0, 4, size=L).astype(np.int32)
    depth = rng.integers(0, 80, size=L)
    depth[rng.integers(0, L - 400):][:300] = 0
    depth[1000:1100] = 0
    depth[2000:2050] = 4095
    acgt = np.zeros((4, L), dtype=np.int32)
    acgt[rc, np.arange(L)] = depth
    if mismatches:
        alt = np.nonzero(rng.random(L) < 0.08)[0]
        for g in alt:
            c = (rc[g] + rng.integers(1, 4)) % 4
            acgt[c, g] = min(int(rng.integers(0, depth[g] + 3)), 4095)
        acgt[(rc[2000:2050] + 1) % 4, np.arange(2000, 2050)] = \
            rng.integers(780, 840, size=50)
        acgt[:, 1000:1100] = 0
    multi = np.zeros(L, dtype=np.int32)
    multi[3000:3200] = rng.integers(0, 3, size=200)
    multi[1000:1060] = 2
    F = rng.integers(0, 50, size=(4, L)).astype(np.int32)
    cov = acgt.sum(axis=0, dtype=np.int32)
    cov_prefix = np.concatenate([[0], np.cumsum(cov)]).astype(np.int64)
    return acgt, F, multi, cov, cov_prefix, rc


def _evidence_pair(fin, somatic=False):
    """A reference DeviceEvidence and the port's on a stand-in backend,
    both holding the same finalized planes."""
    acgt, F, multi, cov, cov_prefix, rc = fin
    idx = types.SimpleNamespace(genome_size=L, seq_len=2 * L)
    cfg = types.SimpleNamespace(somatic=somatic, frequency_thr=0.2,
                                min_allele_depth=5)
    jev = jdp.DeviceEvidence(types.SimpleNamespace(idx=idx), cfg, None)
    jev._final = tuple(jnp.asarray(x.astype(np.int32)) for x in
                       (acgt, F, multi, cov, cov_prefix))
    jev._ref_codes_dev = lambda: jnp.asarray(rc)
    tev = tdp.DeviceEvidence(types.SimpleNamespace(idx=idx, device="cpu"),
                             cfg, None)
    tev._final = tuple(torch.from_numpy(x) for x in
                       (acgt, F, multi, cov, cov_prefix))
    tev._ref_codes = torch.from_numpy(rc)
    return jev, tev


@pytest.mark.parametrize("case", ["germline", "somatic", "no_candidates"])
def test_scan(case):
    fin = _finalized(1, mismatches=case != "no_candidates")
    jev, tev = _evidence_pair(fin, somatic=case == "somatic")
    jbd, jcand, jrs, jrv, jscal = jev.scan()
    tbd, tcand, trs, trv, tscal = tev.scan()
    np.testing.assert_array_equal(tscal, jscal)
    n_cand, n_runs = int(tscal[0]), int(tscal[1])
    if case == "no_candidates":
        assert n_cand == 0 and tcand.size == 0
    else:
        assert n_cand > 20
    assert n_runs > 5
    np.testing.assert_array_equal(tcand[:n_cand], jcand[:n_cand])
    np.testing.assert_array_equal(trs[:n_runs], jrs[:n_runs])
    np.testing.assert_array_equal(trv[:n_runs], jrv[:n_runs])
    assert len(tbd) == len(jbd) == (L + 99) // 100
    np.testing.assert_array_equal(tbd.dense(), jbd.dense())
    # the tables' full device buffers, -1 / 0 past the counts
    want = jsd.build_scan_kernel(L, case == "somatic")(
        *(jnp.asarray(x) for x in (fin[0], fin[2], fin[3], fin[5])),
        jnp.int32(5), jnp.float32(0.01 if case == "somatic" else 0.2))
    got = tsd.build_scan_kernel(L, case == "somatic")(
        *(torch.from_numpy(x) for x in (fin[0], fin[2], fin[3], fin[5])),
        5, np.float32(0.01 if case == "somatic" else 0.2))
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_fetch_columns():
    """Columns and prefix values at sparse positions, out-of-range ones
    clipped, with block depths riding the same copy into the cache."""
    jev, tev = _evidence_pair(_finalized(2))
    jev.scan()
    tev.scan()
    rng = np.random.default_rng(2)
    pos = np.concatenate([[-3, 0, L - 1, L + 5],
                          rng.integers(0, L, size=60)]).astype(np.int64)
    pref = np.concatenate([[0, L, L + 2, -1],
                           rng.integers(0, L, size=30)]).astype(np.int64)
    blocks = np.unique(pos // 100)
    jcols, jpref = jev.fetch_columns(pos, pref, bd_blocks=pos // 100)
    tcols, tpref = tev.fetch_columns(pos, pref, bd_blocks=pos // 100)
    np.testing.assert_array_equal(tcols, jcols)
    np.testing.assert_array_equal(tpref, jpref)
    lbd = tev.scan()[0]
    assert lbd._dense is None
    for b in blocks[(blocks >= 0) & (blocks < lbd.nb)]:
        assert int(b) in lbd._cache
        assert lbd[b] == jev.scan()[0][b]


@pytest.mark.parametrize("case", ["breaks", "no_breaks"])
def test_nor_blocks(case):
    """gVCF NOR blocks: one block per break key; a key whose positions
    are all uncovered or emitted is an empty segment (INT32_MAX)."""
    fin = _finalized(3)
    cov = fin[3]
    jev, tev = _evidence_pair(fin)
    if case == "breaks":
        emitted = np.array([5, 6, 7, 1500, 2100, 4000], dtype=np.int32)
        # 1010 and 1050 enclose only uncovered positions: an empty key
        brk = np.array([7, 1010, 1050, 1500, 2100, 4000, L - 1],
                       dtype=np.int32)
    else:
        emitted = np.zeros(0, dtype=np.int32)
        brk = np.zeros(0, dtype=np.int32)
    jfirst, jmin, jcovf = jev.nor_blocks(emitted, brk)
    tfirst, tmin, tcovf = tev.nor_blocks(emitted, brk)
    k = brk.size + 1
    np.testing.assert_array_equal(tfirst[:k], jfirst[:k])
    np.testing.assert_array_equal(tmin[:k], jmin[:k])
    np.testing.assert_array_equal(tcovf[:k], jcovf[:k])
    if case == "breaks":
        assert (cov[1010:1050] == 0).all()
        assert tfirst[2] == tsd.INT32_MAX and tmin[2] == tsd.INT32_MAX
    assert (tfirst[:k] != tsd.INT32_MAX).sum() >= k - 1


def test_lazy_block_depth():
    """prefetch / insert / item access / dense agree with the reference's
    LazyBlockDepth on the same array."""
    rng = np.random.default_rng(4)
    arr = rng.integers(0, 500, size=53).astype(np.int32)
    nb = 50      # the array may be longer than its blocks
    j = jsd.LazyBlockDepth(jnp.asarray(arr), nb)
    t = tsd.LazyBlockDepth(torch.from_numpy(arr), nb)
    t.prefetch([3, 3, -1, 7, 49, 50, 12])
    assert sorted(t._cache) == [3, 7, 12, 49]
    t.insert([20, 21], [-5, -6])   # inserted values win over the array
    assert (t[20], t[21]) == (-5, -6)
    for b in (0, 3, 7, 33, 49):
        assert t[b] == j[b] == int(arr[b])
    with pytest.raises(IndexError):
        t[nb]
    assert len(t) == len(j) == nb
    np.testing.assert_array_equal(t.dense(), j.dense())
    assert t.dense().dtype == np.int64
    np.testing.assert_array_equal(t.astype(np.int32), arr[:nb])
    assert t[20] == int(arr[20])    # once dense, reads the array
