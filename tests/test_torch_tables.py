"""The port's device index tables (mapcaller_tpu_torch/ops/fm_device.py,
fm3_device.py), built from the same host FMIndex as the reference
package's, must equal them exactly: the 1-step occ rows and Occ
primitives, the occ3 rows with c3_first and (row_p1, row_p2), and the
embedded prefix-skip rows."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mapcaller_tpu.index.fmindex import build_index
from mapcaller_tpu.index.packer import PackedReference
from mapcaller_tpu.ops import fm3_device as jax_fm3
from mapcaller_tpu.ops import fm_device as jax_fm
from mapcaller_tpu_torch.index.occ3 import build_occ3
from mapcaller_tpu_torch.ops import fm3_device, fm_device

torch.set_num_threads(1)   # small tensor ops: see test_torch_e2e.py


def _index(L, seed):
    codes = np.random.default_rng(seed).integers(0, 4, size=L).astype(
        np.uint8)
    return build_index(None, packed=PackedReference(["c1"], [L], [0], codes,
                                                    []))


@pytest.fixture(scope="module")
def idx():
    return _index(6007, seed=5)


@pytest.mark.parametrize("L", [503, 4093, 20011])
def test_occ3_rows_equal_reference(L):
    idx = _index(L, seed=L)
    want = jax_fm3.DeviceFM3.from_host(idx, pfx_k=0)
    got = fm3_device.DeviceFM3.from_host(idx, pfx_k=0, device="cpu")
    np.testing.assert_array_equal(got.occ3_rows.numpy(),
                                  np.asarray(want.occ3_rows))
    np.testing.assert_array_equal(got.c3_first.numpy(),
                                  np.asarray(want.c3_first))
    assert (got.row_p1, got.row_p2, got.t0, got.t1, got.tail1, got.tail2a,
            got.tail2b) == (want.row_p1, want.row_p2, want.t0, want.t1,
                            want.tail1, want.tail2a, want.tail2b)
    # and the host builder the port carries agrees with its device build
    host = build_occ3(idx.sa_full, idx.ref.fwd_rc_codes())
    np.testing.assert_array_equal(got.occ3_rows.numpy(), host.rows)


@pytest.mark.parametrize("K", [2, 6])
def test_prefix_rows_equal_reference(idx, K):
    want = jax_fm3.DeviceFM3.from_host(idx, pfx_k=K)
    got = fm3_device.DeviceFM3.from_host(idx, pfx_k=K, device="cpu")
    assert (got.pfx_k, got.pfx_base) == (want.pfx_k, want.pfx_base) == (
        K, got.occ3_rows.shape[0] - 4 ** K // 16)
    np.testing.assert_array_equal(got.occ3_rows.numpy(),
                                  np.asarray(want.occ3_rows))


def test_occ_rows_equal_reference(idx):
    want = jax_fm.DeviceFMIndex.from_host(idx)
    got = fm_device.DeviceFMIndex.from_host(idx, device="cpu")
    np.testing.assert_array_equal(got.occ_rows.numpy(),
                                  np.asarray(want.occ_rows))
    np.testing.assert_array_equal(got.sa_full.numpy(),
                                  np.asarray(want.sa_full))
    assert got.primary == want.primary


@pytest.mark.parametrize("fn", ["occ4", "occ_one", "inv_psi"])
def test_occ_primitives_equal_reference(idx, fn):
    rng = np.random.default_rng(9)
    want_fm = jax_fm.DeviceFMIndex.from_host(idx)
    got_fm = fm_device.DeviceFMIndex.from_host(idx, device="cpu")
    lo = 0 if fn == "inv_psi" else -1
    k = rng.integers(lo, idx.seq_len + 1, size=4000)
    k[:3] = [max(lo, 0), idx.primary, idx.seq_len]
    c = rng.integers(0, 4, size=k.size)
    args_j = [jnp.asarray(k, jnp.int32)]
    args_t = [torch.as_tensor(k)]
    if fn == "occ_one":
        args_j.append(jnp.asarray(c, jnp.int32))
        args_t.append(torch.as_tensor(c))
    want = np.asarray(getattr(jax_fm, fn)(want_fm, *args_j))
    got = getattr(fm_device, fn)(got_fm, *args_t).numpy()
    np.testing.assert_array_equal(got, want)


def test_sa_walk_equals_reference(idx):
    """The sampled-SA inverse-Psi walk (no full SA on the device)."""
    want_fm = jax_fm.DeviceFMIndex.from_host(idx, sa_budget_bytes=0)
    got_fm = fm_device.DeviceFMIndex.from_host(idx, device="cpu",
                                               sa_budget_bytes=0)
    assert not got_fm.has_full_sa
    k = np.random.default_rng(2).integers(0, idx.seq_len + 1, size=500)
    active = np.arange(k.size) % 7 != 0
    w_loc, w_ok = jax_fm.sa_resolve(want_fm, jnp.asarray(k, jnp.int32),
                                    jnp.asarray(active))
    g_loc, g_ok = fm_device.sa_resolve(got_fm, torch.as_tensor(k),
                                       torch.as_tensor(active))
    np.testing.assert_array_equal(g_ok.numpy(), np.asarray(w_ok))
    ok = np.asarray(w_ok)
    np.testing.assert_array_equal(g_loc.numpy()[ok], np.asarray(w_loc)[ok])
    np.testing.assert_array_equal(g_loc.numpy()[ok], idx.sa_full[k[ok]])


def test_popcount32_matches_numpy():
    x = np.random.default_rng(1).integers(0, 2**32, size=1000,
                                          dtype=np.int64)
    x[:3] = [0, 2**32 - 1, 2**31]
    want = np.array([bin(int(v)).count("1") for v in x])
    got = fm_device.popcount32(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)
