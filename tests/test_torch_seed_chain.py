"""The port's seed + chain stage (mapcaller_tpu_torch/ops/fm_search.py,
chain_device.py, pipeline/device_backend.py) against the reference
package's on one batch: the packed output vector and the device-resident
pd/mmp must be equal exactly, and the backend's collect (tier-18 rerun,
host-oracle splice for overflowed and too-long reads) must return the
same arrays and counters."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mapcaller_tpu.config import Config as JaxConfig
from mapcaller_tpu.index.fmindex import build_index
from mapcaller_tpu.index.packer import PackedReference
from mapcaller_tpu.ops.chain_device import ChainCtx as JaxChainCtx
from mapcaller_tpu.ops.fm3_device import DeviceFM3 as JaxFM3
from mapcaller_tpu.ops.fm_search import build_seed_chain_kernel as jax_kernel
from mapcaller_tpu.pipeline.device_backend import DeviceBackend as JaxBackend
from mapcaller_tpu_torch.config import Config
from mapcaller_tpu_torch.ops.chain_device import CLASS_FAST, ChainCtx
from mapcaller_tpu_torch.ops.fm3_device import DeviceFM3
from mapcaller_tpu_torch.ops.fm_search import build_seed_chain_kernel
from mapcaller_tpu_torch.pipeline.device_backend import DeviceBackend

torch.set_num_threads(1)   # small tensor ops: see test_torch_e2e.py

B, BUCKET = 128, 128


@pytest.fixture(scope="module")
def batch():
    """A 20 kb genome with a 300-bp block repeated 6 times, and one
    batch of reads: exact, SNP, reverse strand, 2-bp deletion, random
    (no hits), repeat (many hits), and too short to seed."""
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, size=20000).astype(np.uint8)
    rep = codes[500:800].copy()
    for k in range(6):
        codes[2000 + 1000 * k:2300 + 1000 * k] = rep
    idx = build_index(None, packed=PackedReference(["chr1"], [len(codes)],
                                                   [0], codes, []))
    mat = np.zeros((B, BUCKET), dtype=np.uint8)
    rlens = np.zeros(B, dtype=np.int32)
    for b in range(B):
        ln = int(rng.integers(60, 121))
        p = int(rng.integers(0, len(codes) - 130))
        r = codes[p:p + ln + 2].copy()
        kind = b % 7
        if kind == 1:
            r[ln // 2] = (r[ln // 2] + 1) % 4
        elif kind == 2:
            r = (3 - r)[::-1]
        elif kind == 3:
            r = np.concatenate([r[:ln // 2], r[ln // 2 + 2:]])
        elif kind == 4:
            r = rng.integers(0, 4, size=ln + 2).astype(np.uint8)
        elif kind == 5:
            r = codes[2000 + 1000 * (b % 6):][:ln + 2].copy()
        elif kind == 6:
            ln = int(rng.integers(4, 17))
        r = r[:ln]
        mat[b, :ln] = r
        rlens[b] = ln
    packed = np.zeros((B, BUCKET // 4), dtype=np.uint8)
    for j in range(4):
        packed |= (mat[:, j::4] & 3) << (2 * j)
    return idx, packed, rlens, mat


def test_packed_output_equal_reference(batch):
    """With the fused prefix skip (K=6) and the stream path's tier 2."""
    idx, packed, rlens, _ = batch
    pfx_k, tier = 6, 2
    want_k = jax_kernel(JaxFM3.from_host(idx, pfx_k=pfx_k),
                        JaxChainCtx.from_host(idx), BUCKET, B,
                        slow_hits_x4=tier)
    w_dev, w_pd, w_mmp = want_k(jnp.asarray(packed), jnp.asarray(rlens))
    fm3 = DeviceFM3.from_host(idx, pfx_k=pfx_k, device="cpu")
    assert fm3.pfx_k == pfx_k
    got_k = build_seed_chain_kernel(fm3, ChainCtx.from_host(idx, "cpu"),
                                    BUCKET, B, slow_hits_x4=tier)
    g_dev, g_pd, g_mmp = got_k(torch.from_numpy(packed),
                               torch.from_numpy(rlens))
    np.testing.assert_array_equal(g_dev.numpy(), np.asarray(w_dev))
    np.testing.assert_array_equal(g_pd.numpy(), np.asarray(w_pd))
    np.testing.assert_array_equal(g_mmp.numpy(), np.asarray(w_mmp))
    cls = g_dev.numpy()[:B] & 3
    assert len(set(cls.tolist())) == 3            # fast, nocand and slow
    assert (cls == CLASS_FAST).sum() >= B // 4
    for a, b in zip(got_k.collect(g_dev), want_k.collect(w_dev)):
        np.testing.assert_array_equal(a, b)


def test_backend_collect_equal_reference(batch):
    """Without the prefix skip: tier 1 overflows the slow-hit buffer
    (rerun at tier 18) and two reads are marked too long (negative rlen):
    both backends splice the host oracle's seeds for them."""
    idx, packed, rlens, mat = batch
    rl = rlens.copy()
    rl[[3, 10]] = -rl[[3, 10]]
    kw = dict(batch_size=B, max_read_len=BUCKET, prefix_skip_k=0,
              compact_factor=1)
    outs, bes = [], []
    for be in (JaxBackend(idx, JaxConfig(device_evidence=False, **kw)),
               DeviceBackend(idx, Config(device="cpu", **kw))):
        tok = be.submit_chain(packed, rl, BUCKET, tier=1)
        outs.append(be.collect_chain(tok, B - 5,
                                     lambda i: mat[i, :abs(rl[i])]))
        bes.append(be)
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert (bes[1].n_tier_reruns, bes[1].n_oracle_reads) == (
        bes[0].n_tier_reruns, bes[0].n_oracle_reads)
    assert bes[1].n_tier_reruns == 1 and bes[1].n_oracle_reads >= 2
