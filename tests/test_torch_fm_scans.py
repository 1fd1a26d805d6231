"""The port's seed scans and seed kernels (mapcaller_tpu_torch/ops/
fm_search.py) against the reference package's on the CPU: the lane-
compacted occ3 scan, the 1-step occ4 scan with and without ambiguous
bases, the packed seed kernel of the unchained stream path, the non-
native path's byte-code kernel and the chain kernel over the 1-step
index must give exactly the reference's outputs; and the stream's auto
compaction rule must switch at the reference's record count."""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mapcaller_tpu.index.fmindex import build_index
from mapcaller_tpu.index.packer import PackedReference
from mapcaller_tpu.ops import fm_search as jfs
from mapcaller_tpu.ops.chain_device import ChainCtx as JaxChainCtx
from mapcaller_tpu.ops.fm3_device import DeviceFM3 as JaxFM3
from mapcaller_tpu.ops.fm_device import DeviceFMIndex as JaxFM
from mapcaller_tpu.pipeline.seeding import identify_simple_pairs
from mapcaller_tpu_torch.config import Config
from mapcaller_tpu_torch.ops import fm_search as tfs
from mapcaller_tpu_torch.ops.chain_device import ChainCtx
from mapcaller_tpu_torch.ops.fm3_device import DeviceFM3
from mapcaller_tpu_torch.ops.fm_device import DeviceFMIndex
from mapcaller_tpu_torch.pipeline import stream

torch.set_num_threads(1)   # small tensor ops: see test_torch_e2e.py

B, MAXLEN = 192, 64
MAX_SEEDS = MAXLEN // (tfs.MIN_SEED_LEN + 1) + 2


@pytest.fixture(scope="module")
def genome():
    """A 9 kb random genome (the reference's compaction-test template)
    with a 200-bp block repeated 4 times, so some seeds have several
    hits; the reference's and the port's 1-step and occ3 tables (the
    occ3 ones without and with a K=7 fused prefix skip)."""
    rng = np.random.default_rng(23)
    codes = rng.integers(0, 4, size=9000).astype(np.uint8)
    for k in range(4):
        codes[3000 + 600 * k:3200 + 600 * k] = codes[1000:1200]
    idx = build_index(None, packed=PackedReference(["chr1"], [len(codes)],
                                                   [0], codes, []))
    jfm = JaxFM.from_host(idx)
    tfm = DeviceFMIndex.from_host(idx, device="cpu")
    return dict(idx=idx, rng=rng, jfm=jfm, tfm=tfm,
                j3={0: JaxFM3.from_host(idx, jfm),
                    7: JaxFM3.from_host(idx, jfm, pfx_k=7)},
                t3={0: DeviceFM3.from_host(idx, tfm),
                    7: DeviceFM3.from_host(idx, tfm, pfx_k=7)})


def _reads(idx, rng, n, maxlen, n_rate=0.0):
    """n reads of the fwd+rc text with 0-2 substitutions (a share
    `n_rate` of bases turned to N, code 4), every 4th at full length,
    every 11th too short to seed; -> (codes uint8[n, maxlen] padded with
    4, rlens int32[n])."""
    text = idx.ref.fwd_rc_codes()
    mat = np.full((n, maxlen), 4, dtype=np.uint8)
    rlens = np.zeros(n, dtype=np.int32)
    for b in range(n):
        ln = int(rng.integers(20, maxlen + 1)) if b % 4 else maxlen
        if b % 11 == 0:
            ln = int(rng.integers(4, tfs.MIN_SEED_LEN + 2))
        p = int(rng.integers(0, idx.genome_size - maxlen))
        r = text[p:p + ln].copy()
        for _ in range(int(rng.integers(0, 3))):
            j = int(rng.integers(0, ln))
            r[j] = (r[j] + 1 + rng.integers(0, 3)) % 4
        r[rng.random(ln) < n_rate] = 4
        mat[b, :ln] = r
        rlens[b] = ln
    return mat, rlens


def _pack(mat):
    packed = np.zeros((mat.shape[0], mat.shape[1] // 4), dtype=np.uint8)
    for j in range(4):
        packed |= (mat[:, j::4] & 3) << (2 * j)
    return packed


def _jax_codes_fn(packed):
    """The reference kernels' word-select code lookup over packed reads."""
    n, W4 = packed.shape
    pb = jnp.asarray(packed).astype(jnp.uint32).reshape(n, W4 // 4, 4)
    sh = (jnp.arange(4, dtype=jnp.uint32) * 8)[None, None, :]
    words = (pb << sh).sum(axis=2, dtype=jnp.uint32)
    widx = jnp.arange(W4 // 4, dtype=jnp.int32)[None, :]

    def codes_fn(row, pos):
        w = jnp.where(widx == (pos >> 4)[:, None], words, 0).sum(
            axis=1, dtype=jnp.uint32)
        return ((w >> ((pos.astype(jnp.uint32) & 15) * 2)) & 3
                ).astype(jnp.int32)

    return words, codes_fn


def _equal(got, want):
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(g).astype(np.int64),
                                      np.asarray(w).astype(np.int64),
                                      err_msg=tfs._SEED_KEYS[k])


@pytest.mark.parametrize("pfx_k", [0, 7])
@pytest.mark.parametrize("factor", [1, 2, 4])
def test_compact_scan_equal_reference_and_lockstep(genome, factor, pfx_k):
    """Factor 1 is one lane per read (the queue is empty from the start);
    2 and 4 refill lanes from the queue. Equal to the reference's
    compacted scan and to the port's lockstep scan, overflow included."""
    mat, rlens = _reads(genome["idx"], genome["rng"], B, MAXLEN)
    packed = _pack(mat)
    words_j, codes_j = _jax_codes_fn(packed)
    want = jax.jit(lambda fm3, w, r: jfs._seed_scan3_compact(
        fm3, w, r, B, B // factor, MAXLEN, MAX_SEEDS))(
        genome["j3"][pfx_k], words_j, jnp.asarray(rlens))
    words = tfs._read_words_le(torch.from_numpy(packed))
    rl = torch.from_numpy(rlens)
    got = tfs._seed_scan3_compact(genome["t3"][pfx_k], words, rl, B,
                                  B // factor, MAXLEN, MAX_SEEDS)
    _equal(got, want)
    lock = tfs._seed_scan3(
        genome["t3"][pfx_k], lambda p: tfs._word_codes(words, p), rl, B,
        MAXLEN, MAX_SEEDS,
        key_fn=lambda p: tfs._word_key(words, p, pfx_k))
    _equal(got, lock)
    assert int(got[0].sum()) > B // 2     # the reads do seed


@pytest.mark.parametrize("has_n", [False, True])
def test_one_step_scan_equal_reference(genome, has_n):
    """has_n=False: 2-bit codes from packed words; has_n=True: byte codes
    with about 3% N bases, which end extensions and are skipped."""
    mat, rlens = _reads(genome["idx"], genome["rng"], B, MAXLEN,
                        n_rate=0.03 if has_n else 0.0)
    if has_n:
        cj = jnp.asarray(mat)

        def codes_j(row, pos):
            return cj[row, pos].astype(jnp.int32)

        ct = torch.from_numpy(mat)
        bidx = torch.arange(B)

        def codes_t(pos):
            return ct[bidx, pos].to(torch.int64)
    else:
        packed = _pack(mat)
        _, codes_j = _jax_codes_fn(packed)
        words = tfs._read_words_le(torch.from_numpy(packed))

        def codes_t(pos):
            return tfs._word_codes(words, pos)

    want = jax.jit(lambda fm, r: jfs._seed_scan(
        fm, codes_j, r, B, MAXLEN, MAX_SEEDS, has_n))(
        genome["jfm"], jnp.asarray(rlens))
    got = tfs._seed_scan(genome["tfm"], codes_t, torch.from_numpy(rlens), B,
                         MAXLEN, MAX_SEEDS, has_n)
    _equal(got, want)


def test_seed_kernel_equal_reference_and_oracle(genome):
    """The non-native path's kernel (byte codes with N, 1-step index):
    its packed vector equals the reference kernel's, and the FragPair
    lists it gives equal identify_simple_pairs read by read."""
    idx = genome["idx"]
    n, maxlen = 32, 128
    mat, rlens = _reads(idx, genome["rng"], n, maxlen, n_rate=0.02)
    want_k = jfs.build_seed_kernel(genome["jfm"], maxlen, n)
    want = np.asarray(want_k.raw_kernel(genome["jfm"], jnp.asarray(mat),
                                        jnp.asarray(rlens)))
    kern = tfs.build_seed_kernel(genome["tfm"], maxlen, n)
    dev = kern(torch.from_numpy(mat), torch.from_numpy(rlens))
    np.testing.assert_array_equal(dev.numpy(), want)
    (hit_read, hit_rpos, hit_len, hit_loc, hit_valid, _total, overflow,
     buf_ovf) = kern.collect(dev)
    assert not buf_ovf and not overflow.any()
    got = tfs.seeds_to_frag_pairs(hit_read, hit_rpos, hit_len, hit_loc,
                                  hit_valid, n, idx.seq_len)
    for b in range(n):
        oracle = identify_simple_pairs(idx, mat[b, :rlens[b]])
        assert ([(f.rPos, f.gPos, f.rLen) for f in got[b]]
                == [(f.rPos, f.gPos, f.rLen) for f in oracle]), b


@pytest.mark.parametrize("case", ["occ3", "compact", "one_step"])
def test_packed_kernel_equal_reference(genome, case):
    """The unchained stream path's kernel: the occ3 scan with the fused
    prefix skip, the compacted scan (lanes = B / 4) and the 1-step scan;
    the packed vector and its host decode equal the reference's."""
    mat, rlens = _reads(genome["idx"], genome["rng"], B, MAXLEN)
    packed = _pack(mat)
    jfm, tfm = ((genome["jfm"], genome["tfm"]) if case == "one_step"
                else (genome["j3"][7], genome["t3"][7]))
    lanes = B // 4 if case == "compact" else 0
    want_k = jfs.build_seed_kernel_packed(jfm, MAXLEN, B, compact_lanes=lanes)
    want = want_k(jnp.asarray(packed), jnp.asarray(rlens))
    kern = tfs.build_seed_kernel_packed(tfm, MAXLEN, B, compact_lanes=lanes)
    assert kern.compact_lanes == lanes
    got = kern(torch.from_numpy(packed), torch.from_numpy(rlens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for a, b in zip(kern.collect(got), want_k.collect(want)):
        np.testing.assert_array_equal(a, b)
    assert kern.collect(got)[0].sum() > B // 2


def test_chain_kernel_one_step_equal_reference(genome):
    """The chain kernel over the 1-step index (DeviceFMIndex): the packed
    output and the device-resident pd/mmp equal the reference's."""
    idx = genome["idx"]
    mat, rlens = _reads(idx, genome["rng"], B, MAXLEN)
    packed = _pack(mat)
    want_k = jfs.build_seed_chain_kernel(genome["jfm"],
                                         JaxChainCtx.from_host(idx), MAXLEN,
                                         B, slow_hits_x4=2)
    w_dev, w_pd, w_mmp = want_k(jnp.asarray(packed), jnp.asarray(rlens))
    kern = tfs.build_seed_chain_kernel(genome["tfm"],
                                       ChainCtx.from_host(idx, "cpu"),
                                       MAXLEN, B, slow_hits_x4=2)
    assert not kern.use_occ3
    g_dev, g_pd, g_mmp = kern(torch.from_numpy(packed),
                              torch.from_numpy(rlens))
    np.testing.assert_array_equal(g_dev.numpy(), np.asarray(w_dev))
    np.testing.assert_array_equal(g_pd.numpy(), np.asarray(w_pd))
    np.testing.assert_array_equal(g_mmp.numpy(), np.asarray(w_mmp))


@pytest.mark.parametrize("records, chained, want", [
    (6 * 131072 - 1, True, (1, 32768)),
    (6 * 131072, True, (4, 131072)),
    (6 * 131072, False, (1, 32768))])
def test_auto_compaction_rule(records, chained, want):
    """The reference's rule: x4 lanes and 131,072-read stream batches from
    6 x 131,072 records (estimated from a 256 KB prefix, exact here: the
    16-byte records divide it), only with device chaining and the occ3
    table; the mates' records count together."""
    rec = b"@ab\nACGT\n+\nIIII\n"
    half = records // 2
    cfg = Config(device="cpu", compact_factor=0)
    be = types.SimpleNamespace(chain_enabled=chained, _fm3_ok=True,
                               index_shards=0, n_devices=1,
                               device=torch.device("cpu"))
    stream._resolve_auto_compaction(cfg, be, rec * half,
                                    rec * (records - half))
    assert (cfg.compact_factor, cfg.stream_batch_size) == want


def test_auto_compaction_off_on_the_card():
    """On a CUDA backend auto keeps one lane per read: the scan kernel
    runs a thread per read, and the rule's own geometry measured slower
    in lanes."""
    rec = b"@ab\nACGT\n+\nIIII\n"
    cfg = Config(device="cuda", compact_factor=0)
    be = types.SimpleNamespace(chain_enabled=True, _fm3_ok=True,
                               index_shards=0, n_devices=1,
                               device=torch.device("cuda"))
    stream._resolve_auto_compaction(cfg, be, rec * (4 * 131072),
                                    rec * (4 * 131072))
    assert (cfg.compact_factor, cfg.stream_batch_size) == (1, 32768)
