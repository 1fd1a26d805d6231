"""Device batch runner: seeding + chaining on the card for the stream
mapping engine (PyTorch port of mapcaller_tpu/pipeline/device_backend.py,
with the surface pipeline/stream.py uses).

Runs the seed/chain kernel (ops/fm_search.py) per parsed batch and hands
the classified reads and the slow reads' hits back to the host pipeline.
Reads the fixed-capacity kernel flags as overflowed (seed table, SA walk,
hit buffer) are re-seeded with the host oracle and spliced in, as in the
reference package: that splice is part of its capacity contract.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..index.fmindex import FMIndex
from ..ops.chain_device import CLASS_SLOW, ChainCtx
from ..ops.fm3_device import DeviceFM3
from ..ops.fm_device import DeviceFMIndex
from ..ops.fm_search import build_seed_chain_kernel
from .device_profile import STATS as EVIDENCE_STATS
from .seeding import identify_simple_pairs


@dataclasses.dataclass
class ChainToken:
    """One submitted batch. collect_chain swaps in a tier rerun's kernel,
    outputs, pd and mmp, so the evidence step reads the same
    classification the host admitted from."""
    kernel: object
    dev: torch.Tensor          # packed output vector (fm_search layout)
    fb_neg: np.ndarray         # host-fallback reads (negative rlen)
    packed_dev: torch.Tensor
    rl_dev: torch.Tensor       # int32[B] read lengths, fallback reads 0
    bucket: int
    rlens: np.ndarray
    pd: torch.Tensor           # int32[B] diagonals of FAST reads
    mmp: torch.Tensor          # int32[B, MM_SLOTS] packed mismatches
    # (dev, pd, mmp) of a dispatch that applied every device-FAST read's
    # evidence speculatively (fold_evidence), else None
    spec: Optional[tuple] = None
    # the classes of the first collected dispatch, host copy
    cls0: Optional[np.ndarray] = None


class DeviceBackend:
    BUCKETS = (128, 192, 256)
    n_devices = 1
    index_shards = 0

    # stream buffers and temporaries of the seed/chain kernel
    _WORKSPACE = 1_500_000_000
    # device evidence: 40 B/genome base of planes plus 48 B/base of
    # finalize outputs (cov_prefix in int64); the reference charges the
    # same 88 B/base
    _EVIDENCE_B_PER_BASE = 88
    # memory the prefix-skip depth choice leaves free on the card
    _PFX_RESERVE = 500_000_000

    def __init__(self, idx: FMIndex, cfg: Config):
        self.idx = idx
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Config.device is cuda but no CUDA device is visible; pass "
                "device='cpu' to run the plain PyTorch versions")
        _refuse_unported(cfg)
        self.batch = cfg.batch_size
        self.max_len = cfg.max_read_len
        self._kernels = {}
        self._fm3 = None
        self._chain_ctx = None
        self.chain_enabled = getattr(cfg, "device_chain", True)
        if not self.chain_enabled:
            raise NotImplementedError(
                "device_chain=False (hit download + host chaining, "
                "submit_packed) is not ported yet (ROADMAP.md, next "
                "slice 3: C3)")
        # capacity-overflow observability (repeat-rich genomes)
        self.n_tier_reruns = 0
        self.n_full_fallbacks = 0
        self.n_oracle_reads = 0
        self.fm = DeviceFMIndex.from_host(idx, device=self.device)
        self._fm3_ok = (idx.sa_full is not None
                        and idx.seq_len < (1 << 31) - 2
                        and self._occ3_fits(idx))
        if not self._fm3_ok:
            raise NotImplementedError(
                "the occ3 table does not fit (or the index has no full "
                "SA); the 1-step seed scan is not ported yet (ROADMAP.md, "
                "next slice 3: C3)")
        # evidence planes on the card when they fit beside the seeding
        # tables; else the C++ host diff arrays (runner logs the choice)
        self.device_evidence_ok = self._device_evidence_fits(idx)

    def _mem_bytes(self) -> Optional[int]:
        """Free device memory from the CUDA runtime; None on the CPU,
        where no budget applies."""
        if self.device.type != "cuda":
            return None
        free, _total = torch.cuda.mem_get_info(self.device)
        return int(free)

    def _occ3_fits(self, idx) -> bool:
        """Mapping working set with the 3-step table: occ3 (18 B/row)
        + workspace, against the free memory left after the 1-step rows
        and the full SA were placed (they are already resident)."""
        free = self._mem_bytes()
        if free is None:
            return True
        occ3 = (idx.seq_len // 16 + 2) * 288
        return occ3 + self._WORKSPACE <= free

    def _device_evidence_fits(self, idx) -> bool:
        """Evidence working set on top of mapping: the planes plus their
        finalize outputs (88 B/genome base) must fit beside the occ3 rows
        and the workspace in the free memory left after the 1-step rows
        and the full SA were placed. Beyond it the planes stay in host
        RAM (the C++ diff arrays) while seeding and chaining stay on the
        card."""
        free = self._mem_bytes()
        if free is None:
            return True
        occ3 = (idx.seq_len // 16 + 2) * 288
        planes = self._EVIDENCE_B_PER_BASE * idx.genome_size
        return occ3 + planes + self._WORKSPACE <= free

    def _prefix_skip_k(self) -> int:
        k = int(getattr(self.cfg, "prefix_skip_k", -1))
        free = self._mem_bytes()
        if free is None:
            # identical seed sets at any depth; a small table keeps CPU
            # runs cheap
            return 6 if k < 0 else min(k, 8)
        if k >= 0:
            return k
        # auto: the K maximizing the expected skip K * (1 - e^-lambda),
        # lambda = n / 4^K (a deeper skip only pays when the genome
        # contains the K-mer; an absent entry falls back to the 1-base
        # init), among the depths whose packed table (18 B/entry, 16
        # entries per 288-B row) fits the free memory left once the occ3
        # rows, the kernel workspace and the evidence working set are
        # placed, less a reserve
        n = self.idx.seq_len
        slack = (free - (n // 16 + 2) * 288 - self._WORKSPACE
                 - self._PFX_RESERVE
                 - (self._EVIDENCE_B_PER_BASE * self.idx.genome_size
                    if self.device_evidence_ok else 0))
        best = (0.0, 0)
        for kk in range(8, 15):
            if 18 * (4 ** kk) > slack:
                break
            gain = kk * (1.0 - math.exp(-n / (4.0 ** kk)))
            if gain > best[0]:
                best = (gain, kk)
        return best[1]

    @property
    def fm3(self) -> DeviceFM3:
        if self._fm3 is None:
            self._fm3 = DeviceFM3.from_host(
                self.idx, self.fm, pfx_k=self._prefix_skip_k(),
                text_words=self.chain_ctx.text_words)
        return self._fm3

    @property
    def chain_ctx(self) -> ChainCtx:
        if self._chain_ctx is None:
            self._chain_ctx = ChainCtx.from_host(self.idx,
                                                 device=self.device)
        return self._chain_ctx

    def dp_device_min_pairs(self) -> float:
        """Policy for cfg.device_extension == "auto": the least DP batch
        that goes to the device. On the card, -alg nw sends every DP
        batch to the CUDA NW kernel (0); -alg ksw2 has no device kernel
        in this port yet (ROADMAP.md, next slice 2: C1), so its pairs stay on
        the scalar C++ aligner (inf). On the CPU the plain PyTorch DP
        would only repeat the scalar aligner's work (inf)."""
        if self.device.type == "cuda" and self.cfg.use_nw:
            return 0.0
        return float("inf")

    def release_index_tables(self) -> None:
        """Drop the device-resident seeding tables (occ3 rows incl.
        prefix entries, chain kernels) before the calling phase; they
        rebuild lazily if mapping runs again."""
        import gc
        self._kernels.clear()
        self._fm3 = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _chain_kernel_for(self, bucket: int, tier: int = 2,
                          batch: Optional[int] = None):
        B = batch or self.batch
        key = ("chain", bucket, tier, B)
        if key not in self._kernels:
            self._kernels[key] = build_seed_chain_kernel(
                self.fm3, self.chain_ctx, bucket, B, slow_hits_x4=tier)
        return self._kernels[key]

    def submit_chain(self, packed: np.ndarray, rlens: np.ndarray,
                     bucket: int, tier: int = 2, evidence=None,
                     pair_end: bool = False) -> ChainToken:
        """Run the seed/chain kernel on one parsed batch (packed uint8
        [B, bucket/4] 2-bit codes, rlens int32[B]; negative rlen =
        host-fallback read). Returns the token collect_chain takes.

        evidence (a DeviceEvidence) folds the speculative fast-read
        evidence apply into this dispatch; the caller must later run
        evidence.reconcile_batch(token, fast_bits, pair_end)."""
        packed_dev = torch.from_numpy(np.ascontiguousarray(packed)).to(
            self.device)
        rl_dev = torch.from_numpy(np.maximum(rlens, 0).astype(np.int32)).to(
            self.device)
        kernel = self._chain_kernel_for(bucket, tier, batch=packed.shape[0])
        if evidence is not None:
            dev, pd, mmp = kernel(packed_dev, rl_dev, planes=evidence.planes,
                                  pair_end=pair_end)
            EVIDENCE_STATS.folded += 1
            return ChainToken(kernel, dev, rlens < 0, packed_dev, rl_dev,
                              bucket, rlens, pd, mmp, spec=(dev, pd, mmp))
        dev, pd, mmp = kernel(packed_dev, rl_dev)
        return ChainToken(kernel, dev, rlens < 0, packed_dev, rl_dev, bucket,
                          rlens, pd, mmp)

    def collect_chain(self, token: ChainToken, n: int, read_codes_fn):
        """-> (cls, pd, mm, rplast, cscore, counts, rpos, gpos, slen).
        Overflow / too-long reads are re-seeded with the host oracle and
        forced to the SLOW class; hit-buffer overflow reruns at the
        larger tier 18."""
        (cls, pd, mm, rplast, cscore, counts, rpos, gpos, slen,
         overflow, buf_ovf) = token.kernel.collect(token.dev)
        token.cls0 = cls
        if buf_ovf:
            self.n_tier_reruns += 1
            kernel2 = self._chain_kernel_for(token.bucket, tier=18,
                                             batch=len(token.rlens))
            dev2, pd2, mmp2 = kernel2(token.packed_dev, token.rl_dev)
            (cls, pd, mm, rplast, cscore, counts, rpos, gpos, slen,
             overflow, buf_ovf) = kernel2.collect(dev2)
            # the evidence step must use the SAME classification outputs
            # the host admits from
            token.kernel, token.dev = kernel2, dev2
            token.pd, token.mmp = pd2, mmp2
            if buf_ovf:   # pathological: host oracle for everything
                self.n_full_fallbacks += 1
                cls = np.full(n, CLASS_SLOW, dtype=np.int32)
                counts = np.zeros(n, dtype=np.int32)
                return self._splice_chain(
                    n, cls[:n], pd[:n], mm[:n], rplast[:n], cscore[:n],
                    counts, np.zeros(0, np.int32), np.zeros(0, np.int64),
                    np.zeros(0, np.int32), np.ones(n, dtype=bool),
                    read_codes_fn)
        fallback = overflow[:n] | token.fb_neg[:n]
        cls = cls[:n].copy()
        counts = counts[:n]
        self.n_oracle_reads += int(fallback.sum())
        if fallback.any():
            # drop device hits of fallback reads, then splice oracle seeds
            bounds = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(counts, out=bounds[1:])
            keep = np.ones(len(rpos), dtype=bool)
            for i in np.nonzero(fallback)[0].tolist():
                keep[bounds[i]:bounds[i + 1]] = False
            rpos, gpos, slen = rpos[keep], gpos[keep], slen[keep]
            counts = counts.copy()
            counts[fallback] = 0
            return self._splice_chain(n, cls, pd[:n], mm[:n], rplast[:n],
                                      cscore[:n], counts, rpos, gpos, slen,
                                      fallback, read_codes_fn)
        return (cls, pd[:n], mm[:n], rplast[:n], cscore[:n], counts,
                rpos.astype(np.int32), gpos, slen.astype(np.int32))

    def _splice_chain(self, n, cls, pd, mm, rplast, cscore, counts,
                      rpos, gpos, slen, fallback, read_codes_fn):
        cls[fallback] = CLASS_SLOW
        counts, rpos, gpos, slen = self._splice_fallback(
            n, counts, rpos, gpos, slen, fallback, read_codes_fn)
        return cls, pd, mm, rplast, cscore, counts, rpos, gpos, slen

    def _splice_fallback(self, n, counts, rpos, gpos, slen, fallback,
                         read_codes_fn):
        bounds = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=bounds[1:])
        rp_parts, gp_parts, ln_parts = [], [], []
        prev = 0
        for i in np.nonzero(fallback)[0].tolist():
            s = int(bounds[i])
            rp_parts.append(rpos[prev:s])
            gp_parts.append(gpos[prev:s])
            ln_parts.append(slen[prev:s])
            orp, ogp, oln = self._oracle_arrays(read_codes_fn(i))
            rp_parts.append(orp)
            gp_parts.append(ogp)
            ln_parts.append(oln)
            counts[i] = len(orp)
            prev = s
        rp_parts.append(rpos[prev:])
        gp_parts.append(gpos[prev:])
        ln_parts.append(slen[prev:])
        return (counts,
                np.concatenate(rp_parts).astype(np.int32),
                np.concatenate(gp_parts).astype(np.int64),
                np.concatenate(ln_parts).astype(np.int32))

    def submit(self, codes_list):
        """The non-native path's per-read seeding (reference:
        DeviceBackend.submit over build_seed_kernel)."""
        raise NotImplementedError(
            "the non-native path's 1-step seed kernel is not ported yet "
            "(ROADMAP.md, next slice 3: C3); run with the native host leg")

    def _oracle_arrays(self, c: np.ndarray) -> tuple:
        pairs = identify_simple_pairs(self.idx, c)[:-1]  # drop sentinel
        return (np.array([p.rPos for p in pairs], dtype=np.int32),
                np.array([p.gPos for p in pairs], dtype=np.int64),
                np.array([p.rLen for p in pairs], dtype=np.int32))


def _refuse_unported(cfg: Config) -> None:
    """Options whose device paths are not in this port yet raise here,
    naming their ROADMAP.md items, instead of running something else."""
    if int(getattr(cfg, "compact_factor", 1)) > 1:
        raise NotImplementedError(
            "compact_factor > 1: the lane-compacted scan "
            "(_seed_scan3_compact) is not ported yet (ROADMAP.md, next "
            "slice 1); seed sets are identical with "
            "compact_factor=1")
    if int(getattr(cfg, "devices", 1)) > 1:
        raise NotImplementedError(
            "-devices N > 1 is not ported yet (ROADMAP.md, next slice "
            "4)")
    if int(getattr(cfg, "index_shards", 0) or 0) > 1:
        raise NotImplementedError(
            "-shards N > 1 is not ported yet (ROADMAP.md, next slice "
            "5)")
    if getattr(cfg, "big_x64", False):
        raise NotImplementedError(
            "big_x64 is not ported yet (ROADMAP.md, next slice 6)")
