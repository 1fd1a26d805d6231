"""`-devices N`: read data parallelism over N replicas of the device
backend (PyTorch port of mapcaller_tpu/parallel/devices.py).

The reference scales out with pthread workers that share one PFM under
mutexes (ref: src/ReadMapping.cpp:735-736, main.cpp:27). Here one process
drives N replicas of pipeline/device_backend.DeviceBackend:

  * the index tables (occ rows, the occ3 table, the SA, the text words)
    are replicated on every replica's device: batches move no data
    between cards until the final plane merge;
  * stream batches are submitted round-robin over the replicas, whole
    transfer groups of them under the stream's default grouped submit
    (one upload and one download a group on its replica); a token is
    (owner, the replica's own token) and is collected on its owner;
    each replica runs the single-card kernels unchanged (tier reruns and
    oracle splices included);
  * the C++ host leg processes batches strictly in submission order
    through the one native engine. This order is what keeps the
    PCR-duplicate gate (a sequential per-start counter, ref:
    AlignmentProfile.cpp:76), the SAM record order and the pairing state
    equal to one device's: the N-replica run writes the one-device run's
    bytes by construction, also where the gate binds;
  * fast-read evidence accumulates in per-replica planes
    (MultiDeviceEvidence); a batch's admit bitmask is reconciled on the
    replica that mapped it, and the planes are summed into replica 0
    once, before the first finalize (integer adds commute, caps apply
    after the sum).

On the card each replica issues on a stream of its own, so replicas on one
card (a device list with repeats) overlap; the chain kernels' look-back
scratch is kept per (device, stream) for that (ops/chain_kernels.py).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..index.fmindex import FMIndex
from ..ops.device_util import device_list, issue_on
from ..pipeline.device_backend import DeviceBackend
from ..pipeline.device_profile import DeviceEvidence


class MultiDeviceBackend:
    """N DeviceBackend replicas with one DeviceBackend's submit/collect
    contract; tokens carry their owner.

    devices: an explicit device list (repeats allowed, as ["cpu"] * 4 in
    the tests or [cuda:0] * 2 on one card); else n_devices (default
    cfg.devices) of cfg.device: the first n visible cards on "cuda",
    raising when fewer are visible, or n CPU replicas."""

    is_multi_device = True
    index_shards = 0
    big_x64 = False

    def __init__(self, idx: FMIndex, cfg: Config,
                 n_devices: Optional[int] = None,
                 devices: Optional[Sequence] = None):
        n = n_devices if n_devices is not None else (
            len(devices) if devices is not None else cfg.devices)
        self.idx = idx
        self.cfg = cfg
        self.devs = device_list(cfg.device, n, devices)
        self.streams = [torch.cuda.Stream(device=d) if d.type == "cuda"
                        else None for d in self.devs]
        self.bes: List[DeviceBackend] = []
        for i, d in enumerate(self.devs):
            with self.on(i):
                self.bes.append(DeviceBackend(idx, cfg, device=d))
        # batches each replica mapped (each member of a transfer group
        # counts), and its transfer groups (submits: an ungrouped batch is
        # a group of one)
        self.batches = [0] * len(self.bes)
        self.groups = [0] * len(self.bes)
        self._rr = 0

    def on(self, i: int):
        """Replica i's stream (and so its device) for the calls inside."""
        return issue_on(self.devs[i], self.streams[i])

    # -- one DeviceBackend's contract surface ----------------------------
    @property
    def n_devices(self) -> int:
        return len(self.bes)

    @property
    def device(self) -> torch.device:
        return self.bes[0].device

    @property
    def BUCKETS(self):
        return self.bes[0].BUCKETS

    @property
    def max_len(self):
        return self.bes[0].max_len

    @property
    def batch(self):
        return self.bes[0].batch

    @property
    def chain_enabled(self):
        return self.bes[0].chain_enabled

    @property
    def _fm3_ok(self):
        return self.bes[0]._fm3_ok

    @property
    def device_evidence_ok(self):
        return all(be.device_evidence_ok for be in self.bes)

    @property
    def n_tier_reruns(self):
        return sum(be.n_tier_reruns for be in self.bes)

    @property
    def n_full_fallbacks(self):
        return sum(be.n_full_fallbacks for be in self.bes)

    @property
    def n_oracle_reads(self):
        return sum(be.n_oracle_reads for be in self.bes)

    @property
    def n_uploads(self):
        return sum(be.n_uploads for be in self.bes)

    @property
    def n_downloads(self):
        return sum(be.n_downloads for be in self.bes)

    @property
    def chain_ctx(self):
        return self.bes[0].chain_ctx

    @property
    def fm(self):
        return self.bes[0].fm

    @property
    def fm3(self):
        return self.bes[0].fm3

    def dp_device_min_pairs(self) -> float:
        return self.bes[0].dp_device_min_pairs()

    # -- round-robin submission, collection on the owner -----------------
    def _next(self, batches: int = 1) -> int:
        i = self._rr
        self._rr = (self._rr + 1) % len(self.bes)
        self.batches[i] += batches
        return i

    def collect_chain(self, token, n: int, read_codes_fn):
        i, inner = token
        with self.on(i):
            return self.bes[i].collect_chain(inner, n, read_codes_fn)

    def submit_chain_group(self, parts, bucket: int, tier: int = 2,
                           evidence=None, pair_end: bool = False):
        """A whole transfer group (or one batch) to the next replica, on
        its stream (one upload and one download of the group there), the
        folded apply on that replica's planes; the member tokens carry the
        owner."""
        i = self._next(len(parts))
        self.groups[i] += 1
        ev = evidence.sub(i) if evidence is not None else None
        with self.on(i):
            tokens, group = self.bes[i].submit_chain_group(
                parts, bucket, tier, ev, pair_end)
        return [(i, t) for t in tokens], group

    @staticmethod
    def resolve_chain_group(group) -> None:
        DeviceBackend.resolve_chain_group(group)

    def submit_packed(self, packed: np.ndarray, rlens: np.ndarray,
                      bucket: int, tier: int = 9):
        i = self._next()
        with self.on(i):
            return (i, self.bes[i].submit_packed(packed, rlens, bucket,
                                                 tier))

    def collect_packed(self, token, n: int, read_codes_fn):
        i, inner = token
        with self.on(i):
            return self.bes[i].collect_packed(inner, n, read_codes_fn)

    # -- the non-native path's lists of reads ----------------------------
    def submit(self, codes_list: List[np.ndarray]):
        pending = []
        B = self.batch
        for lo in range(0, len(codes_list), B):
            i = self._next()
            with self.on(i):
                pending.append((i, self.bes[i]._submit_one(
                    codes_list[lo:lo + B])))
        return pending

    def collect(self, pending) -> List[tuple]:
        out: List[tuple] = []
        for i, item in pending:
            with self.on(i):
                out.extend(self.bes[i]._collect_one(item))
        return out

    def seed_batch(self, codes_list: List[np.ndarray]) -> List[tuple]:
        return self.collect(self.submit(codes_list))

    def synchronize(self) -> None:
        """Wait for every replica's stream."""
        for s in self.streams:
            if s is not None:
                s.synchronize()


class MultiDeviceEvidence:
    """Evidence planes on every replica: a DeviceEvidence each. A batch
    is reconciled (or applied) on the replica that mapped it; finalize,
    the caller scan, the column fetch, the gVCF blocks and the downloads
    run on replica 0's, after every other replica's planes are added into
    replica 0's in place, once, and freed. The planes are integer adds of
    +1/-1 diff endpoints and point counts, and the caps apply after the
    sum, so the merged planes equal one device's in every word (ref caps:
    AlignmentProfile.cpp:41)."""

    def __init__(self, mbe: MultiDeviceBackend, cfg, host_profile):
        # the planes are allocated on each device's current stream, which
        # finalize and calling use; each replica's stream waits for their
        # zeroing before its first apply
        self.mbe = mbe
        self.reps = [DeviceEvidence(be, cfg, host_profile)
                     for be in mbe.bes]
        for d, s in zip(mbe.devs, mbe.streams):
            if s is not None:
                s.wait_stream(torch.cuda.current_stream(d))
        self._merged = False

    def sub(self, i: int) -> DeviceEvidence:
        """Replica i's evidence (the folded apply of its dispatches)."""
        return self.reps[i]

    def reconcile_batch(self, token, fast_bits: np.ndarray,
                        pair_end: bool) -> None:
        i, inner = token
        with self.mbe.on(i):
            self.reps[i].reconcile_batch(inner, fast_bits, pair_end)

    def apply_batch(self, token, fast_bits: np.ndarray,
                    pair_end: bool) -> None:
        i, inner = token
        with self.mbe.on(i):
            self.reps[i].apply_batch(inner, fast_bits, pair_end)

    def _merged_rep0(self) -> DeviceEvidence:
        """Replica 0's evidence, every other replica's planes added into
        it once; the replicas' streams are drained first, so the sum reads
        their last batch and nothing writes a plane after it."""
        rep0 = self.reps[0]
        if not self._merged:
            self._merged = True
            self.mbe.synchronize()
            for r in self.reps[1:]:
                for name in ("acgt", "exact_diff", "f_diff", "multi_diff"):
                    getattr(rep0.planes, name).add_(
                        getattr(r.planes, name).to(rep0.device))
                r.planes = None
        return rep0

    @property
    def planes(self):
        return self._merged_rep0().planes

    def finalize(self):
        return self._merged_rep0().finalize()

    def start_scan(self) -> None:
        self._merged_rep0().start_scan()

    def scan(self):
        return self._merged_rep0().scan()

    def fetch_columns(self, positions, prefix_pts, bd_blocks=None):
        return self._merged_rep0().fetch_columns(positions, prefix_pts,
                                                 bd_blocks)

    def nor_blocks(self, emitted, brk):
        return self._merged_rep0().nor_blocks(emitted, brk)

    def download_raw_into(self, profile) -> None:
        self._merged_rep0().download_raw_into(profile)

    def download_into(self, profile) -> None:
        self._merged_rep0().download_into(profile)
