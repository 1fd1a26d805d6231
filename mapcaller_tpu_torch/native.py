"""ctypes bindings for the native C++ chunk processor (csrc/mc_native.cpp).

The native runtime owns the post-seeding per-read pipeline (chaining ->
pairing -> rescue -> gapped alignment -> SAM -> PFM update); the device
code (PyTorch, plus the CUDA NW and ksw2 kernels) provides the seeds and
the DP batches; Python orchestrates chunks and owns the variant caller.

The library is compiled at first use into the port's git-ignored build
directory (toolchain.py).
"""
from __future__ import annotations

import ctypes as C
import os
from typing import Optional, Tuple

import numpy as np

from .toolchain import ensure_native


_lib = None


def load_lib():
    global _lib
    if _lib is None:
        lib = C.CDLL(ensure_native())
        lib.mc_create.restype = C.c_void_p
        lib.mc_create.argtypes = [C.c_char_p, C.c_int64, C.c_void_p, C.c_void_p,
                                  C.c_int32, C.c_char_p, C.c_void_p, C.c_void_p,
                                  C.c_int32]
        lib.mc_destroy.argtypes = [C.c_void_p]
        lib.mc_set_profile.argtypes = [C.c_void_p] + [C.c_void_p] * 10
        lib.mc_configure.argtypes = [C.c_void_p, C.c_int32, C.c_double,
                                     C.c_int32, C.c_int32, C.c_int32, C.c_int32,
                                     C.c_int32, C.c_int32, C.c_int32]
        lib.mc_process_chunk.argtypes = [
            C.c_void_p, C.c_int32, C.c_int32, C.c_char_p, C.c_char_p,
            C.c_char_p, C.c_void_p, C.c_void_p, C.c_void_p, C.c_void_p,
            C.c_void_p, C.c_int64, C.c_void_p]
        lib.mc_fetch.argtypes = [C.c_void_p] + [C.c_void_p] * 9
        lib.mc_event_seq_total.restype = C.c_int64
        lib.mc_event_seq_total.argtypes = [C.c_void_p]
        lib.mc_set_input.argtypes = [C.c_void_p, C.c_char_p, C.c_int64,
                                     C.c_char_p, C.c_int64, C.c_int32]
        lib.mc_next_batch.restype = C.c_int32
        lib.mc_next_batch.argtypes = [C.c_void_p, C.c_int32, C.c_int32,
                                      C.c_void_p]
        lib.mc_parser_slots.restype = C.c_int32
        lib.mc_parser_slots.argtypes = []
        lib.mc_slot_release.argtypes = [C.c_void_p, C.c_int32]
        lib.mc_batch_codes.argtypes = [C.c_void_p, C.c_int32, C.c_void_p,
                                       C.c_void_p, C.c_int32, C.c_int32]
        lib.mc_batch_codes_packed.argtypes = [C.c_void_p, C.c_int32,
                                              C.c_void_p, C.c_void_p,
                                              C.c_int32, C.c_int32]
        lib.mc_read_seq.restype = C.c_int32
        lib.mc_read_seq.argtypes = [C.c_void_p, C.c_int32, C.c_int32,
                                    C.c_char_p, C.c_int32]
        lib.mc_process_batch.argtypes = [
            C.c_void_p, C.c_int32, C.c_int32, C.c_int32, C.c_void_p,
            C.c_void_p, C.c_void_p, C.c_void_p, C.c_void_p, C.c_void_p]
        lib.mc_process_batch_cls.argtypes = [
            C.c_void_p, C.c_int32, C.c_int32, C.c_int32] + [C.c_void_p] * 11
        lib.mc_set_ops_mode.argtypes = [C.c_void_p, C.c_int32]
        lib.mc_prepare_batch_cls.restype = C.c_int64
        lib.mc_prepare_batch_cls.argtypes = [
            C.c_void_p, C.c_int32, C.c_int32, C.c_int32] + [C.c_void_p] * 9
        lib.mc_dp_sizes.argtypes = [C.c_void_p, C.c_void_p, C.c_void_p]
        lib.mc_dp_fetch.argtypes = [C.c_void_p, C.c_char_p, C.c_char_p]
        lib.mc_dp_put.argtypes = [C.c_void_p, C.c_char_p, C.c_char_p,
                                  C.c_void_p]
        lib.mc_dp_put_ops.argtypes = [C.c_void_p, C.c_void_p, C.c_int32,
                                      C.c_int32]
        lib.mc_finish_batch_cls.argtypes = [C.c_void_p, C.c_void_p,
                                            C.c_void_p]
        lib.mc_fast_bits.argtypes = [C.c_void_p, C.c_void_p, C.c_void_p]
        lib.mc_set_diff_mode.argtypes = [C.c_void_p] + [C.c_void_p] * 6
        lib.mc_host_planes_dirty.argtypes = [C.c_void_p]
        lib.mc_host_planes_dirty.restype = C.c_int32
        lib.mc_reset_run.argtypes = [C.c_void_p]
        lib.mc_nw.argtypes = [C.c_char_p, C.c_char_p, C.c_char_p, C.c_char_p]
        lib.mc_ksw2.argtypes = [C.c_char_p, C.c_char_p, C.c_char_p, C.c_char_p]
        lib.mc_prof_fetch.argtypes = [C.c_void_p]
        lib.mc_prof_enable.argtypes = [C.c_int32]
        lib.mc_set_threads.argtypes = [C.c_void_p, C.c_int32]
        _lib = lib
    return _lib


def nw_align_native(s1: str, s2: str) -> Tuple[str, str]:
    lib = load_lib()
    n = len(s1) + len(s2) + 8
    o1 = C.create_string_buffer(n)
    o2 = C.create_string_buffer(n)
    lib.mc_nw(s1.encode(), s2.encode(), o1, o2)
    return o1.value.decode(), o2.value.decode()


def ksw2_align_native(s1: str, s2: str) -> Tuple[str, str]:
    lib = load_lib()
    n = len(s1) + len(s2) + 8
    o1 = C.create_string_buffer(n)
    o2 = C.create_string_buffer(n)
    lib.mc_ksw2(s1.encode(), s2.encode(), o1, o2)
    return o1.value.decode(), o2.value.decode()


PROF_STAGES = ("build_read", "pair", "align", "profile", "sam", "span",
               "chunks", "reads", "chunks_redone")


def prof_fetch() -> dict:
    """The host leg's stage counters since the last fetch, then zeroes
    them (mc_prof_fetch): nanoseconds of building reads (the two-phase
    leg's DP pair collection included), pairing, alignment, evidence and
    SAM, summed over the threads that ran them, and of the whole chunk
    loop on the calling thread (`span`); the batches' chunks, the reads
    built and the chunks mapped again after a missed speculation.
    Counters are process-wide, shared by every engine, and count only
    while prof_enable has them on."""
    out = np.zeros(len(PROF_STAGES), dtype=np.int64)
    load_lib().mc_prof_fetch(out.ctypes.data_as(C.c_void_p))
    return dict(zip(PROF_STAGES, out.tolist()))


def host_threads(n_threads: int) -> int:
    """Threads the host leg runs a batch's chunks on: -t, cut to the
    cores this process may use."""
    return max(1, min(n_threads, len(os.sched_getaffinity(0))))


def prof_enable(on: bool) -> None:
    """Switch the host leg's stage counters on or off and zero them
    (mc_prof_enable); off, no pair reads the clock. A library not yet
    loaded is left alone: it loads with them off."""
    if _lib is not None:
        _lib.mc_prof_enable(int(on))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(C.c_void_p)


class NativeEngine:
    """Owns the native context; mirrors MappingEngine's chunk contract."""

    def __init__(self, genome, profile, ref_chars: np.ndarray, cfg):
        self.lib = load_lib()
        self.genome = genome
        self.profile = profile
        self.device = cfg.device          # where the device DP batches run
        self._ref_chars = np.ascontiguousarray(ref_chars)  # keep alive
        self._bkeys = np.ascontiguousarray(genome.boundary_keys, dtype=np.int64)
        self._bchrom = np.ascontiguousarray(genome.boundary_chrom, dtype=np.int32)
        names = b"".join(n.encode() + b"\0" for n in genome.names)
        self._lens = np.ascontiguousarray(genome.lengths, dtype=np.int64)
        self._locs = np.ascontiguousarray(genome.fwd_loc, dtype=np.int64)
        self.ctx = self.lib.mc_create(
            self._ref_chars.ctypes.data_as(C.c_char_p),
            C.c_int64(genome.genome_size),
            _ptr(self._bkeys), _ptr(self._bchrom), len(self._bkeys),
            names, _ptr(self._lens), _ptr(self._locs), len(genome.names))
        p = profile
        self.lib.mc_set_profile(self.ctx, _ptr(p.acgt[0]), _ptr(p.acgt[1]),
                                _ptr(p.acgt[2]), _ptr(p.acgt[3]),
                                _ptr(p.multi_hit), _ptr(p.read_count),
                                _ptr(p.F1), _ptr(p.R2), _ptr(p.F2), _ptr(p.R1))
        self.configure(cfg, fastq=True)
        self.threads = host_threads(cfg.n_threads)
        self.lib.mc_set_threads(self.ctx, self.threads)

    def configure(self, cfg, fastq: bool) -> None:
        self.lib.mc_configure(self.ctx, cfg.max_pos_diff,
                              cfg.max_mismatch_rate, cfg.max_clip_size,
                              cfg.max_duplicate, int(cfg.use_nw),
                              int(cfg.unique_only), int(cfg.vcf_output),
                              int(bool(cfg.sam_file or cfg.bam_file)),
                              int(fastq))

    def __del__(self):
        try:
            if self.ctx:
                self.lib.mc_destroy(self.ctx)
        except Exception:
            pass

    def host_planes_dirty(self) -> bool:
        """True once any HOST plane/diff array received evidence (the
        C++ slow path writes them invisibly to Python)."""
        return bool(self.lib.mc_host_planes_dirty(self.ctx))

    def reset_run(self) -> None:
        """Clear per-run accumulators (discord state, fast-bits, DP
        caches, host-dirtiness) so this Ctx can serve another run; the
        borrowed numpy planes are zeroed by MappingEngine.reset_run."""
        self.lib.mc_reset_run(self.ctx)

    def enable_diff_mode(self, profile) -> None:
        """Switch evidence accumulation to O(1)/read diff-array endpoints
        (exact-match coverage, F counters, multi) cumsum'd at finalize;
        only mismatch bases are per-base point adds."""
        profile.alloc_diffs()
        self._diffs = (profile.F1_diff, profile.R2_diff, profile.F2_diff,
                       profile.R1_diff, profile.multi_diff,
                       profile.exact_diff)
        self.lib.mc_set_diff_mode(self.ctx, *(_ptr(d) for d in self._diffs))
        self.diff_mode = True

    # -- stream API: native parsing + double-buffered batches -------------
    def set_input(self, buf1: bytes, buf2: Optional[bytes],
                  pair_interleaved: bool) -> None:
        """Hand raw (decompressed) read-file bytes to the native parser.
        Keeps references so the borrowed buffers stay alive."""
        self._buf1, self._buf2 = buf1, buf2
        self.lib.mc_set_input(self.ctx, buf1, len(buf1),
                              buf2, len(buf2) if buf2 is not None else 0,
                              int(pair_interleaved))

    @property
    def parser_slots(self) -> int:
        """Size of the native parser slot ring (single source of truth)."""
        return int(self.lib.mc_parser_slots())

    def next_batch(self, slot: int, max_reads: int) -> Tuple[int, int]:
        """Parse the next batch into a slot; -> (n_reads, max_rlen).
        The slot stays owned by the in-flight batch until slot_release."""
        maxlen = np.zeros(1, dtype=np.int32)
        n = self.lib.mc_next_batch(self.ctx, slot, max_reads, _ptr(maxlen))
        if n < 0:
            raise RuntimeError(
                f"parser slot {slot} reused while its batch is still in "
                f"flight (ring size {self.parser_slots}); pipeline "
                f"depth x group exceeds the ring")
        return n, int(maxlen[0])

    def slot_release(self, slot: int) -> None:
        """Mark a parsed batch's host read data as no longer in flight."""
        self.lib.mc_slot_release(self.ctx, slot)

    def batch_codes(self, slot: int, bucket: int, cap: int):
        codes = np.empty((cap, bucket), dtype=np.uint8)
        rlens = np.empty(cap, dtype=np.int32)
        self.lib.mc_batch_codes(self.ctx, slot, _ptr(codes), _ptr(rlens),
                                bucket, cap)
        return codes, rlens

    def batch_codes_packed(self, slot: int, bucket: int, cap: int):
        """2-bit packed code matrix (4 bases/byte) + rlens; negative rlen
        = host-fallback read (too long or contains N)."""
        packed = np.empty((cap, bucket // 4), dtype=np.uint8)
        rlens = np.empty(cap, dtype=np.int32)
        self.lib.mc_batch_codes_packed(self.ctx, slot, _ptr(packed),
                                       _ptr(rlens), bucket, cap)
        return packed, rlens

    def read_codes(self, slot: int, i: int) -> np.ndarray:
        """Full codes of one read (too-long-for-bucket fallback)."""
        cap = 1 << 20
        buf = C.create_string_buffer(cap)
        n = self.lib.mc_read_seq(self.ctx, slot, i, buf, cap)
        if n > cap:  # pathological FASTA record longer than 1 MiB
            cap = n
            buf = C.create_string_buffer(cap)
            n = self.lib.mc_read_seq(self.ctx, slot, i, buf, cap)
        from .dna import encode
        return encode(buf.raw[:n].decode())

    def process_batch(self, slot: int, pair_end: bool, fastq: bool,
                      seed_counts: np.ndarray, seed_rpos: np.ndarray,
                      seed_gpos: np.ndarray, seed_len: np.ndarray,
                      stats_io: np.ndarray):
        """Run the post-seeding pipeline over a parsed batch. stats_io
        (int64[6]) carries running totals + avg_dist, updated in place
        per 200-read sub-chunk. Returns (sam_text, stats dict)."""
        sizes = np.zeros(8, dtype=np.int64)
        self.lib.mc_process_batch(
            self.ctx, slot, int(pair_end), int(fastq),
            _ptr(np.ascontiguousarray(seed_counts, dtype=np.int32)),
            _ptr(np.ascontiguousarray(seed_rpos, dtype=np.int32)),
            _ptr(np.ascontiguousarray(seed_gpos, dtype=np.int64)),
            _ptr(np.ascontiguousarray(seed_len, dtype=np.int32)),
            _ptr(stats_io), _ptr(sizes))
        return self._fetch(sizes)

    def process_batch_cls(self, slot: int, pair_end: bool, fastq: bool,
                          cls: np.ndarray, pd: np.ndarray, mm: np.ndarray,
                          rplast: np.ndarray, cscore: np.ndarray,
                          seed_counts: np.ndarray, seed_rpos: np.ndarray,
                          seed_gpos: np.ndarray, seed_len: np.ndarray,
                          stats_io: np.ndarray):
        """Classified-batch variant: FAST/NOCAND reads carry no seeds
        (see ops/chain_device.py); SLOW reads' seeds are in the flat
        arrays as in process_batch."""
        sizes = np.zeros(8, dtype=np.int64)
        self.lib.mc_process_batch_cls(
            self.ctx, slot, int(pair_end), int(fastq),
            _ptr(np.ascontiguousarray(cls, dtype=np.int32)),
            _ptr(np.ascontiguousarray(pd, dtype=np.int64)),
            _ptr(np.ascontiguousarray(mm, dtype=np.int32)),
            _ptr(np.ascontiguousarray(rplast, dtype=np.int32)),
            _ptr(np.ascontiguousarray(cscore, dtype=np.int32)),
            _ptr(np.ascontiguousarray(seed_counts, dtype=np.int32)),
            _ptr(np.ascontiguousarray(seed_rpos, dtype=np.int32)),
            _ptr(np.ascontiguousarray(seed_gpos, dtype=np.int64)),
            _ptr(np.ascontiguousarray(seed_len, dtype=np.int32)),
            _ptr(stats_io), _ptr(sizes))
        return self._fetch(sizes)

    def process_batch_cls_devdp(self, slot: int, pair_end: bool,
                                fastq: bool, cls, pd, mm, rplast, cscore,
                                seed_counts, seed_rpos, seed_gpos, seed_len,
                                stats_io, use_nw: bool, dp_max: int = 160):
        """Two-phase classified batch with the gapped-extension DP batch
        running on `self.device` (the CUDA NW kernel of ops/nw_device.py
        for -alg nw, the CUDA ksw2 kernel of ops/ksw2_device.py for -alg
        ksw2, each bit-identical to its scalar aligner; oversize pairs
        fall back to scalar)."""
        n_dp = self.lib.mc_prepare_batch_cls(
            self.ctx, slot, int(pair_end), int(fastq),
            _ptr(np.ascontiguousarray(cls, dtype=np.int32)),
            _ptr(np.ascontiguousarray(pd, dtype=np.int64)),
            _ptr(np.ascontiguousarray(mm, dtype=np.int32)),
            _ptr(np.ascontiguousarray(rplast, dtype=np.int32)),
            _ptr(np.ascontiguousarray(cscore, dtype=np.int32)),
            _ptr(np.ascontiguousarray(seed_counts, dtype=np.int32)),
            _ptr(np.ascontiguousarray(seed_rpos, dtype=np.int32)),
            _ptr(np.ascontiguousarray(seed_gpos, dtype=np.int64)),
            _ptr(np.ascontiguousarray(seed_len, dtype=np.int32)))
        if n_dp > 0:
            qlens = np.zeros(n_dp, dtype=np.int32)
            tlens = np.zeros(n_dp, dtype=np.int32)
            self.lib.mc_dp_sizes(self.ctx, _ptr(qlens), _ptr(tlens))
            qbuf = C.create_string_buffer(int(qlens.sum()) + 1)
            tbuf = C.create_string_buffer(int(tlens.sum()) + 1)
            self.lib.mc_dp_fetch(self.ctx, qbuf, tbuf)
            # .raw copies the whole buffer: take it once, not per pair
            qraw, traw = qbuf.raw, tbuf.raw
            pairs = []
            qo = to = 0
            for i in range(n_dp):
                pairs.append((qraw[qo:qo + qlens[i]].decode(),
                              traw[to:to + tlens[i]].decode()))
                qo += qlens[i]
                to += tlens[i]
            # per-call size tier: the kernel is sized to the batch's
            # actual longest side instead of dp_max (tiers 32/48/96, else
            # dp_max + 32), so short pairs do not pay for padded cells
            maxlen = int(max(qlens.max(), tlens.max()))
            MN = next((t for t in (32, 48, 96) if t >= maxlen), dp_max + 32)
            if use_nw:
                from .ops.nw_device import nw_align_batch
                words, _scores = nw_align_batch(pairs, M=MN, N=MN,
                                                return_ops=True,
                                                device=self.device)
                mode = 0
            else:
                from .ops.ksw2_device import ksw2_align_batch
                words = ksw2_align_batch(pairs, M=MN, N=MN, return_ops=True,
                                         device=self.device)
                mode = 1
            words = np.ascontiguousarray(words, dtype=np.uint32)
            self.lib.mc_dp_put_ops(self.ctx, _ptr(words),
                                   C.c_int32(words.shape[1]),
                                   C.c_int32(mode))
        sizes = np.zeros(8, dtype=np.int64)
        self.lib.mc_finish_batch_cls(self.ctx, _ptr(stats_io), _ptr(sizes))
        return self._fetch(sizes)

    def set_ops_mode(self, on: bool) -> None:
        """Device-evidence mode: the C++ pipeline emits an op stream +
        duplicate-gate entries instead of touching host planes."""
        self.lib.mc_set_ops_mode(self.ctx, int(on))

    def fetch_fast_bits(self):
        """Admitted-fast-read bitmask for the batch just processed by
        process_batch_cls (unique-mapped + passed the duplicate gate)."""
        nw = np.zeros(1, dtype=np.int64)
        self.lib.mc_fast_bits(self.ctx, _ptr(nw), None)
        fbits = np.zeros(max(int(nw[0]), 1), dtype=np.uint32)
        self.lib.mc_fast_bits(self.ctx, _ptr(nw), _ptr(fbits))
        return fbits

    def process_chunk(self, reads, pair_end: bool, avg_dist: int,
                      seed_counts: np.ndarray, seed_rpos: np.ndarray,
                      seed_gpos: np.ndarray, seed_len: np.ndarray):
        """reads: list of ReadState (mate2 already reverse-complemented).
        Returns (sam_text, stats dict)."""
        n = len(reads)
        seqs = b"\0".join(r.seq.encode() for r in reads) + b"\0"
        quals = b"\0".join((r.qual or "").encode() for r in reads) + b"\0"
        headers = b"\0".join(r.header.encode() for r in reads) + b"\0"
        rlens = np.array([r.rlen for r in reads], dtype=np.int32)
        sizes = np.zeros(8, dtype=np.int64)
        self.lib.mc_process_chunk(
            self.ctx, n, int(pair_end), seqs, quals, headers, _ptr(rlens),
            _ptr(np.ascontiguousarray(seed_counts, dtype=np.int32)),
            _ptr(np.ascontiguousarray(seed_rpos, dtype=np.int32)),
            _ptr(np.ascontiguousarray(seed_gpos, dtype=np.int64)),
            _ptr(np.ascontiguousarray(seed_len, dtype=np.int32)),
            C.c_int64(avg_dist), _ptr(sizes))
        return self._fetch(sizes)

    def _fetch(self, sizes: np.ndarray):
        (mapped, paired, dist_sum, rlen_sum, sam_len, n_ev,
         n_inv, n_tnl) = (int(x) for x in sizes)
        sam_buf = C.create_string_buffer(max(sam_len, 1))
        ev_gpos = np.zeros(max(n_ev, 1), dtype=np.int64)
        ev_kind = np.zeros(max(n_ev, 1), dtype=np.int32)
        ev_slen = np.zeros(max(n_ev, 1), dtype=np.int32)
        seq_total = int(self.lib.mc_event_seq_total(self.ctx))
        ev_seq = C.create_string_buffer(max(seq_total, 1))
        inv_g = np.zeros(max(n_inv, 1), dtype=np.int64)
        inv_d = np.zeros(max(n_inv, 1), dtype=np.int64)
        tnl_g = np.zeros(max(n_tnl, 1), dtype=np.int64)
        tnl_d = np.zeros(max(n_tnl, 1), dtype=np.int64)
        self.lib.mc_fetch(self.ctx, sam_buf, _ptr(ev_gpos), _ptr(ev_kind),
                          _ptr(ev_slen), ev_seq, _ptr(inv_g), _ptr(inv_d),
                          _ptr(tnl_g), _ptr(tnl_d))
        sam_text = sam_buf.raw[:sam_len].decode()
        # merge events into the host maps
        off = 0
        raw = ev_seq.raw
        bp = self.profile.break_point
        ins_m = self.profile.insert_map
        del_m = self.profile.delete_map
        for i in range(n_ev):
            k = int(ev_kind[i])
            g = int(ev_gpos[i])
            ln = int(ev_slen[i])
            if k == 0:
                bp[g] = bp.get(g, 0) + 1
            else:
                s = raw[off:off + ln].decode()
                tbl = ins_m if k == 1 else del_m
                inner = tbl.setdefault(g, {})
                inner[s] = inner.get(s, 0) + 1
            off += ln
        stats = {
            "mapped": mapped, "paired": paired, "dist_sum": dist_sum,
            "rlen_sum": rlen_sum,
            "inv": list(zip(inv_g[:n_inv].tolist(), inv_d[:n_inv].tolist())),
            "tnl": list(zip(tnl_g[:n_tnl].tolist(), tnl_d[:n_tnl].tolist())),
        }
        return sam_text, stats
