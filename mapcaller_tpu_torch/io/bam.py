"""BAM output: BGZF container + BAM record encoding.

The reference links all of htslib but uses it only to re-encode its own
SAM strings as BAM (ref: src/ReadMapping.cpp:95,121,550-557,603,701,765
-- sam_parse1 + sam_write1 on each generated SAM line). Here the same
contract is ~250 lines: a BGZF block writer and a SAM-line -> BAM-record
encoder (SAMv1 spec section 4). Output is readable by samtools/pysam.
"""
from __future__ import annotations

import struct
import zlib
from typing import List

from ..genome import Genome

# BGZF constants (SAMv1 spec 4.1)
_BGZF_MAX_PAYLOAD = 0xFF00          # htslib's block payload cap
_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

_CIGAR_OPS = "MIDNSHP=X"
_SEQ_NIBBLE = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}


def _bgzf_block(payload: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = co.compress(payload) + co.flush()
    bsize = len(cdata) + 25 + 1     # header(12)+XLEN extra(6)+CRC(4)+ISIZE(4)
    if bsize > 0x10000:
        raise ValueError("BGZF block too large")
    # gzip member header: magic, CM=8, FLG=4(FEXTRA), MTIME=0, XFL=0,
    # OS=0xFF, XLEN=6, extra subfield BC with BSIZE = block size - 1
    head = (struct.pack("<4B", 0x1F, 0x8B, 8, 4) + struct.pack("<I", 0)
            + struct.pack("<2B", 0, 0xFF) + struct.pack("<H", 6)
            + b"BC" + struct.pack("<H", 2) + struct.pack("<H", bsize - 1))
    tail = struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                       len(payload) & 0xFFFFFFFF)
    return head + cdata + tail


class BgzfWriter:
    def __init__(self, path: str):
        self._fh = open(path, "wb")
        self._buf = bytearray()

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= _BGZF_MAX_PAYLOAD:
            self._fh.write(_bgzf_block(bytes(self._buf[:_BGZF_MAX_PAYLOAD])))
            del self._buf[:_BGZF_MAX_PAYLOAD]

    def close(self) -> None:
        if self._fh.closed:
            return
        if self._buf:
            self._fh.write(_bgzf_block(bytes(self._buf)))
            self._buf.clear()
        self._fh.write(_BGZF_EOF)
        self._fh.close()


def reg2bin(beg: int, end: int) -> int:
    """UCSC binning (SAMv1 spec 5.3)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _encode_int_tag(tag: bytes, v: int) -> bytes:
    """Smallest-width integer encoding, as htslib's sam_parse1 does."""
    if 0 <= v <= 0xFF:
        return tag + b"C" + struct.pack("<B", v)
    if -0x80 <= v < 0:
        return tag + b"c" + struct.pack("<b", v)
    if 0 <= v <= 0xFFFF:
        return tag + b"S" + struct.pack("<H", v)
    if -0x8000 <= v < 0:
        return tag + b"s" + struct.pack("<h", v)
    if v >= 0:
        return tag + b"I" + struct.pack("<I", v)
    return tag + b"i" + struct.pack("<i", v)


def _parse_cigar(cig: str) -> List[int]:
    ops: List[int] = []
    n = 0
    for ch in cig:
        if ch.isdigit():
            n = n * 10 + ord(ch) - 48
        else:
            ops.append((n << 4) | _CIGAR_OPS.index(ch))
            n = 0
    return ops


def encode_bam_record(line: str, name_to_id: dict) -> bytes:
    """One SAM text line -> one BAM alignment record (without the
    leading block_size word prepended by the caller)."""
    f = line.rstrip("\n").split("\t")
    qname, flag, rname, pos, mapq = f[0], int(f[1]), f[2], int(f[3]), int(f[4])
    cigar, rnext, pnext, tlen, seq, qual = f[5], f[6], int(f[7]), int(f[8]), f[9], f[10]

    ref_id = name_to_id.get(rname, -1)
    next_id = ref_id if rnext == "=" else name_to_id.get(rnext, -1)
    pos0 = pos - 1
    next0 = pnext - 1
    cig_ops = _parse_cigar(cigar) if cigar != "*" else []
    ref_span = sum(op >> 4 for op in cig_ops
                   if (op & 0xF) in (0, 2, 3, 7, 8)) or 1
    bin_ = reg2bin(pos0, pos0 + ref_span) if pos0 >= 0 else 4680
    l_seq = 0 if seq == "*" else len(seq)

    name_b = qname.encode() + b"\0"
    rec = bytearray()
    rec += struct.pack("<iiBBHHHiiii", ref_id, pos0, len(name_b), mapq, bin_,
                       len(cig_ops), flag, l_seq, next_id, next0, tlen)
    rec += name_b
    rec += struct.pack(f"<{len(cig_ops)}I", *cig_ops)
    if l_seq:
        nib = bytearray((l_seq + 1) // 2)
        for i, ch in enumerate(seq):
            v = _SEQ_NIBBLE.get(ch.upper(), 15)
            if i & 1:
                nib[i >> 1] |= v
            else:
                nib[i >> 1] = v << 4
        rec += nib
        if qual == "*":
            rec += b"\xff" * l_seq
        else:
            rec += bytes((ord(c) - 33) & 0xFF for c in qual)
    for tagf in f[11:]:
        tag, typ, val = tagf.split(":", 2)
        tb = tag.encode()
        if typ == "i":
            rec += _encode_int_tag(tb, int(val))
        elif typ == "A":
            rec += tb + b"A" + val[:1].encode()
        elif typ == "f":
            rec += tb + b"f" + struct.pack("<f", float(val))
        elif typ == "Z":
            rec += tb + b"Z" + val.encode() + b"\0"
        # H/B tags unused by the pipeline
    return bytes(rec)


class BamWriter:
    """Streaming BAM writer fed with the pipeline's SAM text lines."""

    def __init__(self, path: str, genome: Genome, header_lines: List[str]):
        self._bgzf = BgzfWriter(path)
        self.name_to_id = {n: i for i, n in enumerate(genome.names)}
        text = ("\n".join(header_lines) + "\n").encode()
        hdr = b"BAM\x01" + struct.pack("<i", len(text)) + text
        hdr += struct.pack("<i", len(genome.names))
        for i, n in enumerate(genome.names):
            nb = n.encode() + b"\0"
            hdr += struct.pack("<i", len(nb)) + nb
            hdr += struct.pack("<i", int(genome.lengths[i]))
        self._bgzf.write(hdr)

    def write_sam_line(self, line: str) -> None:
        rec = encode_bam_record(line, self.name_to_id)
        self._bgzf.write(struct.pack("<i", len(rec)) + rec)

    def close(self) -> None:
        self._bgzf.close()


def read_bam(path: str):
    """Minimal BAM reader (tests/validation only): returns
    (header_text, ref_names, records as SAM-ish tuples)."""
    import gzip
    with gzip.open(path, "rb") as fh:
        data = fh.read()
    assert data[:4] == b"BAM\x01", "bad magic"
    off = 4
    (l_text,) = struct.unpack_from("<i", data, off); off += 4
    text = data[off:off + l_text].decode(); off += l_text
    (n_ref,) = struct.unpack_from("<i", data, off); off += 4
    names = []
    for _ in range(n_ref):
        (ln,) = struct.unpack_from("<i", data, off); off += 4
        names.append(data[off:off + ln - 1].decode()); off += ln
        off += 4
    recs = []
    while off < len(data):
        (bs,) = struct.unpack_from("<i", data, off); off += 4
        end = off + bs
        (ref_id, pos0, lrn, mapq, _bin, ncig, flag, l_seq, nref, npos,
         tlen) = struct.unpack_from("<iiBBHHHiiii", data, off)
        off += 32
        qname = data[off:off + lrn - 1].decode(); off += lrn
        cig = struct.unpack_from(f"<{ncig}I", data, off); off += 4 * ncig
        cigar = "".join(f"{op >> 4}{_CIGAR_OPS[op & 0xF]}" for op in cig) or "*"
        nib = data[off:off + (l_seq + 1) // 2]; off += (l_seq + 1) // 2
        seq = ""
        for i in range(l_seq):
            v = (nib[i >> 1] >> 4) if i % 2 == 0 else (nib[i >> 1] & 0xF)
            seq += "=ACMGRSVTWYHKDBN"[v]
        qb = data[off:off + l_seq]; off += l_seq
        qual = ("*" if (l_seq and qb[0] == 0xFF) or not l_seq
                else "".join(chr(q + 33) for q in qb))
        tags = {}
        while off < end:
            tag = data[off:off + 2].decode(); typ = chr(data[off + 2]); off += 3
            if typ in "cC":
                v = struct.unpack_from("<b" if typ == "c" else "<B", data, off)[0]; off += 1
            elif typ in "sS":
                v = struct.unpack_from("<h" if typ == "s" else "<H", data, off)[0]; off += 2
            elif typ in "iI":
                v = struct.unpack_from("<i" if typ == "i" else "<I", data, off)[0]; off += 4
            elif typ == "f":
                v = struct.unpack_from("<f", data, off)[0]; off += 4
            elif typ == "A":
                v = chr(data[off]); off += 1
            elif typ == "Z":
                z = data.index(b"\0", off); v = data[off:z].decode(); off = z + 1
            else:
                raise ValueError(f"tag type {typ} unsupported")
            tags[tag] = v
        recs.append((qname, flag, ref_id, pos0 + 1, mapq, cigar, nref, npos + 1,
                     tlen, seq if l_seq else "*", qual, tags))
    return text, names, recs
