"""Debug observability: profile-column dumps around a locus
(ref: src/tools.cpp:166-205 ShowProfileColumn / ShowVariationProfile /
ShowIndSeq; the reference accepts -obs/-obr and declares these dumps but
its call sites are commented out — here they are wired up)."""
from __future__ import annotations

import sys
from typing import TextIO

from .genome import Genome
from .pipeline.profile import Profile


def show_profile_column(profile: Profile, ref_chars, g_pos: int,
                        out: TextIO = sys.stdout) -> None:
    """(ref: tools.cpp:171-175)"""
    a, c, g, t = (int(profile.acgt[k, g_pos]) for k in range(4))
    multi = int(profile.multi_hit[g_pos])
    cov = a + c + g + t + multi
    out.write(f"{g_pos}[{chr(ref_chars[g_pos])}]: cov={cov} "
              f"[A={a} C={c} G={g} T={t}] dup={multi}\n")


def show_variation_profile(genome: Genome, profile: Profile, ref_chars,
                           begin_pos: int, end_pos: int,
                           out: TextIO = sys.stdout) -> None:
    """(ref: tools.cpp:177-186)"""
    mid = (begin_pos + end_pos) // 2
    ci, pos = genome.determine_coordinate(mid)
    if end_pos >= genome.genome_size:
        end_pos = genome.genome_size - 1
    out.write(f"{genome.names[ci]}-{pos}\n")
    for g_pos in range(max(begin_pos, 0), end_pos + 1):
        show_profile_column(profile, ref_chars, g_pos, out)
    out.write("\n\n")
    out.flush()


def show_ind_seq(profile: Profile, begin_pos: int, end_pos: int,
                 out: TextIO = sys.stdout) -> None:
    """(ref: tools.cpp:188-205)"""
    for pos in sorted(profile.insert_map.keys()):
        if begin_pos <= pos <= end_pos:
            for seq, freq in sorted(profile.insert_map[pos].items()):
                out.write(f"INS:{pos}\t[{seq}] freq={freq}\n")
    for pos in sorted(profile.delete_map.keys()):
        if begin_pos <= pos < end_pos:
            for seq, freq in sorted(profile.delete_map[pos].items()):
                out.write(f"DEL:{pos}\t{freq}\t[{seq}]\n")


def observe(genome: Genome, profile: Profile, ref_chars, obs_pos: int,
            obr_beg: int, obr_end: int, window: int = 10,
            out: TextIO = sys.stdout) -> None:
    """-obs <pos>: dump the profile window around one locus;
    -obr <beg> <end>: dump a region plus its indel evidence."""
    if obs_pos >= 0:
        show_variation_profile(genome, profile, ref_chars,
                               obs_pos - window, obs_pos + window, out)
        show_ind_seq(profile, obs_pos - window, obs_pos + window, out)
    if obr_beg >= 0 and obr_end >= obr_beg:
        # byte-parity with the reference's re-enabled -obr call site
        # (VariantCalling.cpp:707: Profile[beg-end] header + the
        # ShowVariationProfile dump); the indel-evidence dump follows as
        # an extension after the reference's closing blank lines
        out.write(f"Profile[{obr_beg}-{obr_end}]\n")
        show_variation_profile(genome, profile, ref_chars, obr_beg, obr_end, out)
        show_ind_seq(profile, obr_beg, obr_end, out)
