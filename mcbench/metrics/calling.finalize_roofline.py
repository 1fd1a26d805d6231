"""calling.finalize_roofline: the share of its memory roofline that
evidence_finalize_kernel (csrc/calling.cu) reaches, in %: the bytes the
fold must move over the card's HBM rate, over the kernel's mean time a
call in the traced window.

The bytes, from the planes' shapes at genome length L (each input read
once, each output written once): acgt, exact_diff, f_diff and
multi_diff in (4 + 1 + 4 + 1 int32 = 40 B a position), the reference
text's words (8 B a 16 positions), acgt, F, multi and cov out (16 + 16 +
4 + 4 B), the reference codes out (4 B), and the int64 coverage prefix
(8 B a position, L + 1 of them)."""
from mcbench import devtrace


def finalize_bytes(L: int) -> int:
    return 40 * L + 8 * ((L + 15) // 16) + (16 + 16 + 4 + 4 + 4) * L \
        + 8 * (L + 1)


def read(view):
    if view.trace is None or not view.peaks:
        return None
    sec, calls = devtrace.matching(view.trace, ["evidence_finalize_kernel"])
    if not calls or sec <= 0:
        return None
    bound = finalize_bytes(view.genome_length) / view.peaks["hbm_bytes_per_s"]
    return 100.0 * bound / (sec / calls)
