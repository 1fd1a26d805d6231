from .packer import PackedReference, pack_fasta
from .fmindex import FMIndex, build_index, load_index
