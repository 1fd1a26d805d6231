"""PFM checkpoint: persist the post-mapping evidence profile so
variant calling can be re-run (different thresholds, -gvcf, -somatic,
-filter ...) without re-mapping the reads.

The reference persists only the INDEX (src/bwt_index.cpp:126-148) and
rebuilds its whole in-RAM PFM (src/main.cpp:372) on every run; at
genome scale mapping dominates wall time, so re-calling from a saved
profile is the SURVEY section-5 "optionally checkpoint the PFM" item.

Format (versioned): <path> = raw little-endian plane dump; <path>.json
= shapes + run stats + sparse maps. Planes are written MATERIALIZED
(post finalize_diffs / device download), so a resumed run starts
exactly where calling starts.
"""
from __future__ import annotations

import json
import os
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from .engine import MappingEngine

VERSION = 1
_PLANES = ("acgt", "multi_hit", "read_count", "F1", "R2", "F2", "R1")


def save_pfm(engine: "MappingEngine", path: str) -> None:
    """Write the engine's materialized profile + calling-relevant run
    stats. Must be called after engine.finalize(); downloads device
    planes first if evidence is device-resident."""
    engine.materialize_profile()
    p = engine.profile
    st = engine.stats
    meta = {
        "version": VERSION,
        "genome_size": p.n,
        "planes": [],
        "break_point": {str(k): v for k, v in p.break_point.items()},
        "insert_map": {str(k): v for k, v in p.insert_map.items()},
        "delete_map": {str(k): v for k, v in p.delete_map.items()},
        "inv_sites": engine.inv_sites,
        "tnl_sites": engine.tnl_sites,
        "stats": {
            "total_reads": st.total_reads,
            "total_mapped": st.total_mapped,
            "total_paired": st.total_paired,
            "total_paired_distance": st.total_paired_distance,
            "read_length_sum": st.read_length_sum,
            "avg_dist": st.avg_dist,
            "avg_cov": st.avg_cov,
            "avg_read_length": st.avg_read_length,
            "fragment_size": st.fragment_size,
        },
    }
    with open(path + ".tmp", "wb") as f:
        for name in _PLANES:
            arr = np.ascontiguousarray(getattr(p, name), dtype=np.int32)
            meta["planes"].append({"name": name, "shape": list(arr.shape)})
            f.write(arr.tobytes())
    os.rename(path + ".tmp", path)
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def load_pfm(engine: "MappingEngine", path: str) -> None:
    """Restore a saved profile into the engine (in place); the engine
    is then ready for run_calling exactly as if mapping just ran."""
    with open(path + ".json") as f:
        meta = json.load(f)
    if meta.get("version") != VERSION:
        raise ValueError(f"unsupported PFM checkpoint version: "
                         f"{meta.get('version')}")
    p = engine.profile
    if meta["genome_size"] != p.n:
        raise ValueError(f"checkpoint genome size {meta['genome_size']} "
                         f"!= index genome size {p.n}")
    off = 0
    mm = np.memmap(path, dtype=np.int32, mode="r")
    for ent in meta["planes"]:
        n = int(np.prod(ent["shape"]))
        arr = np.asarray(mm[off:off + n]).reshape(ent["shape"])
        getattr(p, ent["name"])[...] = arr
        off += n
    p.break_point = {int(k): v for k, v in meta["break_point"].items()}
    p.insert_map = {int(k): v for k, v in meta["insert_map"].items()}
    p.delete_map = {int(k): v for k, v in meta["delete_map"].items()}
    engine.inv_sites = [tuple(x) for x in meta["inv_sites"]]
    engine.tnl_sites = [tuple(x) for x in meta["tnl_sites"]]
    for k, v in meta["stats"].items():
        setattr(engine.stats, k, v)
    engine.device_evidence = None
    p.host_dirty = True
