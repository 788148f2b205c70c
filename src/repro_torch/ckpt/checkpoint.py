"""Read the on-disk index format of ``repro.ckpt.save_index``.

One directory per index: ``index_manifest.json`` (kind, shard count,
static fields, codec), one ``shard_<k>.npz`` per term-range shard
(``term_offsets``, ``doc_ids``, ``values``; a single CSR is the K=1 case)
and ``common.npz`` with the replicated arrays (routing table, range
starts and ends, sub-shard tables, idf, per-doc stats).  This is how an
index built by the JAX package reaches the port.  A packed index
(``codec`` in the manifest) stores its packed sidecars per shard and no
fences; the fences are rebuilt from the packed tile metadata.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict

import numpy as np

from ..convert import index_from_arrays
from ..core.codec import validate_codec
from ..kernels.utils import resolve_device

INDEX_MANIFEST = "index_manifest.json"


def load_index_shard(index_dir: str, k: int) -> Dict[str, np.ndarray]:
    """One shard's local CSR arrays (what a single host restores)."""
    with np.load(os.path.join(index_dir, f"shard_{k:05d}.npz")) as z:
        return {n: z[n] for n in z.files}


def load_index(index_dir: str, device=None):
    """Restore an index saved by ``repro.ckpt.save_index`` onto
    ``device`` (default CUDA).  If ``index_dir`` is missing or
    unpublished but a ``<dir>.old<pid>`` left by a writer preempted
    mid-overwrite exists, the newest such previous index is restored."""
    dev = resolve_device(device)
    if not os.path.exists(os.path.join(index_dir, INDEX_MANIFEST)):
        stranded = glob.glob(index_dir.rstrip("/") + ".old*")
        if stranded:
            # newest by mtime: pids don't sort by age
            index_dir = max(stranded, key=os.path.getmtime)
    with open(os.path.join(index_dir, INDEX_MANIFEST)) as f:
        m = json.load(f)
    codec = validate_codec(m.get("codec"))     # legacy: uncompressed
    with np.load(os.path.join(index_dir, "common.npz")) as z:
        arrays = {n: z[n] for n in z.files}
    if m["kind"] == "segment":
        arrays.update(load_index_shard(index_dir, 0))
    elif m["kind"] == "partitioned":
        shards = [load_index_shard(index_dir, k)
                  for k in range(m["n_shards"])]
        arrays.update({n: np.stack([s[n] for s in shards])
                       for n in shards[0]})
    else:
        raise ValueError(f"{index_dir}: unknown index kind {m['kind']!r}")
    return index_from_arrays(
        arrays, n_docs=m["n_docs"], vocab_size=m["vocab_size"],
        n_b=m["n_b"], functions=m["functions"], device=dev, codec=codec,
        codec_tile=m.get("codec_tile", 0),
        max_tile_words=m.get("max_tile_words", 0),
        codec_spans=m.get("codec_spans", (0, 0)))
