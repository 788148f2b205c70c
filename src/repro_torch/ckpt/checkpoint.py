"""Write and read the on-disk index format of ``repro.ckpt.save_index``.

One directory per index: ``index_manifest.json`` (kind, shard count,
static fields, codec), one ``shard_<k>.npz`` per term-range shard
(``term_offsets``, ``doc_ids``, ``values``; a single CSR is the K=1 case)
and ``common.npz`` with the replicated arrays (routing table, range
starts and ends, sub-shard tables, idf, per-doc stats).  This is how an
index crosses between the JAX package and the port, both ways.  A packed
index
(``codec`` in the manifest) stores its packed sidecars per shard and no
fences; the fences are rebuilt from the packed tile metadata.  Saves
record the reference's ``ckpt.save_index`` span and its
``seine_index_saves_total`` / ``seine_ckpt_write_errors_total``
counters.

Training checkpoints (``save_checkpoint`` / ``restore_checkpoint``) use
the reference's format too: ``<dir>/ckpt_<step:010d>/`` holding
``arrays.npz`` (one array per leaf, named by its path in the tree:
dict keys sorted, list items by position, ``/``-joined, as
``jax.tree_util.tree_flatten_with_path`` names them) and
``manifest.json`` (``step``, ``names``, ``extra``, ``time``), kept to
the newest ``keep``; either package restores the other's.  A bfloat16
leaf is stored as the reference's ``np.savez`` stores an
``ml_dtypes.bfloat16`` array: numpy's raw two-byte type ``|V2`` holding
the bf16 bits.
"""
from __future__ import annotations

import glob
import itertools
import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from .. import obs
from .. import tree as T
from ..convert import index_from_arrays
from ..core.codec import validate_codec
from ..kernels.utils import resolve_device

INDEX_MANIFEST = "index_manifest.json"


_ASYNC_THREADS: List[threading.Thread] = []
_ASYNC_ERRORS: List[BaseException] = []
_LOCK = threading.Lock()
_SEQ = itertools.count()
_IN_FLIGHT: Set[str] = set()        # this process's unpublished tmp dirs
_PUBLISH = threading.Lock()         # one ckpt or index publish at a time
_log = obs.get_logger("repro.ckpt")


def _spawn_async(write) -> None:
    """Run ``write`` on a daemon thread, keeping any failure for
    :func:`wait_async` to raise: a background writer never fails
    silently (the obs error counter records it; the join surfaces it)."""
    def run():
        try:
            write()
        except BaseException as e:
            with _LOCK:
                _ASYNC_ERRORS.append(e)
    t = threading.Thread(target=run, daemon=True)
    t.start()
    with _LOCK:
        _ASYNC_THREADS.append(t)


def wait_async() -> None:
    """Join every background writer; raise the first failure kept."""
    with _LOCK:
        threads = list(_ASYNC_THREADS)
        _ASYNC_THREADS.clear()
    for t in threads:
        t.join()
    with _LOCK:
        err = _ASYNC_ERRORS[0] if _ASYNC_ERRORS else None
        _ASYNC_ERRORS.clear()
    if err is not None:
        raise err


def _unique_sibling(index_dir: str, kind: str) -> str:
    """``<dir>.<kind><pid>.<n>``: a name no other write of this process
    or of another process shares (the reference's ``<dir>.tmp<pid>``
    lets two writes of one process publish into each other)."""
    with _LOCK:
        n = next(_SEQ)
    return f"{index_dir.rstrip('/')}.{kind}{os.getpid()}.{n}"


def save_index(index_dir: str, index: Any, *,
               async_write: bool = False) -> str:
    """Persist a port index (single CSR or partitioned, raw or packed) in
    the reference's layout, so ``repro.ckpt.load_index`` reads it: one
    ``shard_<k>.npz`` per term-range shard, ``common.npz`` and the
    manifest; fences are not stored (the loaders rebuild them).

    Published through a temporary directory and ``os.replace``.  An
    existing ``index_dir`` is first moved aside to ``<dir>.old<pid>.<n>``,
    so a writer stopped mid-overwrite leaves the previous index
    recoverable (:func:`load_index` falls back to it); a successful
    publish removes every stranded ``.old*`` / ``.tmp*`` sibling except
    the unpublished ones of this process's writes still in flight.  Every
    write has its own temporary name.  The device-to-host copies run on
    the caller's thread; ``async_write=True`` moves the file I/O and the
    publish to a background thread, whose failure is counted on
    ``seine_ckpt_write_errors_total`` and raised by :func:`wait_async`.
    Returns ``index_dir``.

    An index placed on a mesh is saved by every rank of it together:
    its rows or shards are gathered, and once every rank has reached a
    barrier rank 0 writes the same files as the mesh-less save would
    (synchronously, whatever ``async_write`` says); a second barrier
    returns when the index is published."""
    from ..core.index import SegmentInvertedIndex
    from ..dist.partition import PartitionedIndex, _host

    if getattr(index, "placement", None) is not None:
        import torch.distributed as dist

        from ..dist.collective import barrier
        from ..dist.sharding import gather_index
        whole = gather_index(index)
        barrier()
        if dist.get_rank() == 0:
            save_index(index_dir, whole)
        barrier()
        return index_dir
    os.makedirs(os.path.dirname(index_dir) or ".", exist_ok=True)
    if isinstance(index, PartitionedIndex):
        kind, n_shards = "partitioned", index.n_shards
        common = {"term_to_shard": index.term_to_shard,
                  "range_lo": index.range_lo}
        for name in ("range_hi", "split_term", "split_doc"):
            if getattr(index, name) is not None:
                common[name] = getattr(index, name)
        posting = {n: getattr(index, n) for n in (
            "doc_ids", "values", "packed_words", "tile_bits", "tile_base",
            "tile_word_off", "values_q", "value_scale")}
        shards = [dict({"term_offsets": _host(index.term_offsets[k])},
                       **{n: _host(a[k]) for n, a in posting.items()
                          if a is not None})
                  for k in range(n_shards)]
    elif isinstance(index, SegmentInvertedIndex):
        kind, n_shards = "segment", 1
        common = {}
        shards = [{n: _host(getattr(index, n))
                   for n in ("term_offsets", "doc_ids", "values")}]
    else:
        raise TypeError(f"cannot save index of type {type(index).__name__}")
    common.update(idf=index.idf, doc_len=index.doc_len,
                  seg_len=index.seg_len)
    common = {n: _host(a) for n, a in common.items()}
    manifest = {
        "kind": kind, "n_shards": int(n_shards),
        "n_docs": int(index.n_docs), "vocab_size": int(index.vocab_size),
        "n_b": int(index.n_b), "functions": list(index.functions),
        "time": time.time(),
    }
    codec = getattr(index, "codec", "none")
    if codec != "none":
        manifest.update(codec=codec, codec_tile=int(index.codec_tile),
                        max_tile_words=int(index.max_tile_words),
                        codec_spans=[int(s) for s in index.codec_spans])
    tmp = _unique_sibling(index_dir, "tmp")
    with _LOCK:
        _IN_FLIGHT.add(tmp)

    def write():
        try:
            with obs.span("ckpt.save_index"):
                os.makedirs(tmp, exist_ok=True)
                for k, arrays in enumerate(shards):
                    np.savez(os.path.join(tmp, f"shard_{k:05d}.npz"),
                             **arrays)
                np.savez(os.path.join(tmp, "common.npz"), **common)
                with open(os.path.join(tmp, INDEX_MANIFEST), "w") as f:
                    json.dump(manifest, f)
                # one publish at a time: the existence check, both
                # replaces and the sweep, so two writers never move each
                # other's directory away between the check and a replace
                with _PUBLISH:
                    _publish_index(tmp, index_dir)
            obs.counter("seine_index_saves_total",
                        "index dir publishes").inc()
        except BaseException as e:
            obs.counter("seine_ckpt_write_errors_total",
                        "failed (a)sync ckpt/index writes").inc()
            _log.error("index save failed", path=index_dir, err=repr(e))
            raise
        finally:
            with _LOCK:
                _IN_FLIGHT.discard(tmp)

    if async_write:
        _spawn_async(write)
    else:
        write()
    return index_dir


def _publish_index(tmp: str, index_dir: str) -> None:
    """``tmp`` becomes ``index_dir`` (the caller holds ``_PUBLISH``)."""
    if not os.path.exists(index_dir):
        os.replace(tmp, index_dir)                  # atomic publish
        return
    # move the live index aside before publishing, so a writer stopped
    # between the two replaces leaves it recoverable at <dir>.old*
    old = _unique_sibling(index_dir, "old")
    os.replace(index_dir, old)
    os.replace(tmp, index_dir)
    # list the siblings before reading which writes are in flight: a
    # write's name joins _IN_FLIGHT before its directory exists, so every
    # unpublished directory listed here is in the set read after it
    siblings = (glob.glob(index_dir.rstrip("/") + ".old*")
                + glob.glob(index_dir.rstrip("/") + ".tmp*"))
    with _LOCK:
        _IN_FLIGHT.discard(tmp)
        keep = set(_IN_FLIGHT)
    for stale in siblings:
        if stale not in keep:
            shutil.rmtree(stale, ignore_errors=True)


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


# ---------------------------------------------------------------------------
# training checkpoints
# ---------------------------------------------------------------------------

def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt_{step:010d}")


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, *,
                    extra: Optional[Dict] = None, keep: int = 3,
                    async_write: bool = False) -> str:
    """Write ``tree`` (a ParamTree, an optimizer state, or nested dicts
    and lists of tensors) as checkpoint ``step`` and keep the newest
    ``keep``.  Returns the checkpoint's path.

    Every leaf is copied to the host on the caller's thread, so later
    in-place updates of the parameters never reach the files.  The write
    goes to a directory of its own (``<path>.tmp<pid>.<n>``: two saves
    of one step never share it) and is published with ``os.replace``,
    one publish at a time; a checkpoint already at the path is moved
    aside first and removed after.  ``async_write=True`` moves the file
    I/O and the publish to a background thread, whose failure is counted
    on ``seine_ckpt_write_errors_total`` and raised by
    :func:`wait_async`."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = T.flatten_with_paths(tree)
    arrays = {name: _to_numpy(leaf) for name, leaf in flat}
    manifest = {
        "step": int(step),
        "names": [n for n, _ in flat],
        "extra": extra or {},
        "time": time.time(),
    }
    final = _step_dir(ckpt_dir, step)
    tmp = _unique_sibling(final, "tmp")

    def write():
        try:
            with obs.span("ckpt.save"):
                os.makedirs(tmp)
                np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                with _PUBLISH:
                    old = None
                    if os.path.exists(final):
                        old = _unique_sibling(final, "old")
                        os.replace(final, old)
                    os.replace(tmp, final)          # atomic publish
                    if old is not None:
                        shutil.rmtree(old, ignore_errors=True)
                    _retain(ckpt_dir, keep)
            obs.counter("seine_ckpt_saves_total",
                        "checkpoint publishes").inc()
        except BaseException as e:
            obs.counter("seine_ckpt_write_errors_total",
                        "failed (a)sync ckpt/index writes").inc()
            _log.error("checkpoint write failed", path=final, err=repr(e))
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    if async_write:
        _spawn_async(write)
    else:
        write()
    return final


def _to_numpy(leaf) -> np.ndarray:
    """A host copy of a leaf; bfloat16 (which numpy lacks) as ``|V2``
    holding its bits, as the reference writes it."""
    t = torch.as_tensor(leaf).detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A stored leaf as a tensor: ``|V2`` as the bfloat16 of its bits."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _retain(ckpt_dir: str, keep: int) -> None:
    for s in all_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)


def all_steps(ckpt_dir: str) -> List[int]:
    """The published checkpoints' steps, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for n in os.listdir(ckpt_dir):
        m = re.fullmatch(r"ckpt_(\d{10})", n)
        if m and os.path.exists(os.path.join(ckpt_dir, n, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, target: Any, *,
                       step: Optional[int] = None,
                       shardings: Any = None) -> Tuple[Any, Dict]:
    """Read checkpoint ``step`` (default: the latest) into the structure
    of ``target``: returns ``(tree, manifest)``, the tree's containers
    plain dicts and lists (a ParamTree read as a dict; see
    ``repro_torch.tree.assign``) and each leaf a tensor of the target
    leaf's dtype on its device.  A leaf missing from the checkpoint
    raises ``KeyError``, a shape that differs ``ValueError``.

    ``shardings``: a tree of ``dist.sharding.NamedSharding`` matching
    ``target`` (e.g. ``tree_shardings``' result), on a mesh of any shape
    (reshard-on-load).  Every leaf then comes back as a DTensor on that
    mesh, of the stored dtype, built from this rank's slice of the
    stored array (no collective): its ``full_tensor()`` is the saved
    leaf, bitwise, on every rank."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = _step_dir(ckpt_dir, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    shard_flat = None if shardings is None else T.leaves(shardings)
    leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, (name, leaf) in enumerate(T.flatten_with_paths(target)):
            if name not in data:
                raise KeyError(f"checkpoint missing leaf {name}")
            arr = data[name]
            want = tuple(np.shape(leaf)) if not isinstance(
                leaf, torch.Tensor) else tuple(leaf.shape)
            if tuple(arr.shape) != want:
                raise ValueError(f"shape mismatch for {name}: "
                                 f"{arr.shape} vs {want}")
            t = _from_numpy(arr)
            if shard_flat is not None:
                t = _place_leaf(t, shard_flat[i])
            elif isinstance(leaf, torch.Tensor):
                t = t.to(device=leaf.device, dtype=leaf.dtype)
            leaves.append(t)
    return T.unflatten(target, leaves), manifest


def _place_leaf(t: torch.Tensor, sharding) -> torch.Tensor:
    """A DTensor of the whole ``t`` laid out by ``sharding`` (a
    ``dist.sharding.NamedSharding``), from this rank's slice."""
    from torch.distributed.tensor import DTensor

    from ..launch.mesh import mesh_device
    local = sharding.local_slice(t).to(mesh_device(sharding.mesh))
    return DTensor.from_local(local.contiguous(), sharding.mesh,
                              sharding.placements, run_check=False,
                              shape=t.shape, stride=t.stride())
