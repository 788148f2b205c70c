"""The ranks of the port's mesh tests (tests/test_torch_mesh.py), spawned
as processes of a gloo world on a ``FileStore``.

A test writes its inputs into a work directory (indexes through
``save_index``, KNRM weights, requests, a decode cache, a checkpoint and
``tasks.json``) and calls :func:`run_worlds`; each rank joins the world,
runs the tasks on the meshes they name and writes what it got to
``rank<r>.npz`` (or its traceback to ``rank<r>.err``).  This module
imports only torch and the port, so a rank starts in a few seconds; it
takes one CPU thread, as ``torch_threads`` would give a test process.
"""
import json
import multiprocessing as mp
import os
import time
import traceback
import warnings

import numpy as np
import torch

TIMEOUT_S = 120


def run_worlds(worlds, timeout: float = TIMEOUT_S) -> list:
    """Run each ``(world size, work directory)`` of ``worlds`` at once and
    return, per world, each rank's outputs (a dict of arrays).  Ranks
    still running after ``timeout`` seconds are killed and the call
    fails, so a hung collective never hangs the test run."""
    ctx = mp.get_context("spawn")
    procs = [[ctx.Process(target=rank_main,
                          args=(r, n, os.path.join(work, "store"), work),
                          daemon=True) for r in range(n)]
             for n, work in worlds]
    for p in sum(procs, []):
        p.start()
    deadline = time.monotonic() + timeout
    for p in sum(procs, []):
        p.join(max(deadline - time.monotonic(), 0.1))
    hung = [p.pid for p in sum(procs, []) if p.is_alive()]
    for p in sum(procs, []):
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = {(n, r): open(os.path.join(work, f"rank{r}.err")).read()
              for n, work in worlds for r in range(n)
              if os.path.exists(os.path.join(work, f"rank{r}.err"))}
    codes = [p.exitcode for p in sum(procs, [])]
    if hung or errors or any(codes):
        raise AssertionError(
            f"ranks {hung} still running after {timeout:.0f}s; exit codes "
            f"{codes}; errors: {errors}")
    out = []
    for n, work in worlds:
        ranks = []
        for r in range(n):
            with np.load(os.path.join(work, f"rank{r}.npz")) as z:
                ranks.append({k: z[k] for k in z.files})
        out.append(ranks)
    return out


def rank_main(rank: int, world: int, store: str, work: str) -> None:
    torch.set_num_threads(1)
    warnings.simplefilter("error")        # as pytest.ini's filterwarnings
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        with open(os.path.join(work, "tasks.json")) as f:
            tasks = json.load(f)
        out = {}
        for shape in tasks.get("serve", []):
            out.update(_serve(work, tuple(shape)))
        if tasks.get("build"):
            out.update(_build(work, tuple(tasks["build"])))
        for shape in tasks.get("decode", []):
            out.update(_decode(work, tuple(shape)))
        if tasks.get("restore"):
            out.update(_restore(work, tuple(tasks["restore"])))
        np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
    except BaseException:
        with open(os.path.join(work, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def _mesh(shape):
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(*shape, device="cpu")


def _params(work: str, name: str, index):
    from repro_torch.retrievers import get_retriever
    p = get_retriever("knrm").init(torch.Generator().manual_seed(0),
                                   index.n_b, index.functions,
                                   device="cpu")
    p.load_state_dict(torch.load(os.path.join(work, f"knrm_{name}.pt"),
                                 weights_only=True))
    return p


def requests(work: str, name: str) -> list:
    """The (query, candidates) pairs of index ``name``."""
    with np.load(os.path.join(work, f"requests_{name}.npz")) as z:
        n = len([k for k in z.files if k.startswith("q")])
        return [(z[f"q{i}"], z[f"d{i}"]) for i in range(n)]


def serve_paths(work: str):
    """``{path: (index, params, engine keyword arguments, requests)}``:
    seine_world's index as a single CSR, term-partitioned with the shard
    count left to the mesh and in 4 shards, and the committed K = 4
    hot-term fixture (a term split across shards)."""
    from repro_torch.ckpt import load_index
    here = os.path.dirname(os.path.abspath(__file__))
    world = load_index(os.path.join(work, "world_index"), device="cpu")
    hot = load_index(os.path.join(here, "data", "torch_hot_term_k4"),
                     device="cpu")
    pw, ph = _params(work, "world", world), _params(work, "hot", hot)
    rw, rh = requests(work, "world"), requests(work, "hot")
    return {"single": (world, pw, {}, rw),
            "term": (world, pw, dict(partition="term"), rw),
            "term4": (world, pw, dict(partition="term", n_shards=4), rw),
            "hot": (hot, ph, {}, rh)}


def pair_batch(request):
    """A request as ``lookup_pairs``' (B, Q) terms and (B,) docs."""
    q, d = (torch.as_tensor(np.asarray(a), dtype=torch.int32)
            for a in request)
    return q[None].expand(d.shape[0], -1), d


def _serve(work: str, shape) -> dict:
    from repro_torch.serving import SeineEngine
    mesh = _mesh(shape)
    tag = "x".join(map(str, shape))
    out = {}
    for path, (index, params, kw, reqs) in serve_paths(work).items():
        eng = SeineEngine(index, "knrm", params, mesh=mesh, **kw)
        for i, (q, d) in enumerate(reqs):
            out[f"serve/{tag}/{path}/{i}"] = eng.score(q, d).numpy()
        out[f"pairs/{tag}/{path}"] = eng.index.lookup_pairs(
            *pair_batch(reqs[-1])).numpy()
        pl = eng.index.placement
        out[f"held/{tag}/{path}"] = np.array([pl.lo, pl.hi, len(pl.axes)])
    return out


def corpus_builder():
    """The serve CLI's smoke corpus and an IndexBuilder over it on the
    CPU (the HashProvider drawn from seed 0)."""
    from repro_torch.configs import seine_smoke
    from repro_torch.core.builder import IndexBuilder
    from repro_torch.core.providers import HashProvider
    from repro_torch.core.segment import segment_corpus
    from repro_torch.core.vocab import build_vocabulary
    from repro_torch.data.synth_corpus import generate
    cfg = seine_smoke()
    ds = generate(cfg, seed=0)
    vocab = build_vocabulary(ds.docs, ds.n_raw_tokens)
    toks, segs = segment_corpus([vocab.map_tokens(d) for d in ds.docs],
                                cfg.n_segments, max_len=160)
    provider = HashProvider(vocab.size, cfg.embed_dim,
                            generator=torch.Generator().manual_seed(0),
                            device="cpu")
    return IndexBuilder(cfg, vocab, provider, device="cpu"), toks, segs


BUILD_K = 4
STACKED = ("term_offsets", "doc_ids", "values", "fences")


def _build(work: str, shape) -> dict:
    """build_partitioned on the mesh: this rank's shards against the
    mesh-less build's, and the meshed save_index (rank 0 also saves the
    mesh-less build, for the test to read both back with the
    reference's load_index)."""
    import torch.distributed as dist

    from repro_torch.ckpt import save_index
    builder, toks, segs = corpus_builder()
    plain = builder.build_partitioned(toks, segs, BUILD_K, batch_size=16)
    mesh = _mesh(shape)
    placed = builder.build_partitioned(toks, segs, BUILD_K, batch_size=16,
                                       mesh=mesh)
    pl = placed.placement
    out = {"build/held": np.array([pl.lo, pl.hi])}
    for n in STACKED + ("term_to_shard", "range_lo", "range_hi", "idf",
                        "doc_len", "seg_len"):
        want = getattr(plain, n)
        if n in STACKED:
            want = want[pl.lo:pl.hi]
        out[f"build/equal/{n}"] = np.array(torch.equal(getattr(placed, n),
                                                       want))
    out["build/nnz"] = np.array([placed.nnz, plain.nnz])
    save_index(os.path.join(work, "built_mesh"), placed)
    if dist.get_rank() == 0:
        save_index(os.path.join(work, "built_plain"), plain)
    return out


def _decode(work: str, shape) -> dict:
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.dist.sp_decode import sp_decode_attention
    with np.load(os.path.join(work, "decode.npz")) as z:
        q, k, v, lengths = (torch.from_numpy(z[n])
                            for n in ("q", "k", "v", "lengths"))
    mesh = _mesh(shape)
    tag = "x".join(map(str, shape))
    fn = sp_decode_attention(mesh, "model")
    out = {f"decode/{tag}": fn(q, k, v, lengths).numpy()}
    # the cache as DTensors sharded on the sequence axis over 'model'
    n = shape[1]
    r = mesh.get_local_rank("model")
    s_loc = k.shape[1] // n
    place = [Replicate(), Shard(1)]
    kd, vd = (DTensor.from_local(t[:, r * s_loc:(r + 1) * s_loc], mesh,
                                 place, run_check=False) for t in (k, v))
    out[f"decode/{tag}/dtensor"] = fn(q, kd, vd, lengths).numpy()
    return out


def checkpoint_rules():
    from repro_torch.dist.sharding import P
    return [(r"^w$", P("data", "model")), (r"^e$", P(None, "model")),
            (r"odd$", P("model"))]


def _restore(work: str, shape) -> dict:
    """restore_checkpoint(shardings=) on the mesh: each leaf a DTensor
    whose whole tensor is the saved leaf and whose local part is this
    rank's slice."""
    from repro_torch import tree as T
    from repro_torch.ckpt import restore_checkpoint
    from repro_torch.dist.sharding import tree_shardings
    with np.load(os.path.join(work, "ckpt_leaves.npz")) as z:
        saved = {k: z[k] for k in z.files}
    target = {"w": torch.zeros(8, 6), "e": torch.zeros(2, 4, 3),
              "nest": {"b": torch.zeros(6), "odd": torch.zeros(3)}}
    mesh = _mesh(shape)
    sh = tree_shardings(mesh, target, checkpoint_rules())
    tree, manifest = restore_checkpoint(os.path.join(work, "ckpt"),
                                        target, shardings=sh)
    out = {"restore/step": np.array(manifest["step"])}
    for (name, leaf), (_, s) in zip(T.flatten_with_paths(tree),
                                    T.flatten_with_paths(sh)):
        out[f"restore/full/{name}"] = leaf.full_tensor().numpy()
        out[f"restore/local/{name}"] = np.array(
            torch.equal(leaf.to_local(),
                        s.local_slice(torch.from_numpy(saved[name]))))
        out[f"restore/spec/{name}"] = np.array(repr(s.spec))
    return out
