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
        for shape in tasks.get("train", []):
            out.update(_train(tuple(shape)))
        if tasks.get("fit"):
            out.update(_fit(work, tuple(tasks["fit"])))
        if tasks.get("mace"):
            out.update(_mace(work, tuple(tasks["mace"])))
        if tasks.get("collectives"):
            out.update(_collectives())
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


# ---------------------------------------------------------------------------
# training under a mesh (tests/test_torch_train_mesh.py)
# ---------------------------------------------------------------------------

LM_SHAPE = dict(name="train_4k", kind="training", seq_len=16,
                global_batch=12)
TRAIN_CASES = (("stablelm-1.6b", "fsdp"), ("stablelm-1.6b", "tp2d"),
               ("granite-moe-3b-a800m", "fsdp"),
               ("granite-moe-3b-a800m", "tp2d"), ("mace", "tp2d"),
               ("dlrm-mlperf", "tp2d"))


def train_cell(arch: str, strategy: str, mesh):
    """A smoke-size training cell of ``arch``, on ``mesh`` or (None)
    mesh-less: the LM at (12, 16), MACE on 3 molecules of 6 atoms padded
    to 512, DLRM's smoke tables at a batch of 24."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps as S
    cfg = configs.smoke(arch)
    if arch == "mace":
        return S._mace_cell(cfg, ShapeConfig(
            name="molecule", kind="batched-small-graphs", n_nodes=6,
            n_edges=10, n_graphs=3), mesh)
    if arch == "dlrm-mlperf":
        return S._recsys_cell(cfg, ShapeConfig(
            name="train_batch", kind="training", batch=24), mesh)
    return S._lm_train_cell(cfg, ShapeConfig(**LM_SHAPE), mesh,
                            strategy=strategy)


def plain_cfg(arch: str):
    from repro_torch import configs
    return configs.smoke(arch)


def _whole(tree) -> list:
    from repro_torch import tree as T
    return [(n, (x.full_tensor() if hasattr(x, "full_tensor") else x)
             .detach().float().numpy())
            for n, x in T.flatten_with_paths(tree)]


def _train(shape) -> dict:
    """Each training case's step on the mesh from the mesh-less cell's
    arguments: its loss, grad norm and Adam moments (the gradients, as
    0.1 g and 0.001 g^2) against the mesh-less step's; then Adam's
    update on the mesh from the mesh-less step's gradients and state
    against the mesh-less update."""
    import copy

    from repro_torch import tree as T
    from repro_torch.train.optimizer import adam
    torch.use_deterministic_algorithms(True)
    mesh = _mesh(shape)
    tag = "x".join(map(str, shape))
    out = {}
    for arch, strategy in TRAIN_CASES:
        key = f"train/{tag}/{arch}/{strategy}"
        plain, placed = train_cell(arch, strategy, None), train_cell(
            arch, strategy, mesh)
        args = plain.make_args("cpu", 0)
        p_ref, o_ref, m_ref = plain.fn(*copy.deepcopy(args))
        p_got, o_got, m_got = placed.fn(*placed.place(copy.deepcopy(args)))
        for name in m_ref:
            out[f"{key}/metric/{name}"] = np.array(
                [float(m_ref[name]), float(m_got[name].full_tensor()
                                           if hasattr(m_got[name],
                                                      "full_tensor")
                                           else m_got[name])])
        for part in ("mu", "nu"):
            for (n, a), (_, b) in zip(_whole(o_ref[part]),
                                      _whole(o_got[part])):
                out[f"{key}/{part}/{n}/ref"] = a
                out[f"{key}/{part}/{n}/got"] = b
        out[f"{key}/placed"] = np.array(sum(
            hasattr(x, "placements") for x in T.leaves(p_got)))
    # a decode step on a placed cache (the sequence over model, the
    # batch over data), granite's MoE and stablelm's dense layers
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps as S
    for arch in ("stablelm-1.6b", "granite-moe-3b-a800m"):
        sh = ShapeConfig(name="decode_32k", kind="inference-decode",
                         seq_len=24, global_batch=4)
        plain = S._lm_decode_cell(configs.smoke(arch), sh, None)
        placed = S._lm_decode_cell(configs.smoke(arch), sh, mesh)
        args = plain.make_args("cpu", 0)
        want = plain.fn(*copy.deepcopy(args))
        got = placed.fn(*placed.place(copy.deepcopy(args)))
        for name, a, b in (("logits", want[0], got[0]),
                           ("k", want[1].k, got[1].k),
                           ("v", want[1].v, got[1].v)):
            out[f"decode/{tag}/{arch}/{name}/ref"] = a.numpy()
            out[f"decode/{tag}/{arch}/{name}/got"] = \
                b.full_tensor().float().numpy()
    # MACE's energies on placed inputs (split over every axis; each rank
    # runs its own nodes and edges)
    from repro_torch.models import mace as MA
    from repro_torch.launch.mesh import set_mesh
    from torch.distributed.tensor.experimental import implicit_replication
    plain = train_cell("mace", "tp2d", None)
    placed = train_cell("mace", "tp2d", mesh)
    params, _, batch = plain.make_args("cpu", 0)
    kw = dict(cfg=plain_cfg("mace"), n_graphs=plain.meta["n_graphs"])
    want = MA.forward(params, **kw, **{k: batch[k] for k in MA.INPUTS})
    pp = placed.place(params, placed.in_shardings[0])
    pb = placed.place(batch, placed.in_shardings[2])
    with set_mesh(mesh), implicit_replication():
        got = MA.forward(pp, **kw, **{k: pb[k] for k in MA.INPUTS})
    out[f"energy/{tag}/ref"] = want.numpy()
    out[f"energy/{tag}/got"] = got.full_tensor().numpy()
    # the update from the same state: random gradients, Adam after one
    # step, on the mesh and mesh-less
    plain = train_cell("stablelm-1.6b", "fsdp", None)
    placed = train_cell("stablelm-1.6b", "fsdp", mesh)
    params, opt_state, _ = plain.make_args("cpu", 1)
    gen = torch.Generator().manual_seed(2)
    grads = T.tree_map(lambda p: torch.randn(p.shape, generator=gen), params)
    opt = adam(3e-4)
    s1 = opt.update(grads, opt_state, params)[1]
    u_ref, _ = opt.update(grads, s1, params)
    pshard = placed.in_shardings[0]
    gp, pp = placed.place(grads, pshard), placed.place(params, pshard)
    sp = placed.place(s1, placed.in_shardings[1])
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication():
        u_got, _ = opt.update(gp, sp, pp)
    for (n, a), (_, b) in zip(_whole(u_ref), _whole(u_got)):
        out[f"update/{tag}/{n}/ref"] = a
        out[f"update/{tag}/{n}/got"] = b
    return out


def _fit(work: str, shape) -> dict:
    """``fit`` of three steps on placed state (the stablelm FSDP cell's
    loss through ``make_train_step``) against the mesh-less ``fit``,
    with a checkpoint at the end; the checkpoint restored onto a mesh of
    another shape, and saved from there again."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.ckpt import restore_checkpoint, save_checkpoint
    from repro_torch.dist.sharding import (P, NamedSharding, lm_param_rules,
                                           tree_shardings)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import lm_batch_axes
    from repro_torch.models import transformer as TF
    from repro_torch.train.loop import TrainState, fit, make_train_step
    from repro_torch.train.optimizer import adam
    mesh = _mesh(shape)
    cfg = configs.smoke("stablelm-1.6b")
    placed = train_cell("stablelm-1.6b", "fsdp", mesh)
    params, opt_state, batch = train_cell(
        "stablelm-1.6b", "fsdp", None).make_args("cpu", 3)
    mb = {k: v[0] for k, v in batch.items()}
    da, seq = lm_batch_axes(mesh, LM_SHAPE["global_batch"], "fsdp")
    mb_sh = {k: NamedSharding(mesh, P(da, seq)) for k in mb}
    out = {}
    for tag in ("plain", "mesh"):
        meshed = tag == "mesh"
        loss = (lambda p, b, g=meshed: TF.lm_loss(
            p, b, cfg, ce_chunks=8, remat=True, gather_layer_weights=g))
        state = TrainState(params, opt_state, None, 0)
        b0 = mb
        if meshed:
            state = TrainState(placed.place(params, placed.in_shardings[0]),
                               placed.place(opt_state,
                                            placed.in_shardings[1]),
                               None, 0)
            b0 = placed.place(mb, mb_sh)
        res = fit(state, make_train_step(loss, adam(3e-4)), lambda i: b0,
                  n_steps=3, verbose=False,
                  ckpt_dir=os.path.join(work, "fit_mesh") if meshed
                  else None)
        out[f"fit/{tag}/loss"] = np.array([h["loss"] for h in res.history])
        for n, a in _whole(res.state.params):
            out[f"fit/{tag}/params/{n}"] = a
    # the meshed checkpoint onto a mesh of another shape, bitwise
    other = make_host_mesh(shape[0] * shape[1], 1, device="cpu")
    sh = {"params": tree_shardings(other, params, lm_param_rules())}
    tree, manifest = restore_checkpoint(os.path.join(work, "fit_mesh"),
                                        {"params": params}, shardings=sh)
    for n, a in _whole(tree):
        out[f"fit/restored/{n}"] = a
    out["fit/restored/step"] = np.array(manifest["step"])
    save_checkpoint(os.path.join(work, "fit_again"), 3, tree)
    out["fit/rank"] = np.array(dist.get_rank())
    return out


# ---------------------------------------------------------------------------
# MACE partitioned on a mesh (tests/test_torch_mace_mesh.py)
# ---------------------------------------------------------------------------

MACE_DTYPES = ("float64", "float32")


def mace_cfg():
    """The smoke MACE at correlation order 3 (every product-basis path)."""
    import dataclasses

    from repro_torch import configs
    return dataclasses.replace(configs.smoke("mace"), correlation_order=3)


def mace_graphs() -> dict:
    """The test graphs, padded by ``launch.steps._mace_cell`` to 1,024
    nodes and 1,536 edges: a random graph of 700 nodes and 1,500 edges
    (its edges cross every rank's block of nodes) and 40 molecules of 13
    atoms (molecules straddle the blocks)."""
    from repro_torch.configs.base import ShapeConfig
    return {"random": ShapeConfig(name="full_graph_sm", kind="full-graph",
                                  n_nodes=700, n_edges=1500),
            "molecules": ShapeConfig(name="molecule",
                                     kind="batched-small-graphs",
                                     n_nodes=13, n_edges=30, n_graphs=40)}


def mace_batch(graph: str) -> dict:
    """``graph``'s batch from seed 3 (numpy), with random force targets."""
    from repro_torch.launch import steps as S
    shape = mace_graphs()[graph]
    cell = S._mace_cell(mace_cfg(), shape, None)
    b = S._mace_batch(mace_cfg(), shape, cell.meta["n_nodes"],
                      cell.meta["n_edges"], seed=3)
    b["forces"] = (np.random.RandomState(4).randn(*b["forces"].shape)
                   * 0.1).astype(np.float32)
    return b


def mace_cast(tree, dtype: str):
    """Every floating tensor of ``tree`` (a dict, list or tensor; numpy
    arrays made tensors) in ``dtype``."""
    from repro_torch import tree as T
    dt = getattr(torch, dtype)

    def cast(x):
        x = torch.as_tensor(np.asarray(x)) if isinstance(x, np.ndarray) else x
        return x.to(dt) if x.is_floating_point() else x
    return T.tree_map(cast, tree)


def _mace(work: str, shape) -> dict:
    """MACE's loss, every gradient, energies and forces on the mesh, the
    parameters (``mace_params.pt``, the reference's draw) and each test
    graph placed as ``_mace_cell`` places them, in float64 and float32;
    this rank's forces with the rows they are, and the collectives'
    launches."""
    from repro_torch import tree as T
    from repro_torch.dist import collective as C
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import axes_group
    from repro_torch.models import mace as MA
    from repro_torch.train.loop import value_and_grad
    torch.use_deterministic_algorithms(True)
    mesh = _mesh(shape)
    tag = "x".join(map(str, shape))
    cfg = mace_cfg()
    params = torch.load(os.path.join(work, "mace_params.pt"),
                        weights_only=True)
    group = axes_group(mesh, mesh.mesh_dim_names)
    out = {}
    for graph, gshape in mace_graphs().items():
        cell = S._mace_cell(cfg, gshape, mesh)
        n_graphs = cell.meta["n_graphs"]
        for dtype in MACE_DTYPES:
            key = f"mace/{tag}/{graph}/{dtype}"
            before = [f.launches for f in (C.all_gather_rows,
                                           C.reduce_scatter_rows,
                                           C.all_reduce_sum)]
            pp = cell.place(mace_cast(params, dtype), cell.in_shardings[0])
            batch = mace_cast(mace_batch(graph), dtype)
            pb = cell.place(batch, cell.in_shardings[2])
            loss, grads = value_and_grad(
                lambda p, b: MA.mace_loss(p, cfg, b, n_graphs), pp, pb)
            out[f"{key}/loss"] = loss.to_local().numpy()
            for n, g in T.flatten_with_paths(grads):
                out[f"{key}/grad/{n}"] = g.to_local().numpy()
                out[f"{key}/whole/{n}"] = np.array(
                    all(p.is_replicate() for p in g.placements))
            with torch.no_grad():
                e, f = MA.energy_and_forces(pp, cfg, n_graphs=n_graphs,
                                            **{k: pb[k] for k in MA.INPUTS})
            out[f"{key}/energy"] = e.to_local().numpy()
            # placed parameters beside plain (whole) inputs
            with torch.no_grad():
                e = MA.forward(pp, cfg, n_graphs=n_graphs,
                               **{k: batch[k] for k in MA.INPUTS})
            out[f"{key}/energy_of_whole_inputs"] = e.to_local().numpy()
            out[f"{key}/forces"] = f.to_local().numpy()
            out[f"{key}/forces_shape"] = np.array(f.shape)
            out[f"{key}/rows"] = np.array(C.row_block(f.shape[0], group))
            out[f"{key}/launches"] = np.array([
                f.launches - b for f, b in zip(
                    (C.all_gather_rows, C.reduce_scatter_rows,
                     C.all_reduce_sum), before)])
    return out


class Parts:
    """The three collectives' test functions of a tensor ``x`` whole on
    every rank (float64): each takes this rank's part through
    ``collective._Broadcast`` (a whole input each rank uses for its part:
    its gradient summed over the group, as a replicated parameter's is)
    and returns a value whole on every rank, with rank-dependent weights
    so each rank's part counts."""

    def __init__(self, group, n: int):
        from repro_torch.dist.collective import row_block
        import torch.distributed as dist
        self.group, self.n = group, n
        self.lo, self.hi = row_block(n, group)
        gen = torch.Generator().manual_seed(11)
        w = dist.get_world_size(group)
        r = dist.get_rank(group)
        self.w = (torch.rand((w, n, 2), generator=gen,
                             dtype=torch.float64) + 0.5)[r]
        self.u = (torch.rand((w, n, 2), generator=gen,
                             dtype=torch.float64) + 0.5)[r]

    def _whole(self, x):
        from repro_torch.dist.collective import _Broadcast
        return _Broadcast.apply(x, self.group)

    def all_gather_rows(self, x):
        from repro_torch.dist import collective as C
        mine = self._whole(x)[self.lo:self.hi]
        g = C.all_gather_rows(torch.tanh(mine) ** 2, self.group, self.n)
        return C.all_reduce_sum(self.w * torch.sin(g), self.group)

    def reduce_scatter_rows(self, x):
        from repro_torch.dist import collective as C
        s = C.reduce_scatter_rows(self.w * torch.sin(self._whole(x)),
                                  self.group)
        g = C.all_gather_rows(s * s, self.group, self.n)
        return C.all_reduce_sum(self.u * g, self.group)

    def all_reduce_sum(self, x):
        from repro_torch.dist import collective as C
        y = C.all_reduce_sum(self.w * torch.exp(self._whole(x) * 0.5),
                             self.group)
        return y * y


COLLECTIVE_ROWS = (7, 5)      # over 4 ranks: blocks 2, 2, 2, 1 and 2, 2, 1, 0


def _collectives() -> dict:
    """``gradcheck`` and ``gradgradcheck`` of the three collectives over
    the world (float64), at row counts that leave the last ranks fewer
    rows or none; every rank draws the same inputs and seeds."""
    import torch.distributed as dist
    from torch.autograd import gradcheck, gradgradcheck
    out = {}
    for n in COLLECTIVE_ROWS:
        parts = Parts(dist.group.WORLD, n)
        for name in ("all_gather_rows", "reduce_scatter_rows",
                     "all_reduce_sum"):
            fn = getattr(parts, name)
            x = torch.randn((n, 2), generator=torch.Generator().manual_seed(
                n), dtype=torch.float64, requires_grad=True)
            out[f"collective/{n}/{name}/grad"] = np.array(
                gradcheck(fn, (x,), eps=1e-6, atol=1e-8,
                          raise_exception=False))
            torch.manual_seed(5)
            out[f"collective/{n}/{name}/gradgrad"] = np.array(
                gradgradcheck(fn, (x,), eps=1e-6, atol=1e-8,
                              raise_exception=False))
    return out


# ---------------------------------------------------------------------------
# a fake world in this process (tests/test_torch_launch_mesh.py)
# ---------------------------------------------------------------------------

def _pl(x) -> list:
    from torch.distributed.tensor import Replicate, Shard
    return [f"S{p.dim}" if isinstance(p, Shard) else
            "R" if isinstance(p, Replicate) else "P" for p in x.placements]


def fake_world_checks(n: int) -> dict:
    """The mesh hints, collective bytes and local flops on meta DTensors
    in a world of ``n`` ranks of torch's fake backend (this process is
    rank 0; no collective moves a byte)."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.dryrun import count_local
    from repro_torch.launch.mesh import make_fake_world, set_mesh
    from repro_torch.models.layers import maybe_constrain, maybe_replicate
    make_fake_world(n)

    def mesh(shape, names):
        return DeviceMesh("cpu", torch.arange(n).view(*shape),
                          mesh_dim_names=names)

    def place(shape, m, placements, grad=False):
        t = distribute_tensor(torch.empty(shape, device="meta"), m,
                              placements, src_data_rank=None)
        return t.requires_grad_() if grad else t
    out = {}
    if n == 3:
        m = mesh((1, 3), ("data", "model"))
        x = place((6, 4), m, [Replicate()] * 2)
        with set_mesh(m):
            out["model_rows"] = _pl(maybe_constrain(x, "model"))
            y = place((4, 4), m, [Replicate()] * 2)
            out["model_not_dividing_same"] = maybe_constrain(
                y, "model") is y
        m1 = mesh((3,), ("model",))
        z = place((6, 4), m1, [Replicate()])
        with set_mesh(m1):
            out["data_absent_same"] = maybe_constrain(z, "__data__") is z
        return out
    m = mesh((2, 2), ("data", "model"))
    rep = [Replicate()] * 2
    dx = place((8, 6), m, rep)
    out["no_mesh_same"] = maybe_constrain(dx, "__data__") is dx
    plain = torch.zeros(8, 6)
    with set_mesh(m):
        out["plain_same"] = (maybe_constrain(plain, "__data__") is plain
                             and maybe_replicate(plain) is plain)
        out["data_model"] = _pl(maybe_constrain(dx, "__data__", "model"))
        out["all_rows"] = _pl(maybe_constrain(dx, "__all__", None))
        odd = place((3, 6), m, rep)
        out["nothing_divides_same"] = maybe_constrain(odd, "__data__") is odd
        out["replicate"] = _pl(maybe_replicate(
            place((8, 6), m, [Shard(0), Shard(1)])))
        # FSDP: a weight split over the grid, gathered for a batch split
        # the same way; its gradient leaves through a reduce-scatter
        w = place((8, 16), m, [Shard(0), Shard(0)], grad=True)
        xb = place((8, 8), m, [Shard(0), Shard(0)])
        terms, wr = count_local(maybe_replicate, (w,), {})
        out["replicate_fwd"] = terms.coll_by_op
        y = (xb @ wr).sum()
        terms, _ = count_local(lambda: y.backward(), (), {})
        out["replicate_bwd"] = terms.coll_by_op
        out["grad_placements"] = _pl(w.grad)
    pod = mesh((2, 2, 1), ("pod", "data", "model"))
    with set_mesh(pod):
        out["pod_shrunk"] = _pl(maybe_constrain(
            place((2, 6), pod, [Replicate()] * 3), "__all__"))
    d = mesh((4,), ("d",))
    w = place((8, 16), d, [Shard(0)])
    out["gather"] = count_local(
        lambda: w.redistribute(d, [Replicate()]), (), {})[0].coll_by_op
    xs, ws = place((4, 8), d, [Shard(1)]), place((8, 16), d, [Shard(0)])
    out["reduce"] = count_local(lambda: (xs @ ws).full_tensor(), (),
                                {})[0].coll_by_op
    gs = place((8, 8), d, [Shard(1)])
    out["scatter"] = count_local(
        lambda: (gs @ ws).redistribute(d, [Shard(0)]), (), {})[0].coll_by_op
    x = place((64, 8), d, [Shard(0)])
    out["sum"] = count_local(lambda: x.sum().full_tensor(), (),
                             {})[0].coll_by_op
    a, b = place((64, 32), d, [Shard(0)]), place((32, 16), d, [Replicate()])
    out["local_flops"] = count_local(lambda: a @ b, (), {})[0].flops
    out["global_flops"] = 2 * 64 * 32 * 16
    above = FlopCounterMode(display=False)
    with above:
        a @ b
    out["mode_above_flops"] = above.get_total_flops()
    out.update(_moe_counts(m))
    out.update(_mace_counts(m))
    return out


def _mace_counts(m) -> dict:
    """One device's counts of the MACE training step at its published
    config on a random graph of 700 nodes and 1,500 edges (padded to
    1,024 and 1,536) placed on ``m``, beside the one-device count; the
    sizes the collectives' closed form needs; and the local ops that
    held a tensor of every edge (none should)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from torch.distributed.tensor import DTensor

    from repro_torch import configs
    from repro_torch import tree as T
    from repro_torch.launch import dryrun
    from repro_torch.launch import steps as S
    cfg = configs.get_bundle("mace").config
    shape = mace_graphs()["random"]
    plain, cell = S._mace_cell(cfg, shape, None), S._mace_cell(cfg, shape, m)
    whole, _ = dryrun.count(plain.fn, plain.args, {})
    dev, _ = dryrun.count_local(cell.fn, cell.place(cell.args), {})
    n_edges = cell.meta["n_edges"]

    class EdgeWatch(TorchDispatchMode):
        """The names of the local ops with a tensor of ``n_edges`` rows."""
        seen: set = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            if not dryrun._propagating() and any(
                    isinstance(t, torch.Tensor) and t.ndim
                    and t.shape[0] == n_edges
                    for t in tree_leaves((args, kwargs, out))):
                self.seen.add(str(func))
            return out
    args = cell.place(cell.args)
    with EdgeWatch() as watch:
        cell.fn(*args)
    # the parameters the loss reaches: all but mix_t (no feature reads
    # it) and the last layer's mix_v (no layer reads its h_v)
    layers = plain.args[0]["layers"]
    unread = [lp["mix_t"] for lp in layers] + [layers[-1]["mix_v"]]
    return {"mace_flops": [whole.flops, dev.flops],
            "mace_coll": dev.coll_by_op,
            "mace_sizes": dict(n_nodes=cell.meta["n_nodes"],
                               n_edges=n_edges, n_graphs=1,
                               d_hidden=cfg.d_hidden, n_layers=cfg.n_layers,
                               n_params_read=sum(
                                   t.numel() for t in T.leaves(
                                       plain.args[0])) - sum(
                                   t.numel() for t in unread)),
            "mace_edge_ops": sorted(watch.seen)}


def _moe_counts(m) -> dict:
    """One device's counts of the smoke granite-moe's ``moe_ffn``
    (forward and backward, (8, 16) tokens, weights replicated) with the
    groups split over both axes of ``m`` and ``batch_axes="__all__"``,
    beside the mesh-less counts; and of its FSDP training cell."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.dryrun import count_local
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.models import transformer as TF
    cfg = plain_cfg("granite-moe-3b-a800m")
    lp = {k.split(".", 1)[1]: torch.empty(shape[1:], device="meta",
                                          requires_grad=True)
          for k, (shape, _) in TF.param_specs(cfg).items()
          if k.startswith("layers.")}
    x = torch.empty(8, 16, cfg.d_model, device="meta", requires_grad=True)

    def step(x, lp):
        y, aux = TF.moe_ffn(x, lp, cfg, batch_axes="__all__")
        (y.float().sum() + aux).backward()

    def place(t, pl):
        return distribute_tensor(t.detach(), m, pl,
                                 src_data_rank=None).requires_grad_()
    whole, _ = count_local(lambda: step(x, lp), (), {})
    xd = place(x, [Shard(0), Shard(0)])
    lpd = {k: place(v, [Replicate()] * 2) for k, v in lp.items()}
    with set_mesh(m):
        dev, _ = count_local(lambda: step(xd, lpd), (), {})
    plain = train_cell("granite-moe-3b-a800m", "fsdp", None)
    cell = train_cell("granite-moe-3b-a800m", "fsdp", m)
    cell_whole, _ = count_local(plain.fn, plain.args, plain.count_kwargs)
    cell_dev, _ = count_local(cell.fn, cell.place(cell.args),
                              cell.count_kwargs)
    return {"moe_flops": [whole.flops, dev.flops],
            "moe_bytes": [whole.hbm_bytes, dev.hbm_bytes],
            "moe_coll": dev.coll_by_op, "n_experts": cfg.moe.n_experts,
            "d_model": cfg.d_model,
            "moe_cell_flops": [cell_whole.flops, cell_dev.flops]}
