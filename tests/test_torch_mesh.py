"""The port's mesh paths on the CPU, against the JAX package.

Placement rules (``fit_spec``, the five rule sets through
``tree_shardings``, ``opt_state_shardings``, ``lm_cache_spec``,
``index_shardings``, ``partitioned_index_shardings``) resolve to the
reference's specs on abstract meshes from 1 x 1 to the (2, 16, 16) pod
mesh.  Meshed serving runs over gloo: a 1 x 1 mesh in this process, and
meshes of (2, 1), (1, 2), (1, 3), (3, 1) and (2, 2) in spawned ranks
(``torch_mesh_ranks``: one world of each size, all at once, on
``FileStore``s, joined with a timeout).  Their scores are bitwise the
mesh-less port engine's and within rtol 1e-5 / atol 1e-6 of the
reference's ``SeineEngine(mesh=make_host_mesh(1, 1))``, as a single CSR,
term-partitioned and on the K = 4 hot-term fixture, at candidate counts
the data axes do not divide.  The meshed build, reshard-on-load and
``sp_decode_attention`` run in the same worlds.
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh
from jax.sharding import PartitionSpec as JP

from repro import ckpt as jax_ckpt
from repro.dist import sharding as JS
from repro.dist.sp_decode import combine_decode_stats as jax_combine
from repro.dist.sp_decode import local_decode_stats as jax_local_stats
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.models import layers as JL
from repro.models import mace as JM
from repro.models import recsys as JR
from repro.models import transformer as JT
from repro.retrievers import get_retriever as jax_get
from repro.serving.engine import SeineEngine as JaxEngine
from repro.train import optimizer as JO
from repro_torch import configs
from repro_torch import tree as T
from repro_torch.ckpt import load_index, save_checkpoint, save_index
from repro_torch.convert import index_to_device, params_from_jax
from repro_torch.dist import sharding as S
from repro_torch.dist.sp_decode import sp_decode_attention
from repro_torch.launch import mesh as M
from repro_torch.launch import steps as ST
from repro_torch.launch.train import recsys_init
from repro_torch.models import mace as MA
from repro_torch.serving import SeineEngine
from repro_torch.train import optimizer as O
from torch_helpers import adversarial, jax_layout
import torch_mesh_ranks as R
import torch_threads  # noqa: F401  (PyTorch threads per test process)

TOL = dict(rtol=1e-5, atol=1e-6)          # knrm_pool's bar: the scores
DECODE_TOL = dict(rtol=1e-4, atol=1e-5)
HOT = os.path.join(os.path.dirname(__file__), "data", "torch_hot_term_k4")

MESHES = [((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
          ((3, 1), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = ["x".join(map(str, s)) for s, _ in MESHES]


def _meshes(i):
    sizes, names = MESHES[i]
    return S.AbstractMesh(sizes, names), JaxAbstractMesh(sizes, names)


def _jax_specs(tree):
    """{path name: spec tuple} of a JAX tree of NamedShardings."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(s.spec) for path, s in flat}


def _port_specs(tree):
    return {n: tuple(s.spec) for n, s in T.flatten_with_paths(tree)}


# ---------------------------------------------------------------------------
# placement rules against the reference
# ---------------------------------------------------------------------------

SPECS = [
    (JP("model", None, None), (4096, 20, 3)), (JP("model"), (3,)),
    (JP(("pod", "data", "model"), None), (1024, 8)),
    (JP(("pod", "data", "model"), None), (768, 8)),
    (JP(None, ("pod", "data")), (4, 96)), (JP("data", "model"), (6, 9)),
    (JP(None, None, "model"), (2, 5, 48)), (JP(), (7, 7)),
    (JP("pod"), (10,)), (JP(None, "model", None, None), (3, 32, 8, 8)),
]


@pytest.mark.parametrize("mi", range(len(MESHES)), ids=MESH_IDS)
def test_fit_spec_and_cache_spec_match_jax(mi):
    mesh, jmesh = _meshes(mi)
    assert S.data_axes(mesh) == JS.data_axes(jmesh)
    for spec, shape in SPECS:
        got = S.fit_spec(mesh, S.P(*spec), shape)
        assert tuple(got) == tuple(JS.fit_spec(jmesh, spec, shape)), spec
        sh = S.NamedSharding(mesh, got)
        want = _jax_shard_shape(jmesh, JS.fit_spec(jmesh, spec, shape),
                                shape)
        assert sh.shard_shape(shape) == want, (spec, shape)
    for batch in (1, 2, 6, 32, 64):
        for seq in (True, False):
            assert tuple(S.lm_cache_spec(mesh, seq_shard=seq,
                                         batch=batch)) == tuple(
                JS.lm_cache_spec(jmesh, seq_shard=seq, batch=batch))


def _jax_shard_shape(jmesh, spec, shape):
    from jax.sharding import NamedSharding
    return tuple(NamedSharding(jmesh, spec).shard_shape(shape))


def _jax_recsys_init(cfg, key):
    init = {"attn-ctr": JR.autoint_init, "dlrm": JR.dlrm_init}.get(
        cfg.family, JR.seqrec_init)
    return init(cfg, key)


@functools.lru_cache(maxsize=None)
def _param_trees():
    """(rules, port tree, reference tree) per rule set: the LM rules over
    two published widths (dense, MoE; one layer: no rule splits the
    stacked layer axis) as meta tensors / shape structs, the recsys rules
    over every recsys arch's smoke params, MACE's.  The reference's trees
    are ``jax.eval_shape``'s: only shapes matter."""
    from repro import configs as jax_configs
    key = jax.random.key(0)
    one = lambda c: dataclasses.replace(c, n_layers=1)
    out = []
    for arch in ("stablelm-1.6b", "granite-moe-3b-a800m"):
        port = ST._lm_params_meta(one(configs.get_bundle(arch).config))
        ref = jax.eval_shape(lambda: JT.init_params(
            one(jax_configs.get_bundle(arch).config), key))
        out.append((arch, "lm", port, ref))
        out.append((arch, "lm_fsdp", port, ref))
    for arch in ("autoint", "bert4rec", "dlrm-mlperf", "sasrec"):
        port = recsys_init(configs.smoke(arch), torch.Generator()
                           .manual_seed(0), device="cpu")
        ref = jax.eval_shape(lambda: _jax_recsys_init(
            jax_configs.smoke(arch), key))
        out.append((arch, "recsys", port, ref))
    port = MA.init_params(configs.smoke("mace"),
                          torch.Generator().manual_seed(0), device="cpu")
    ref = jax.eval_shape(lambda: JM.init_params(jax_configs.smoke("mace"),
                                                key))
    out.append(("mace", "gnn", port, ref))
    return out


RULES = {"lm": (S.lm_param_rules, JS.lm_param_rules),
         "lm_fsdp": (S.lm_param_rules_fsdp, JS.lm_param_rules_fsdp),
         "recsys": (S.recsys_param_rules, JS.recsys_param_rules),
         "gnn": (S.gnn_param_rules, JS.gnn_param_rules)}


@pytest.mark.parametrize("mi", range(len(MESHES)), ids=MESH_IDS)
def test_param_and_opt_state_rules_match_jax(mi):
    mesh, jmesh = _meshes(mi)
    for arch, kind, port, ref in _param_trees():
        rules, jrules = RULES[kind]
        got = S.tree_shardings(mesh, port, rules())
        want = JS.tree_shardings(jmesh, ref, jrules())
        assert _port_specs(got) == _jax_specs(want), (arch, kind)
        for opt, jopt in ((O.adam(1e-3), JO.adam(1e-3)),
                          (O.sgd(1e-3, momentum=0.9),
                           JO.sgd(1e-3, momentum=0.9)),
                          (O.adafactor(1e-3), JO.adafactor(1e-3))):
            st = opt.init(port)
            jst = jax.eval_shape(jopt.init, ref)
            assert _port_specs(S.opt_state_shardings(mesh, st, got)) == \
                _jax_specs(JS.opt_state_shardings(jmesh, jst, want)), arch


@pytest.fixture(scope="module")
def world_index(seine_world):
    return seine_world["index"]


@pytest.mark.parametrize("mi", range(len(MESHES)), ids=MESH_IDS)
def test_index_shardings_match_jax(world_index, tmp_path_factory, mi):
    mesh, jmesh = _meshes(mi)
    d = str(tmp_path_factory.mktemp("idx"))
    jax_ckpt.save_index(d, world_index)
    port = load_index(d, device="cpu")
    fields = ("term_offsets", "doc_ids", "values", "idf", "doc_len",
              "seg_len", "fences")
    got, want = (S.index_shardings(mesh, port),
                 JS.index_shardings(jmesh, world_index))
    for n in fields:
        assert tuple(getattr(got, n).spec) == tuple(getattr(want, n).spec)
    for jidx in (jax_layout(world_index, 4), jax_ckpt.load_index(HOT)):
        pidx = index_to_device(jidx, device="cpu")
        got = S.partitioned_index_shardings(mesh, pidx)
        want = JS.partitioned_index_shardings(jmesh, jidx)
        for f in dataclasses.fields(want):
            w = getattr(want, f.name)
            if hasattr(w, "spec"):
                assert tuple(getattr(got, f.name).spec) == tuple(w.spec), \
                    f.name
            else:
                assert getattr(got, f.name) is None or not hasattr(
                    getattr(got, f.name), "spec"), f.name


# ---------------------------------------------------------------------------
# the serving inputs, shared by the in-process and the spawned meshes
# ---------------------------------------------------------------------------

def _requests(index, queries, rng):
    """Requests over every candidate class: the whole corpus, 7 and 13
    docs (no data axis divides them), adversarial ids."""
    n = index.n_docs
    reqs = [(queries[0], np.arange(n, dtype=np.int32)),
            (queries[1], rng.choice(n, 7, replace=False).astype(np.int32)),
            (queries[2], rng.choice(n, 13).astype(np.int32))]
    return reqs


@pytest.fixture(scope="module")
def serving(seine_world, tmp_path_factory):
    """The inputs every mesh serves (written for the spawned ranks), the
    mesh-less port scores and the reference's meshed scores."""
    work = str(tmp_path_factory.mktemp("mesh_work"))
    rng = np.random.RandomState(0)
    jworld = seine_world["index"]
    jhot = jax_ckpt.load_index(HOT)
    save_index(os.path.join(work, "world_index"),
               index_to_device(jworld, device="cpu"))
    q_world = [np.asarray(q, np.int32) for q in seine_world["queries"][:3]]
    adv_q, adv_d = adversarial(seine_world, 0)
    reqs = {"world": _requests(jworld, q_world, rng) + [(adv_q, adv_d)]}
    hot_q = [np.asarray(q, np.int32) for q in
             ((3, 0, -1, 7, 99, 5), (3, 7, -1, 12, -1, -1), (0, 1, 2, 3))]
    reqs["hot"] = _requests(jhot, hot_q, rng)
    jparams, ports = {}, {}
    for name, jidx in (("world", jworld), ("hot", jhot)):
        jp = jax_get("knrm").init(jax.random.PRNGKey(1), jidx.n_b,
                                  jidx.functions)
        jparams[name] = jp
        ports[name] = params_from_jax("knrm", jp, device="cpu")
        torch.save(ports[name].state_dict(),
                   os.path.join(work, f"knrm_{name}.pt"))
        np.savez(os.path.join(work, f"requests_{name}.npz"),
                 **{f"q{i}": q for i, (q, _) in enumerate(reqs[name])},
                 **{f"d{i}": d for i, (_, d) in enumerate(reqs[name])})
    paths = R.serve_paths(work)
    plain, pairs, jax_meshed = {}, {}, {}
    jmesh = jax_host_mesh(1, 1)
    jidx = {"single": jworld, "term": jworld, "term4": jworld, "hot": jhot}
    for path, (index, params, kw, rq) in paths.items():
        eng = SeineEngine(index, "knrm", params, **kw)
        plain[path] = [eng.score(q, d).numpy() for q, d in rq]
        pairs[path] = eng.index.lookup_pairs(*R.pair_batch(rq[-1])).numpy()
        name = "hot" if path == "hot" else "world"
        jeng = JaxEngine(jidx[path], "knrm", jparams[name], mesh=jmesh,
                         **kw)
        jax_meshed[path] = [np.asarray(jeng.score(jnp.asarray(q),
                                                  jnp.asarray(d)))
                            for q, d in rq]
    return dict(work=work, paths=paths, plain=plain, pairs=pairs,
                jax=jax_meshed)


def _check_scores(tag, got, serving):
    """Scores bitwise the mesh-less port's and within the bar of the
    reference's meshed engine; ``lookup_pairs`` of the placed index
    bitwise the mesh-less index's."""
    for path, want in serving["pairs"].items():
        np.testing.assert_array_equal(got[f"pairs/{tag}/{path}"], want,
                                      err_msg=f"{tag} {path} pairs")
    for path, want in serving["plain"].items():
        for i, w in enumerate(want):
            g = got[f"serve/{tag}/{path}/{i}"]
            assert g.shape == w.shape and g.dtype == w.dtype, (tag, path)
            np.testing.assert_array_equal(g, w, err_msg=f"{tag} {path} {i}")
            np.testing.assert_allclose(g, serving["jax"][path][i], **TOL)


@pytest.fixture
def host_mesh():
    """A 1 x 1 gloo mesh in this process; its world ends with the test."""
    mesh = M.make_host_mesh(1, 1, device="cpu")
    yield mesh
    M.release_world()


def test_meshed_engine_on_one_rank(serving, host_mesh):
    """The 1 x 1 mesh in process: every path bitwise the mesh-less port
    and within the bar of the reference's meshed engine; the collectives
    ran; retrieve and sampling stay mesh-less."""
    from repro_torch.dist.collective import all_gather_stack, all_reduce_sum
    before = all_reduce_sum.launches, all_gather_stack.launches
    got = {}
    for path, (index, params, kw, rq) in serving["paths"].items():
        eng = SeineEngine(index, "knrm", params, mesh=host_mesh, **kw)
        assert eng.index.placement.axes == ("model",)
        for i, (q, d) in enumerate(rq):
            got[f"serve/1x1/{path}/{i}"] = eng.score(q, d).numpy()
        got[f"pairs/1x1/{path}"] = eng.index.lookup_pairs(
            *R.pair_batch(rq[-1])).numpy()
        with pytest.raises(NotImplementedError, match="mesh-less only"):
            eng.retrieve(rq[0][0], 3)
    _check_scores("1x1", got, serving)
    n_calls = sum(len(v) for v in serving["plain"].values())
    # one all_reduce a score and a lookup_pairs call, one all_gather a score
    assert all_reduce_sum.launches - before[0] == n_calls + len(
        serving["plain"])
    assert all_gather_stack.launches - before[1] == n_calls


# ---------------------------------------------------------------------------
# the spawned worlds
# ---------------------------------------------------------------------------

DECODE_SHAPE = dict(B=3, S=16, Hq=4, Hkv=2, hd=16)
# row 1 ends inside the first of 4 slices: three ranks hold none of it
DECODE_LENGTHS = (16, 3, 9)


@pytest.fixture(scope="module")
def worlds(serving, tmp_path_factory):
    """Worlds of 2, 3 and 4 gloo ranks, run at once: meshes (2, 1) and
    (1, 2) serve, build and decode; (1, 3) and (3, 1) serve; (2, 2)
    serves and restores a checkpoint, and (1, 4) decodes."""
    rng = np.random.RandomState(3)
    d = DECODE_SHAPE
    decode = dict(q=rng.randn(d["B"], d["Hq"], d["hd"]),
                  k=rng.randn(d["B"], d["S"], d["Hkv"], d["hd"]),
                  v=rng.randn(d["B"], d["S"], d["Hkv"], d["hd"]))
    decode = {k: v.astype(np.float32) for k, v in decode.items()}
    decode["lengths"] = np.asarray(DECODE_LENGTHS, np.int32)
    leaves = {"w": rng.randn(8, 6).astype(np.float32),
              "e": rng.randn(2, 4, 3).astype(np.float32),
              "nest/b": rng.randn(6).astype(np.float32),
              "nest/odd": rng.randn(3).astype(np.float32)}
    tree = {"w": torch.from_numpy(leaves["w"]),
            "e": torch.from_numpy(leaves["e"]),
            "nest": {"b": torch.from_numpy(leaves["nest/b"]),
                     "odd": torch.from_numpy(leaves["nest/odd"])}}
    tasks = {2: dict(serve=[[2, 1], [1, 2]], build=[1, 2],
                     decode=[[1, 2]]),
             3: dict(serve=[[1, 3], [3, 1]]),
             4: dict(serve=[[2, 2]], decode=[[1, 4]], restore=[2, 2])}
    runs = []
    for n, task in tasks.items():
        work = str(tmp_path_factory.mktemp(f"world{n}"))
        for f in os.listdir(serving["work"]):
            if f != "store":
                src = os.path.join(serving["work"], f)
                os.symlink(src, os.path.join(work, f))
        with open(os.path.join(work, "tasks.json"), "w") as f:
            json.dump(task, f)
        np.savez(os.path.join(work, "decode.npz"), **decode)
        if task.get("restore"):
            save_checkpoint(os.path.join(work, "ckpt"), 7, tree)
            np.savez(os.path.join(work, "ckpt_leaves.npz"), **leaves)
        runs.append((n, work))
    out = R.run_worlds(runs)
    return {n: dict(ranks=ranks, work=work, decode=decode, leaves=leaves)
            for (n, work), ranks in zip(runs, out)}


@pytest.mark.parametrize("n", [2, 3, 4])
def test_meshed_scores_bitwise_on_spawned_meshes(worlds, serving, n):
    ranks = worlds[n]["ranks"]
    tags = {k.split("/")[1] for k in ranks[0] if k.startswith("serve/")}
    assert tags == {2: {"2x1", "1x2"}, 3: {"1x3", "3x1"},
                    4: {"2x2"}}[n]
    for r, got in enumerate(ranks):
        for tag in tags:
            _check_scores(tag, got, serving)
    for tag in tags:
        model = int(tag.split("x")[1])
        holds = [rk[f"held/{tag}/term4"] for rk in ranks]
        if 4 % model:               # K = 4 does not split over 3 ranks
            assert all(h.tolist() == [0, 4, 0] for h in holds)
        else:
            spans = sorted({tuple(h[:2]) for h in holds})
            assert spans == [(i * 4 // model, (i + 1) * 4 // model)
                             for i in range(model)]
        hot = {tuple(rk[f"held/{tag}/hot"][:2]) for rk in ranks}
        assert len(hot) == (model if 4 % model == 0 else 1)


def test_meshed_build_on_two_model_ranks(worlds):
    """build_partitioned on (1, 2): each rank's two shards bitwise the
    mesh-less build's, and the meshed save_index reads back through the
    reference's load_index equal to the mesh-less one."""
    w = worlds[2]
    held = sorted(tuple(rk["build/held"]) for rk in w["ranks"])
    assert held == [(0, 2), (2, 4)]
    for rk in w["ranks"]:
        for k, v in rk.items():
            if k.startswith("build/equal/"):
                assert bool(v), k
        assert rk["build/nnz"][0] == rk["build/nnz"][1]
    got = jax_ckpt.load_index(os.path.join(w["work"], "built_mesh"))
    want = jax_ckpt.load_index(os.path.join(w["work"], "built_plain"))
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if hasattr(b, "shape"):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f.name)
        else:
            assert a == b, f.name
    assert got.n_shards == 4


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)])
def test_sp_decode_attention_on_spawned_meshes(worlds, shape):
    """sp_decode_attention against the reference's stats merge and its
    naive attention per row (a rank whose slice holds no valid
    position weighs zero)."""
    n = {2: 2, 4: 4}[shape[1]]
    w = worlds[n]
    z = w["decode"]
    q, k, v = (jnp.asarray(z[x]) for x in ("q", "k", "v"))
    lengths = z["lengths"]
    s_loc = k.shape[1] // shape[1]
    stats = []
    for i in range(shape[1]):
        pos = i * s_loc + jnp.arange(s_loc)
        stats.append(jax_local_stats(
            q, k[:, i * s_loc:(i + 1) * s_loc],
            v[:, i * s_loc:(i + 1) * s_loc],
            pos[None, :] < jnp.asarray(lengths)[:, None]))
    merged = np.asarray(jax_combine(*(jnp.stack([s[j] for s in stats])
                                      for j in range(3))))
    tag = "x".join(map(str, shape))
    for rk in w["ranks"]:
        for key in (f"decode/{tag}", f"decode/{tag}/dtensor"):
            got = rk[key]
            np.testing.assert_allclose(got, merged, **DECODE_TOL)
            for b, L in enumerate(lengths):
                ref = JL.naive_attention(q[b:b + 1, None], k[b:b + 1, :L],
                                         v[b:b + 1, :L], causal=False)
                np.testing.assert_allclose(got[b], np.asarray(ref)[0, 0],
                                           **DECODE_TOL)
        np.testing.assert_array_equal(rk[f"decode/{tag}"],
                                      w["ranks"][0][f"decode/{tag}"])


def test_restore_checkpoint_reshards_on_a_2x2_mesh(worlds):
    """A checkpoint saved mesh-less, restored onto (2, 2): every leaf's
    whole tensor is the saved one bitwise on every rank, its local part
    this rank's slice; a spec the mesh does not divide replicates."""
    w = worlds[4]
    for rk in w["ranks"]:
        assert int(rk["restore/step"]) == 7
        for name, want in w["leaves"].items():
            np.testing.assert_array_equal(rk[f"restore/full/{name}"], want)
            assert bool(rk[f"restore/local/{name}"]), name
        assert str(rk["restore/spec/w"]) == "P('data', 'model')"
        assert str(rk["restore/spec/e"]) == "P(None, 'model')"
        assert str(rk["restore/spec/nest/odd"]) == "P()"
        assert str(rk["restore/spec/nest/b"]) == "P()"


def test_restore_checkpoint_and_decode_on_one_rank(tmp_path, host_mesh):
    """The same two paths on the 1 x 1 mesh in process."""
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(4, 3),
            "b": torch.ones(5, dtype=torch.bfloat16)}
    save_checkpoint(str(tmp_path), 3, tree)
    sh = S.tree_shardings(host_mesh, tree, [(r"^a$", S.P("data"))])
    from repro_torch.ckpt import restore_checkpoint
    got, man = restore_checkpoint(str(tmp_path), tree, shardings=sh)
    assert man["step"] == 3
    for n, leaf in T.flatten_with_paths(got):
        want = dict(T.flatten_with_paths(tree))[n]
        assert leaf.dtype == want.dtype
        assert torch.equal(leaf.full_tensor(), want), n
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(*s, generator=g) for s in
               ((2, 4, 8), (2, 6, 2, 8), (2, 6, 2, 8)))
    lengths = torch.tensor([6, 2])
    fn = sp_decode_attention(host_mesh, "model")
    out = fn(q, k, v, lengths)
    ref = np.asarray(jax_combine(*(x[None] for x in
                                   jax_local_stats(
                                       jnp.asarray(q.numpy()),
                                       jnp.asarray(k.numpy()),
                                       jnp.asarray(v.numpy()),
                                       jnp.arange(6)[None] < jnp.asarray(
                                           lengths.numpy())[:, None]))))
    np.testing.assert_allclose(out.numpy(), ref, **DECODE_TOL)


def test_mesh_builders_clamp_and_refuse(host_mesh):
    """make_host_mesh clamps to the world as the reference clamps to its
    devices; the production mesh names the world it needs."""
    m = M.make_host_mesh(4, 8, device="cpu")
    assert tuple(m.shape) == (1, 1) and m.mesh_dim_names == ("data",
                                                             "model")
    for multi, need in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"world of {need} ranks"):
            M.make_production_mesh(multi_pod=multi, device="cpu")
