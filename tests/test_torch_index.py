"""PyTorch port: package isolation, device policy, index construction and
the on-disk index format, held against the JAX package."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.data.synth_corpus import build_zipfian_index as jax_zipfian
from repro.dist.sharding import partition_index
from repro_torch import resolve_device
from repro_torch.ckpt import load_index
from repro_torch.convert import index_to_device
from repro_torch.core.index import build_fences, fence_count
from repro_torch.data.synth_corpus import build_zipfian_index
from repro_torch.dist.sharding import partition_index as \
    partition_index_torch
from repro_torch.kernels.embed_bag import embed_bag
from repro_torch.models.embedding_bag import MultiTable
from repro_torch.retrievers import get_retriever
from repro_torch.serving import SeineEngine, ServingFrontend
from torch_helpers import export, jax_layout

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEGMENT_ARRAYS = ("term_offsets", "doc_ids", "values", "fences", "idf",
                  "doc_len", "seg_len")
PARTITION_ARRAYS = SEGMENT_ARRAYS + ("term_to_shard", "range_lo",
                                     "range_hi", "split_term", "split_doc")
STATIC = ("n_docs", "vocab_size", "n_b", "functions")


def assert_same_index(port, ref):
    names = PARTITION_ARRAYS if hasattr(ref, "term_to_shard") else \
        SEGMENT_ARRAYS
    for n in names:
        want = getattr(ref, n)
        got = getattr(port, n)
        if want is None:
            assert got is None, n
            continue
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype, n
        np.testing.assert_array_equal(got.numpy(), want, err_msg=n)
    for n in STATIC:
        assert getattr(port, n) == getattr(ref, n), n
    assert port.nnz == ref.nnz


def test_port_imports_neither_jax_nor_repro():
    """The port, and the script that drives it on the card, must run on
    a host without JAX: importing every module of repro_torch (walked,
    so a module added later is covered) and chip_smoke loads no jax and
    no repro."""
    code = (
        "import importlib, pkgutil, sys; sys.path[:0] = ['src', '.']\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    expected = {os.path.relpath(os.path.join(d, f), os.path.join(
        REPO, "src"))[:-3].replace(os.sep, ".").removesuffix(".__init__")
        for d, _, fs in os.walk(os.path.join(REPO, "src", "repro_torch"))
        for f in fs if f.endswith(".py")} - {"repro_torch"}
    assert int(r.stdout.split()[-1]) == len(expected)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                            tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_zipfian_index()
    export(jax_zipfian(), tmp_path / "idx")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_index(str(tmp_path / "idx"))
    assert resolve_device("cpu") == torch.device("cpu")
    # numpy inputs go to the default device; tensors keep their own
    table = np.ones((4, 2), np.float32)
    idx, offsets = np.array([0, 3], np.int32), np.array([0], np.int32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        embed_bag(table, idx, offsets, n_bags=1)
    np.testing.assert_array_equal(
        embed_bag(torch.from_numpy(table), idx, offsets, n_bags=1).numpy(),
        [[2.0, 2.0]])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MultiTable((3,), 2).init()
    # the front end and the tile cache serve on their engine's device:
    # over a CPU engine they never ask for CUDA
    pidx = partition_index_torch(build_zipfian_index(device="cpu"), 2)
    eng = SeineEngine(pidx, "bm25", get_retriever("bm25").init(
        None, pidx.n_b, pidx.functions, device="cpu"))
    q, d = np.array([1, 2], np.int32), np.array([0, 5], np.int32)
    with ServingFrontend(eng, cache_tiles=4) as fe:
        got = fe.submit(q, d).result(timeout=120)
    np.testing.assert_array_equal(got, eng.score(q, d).numpy())
    assert fe.cache._cache_ids.device.type == "cpu"


@pytest.mark.parametrize("kw", [{}, dict(n_docs=300, vocab=50,
                                         tail_decay=0.7, n_b=3, seed=5)])
def test_zipfian_index_matches_jax(kw):
    """Same numpy RandomState draws -> the same index in both packages."""
    assert_same_index(build_zipfian_index(device="cpu", **kw),
                      jax_zipfian(**kw))


@pytest.mark.parametrize("tile", (1, 64, 256, 1024))
def test_build_fences_matches_jax(seine_world, tile):
    from repro.core.index import build_fences as jax_fences
    d = np.array(seine_world["index"].doc_ids)
    got = build_fences(torch.from_numpy(d), tile)
    np.testing.assert_array_equal(got.numpy(), jax_fences(d, tile))
    assert got.shape[-1] == fence_count(d.size, tile)
    empty = build_fences(torch.zeros((2, 0), dtype=torch.int32), tile)
    np.testing.assert_array_equal(
        empty.numpy(), jax_fences(np.zeros((2, 0), np.int32), tile))


@pytest.mark.parametrize("layout", ["single", "k2", "k4", "hot_k4"])
def test_load_index_matches_jax(seine_world, hot_term_index, tmp_path,
                                layout):
    """JAX save_index -> port load_index: every array equal, dtype kept."""
    if layout == "hot_k4":
        ref = partition_index(hot_term_index, 4)
        assert ref.split_term is not None, "must trigger sub-sharding"
    else:
        ref = jax_layout(seine_world["index"],
                         {"single": 1, "k2": 2, "k4": 4}[layout])
    port = export(ref, tmp_path / layout)
    assert_same_index(port, ref)
    assert_same_index(index_to_device(ref, device="cpu"), ref)


def test_load_index_recovers_old_and_rejects_packed(tmp_path):
    """The ``.old`` recovery; a packed index loads (its codec tests are in
    tests/test_torch_codec.py) and an unknown codec is rejected."""
    idx = jax_zipfian()
    export(idx, tmp_path / "idx")
    # a writer preempted mid-overwrite leaves only <dir>.old<pid>
    os.replace(tmp_path / "idx", tmp_path / "idx.old4242")
    assert_same_index(load_index(str(tmp_path / "idx"), device="cpu"), idx)
    from repro.ckpt import save_index
    packed = partition_index(idx, 2, codec="packed")
    save_index(str(tmp_path / "packed"), packed)
    got = load_index(str(tmp_path / "packed"), device="cpu")
    assert got.codec == "packed" and got.doc_ids is None
    np.testing.assert_array_equal(got.packed_words.numpy(),
                                  np.asarray(packed.packed_words))
    assert index_to_device(packed, device="cpu").codec == "packed"
    manifest = tmp_path / "packed" / "index_manifest.json"
    m = json.loads(manifest.read_text())
    manifest.write_text(json.dumps(dict(m, codec="zstd")))
    with pytest.raises(ValueError, match="unknown codec 'zstd'"):
        load_index(str(tmp_path / "packed"), device="cpu")


def test_committed_card_fixture_is_fresh(tmp_path):
    """tests/data/torch_hot_term_k4 (loaded by chip_smoke.py on the card,
    which has no JAX) equals what its generator writes today."""
    sys.path.insert(0, os.path.join(REPO, "tests", "data"))
    try:
        from make_torch_fixtures import HOT_TERM_K4, write_hot_term_k4
    finally:
        sys.path.pop(0)
    fresh = write_hot_term_k4(str(tmp_path / "k4"))
    names = sorted(os.listdir(HOT_TERM_K4))
    assert names == sorted(os.listdir(fresh))
    for n in names:
        a, b = os.path.join(HOT_TERM_K4, n), os.path.join(fresh, n)
        if n.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                ma, mb = json.load(fa), json.load(fb)
            ma.pop("time"), mb.pop("time")
            assert ma == mb
        else:
            with np.load(a) as za, np.load(b) as zb:
                assert sorted(za.files) == sorted(zb.files), n
                for f in za.files:
                    np.testing.assert_array_equal(za[f], zb[f],
                                                  err_msg=f"{n}:{f}")
    port = load_index(HOT_TERM_K4, device="cpu")
    assert port.split_term is not None and port.n_shards == 4
