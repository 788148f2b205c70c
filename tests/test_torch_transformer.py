"""PyTorch port of the LM bridge (configs, ``models.layers``' norm and
RoPE, the dense transformer's ``init_params`` / ``forward`` /
``prefill``, ``LMProvider`` and the SEINE build over it), held against
the JAX package on the CPU.

Weights cross from JAX through ``convert.lm_params_from_numpy``;
``LMProvider``'s projection through ``convert.lm_provider_from_numpy``.
Bars: float32 at rtol 1e-4 / atol 1e-5 (tests/test_kernels.py's);
bf16 at 2e-2.  In bf16 the reference runs op by op
(``jax.disable_jit``): under ``jit`` XLA's excess-precision fusion keeps
some bf16 intermediates in float32, so its rounding points are not the
ones its source states, which are the ones the port reproduces
(``rms_norm``, RoPE and attention in float32, cast back; the residual
adds and ``silu(gate) * up`` in bf16).  The build over the LM provider
follows tests/test_system.py::test_lm_provider_bridges_arch_to_index:
ids, offsets and fences bitwise, values at the float32 bar.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_bundle
from repro.configs import smoke as jax_smoke
from repro.core import IndexBuilder as JaxBuilder
from repro.core import LMProvider as JaxLMProvider
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import (LM_ARCH_IDS, get_lm_config, seine_smoke,
                                 smoke)
from repro_torch.convert import (interaction_params_from_jax,
                                 lm_params_from_numpy,
                                 lm_provider_from_numpy)
from repro_torch.core.builder import IndexBuilder
from repro_torch.core.providers import LMProvider
from repro_torch.core.vocab import build_vocabulary
from repro_torch.data.synth_corpus import generate
from repro_torch.models import layers as TL
from repro_torch.models import transformer as T
from repro_torch.serving import NoIndexEngine
import torch_threads  # noqa: F401  (PyTorch threads per test process)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
DENSE = ("minitron-4b", "stablelm-1.6b")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _cfgs(name, dtype):
    return (dataclasses.replace(jax_smoke(name), dtype=dtype),
            dataclasses.replace(smoke(name), dtype=dtype))


def _tokens(seed, vocab, shape=(3, 70)):
    """Ids with -1 and past-vocabulary entries: both forwards wrap a
    negative id, then clamp into [0, V) (the ``mode="clip"`` gather)."""
    return np.random.RandomState(seed).randint(-1, vocab + 90, size=shape
                                               ).astype(np.int32)


@pytest.mark.parametrize("name", LM_ARCH_IDS)
def test_configs_match_jax(name):
    want = get_bundle(name).config
    got = get_lm_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.n_params == want.n_params
    assert got.n_active_params == want.n_active_params
    assert dataclasses.asdict(smoke(name)) == dataclasses.asdict(
        jax_smoke(name))
    if name == "minitron-4b":
        assert got.n_params == 5_096_279_040


@pytest.mark.parametrize("name", DENSE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_tree_shapes_dtypes_and_scales(name, dtype):
    jc, c = _cfgs(name, dtype)
    want = JT.init_params(jc, jax.random.key(0))
    got = T.init_params(c, torch.Generator().manual_seed(0), device="cpu")
    flat_want = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
                 for path, leaf in jax.tree_util.tree_leaves_with_path(want)}
    flat_got = {f"layers/{k}": v for k, v in got["layers"].items()}
    flat_got.update({k: v for k, v in got.items() if k != "layers"})
    assert set(flat_got) == set(flat_want)
    for k, v in flat_got.items():
        assert tuple(v.shape) == flat_want[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(flat_want[k].dtype), k
    n_l, d, f = c.n_layers, c.d_model, c.d_ff
    hq = c.n_heads * c.head_dim
    for k, scale in (("embed", 0.02), ("layers/wq", d ** -0.5),
                     ("layers/wk", d ** -0.5), ("layers/w_up", d ** -0.5),
                     ("layers/wo", (hq * n_l) ** -0.5),
                     ("layers/w_down", (f * n_l) ** -0.5),
                     ("unembed", d ** -0.5)):
        std = float(flat_got[k].float().std())
        assert abs(std / scale - 1) < 0.1, (k, std, scale)
    for k in ("layers/ln1", "layers/ln2", "final_norm"):
        assert bool((flat_got[k] == 1).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weights_carry_across_bitwise(dtype):
    """bf16 crosses as float32 (``torch.from_numpy`` refuses
    ``ml_dtypes.bfloat16``) and comes back in the config's dtype, bit
    for bit."""
    jc, c = _cfgs("minitron-4b", dtype)
    jp = JT.init_params(jc, jax.random.key(1))
    tp = lm_params_from_numpy(jp, c, device="cpu")
    assert tp["embed"].dtype == T._dt(c)
    for k in ("embed", "unembed", "final_norm"):
        np.testing.assert_array_equal(_np(tp[k]), _np(jp[k]))
    for k in [n.split(".", 1)[1] for n in T.param_specs(c)
              if n.startswith("layers.")]:
        assert tp["layers"][k].dtype == T._dt(c)
        np.testing.assert_array_equal(_np(tp["layers"][k]),
                                      _np(jp["layers"][k]))


def test_converter_checks_names_and_shapes():
    jc, c = _cfgs("minitron-4b", "float32")
    jp = JT.init_params(jc, jax.random.key(0))
    missing = dict(jp, layers={k: v for k, v in jp["layers"].items()
                               if k != "wv"})
    with pytest.raises(ValueError, match="layout"):
        lm_params_from_numpy(missing, c, device="cpu")
    with pytest.raises(ValueError, match="layout"):
        lm_params_from_numpy(jp, dataclasses.replace(c, d_ff=64),
                             device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope_match_jax(dtype):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 4, 16).astype(np.float32) * 3
    scale = rng.rand(16).astype(np.float32) + 0.5
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" \
        else (jnp.float32, torch.float32)
    jx, tx = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    tol = BF16 if dtype == "bfloat16" else F32
    got = TL.rms_norm(tx, torch.from_numpy(scale).to(tdt), 1e-5)
    want = JL.rms_norm(jx, jnp.asarray(scale).astype(jdt), 1e-5)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    pos = np.stack([np.arange(9), np.arange(9) + 100]).astype(np.int32)
    for theta in (10000.0, 500.0):
        got = TL.apply_rope(tx, torch.from_numpy(pos), theta)
        want = JL.apply_rope(jx, jnp.asarray(pos), theta)
        assert got.dtype == tdt
        np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_allclose(_np(TL.rope_freqs(16)),
                               _np(JL.rope_freqs(16)), **F32)


@pytest.mark.parametrize("name", DENSE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 2])
def test_forward_and_prefill_match_jax(name, dtype, seed):
    jc, c = _cfgs(name, dtype)
    jp = JT.init_params(jc, jax.random.key(seed))
    tp = lm_params_from_numpy(jp, c, device="cpu")
    toks = _tokens(seed, c.vocab_size)
    hidden, aux = T.forward(tp, torch.from_numpy(toks), c)
    logits = T.prefill(tp, torch.from_numpy(toks), c)
    if dtype == "float32":
        want, want_aux = JT.forward(jp, jnp.asarray(toks), jc, remat=False)
        want_logits = JT.prefill(jp, jnp.asarray(toks), jc)
        tol = F32
    else:
        with jax.disable_jit():
            want, want_aux = JT.forward(jp, jnp.asarray(toks), jc,
                                        remat=False, scan_layers=False)
            want_logits = JT.prefill(jp, jnp.asarray(toks), jc)
        tol = BF16
    assert hidden.dtype == T._dt(c) and hidden.shape == (3, 70, c.d_model)
    assert logits.dtype == torch.float32 and logits.shape == (3,
                                                              c.vocab_size)
    np.testing.assert_allclose(_np(hidden), _np(want), **tol)
    np.testing.assert_allclose(_np(logits), _np(want_logits), **tol)
    assert float(aux) == float(want_aux) == 0.0


MOE = ("granite-moe-3b-a800m", "moonshot-v1-16b-a3b")


def _flat(tree):
    out = {f"layers/{k}": v for k, v in tree["layers"].items()}
    out.update({k: v for k, v in tree.items() if k != "layers"})
    return out


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_init_params_tree_shapes_dtypes_and_scales(name, dtype):
    """The reference's MoE tree: the router float32 in any model, the
    expert weights stacked over (L, E), the shared experts' when the
    config has them; the init's scales and the config's count."""
    jc, c = _cfgs(name, dtype)
    want = JT.init_params(jc, jax.random.key(0))
    got = T.init_params(c, torch.Generator().manual_seed(0), device="cpu")
    flat_want = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
                 for path, leaf in jax.tree_util.tree_leaves_with_path(want)}
    flat_got = _flat(got)
    assert set(flat_got) == set(flat_want)
    for k, v in flat_got.items():
        assert tuple(v.shape) == flat_want[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(flat_want[k].dtype), k
    assert flat_got["layers/router"].dtype == torch.float32
    assert ("layers/ws_gate" in flat_got) == bool(c.moe.n_shared_experts)
    assert sum(v.numel() for v in flat_got.values()) == c.n_params
    n_l, d, fe = c.n_layers, c.d_model, c.moe.d_expert
    for k, scale in (("layers/router", d ** -0.5),
                     ("layers/we_gate", d ** -0.5),
                     ("layers/we_up", d ** -0.5),
                     ("layers/we_down", (fe * n_l) ** -0.5)):
        std = float(flat_got[k].float().std())
        assert abs(std / scale - 1) < 0.1, (k, std, scale)


@pytest.mark.parametrize("name", MOE)
def test_moe_weights_carry_across_bitwise(name):
    """A bf16 MoE tree crosses leaf by leaf in its own dtype: the router
    stays float32, bit for bit."""
    jc, c = _cfgs(name, "bfloat16")
    jp = JT.init_params(jc, jax.random.key(1))
    tp = lm_params_from_numpy(jp, c, device="cpu")
    got, want = _flat(tp), _flat(jp)
    assert set(got) == set(want)
    for k, v in got.items():
        assert str(v.dtype).split(".")[-1] == str(want[k].dtype), k
        np.testing.assert_array_equal(_np(v), _np(want[k]), err_msg=k)
    assert tp["layers"]["router"].dtype == torch.float32
    assert tp["layers"]["we_gate"].dtype == torch.bfloat16


def test_moe_converter_checks_names_and_shapes():
    jc, c = _cfgs("moonshot-v1-16b-a3b", "float32")
    jp = JT.init_params(jc, jax.random.key(0))
    missing = dict(jp, layers={k: v for k, v in jp["layers"].items()
                               if k != "ws_up"})
    with pytest.raises(ValueError, match="layout"):
        lm_params_from_numpy(missing, c, device="cpu")
    fewer = dataclasses.replace(c, moe=dataclasses.replace(c.moe,
                                                           n_experts=3))
    with pytest.raises(ValueError, match="layout"):
        lm_params_from_numpy(jp, fewer, device="cpu")


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 2])
def test_moe_forward_and_prefill_match_jax(name, dtype, seed):
    """Both MoE smoke configs through ``forward`` (hidden and the summed
    aux loss) and ``prefill``; each batch row is its own routing
    group."""
    jc, c = _cfgs(name, dtype)
    jp = JT.init_params(jc, jax.random.key(seed))
    tp = lm_params_from_numpy(jp, c, device="cpu")
    toks = _tokens(seed, c.vocab_size)
    hidden, aux = T.forward(tp, torch.from_numpy(toks), c)
    logits = T.prefill(tp, torch.from_numpy(toks), c)
    if dtype == "float32":
        want, want_aux = JT.forward(jp, jnp.asarray(toks), jc, remat=False)
        want_logits = JT.prefill(jp, jnp.asarray(toks), jc)
        tol = F32
    else:
        with jax.disable_jit():
            want, want_aux = JT.forward(jp, jnp.asarray(toks), jc,
                                        remat=False, scan_layers=False)
            want_logits = JT.prefill(jp, jnp.asarray(toks), jc)
        tol = BF16
    assert hidden.dtype == T._dt(c) and hidden.shape == (3, 70, c.d_model)
    assert aux.dtype == torch.float32 and float(aux) > 0
    np.testing.assert_allclose(_np(hidden), _np(want), **tol)
    np.testing.assert_allclose(_np(logits), _np(want_logits), **tol)
    np.testing.assert_allclose(float(aux), float(want_aux), **F32)


@pytest.mark.parametrize("name", MOE)
def test_moe_forward_in_the_drop_regime_matches_jax(name):
    """Granite's and moonshot's published capacity factor 1.25 on the
    smoke widths: groups of 70 tokens drop (token, slot) pairs, and the
    same pairs drop in both."""
    jc, c = _cfgs(name, "float32")
    moe = dataclasses.replace(c.moe, capacity_factor=1.25)
    jc, c = (dataclasses.replace(jc, moe=moe),
             dataclasses.replace(c, moe=moe))
    jp = JT.init_params(jc, jax.random.key(5))
    tp = lm_params_from_numpy(jp, c, device="cpu")
    toks = _tokens(5, c.vocab_size)
    hidden, aux = T.forward(tp, torch.from_numpy(toks), c)
    want, want_aux = JT.forward(jp, jnp.asarray(toks), jc, remat=False)
    np.testing.assert_allclose(_np(hidden), _np(want), **F32)
    np.testing.assert_allclose(float(aux), float(want_aux), **F32)
    dropless, _ = T.forward(tp, torch.from_numpy(toks),
                            dataclasses.replace(c, moe=dataclasses.replace(
                                moe, capacity_factor=8.0)))
    assert not torch.allclose(hidden, dropless, **F32)


# -- the SEINE bridge ------------------------------------------------------

@pytest.fixture(scope="module")
def lm_world(seine_world):
    """tests/test_system.py's recipe: smoke("stablelm-1.6b") from
    jax.random.key(0), projected to the SEINE config's embed_dim; the JAX
    build over the first 8 docs in batches of 4, and the port's over the
    same LM, projection, vocabulary and interaction parameters."""
    w = seine_world
    jc, c = jax_smoke("stablelm-1.6b"), smoke("stablelm-1.6b")
    jp = JT.init_params(jc, jax.random.key(0))
    jprov = JaxLMProvider(jc, jp, embed_dim=w["cfg"].embed_dim)
    jb = JaxBuilder(w["cfg"], w["vocab"], jprov)
    jidx = jb.build(w["toks"][:8], w["segs"][:8], batch_size=4)
    prov = lm_provider_from_numpy(c, jp, np.asarray(jprov._proj),
                                  device="cpu")
    ds = generate(seine_smoke(), seed=0)
    vocab = build_vocabulary(ds.docs, ds.n_raw_tokens,
                             keep_frac=seine_smoke().vocab_keep_frac)
    b = IndexBuilder(seine_smoke(), vocab, prov,
                     ip=interaction_params_from_jax(jb.ip, device="cpu"),
                     device="cpu")
    idx = b.build(w["toks"][:8], w["segs"][:8], batch_size=4)
    return dict(jprov=jprov, jidx=jidx, prov=prov, builder=b, index=idx)


def test_lm_provider_matches_jax(seine_world, lm_world):
    w, jprov, prov = seine_world, lm_world["jprov"], lm_world["prov"]
    table = prov.table()
    assert table.dtype == torch.float32 and table.shape == (512, 32)
    np.testing.assert_allclose(_np(table), _np(jprov.table()), **F32)
    toks, segs = w["toks"][:4], w["segs"][:4]
    got = prov.contextualize(torch.from_numpy(toks), torch.from_numpy(segs))
    assert got.shape == toks.shape + (32,)
    for i in range(4):
        want = jprov.contextualize(jnp.asarray(toks[i]), jnp.asarray(segs[i]))
        np.testing.assert_allclose(_np(got[i]), _np(want), **F32)
        assert bool((got[i][toks[i] < 0] == 0).all())
    one = prov.contextualize(torch.from_numpy(toks[1]),
                             torch.from_numpy(segs[1]))
    np.testing.assert_allclose(_np(one), _np(got[1]), **F32)


def test_lm_build_matches_jax(lm_world):
    got, want = lm_world["index"], lm_world["jidx"]
    assert got.nnz == int(want.nnz) > 0
    for n in ("term_offsets", "doc_ids", "fences"):
        g, w = got.__dict__[n].numpy(), np.asarray(getattr(want, n))
        assert g.dtype == w.dtype, n
        np.testing.assert_array_equal(g, w, err_msg=n)
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               **F32)


def test_lm_indexed_equals_noindex(seine_world, lm_world):
    """Every stored pair of the 8 docs: M looked up == M recomputed
    through the LM at query time (tests/test_seine_core.py's atol)."""
    w, idx = seine_world, lm_world["index"]
    noindex = NoIndexEngine(lm_world["builder"], idx, w["toks"][:8],
                            w["segs"][:8], "knrm",
                            _knrm_params(idx))
    for d in range(8):
        present = np.unique(w["toks"][d][w["toks"][d] >= 0])[:6]
        q = torch.from_numpy(present.astype(np.int32))
        docs = torch.tensor([d], dtype=torch.int32)
        looked, fly = idx.qd_matrix(q, docs), noindex.qd_matrix(q, docs)
        assert bool(looked.flatten(2).ne(0).any(-1).all())
        np.testing.assert_allclose(_np(fly), _np(looked), rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def moe_lm_world(seine_world):
    """``lm_world``'s recipe over smoke("granite-moe-3b-a800m") in its
    published drop regime (capacity factor 1.25): the JAX build and the
    port's over the first 8 docs, and the JAX provider."""
    w = seine_world
    moe = dataclasses.replace(jax_smoke("granite-moe-3b-a800m").moe,
                              capacity_factor=1.25)
    jc = dataclasses.replace(jax_smoke("granite-moe-3b-a800m"), moe=moe)
    c = dataclasses.replace(smoke("granite-moe-3b-a800m"), moe=moe)
    jp = JT.init_params(jc, jax.random.key(0))
    jprov = JaxLMProvider(jc, jp, embed_dim=w["cfg"].embed_dim)
    jb = JaxBuilder(w["cfg"], w["vocab"], jprov)
    jidx = jb.build(w["toks"][:8], w["segs"][:8], batch_size=4)
    prov = lm_provider_from_numpy(c, jp, np.asarray(jprov._proj),
                                  device="cpu")
    b = IndexBuilder(seine_smoke(), _port_vocab(), prov,
                     ip=interaction_params_from_jax(jb.ip, device="cpu"),
                     device="cpu")
    idx = b.build(w["toks"][:8], w["segs"][:8], batch_size=4)
    return dict(jprov=jprov, jidx=jidx, prov=prov, index=idx)


def _port_vocab():
    ds = generate(seine_smoke(), seed=0)
    return build_vocabulary(ds.docs, ds.n_raw_tokens,
                            keep_frac=seine_smoke().vocab_keep_frac)


def test_moe_lm_provider_matches_jax(seine_world, moe_lm_world):
    """``contextualize`` of 4 docs at once equals the reference's one-doc
    forwards: each doc routes as its own group at the padded length."""
    w, jprov, prov = seine_world, moe_lm_world["jprov"], moe_lm_world["prov"]
    np.testing.assert_allclose(_np(prov.table()), _np(jprov.table()), **F32)
    toks, segs = w["toks"][:4], w["segs"][:4]
    got = prov.contextualize(torch.from_numpy(toks), torch.from_numpy(segs))
    for i in range(4):
        want = jprov.contextualize(jnp.asarray(toks[i]), jnp.asarray(segs[i]))
        np.testing.assert_allclose(_np(got[i]), _np(want), **F32)
        assert bool((got[i][toks[i] < 0] == 0).all())


def test_moe_lm_build_matches_jax(moe_lm_world):
    got, want = moe_lm_world["index"], moe_lm_world["jidx"]
    assert got.nnz == int(want.nnz) > 0
    for n in ("term_offsets", "doc_ids", "fences"):
        g, w = got.__dict__[n].numpy(), np.asarray(getattr(want, n))
        assert g.dtype == w.dtype, n
        np.testing.assert_array_equal(g, w, err_msg=n)
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               **F32)


def _knrm_params(idx):
    from repro_torch.retrievers import get_retriever
    return get_retriever("knrm").init(torch.Generator().manual_seed(0),
                                      idx.n_b, idx.functions, device="cpu")


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    c = smoke("minitron-4b")
    params = T.init_params(c, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_params(c)
    with pytest.raises(RuntimeError, match="CUDA"):
        LMProvider(c, params, 16)
    prov = LMProvider(c, params, 16, device="cpu")
    assert prov.table().shape == (c.vocab_size, 16)
    assert prov.device.type == "cpu"


def test_readme_lm_recipe_runs():
    """The README's LM recipe runs as written after its build recipe (on
    the CPU here)."""
    with open(os.path.join(REPO, "README.md")) as f:
        blocks = [b.split("```")[0] for b in f.read().split("```python\n")[1:]]
    code = next(b for b in blocks if "repro_torch.core.builder" in b) \
        + next(b for b in blocks if "LMProvider" in b) \
        + "print('lm', pidx.n_shards, pidx.nnz > 0)\n"
    env = dict({k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
               PYTHONPATH="src")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "lm 2 True" in r.stdout
