"""PyTorch port of the KV-cache decode (``models.transformer``'s
``KVCache`` / ``init_cache`` / ``decode_step``, and the port's
``prefill_cache``) and of the decode attention's slice merge
(``dist.sp_decode``), held against the JAX package on the CPU.

``decode_step`` against JAX's step by step, dense and MoE, float32
(rtol 1e-4 / atol 1e-5) and bf16 (2e-2, JAX op by op under
``jax.disable_jit``), with per-row lengths and a full row whose write
the reference drops; the port's decode against its own prefill and
forward at the reference's decode-vs-prefill bar (rtol 2e-2 / atol 2e-2,
tests/test_models_smoke.py::test_lm_decode_matches_prefill); the merge
at tests/test_extensions.py::TestSPDecode's 1e-5.
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

from repro.configs import smoke as jax_smoke
from repro.dist import sp_decode as JS
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import smoke
from repro_torch.convert import lm_params_from_numpy
from repro_torch.dist import sp_decode as S
from repro_torch.models import layers as TL
from repro_torch.models import transformer as T
import torch_threads  # noqa: F401  (PyTorch threads per test process)

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
DECODE_BAR = dict(rtol=2e-2, atol=2e-2)
MERGE = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("minitron-4b", "stablelm-1.6b", "granite-moe-3b-a800m",
         "moonshot-v1-16b-a3b")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _world(name, dtype, seed=0):
    jc = dataclasses.replace(jax_smoke(name), dtype=dtype)
    c = dataclasses.replace(smoke(name), dtype=dtype)
    jp = JT.init_params(jc, jax.random.key(seed))
    return jc, c, jp, lm_params_from_numpy(jp, c, device="cpu")


def _jax_step(jp, cache, toks, jc, dtype):
    if dtype == "bfloat16":
        with jax.disable_jit():
            return JT.decode_step(jp, cache, jnp.asarray(toks), jc)
    return JT.decode_step(jp, cache, jnp.asarray(toks), jc)


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_matches_jax(name, dtype):
    jc, c = jax_smoke(name), smoke(name)
    jc, c = (dataclasses.replace(jc, dtype=dtype),
             dataclasses.replace(c, dtype=dtype))
    want = JT.init_cache(jc, 3, 11)
    got = T.init_cache(c, 3, 11, device="cpu")
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        assert not bool(g.any())
    assert T.init_cache(c, 2, 5, dtype=torch.float32,
                        device="cpu").k.dtype == torch.float32


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_jax(name, dtype):
    """Seven steps from an empty cache, the logits, the cache and its
    lengths after every step."""
    jc, c, jp, tp = _world(name, dtype)
    toks = np.random.RandomState(1).randint(-1, c.vocab_size + 40,
                                            (3, 7)).astype(np.int32)
    jcache = JT.init_cache(jc, 3, 9)
    cache = T.init_cache(c, 3, 9, device="cpu")
    tol = BF16 if dtype == "bfloat16" else F32
    for t in range(toks.shape[1]):
        want, jcache = _jax_step(jp, jcache, toks[:, t], jc, dtype)
        got, cache = T.decode_step(tp, cache, torch.from_numpy(toks[:, t]),
                                   c)
        assert got.dtype == torch.float32 and got.shape == (3, c.vocab_size)
        np.testing.assert_allclose(_np(got), _np(want), **tol)
        np.testing.assert_array_equal(cache.length.numpy(),
                                      np.asarray(jcache.length))
        assert cache.length.dtype == torch.int32
    np.testing.assert_allclose(_np(cache.k), _np(jcache.k), **tol)
    np.testing.assert_allclose(_np(cache.v), _np(jcache.v), **tol)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_with_ragged_lengths_matches_jax(name):
    """A cache whose rows hold 0, 3, 6 and 8 (= full) positions of
    random k and v: each row writes at its own length, attends over its
    own valid prefix, and the full row's write is dropped."""
    jc, c, jp, tp = _world(name, "float32", seed=2)
    rng = np.random.RandomState(2)
    sh = (c.n_layers, 4, 8, c.n_kv_heads, c.head_dim)
    k0, v0 = (rng.randn(*sh).astype(np.float32) for _ in range(2))
    lengths = np.array([0, 3, 6, 8], np.int32)
    jcache = JT.KVCache(jnp.asarray(k0), jnp.asarray(v0),
                        jnp.asarray(lengths))
    cache = T.KVCache(torch.from_numpy(k0.copy()), torch.from_numpy(
        v0.copy()), torch.from_numpy(lengths))
    for t in range(2):
        toks = rng.randint(0, c.vocab_size, 4).astype(np.int32)
        want, jcache = JT.decode_step(jp, jcache, jnp.asarray(toks), jc)
        got, cache = T.decode_step(tp, cache, torch.from_numpy(toks), c)
        np.testing.assert_allclose(_np(got), _np(want), **F32)
        np.testing.assert_allclose(_np(cache.k), _np(jcache.k), **F32)
        np.testing.assert_allclose(_np(cache.v), _np(jcache.v), **F32)
        np.testing.assert_array_equal(cache.length.numpy(),
                                      np.asarray(jcache.length))
    np.testing.assert_array_equal(cache.k[:, 3].numpy(), k0[:, 3])


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_prefill(name, dtype):
    """Greedy decode's logits at position t == prefill's logits of the
    prefix through t (the reference's own check, on the port)."""
    _, c, _, tp = _world(name, dtype, seed=1)
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, c.vocab_size, (2, 6)).astype(np.int32))
    cache = T.init_cache(c, 2, 7, device="cpu")
    for t in range(6):
        logits, cache = T.decode_step(tp, cache, toks[:, t], c)
        want = T.prefill(tp, toks[:, :t + 1], c)
        np.testing.assert_allclose(_np(logits), _np(want), **DECODE_BAR)


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_cache_then_decode_matches_forward(name, dtype):
    """A prompt of 9 through ``prefill_cache``, then 4 decode steps: its
    logits equal the forward's over all 13 tokens at positions 8-12, and
    its cache equals the cache that decoding the prompt token by token
    leaves (the smoke configs are dropless)."""
    _, c, _, tp = _world(name, dtype, seed=4)
    toks = torch.from_numpy(np.random.RandomState(4).randint(
        0, c.vocab_size, (3, 13)).astype(np.int32))
    hidden, _ = T.forward(tp, toks, c)
    want = T.logits_of(tp, hidden, c)
    logits, cache = T.prefill_cache(tp, toks[:, :9], c, 16)
    assert cache.k.shape == (c.n_layers, 3, 16, c.n_kv_heads, c.head_dim)
    assert cache.length.tolist() == [9, 9, 9]
    np.testing.assert_allclose(_np(logits), _np(want[:, 8]), **DECODE_BAR)
    stepped = T.init_cache(c, 3, 16, device="cpu")
    for t in range(9):
        _, stepped = T.decode_step(tp, stepped, toks[:, t], c)
    tol = BF16 if dtype == "bfloat16" else F32
    np.testing.assert_allclose(_np(cache.k), _np(stepped.k), **tol)
    np.testing.assert_allclose(_np(cache.v), _np(stepped.v), **tol)
    for t in range(9, 13):
        logits, cache = T.decode_step(tp, cache, toks[:, t], c)
        np.testing.assert_allclose(_np(logits), _np(want[:, t]),
                                   **DECODE_BAR)
    with pytest.raises(ValueError, match="max_len"):
        T.prefill_cache(tp, toks, c, 12)


def test_init_cache_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_cache(smoke("granite-moe-3b-a800m"), 1, 4)


# -- the decode attention's slice merge -------------------------------------

def _merge_case(seed, lengths, n_b=2, n_s=64, hq=4, hkv=2, hd=16):
    rng = np.random.RandomState(seed)
    q = rng.randn(n_b, hq, hd).astype(np.float32)
    k = rng.randn(n_b, n_s, hkv, hd).astype(np.float32)
    v = rng.randn(n_b, n_s, hkv, hd).astype(np.float32)
    return q, k, v, np.asarray(lengths, np.int32)


def _slices(q, k, v, lengths, n_slices, mod):
    s_loc = k.shape[1] // n_slices
    stats = []
    for i in range(n_slices):
        pos = i * s_loc + np.arange(s_loc)
        valid = pos[None, :] < lengths[:, None]
        sl = slice(i * s_loc, (i + 1) * s_loc)
        if mod is S:
            stats.append(S.local_decode_stats(
                torch.from_numpy(q), torch.from_numpy(k[:, sl]),
                torch.from_numpy(v[:, sl]), torch.from_numpy(valid)))
        else:
            stats.append(JS.local_decode_stats(
                jnp.asarray(q), jnp.asarray(k[:, sl]), jnp.asarray(v[:, sl]),
                jnp.asarray(valid)))
    return stats


@pytest.mark.parametrize("lengths", [[40, 64], [10, 64], [1, 17]])
@pytest.mark.parametrize("n_slices", [1, 4])
def test_slice_stats_and_merge_match_jax(lengths, n_slices):
    """tests/test_extensions.py's case (B 2, S 64, 4/2 heads of 16) and
    rows whose later slices hold no valid position (m = -inf)."""
    q, k, v, ln = _merge_case(0, lengths)
    got = _slices(q, k, v, ln, n_slices, S)
    want = _slices(q, k, v, ln, n_slices, JS)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **MERGE)
    stack = [torch.stack([s[j] for s in got]) for j in range(3)]
    out = S.combine_decode_stats(*stack)
    want_out = JS.combine_decode_stats(
        *[jnp.stack([s[j] for s in want]) for j in range(3)])
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **MERGE)
    for b in range(q.shape[0]):
        n = int(ln[b])
        ref = JL.naive_attention(jnp.asarray(q[b:b + 1, None]),
                                 jnp.asarray(k[b:b + 1, :n]),
                                 jnp.asarray(v[b:b + 1, :n]),
                                 causal=False)[0, 0]
        np.testing.assert_allclose(out[b].numpy(), np.asarray(ref), **MERGE)


@pytest.mark.parametrize("n_slices", [2, 4, 8])
def test_merge_equals_gqa_attention_decode(n_slices):
    """The merge of the cache's slices == ``gqa_attention``'s decode
    output over the whole cache with ``kv_valid_len`` (what
    ``decode_step`` runs)."""
    q, k, v, ln = _merge_case(1, [23, 64, 5], n_b=3)
    got = _slices(q, k, v, ln, n_slices, S)
    out = S.combine_decode_stats(*[torch.stack([s[j] for s in got])
                                   for j in range(3)])
    want = TL.gqa_attention(torch.from_numpy(q)[:, None],
                            torch.from_numpy(k), torch.from_numpy(v),
                            causal=False, chunk=64,
                            kv_valid_len=torch.from_numpy(ln))[:, 0]
    np.testing.assert_allclose(out.numpy(), want.numpy(), **MERGE)


def test_sp_decode_attention_raises():
    with pytest.raises(NotImplementedError, match="mesh"):
        S.sp_decode_attention(None, "seq")


def test_readme_decode_recipe_runs():
    """The README's decode recipe runs as written (on the CPU here)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "README.md")) as f:
        blocks = [b.split("```")[0] for b in f.read().split("```python\n")[1:]]
    code = next(b for b in blocks if "prefill_cache" in b)
    env = dict({k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
               PYTHONPATH="src")
    r = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[24, 24]"
