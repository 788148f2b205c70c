"""PyTorch port of the KNRM kernel bank, held at rtol 1e-5 / atol 1e-6
(the bar tests/test_kernels.py sets between knrm_pool and its oracle)
against the JAX ``knrm_pool_ref`` and ``kernel_features``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.knrm_pool.ref import knrm_pool_ref as jax_pool_ref
from repro.retrievers.knrm import MUS as JAX_MUS
from repro.retrievers.knrm import SIGMAS as JAX_SIGMAS
from repro.retrievers.knrm import kernel_features as jax_features
from repro_torch.kernels.knrm_pool import (MUS, SIGMAS, kernel_features,
                                           knrm_pool, knrm_pool_kernel,
                                           knrm_pool_ref)
import torch_threads  # noqa: F401  (PyTorch threads per test process)

TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(shape, seed, c_lo=-1.0):
    """cos_norm in [c_lo, 1] with exact-match (+1) entries (and -1 ones
    when c_lo is -1), and a segment mask with an all-empty candidate."""
    b, q, n_b = shape
    rng = np.random.RandomState(seed)
    cos = rng.uniform(c_lo, 1, size=shape).astype(np.float32)
    cos.reshape(-1)[::7] = 1.0
    if c_lo == -1.0:
        cos.reshape(-1)[3::11] = -1.0
    mask = (rng.rand(b, n_b) > 0.25).astype(np.float32)
    mask[0] = 0.0
    return cos, mask


def test_constants_match_jax():
    np.testing.assert_array_equal(np.float32(MUS), np.asarray(JAX_MUS))
    np.testing.assert_array_equal(np.float32(SIGMAS),
                                  np.asarray(JAX_SIGMAS))


# (B, Q, n_b[, c_lo]): n_b not a multiple of 4, Q = 1 (the coalesced
# front end), B * Q that the kernel's 16-row tiles do not divide, and
# cos_norm in [0.99, 1.0], where only the exact-match kernel (sigma 1e-3)
# is far from 0 and it spans exp(0) to exp(-50)
@pytest.mark.parametrize("shape", [(1, 1, 1), (3, 6, 5), (17, 6, 20),
                                   (64, 9, 20), (5, 130, 7), (4, 6, 3),
                                   (9, 1, 7), (37, 1, 20), (11, 6, 3),
                                   (40, 6, 20, 0.99), (9, 1, 7, 0.99)])
@pytest.mark.parametrize("seed", [0, 1])
def test_pool_matches_jax(shape, seed):
    """Every candidate 0 is fully masked."""
    cos, mask = _inputs(shape[:3], seed, *shape[3:])
    want = np.asarray(jax_pool_ref(jnp.asarray(cos), jnp.asarray(mask)))
    feats = np.asarray(jax_features(jnp.asarray(cos),
                                    jnp.asarray(mask)[:, None, :]))
    np.testing.assert_allclose(want, feats, **TOL)
    c, m = torch.from_numpy(cos), torch.from_numpy(mask)
    for got in (knrm_pool_ref(c, m), knrm_pool(c, m),
                knrm_pool_kernel(c, m), kernel_features(c, m[:, None, :])):
        assert got.shape == shape[:2] + (11,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("threads", [1, 2, 5])
def test_ref_is_bitwise_stable_across_threads_and_slicing(threads):
    """The plain version that the kernel and the nine scorers are held
    against gives the same bits whatever the CPU thread count and however
    the candidates are batched."""
    cos, mask = _inputs((64, 6, 20), 3)
    c, m = torch.from_numpy(cos), torch.from_numpy(mask)
    want = knrm_pool_ref(c, m)
    saved = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        whole = knrm_pool_ref(c, m)
        sliced = torch.cat([knrm_pool_ref(c[i:i + 7], m[i:i + 7])
                            for i in range(0, 64, 7)])
    finally:
        torch.set_num_threads(saved)
    assert torch.equal(whole, want) and torch.equal(sliced, want)


@pytest.mark.parametrize("n_b", [1024, 1025, 2500])
def test_scorer_past_one_staging_chunk_matches_jax(n_b):
    """At segment counts past the 1,024 a CTA stages at a time on the card
    (where the kernel walks them in chunks), the port's KNRM bank and
    scorer take the same inputs as the reference's ``kernel_features``
    and ``score``: features and scores at rtol 1e-5 / atol 1e-6."""
    import jax
    from repro.retrievers import get_retriever as jax_get
    from repro.retrievers.base import QMeta as JaxMeta
    from repro_torch.convert import params_from_jax
    from repro_torch.retrievers import QMeta, get_retriever
    cos, mask = _inputs((7, 6, n_b), n_b)
    want = np.asarray(jax_features(jnp.asarray(cos),
                                   jnp.asarray(mask)[:, None, :]))
    c, m = torch.from_numpy(cos), torch.from_numpy(mask)
    np.testing.assert_allclose(knrm_pool(c, m).numpy(), want, **TOL)
    rng = np.random.RandomState(n_b)
    seg_len = (rng.randint(0, 4, (7, n_b)) * mask).astype(np.float32)
    q_mask = np.array([1, 1, 0, 1, 1, 1], np.float32)
    m4 = np.zeros((7, 6, n_b, 2), np.float32)
    m4[..., 1] = cos * np.maximum(seg_len, 1.0)[:, None, :]
    fns = ("tf", "cosine")
    jparams = jax_get("knrm").init(jax.random.key(0), n_b, fns)
    meta = dict(q_mask=q_mask, q_idf=q_mask, doc_len=seg_len.sum(1),
                seg_len=seg_len, avg_dl=np.float32(seg_len.sum(1).mean()))
    js = jax_get("knrm").score(
        jparams, jnp.asarray(m4),
        JaxMeta(**{k: jnp.asarray(v) for k, v in meta.items()}), fns)
    with torch.no_grad():
        got = get_retriever("knrm").score(
            params_from_jax("knrm", jparams, device="cpu"),
            torch.from_numpy(m4),
            QMeta(**{k: torch.as_tensor(v) for k, v in meta.items()}), fns)
    np.testing.assert_allclose(got.numpy(), np.asarray(js), **TOL)


def test_bank_made_under_inference_mode_serves_autograd():
    """An engine scores under ``torch.inference_mode`` before a training
    step in the same process: the RBF bank cached by the first call must
    still be usable by autograd."""
    from repro_torch.kernels.knrm_pool import ref
    ref._bank.cache_clear()
    x = torch.rand(2, 3, 4)
    mask = torch.ones(2, 4)
    try:
        with torch.inference_mode():
            want = kernel_features(x, mask[:, None, :])
        xg = x.clone().requires_grad_(True)
        got = kernel_features(xg, mask[:, None, :])
        got.sum().backward()
        assert xg.grad is not None and bool(torch.isfinite(xg.grad).all())
        torch.testing.assert_close(got.detach(), want, rtol=0, atol=0)
    finally:
        ref._bank.cache_clear()
