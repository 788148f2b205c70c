"""PyTorch port of the nine retrievers: each scorer, fed the JAX init's
own parameters through ``convert.params_from_jax``, matches the JAX
scorer at rtol 1e-5 / atol 1e-6 and ranks the candidates identically."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.retrievers import QMeta as JaxQMeta
from repro.retrievers import all_retrievers as jax_all
from repro.retrievers import get_retriever as jax_get
from repro.retrievers import hinge_pair_loss as jax_hinge
from repro_torch.convert import params_from_jax
from repro_torch.data.synth_corpus import ZIPF_FUNCTIONS
from repro_torch.retrievers import (QMeta, all_retrievers, get_retriever,
                                    hinge_pair_loss)
import torch_threads  # noqa: F401  (PyTorch threads per test process)

TOL = dict(rtol=1e-5, atol=1e-6)
B, Q, N_B = 48, 6, 7


def _batch(seed):
    """Random M with absent pairs (zero rows), pad query slots, empty
    segments and varied lengths, as numpy."""
    rng = np.random.RandomState(seed)
    m = rng.uniform(-1, 3, size=(B, Q, N_B, len(ZIPF_FUNCTIONS)))
    m *= rng.rand(B, Q, 1, 1) > 0.3                   # absent pairs
    m[:4] = 0.0                                        # docs matching nothing
    tf = ZIPF_FUNCTIONS.index("tf")
    m[..., tf] = np.abs(np.round(m[..., tf]))          # tf counts >= 0
    seg_len = rng.randint(0, 40, size=(B, N_B)).astype(np.float32)
    seg_len[:, 0] = np.maximum(seg_len[:, 0], 1)
    meta = dict(q_mask=np.array([1, 1, 1, 1, 0, 0], np.float32),
                q_idf=rng.uniform(0.5, 4, size=Q).astype(np.float32),
                doc_len=seg_len.sum(1), seg_len=seg_len,
                avg_dl=np.float32(seg_len.sum(1).mean()))
    return m.astype(np.float32), meta


def _jax_meta(meta):
    return JaxQMeta(**{k: jnp.asarray(v) for k, v in meta.items()})


def _torch_meta(meta):
    return QMeta(**{k: torch.as_tensor(v) for k, v in meta.items()})


def _params(name, seed=0):
    jp = jax_get(name).init(jax.random.PRNGKey(seed), N_B, ZIPF_FUNCTIONS)
    return jp, params_from_jax(name, jp, device="cpu")


def test_registry_matches_jax():
    assert all_retrievers() == jax_all()
    assert len(all_retrievers()) == 9
    for name in all_retrievers():
        assert get_retriever(name).needs == jax_get(name).needs


@pytest.mark.parametrize("name", sorted(jax_all()))
def test_scorer_matches_jax(name):
    jp, tp = _params(name)
    # the port's own init draws the same layout
    own = get_retriever(name).init(torch.Generator().manual_seed(0), N_B,
                                   ZIPF_FUNCTIONS, device="cpu")
    assert {k: v.shape for k, v in own.state_dict().items()} == \
        {k: v.shape for k, v in tp.state_dict().items()}
    for seed in range(2):
        m, meta = _batch(seed)
        want = np.asarray(jax_get(name).score(jp, jnp.asarray(m),
                                              _jax_meta(meta),
                                              ZIPF_FUNCTIONS))
        with torch.no_grad():
            got = get_retriever(name).score(tp, torch.from_numpy(m),
                                            _torch_meta(meta),
                                            ZIPF_FUNCTIONS).numpy()
        np.testing.assert_allclose(got, want, **TOL, err_msg=name)
        np.testing.assert_array_equal(np.argsort(-got, kind="stable"),
                                      np.argsort(-want, kind="stable"))


def test_hinge_pair_loss_matches_jax():
    jp, tp = _params("knrm", seed=3)
    (m1, meta1), (m2, meta2) = _batch(0), _batch(1)
    want = float(jax_hinge(jax_get("knrm").score, jp, jnp.asarray(m1),
                           jnp.asarray(m2), _jax_meta(meta1),
                           _jax_meta(meta2), ZIPF_FUNCTIONS))
    got = hinge_pair_loss(get_retriever("knrm").score, tp,
                          torch.from_numpy(m1), torch.from_numpy(m2),
                          _torch_meta(meta1), _torch_meta(meta2),
                          ZIPF_FUNCTIONS)
    np.testing.assert_allclose(float(got.detach()), want, **TOL)
    got.backward()                      # parameters train in the port
    assert tp["w"].grad is not None


def test_params_from_jax_rejects_a_foreign_tree():
    jp, _ = _params("hint")
    with pytest.raises(ValueError, match="do not match"):
        params_from_jax("knrm", jp, device="cpu")
    with pytest.raises(KeyError, match="unknown retriever"):
        params_from_jax("bm26", {}, device="cpu")
