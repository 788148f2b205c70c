"""PyTorch port of the MoE FFN (``models.transformer.moe_ffn``: the
float32 router, top-k, the Switch aux loss, the slot ranks, the capacity
drop and the expert SwiGLU), held against ``repro.models.transformer``
on the CPU.

Weights cross from JAX through ``convert.lm_params_from_numpy``.  Bars:
float32 at rtol 1e-4 / atol 1e-5, bf16 at 2e-2
(tests/test_torch_transformer.py's); bf16 against the reference run op
by op (``jax.disable_jit``), whose rounding points are its source's.
The smoke configs' capacity factor 8 is dropless; 0.5 and 1.25 drop
(Switch semantics), so which (token, slot) pairs keep a row must match.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke as jax_smoke
from repro.models import transformer as JT
from repro_torch.configs import smoke
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import transformer as T
import torch_threads  # noqa: F401  (PyTorch threads per test process)

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
MOE = ("granite-moe-3b-a800m", "moonshot-v1-16b-a3b")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _world(name, dtype, seed=0):
    jc = dataclasses.replace(jax_smoke(name), dtype=dtype)
    c = dataclasses.replace(smoke(name), dtype=dtype)
    jp = JT.init_params(jc, jax.random.key(seed))
    return jc, c, jp, lm_params_from_numpy(jp, c, device="cpu")


def _layer(tree, i=0):
    return {k: v[i] for k, v in tree["layers"].items()}


def _jax_moe(x, lp, jc, cf, dtype):
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16"
                               else jnp.float32)
    if dtype == "bfloat16":
        with jax.disable_jit():
            return JT.moe_ffn(jx, lp, jc, capacity_factor=cf)
    return JT.moe_ffn(jx, lp, jc, capacity_factor=cf)


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [None, 0.5, 1.25])
@pytest.mark.parametrize("layer", [0, 1])
def test_moe_ffn_matches_jax(name, dtype, cf, layer):
    """G = 3 groups of M = 37 tokens; cf None is the config's dropless
    8.0, 0.5 and 1.25 drop."""
    jc, c, jp, tp = _world(name, dtype)
    x = np.random.RandomState(layer).randn(3, 37, c.d_model).astype(
        np.float32)
    want, want_aux = _jax_moe(x, _layer(jp, layer), jc, cf, dtype)
    got, aux = T.moe_ffn(torch.from_numpy(x).to(T._dt(c)), _layer(tp, layer),
                         c, capacity_factor=cf)
    assert got.dtype == T._dt(c) and got.shape == (3, 37, c.d_model)
    assert aux.dtype == torch.float32 and aux.shape == ()
    tol = BF16 if dtype == "bfloat16" else F32
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_allclose(float(aux), float(want_aux), **F32)


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
def test_all_tie_router_matches_jax(name, cf):
    """An all-zero router gives every expert probability 1/E: top-k must
    take the lowest ids first and the slot ranks must follow token
    order, as JAX's ``top_k`` and stable argsort do, so the same pairs
    are kept and dropped."""
    jc, c, jp, tp = _world(name, "float32", seed=3)
    jlp = dict(_layer(jp), router=jnp.zeros_like(jp["layers"]["router"][0]))
    tlp = dict(_layer(tp), router=torch.zeros_like(tp["layers"]["router"][0]))
    x = np.random.RandomState(5).randn(3, 37, c.d_model).astype(np.float32)
    want, want_aux = JT.moe_ffn(jnp.asarray(x), jlp, jc, capacity_factor=cf)
    got, aux = T.moe_ffn(torch.from_numpy(x), tlp, c, capacity_factor=cf)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_allclose(float(aux), float(want_aux), **F32)
    cap = T.moe_capacity(37, c.moe.top_k, c.moe.n_experts, cf)
    if cap < 37:
        # tokens past the capacity of experts 0..K-1 get nothing from
        # them: only the shared experts (if any) remain
        shared = torch.zeros_like(got[:, cap:])
        if c.moe.n_shared_experts:
            xt = torch.from_numpy(x)[:, cap:]
            shared = T.silu(xt @ tlp["ws_gate"]) * (xt @ tlp["ws_up"]) \
                @ tlp["ws_down"]
        np.testing.assert_allclose(_np(got[:, cap:]), _np(shared), **F32)


@pytest.mark.parametrize("m,k,e,cf", [(37, 2, 4, 0.5), (37, 2, 4, 1.25),
                                      (512, 8, 40, 1.25), (1, 8, 40, 1.25),
                                      (512, 8, 40, 5.0), (1, 6, 64, 1.25)])
def test_capacity_matches_jax(m, k, e, cf):
    assert T.moe_capacity(m, k, e, cf) == JT.moe_capacity(m, k, e, cf)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_top_k_orders_ties_as_jax(seed):
    """Values from a few levels, so most rows hold ties."""
    x = np.random.RandomState(seed).randint(0, 4, (50, 12)).astype(
        np.float32) / 4
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 5)
    got_v, got_i = T.top_k(torch.from_numpy(x), 5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("seed", [0, 1])
def test_slot_ranks_follow_entry_order(seed):
    """The rank of each entry among its expert's entries in its group,
    counted in entry order (what the reference's sort-and-run ranking
    yields)."""
    eid = np.random.RandomState(seed).randint(0, 5, (4, 60))
    got = T.moe_slots(torch.from_numpy(eid)).numpy()
    want = np.zeros_like(eid)
    for g in range(eid.shape[0]):
        seen = {}
        for j, e in enumerate(eid[g]):
            want[g, j] = seen.get(e, 0)
            seen[e] = want[g, j] + 1
    np.testing.assert_array_equal(got, want)


def test_decode_shape_group_is_dropless():
    """At decode G = B, M = 1: C = 1 and the K experts of a token are
    distinct, so nothing drops (granite at full width: 40 experts,
    top-8)."""
    c = dataclasses.replace(smoke("granite-moe-3b-a800m"),
                            moe=dataclasses.replace(
                                smoke("granite-moe-3b-a800m").moe,
                                capacity_factor=1.25))
    jc = dataclasses.replace(jax_smoke("granite-moe-3b-a800m"), moe=c.moe)
    jp = JT.init_params(jc, jax.random.key(4))
    tp = lm_params_from_numpy(jp, c, device="cpu")
    x = np.random.RandomState(4).randn(5, 1, c.d_model).astype(np.float32)
    got, _ = T.moe_ffn(torch.from_numpy(x), _layer(tp), c)
    want, _ = JT.moe_ffn(jnp.asarray(x), _layer(jp), jc)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    dropless, _ = T.moe_ffn(torch.from_numpy(x), _layer(tp), c,
                            capacity_factor=100.0)
    np.testing.assert_allclose(_np(got), _np(dropless), **F32)
