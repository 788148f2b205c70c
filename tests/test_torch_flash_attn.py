"""PyTorch port of ``flash_attn`` and the attention helpers of
``models.layers``, held against the JAX package on the CPU.

The same numpy inputs go through JAX ``flash_attn_ref`` (the kernel's
oracle, ``naive_attention``) and ``gqa_attention`` (the chunked jnp
online softmax the JAX model runs) and through the port's
``flash_attn_plain`` (the CUDA kernel's tiling in torch) and
``ops.flash_attention`` (which, given CPU tensors, runs it).  Shapes are
those of tests/test_kernels.py::TestFlashAttention, its non-causal case,
the LM build's grouping at S = 160 (Hq 6 over Hkv 2), and sequence
lengths around the 64-row tile.  Bars: rtol 1e-4 / atol 1e-5 in float32
(tests/test_kernels.py's), 2e-2 for bf16 inputs.

The backward: ``flash_attn_bwd_plain`` (the backward kernel's tiling in
torch, P recomputed from the forward's lse) and ``flash_attention``'s
autograd Function, which runs it on CPU tensors, against ``jax.grad`` of
the reference's ``gqa_attention`` (the function the JAX model
differentiates) and of ``naive_attention``, at the same bars.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn.ref import flash_attn_ref as jax_ref
from repro.models.layers import gqa_attention as jax_gqa
from repro.models.layers import naive_attention as jax_naive
from repro_torch.kernels.flash_attn import (BLOCK_K, BLOCK_Q,
                                            flash_attention,
                                            flash_attention_plain,
                                            flash_attn_bwd_kernel,
                                            flash_attn_bwd_plain,
                                            flash_attn_kernel,
                                            flash_attn_plain)
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.models.layers import gqa_attention, naive_attention
import torch_threads  # noqa: F401  (PyTorch threads per test process)

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
# (B, S, Hq, Hkv, hd, causal): TestFlashAttention's four causal shapes,
# its non-causal one, and the LM build's group of 3 at S = 160
SHAPES = [(2, 128, 4, 2, 32, True), (1, 256, 8, 8, 64, True),
          (2, 64, 4, 1, 16, True), (1, 96, 2, 2, 32, True),
          (1, 64, 4, 2, 32, False), (2, 160, 6, 2, 32, True)]


def _qkv(b, sq, hq, hkv, hd, seed, skv=None):
    rng = np.random.RandomState(seed)
    skv = sq if skv is None else skv
    return (rng.randn(b, sq, hq, hd).astype(np.float32),
            rng.randn(b, skv, hkv, hd).astype(np.float32),
            rng.randn(b, skv, hkv, hd).astype(np.float32))


def _jax(arrays, dtype=jnp.float32):
    return [jnp.asarray(a).astype(dtype) for a in arrays]


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("b,s,hq,hkv,hd,causal", SHAPES)
def test_matches_jax_in_float32(b, s, hq, hkv, hd, causal):
    arrays = _qkv(b, s, hq, hkv, hd, seed=s + hq)
    q, k, v = _jax(arrays)
    want = _np(jax_ref(q, k, v, causal=causal))
    chunked = _np(jax_gqa(q, k, v, causal=causal, chunk=48))
    tq, tk, tv = _torch(arrays)
    for got in (flash_attn_plain(tq, tk, tv, causal=causal),
                flash_attention(tq, tk, tv, causal=causal)):
        assert got.dtype == torch.float32 and got.shape == tq.shape
        np.testing.assert_allclose(_np(got), want, **F32)
        np.testing.assert_allclose(_np(got), chunked, **F32)


@pytest.mark.parametrize("b,s,hq,hkv,hd,causal", SHAPES)
def test_matches_jax_in_bf16(b, s, hq, hkv, hd, causal):
    arrays = _qkv(b, s, hq, hkv, hd, seed=s + hq + 1)
    q, k, v = _jax(arrays, jnp.bfloat16)
    want = _np(jax_ref(q, k, v, causal=causal))
    chunked = _np(jax_gqa(q, k, v, causal=causal, chunk=64))
    got = flash_attention(*_torch(arrays, torch.bfloat16), causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), want, **BF16)
    np.testing.assert_allclose(_np(got), chunked, **BF16)


@pytest.mark.parametrize("sq,skv", [(1, 1), (63, 63), (64, 64), (65, 65),
                                    (127, 127), (129, 129), (70, 130),
                                    (130, 70)])
@pytest.mark.parametrize("causal", [True, False])
def test_tile_edges_match_jax_oracle(sq, skv, causal):
    """Sequence lengths at and around the tile: the tail tile is masked
    (no halving of the tile), the diagonal skip drops exactly the tiles
    above it; Sq != Skv counts both positions from 0, as the TPU
    kernel does."""
    arrays = _qkv(2, sq, 6, 2, 16, seed=sq * 7 + skv, skv=skv)
    want = _np(jax_naive(*_jax(arrays), causal=causal))
    got = flash_attn_plain(*_torch(arrays), causal=causal)
    np.testing.assert_allclose(_np(got), want, **F32)
    assert BLOCK_Q == BLOCK_K == 64


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,q_offset,chunk,valid", [(8, 0, 16, None),
                                                    (8, 32, 12, None),
                                                    (1, 32, 12, (35, 40)),
                                                    (1, 39, 7, (1, 40))])
def test_gqa_attention_matches_jax(causal, sq, q_offset, chunk, valid):
    """The port's chunked jnp stand-in: q_offset (a prefill chunk or a
    decode step), a chunk that does not divide Skv, kv_valid_len (a
    decode step: the reference broadcasts that mask for Sq = 1)."""
    arrays = _qkv(2, sq, 4, 2, 16, seed=q_offset + chunk, skv=40)
    kv_len = None if valid is None else np.asarray(valid, np.int32)
    want = jax_gqa(*_jax(arrays), causal=causal, q_offset=q_offset,
                   chunk=chunk, kv_valid_len=None if kv_len is None
                   else jnp.asarray(kv_len))
    got = gqa_attention(*_torch(arrays), causal=causal, q_offset=q_offset,
                        chunk=chunk, kv_valid_len=None if kv_len is None
                        else torch.from_numpy(kv_len))
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("q_offset", [0, 5])
def test_naive_attention_matches_jax(causal, q_offset):
    arrays = _qkv(2, 12, 6, 3, 32, seed=q_offset, skv=17)
    want = jax_naive(*_jax(arrays), causal=causal, q_offset=q_offset)
    got = naive_attention(*_torch(arrays), causal=causal, q_offset=q_offset)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    bf = naive_attention(*_torch(arrays, torch.bfloat16), causal=causal,
                         q_offset=q_offset)
    assert bf.dtype == torch.bfloat16


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """On the CPU the wrapper runs the plain version and counts nothing;
    ops hands it contiguous tensors in the model layout."""
    calls = []
    monkeypatch.setattr(fa_ops, "flash_attn_kernel",
                        lambda *a, **k: calls.append(a) or
                        flash_attn_kernel(*a, **k))
    arrays = _qkv(1, 40, 4, 2, 16, seed=3)
    tq, tk, tv = _torch(arrays)
    before = flash_attn_kernel.launches
    got = flash_attention(tq.transpose(1, 2).contiguous().transpose(1, 2),
                          tk, tv)
    assert flash_attn_kernel.launches == before
    assert all(t.is_contiguous() for t in calls[0])
    assert torch.equal(got, flash_attn_plain(tq, tk, tv))


@pytest.mark.parametrize("q,k", [((1, 8, 4, 16), (1, 8, 3, 16)),
                                 ((1, 8, 4, 16), (2, 8, 2, 16)),
                                 ((1, 8, 4, 16), (1, 8, 2, 32)),
                                 ((8, 4, 16), (8, 2, 16))])
def test_rejects_mismatched_shapes(q, k):
    with pytest.raises(ValueError):
        flash_attn_plain(torch.zeros(q), torch.zeros(k), torch.zeros(k))


@pytest.mark.parametrize("s", [512, 160])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_bf16_at_the_build_width_matches_jax(s, causal):
    """The plain version in bf16 (the kernel's yardstick on the card) at
    hd 128, the LM build's head width, against the JAX oracle (jnp, not
    the interpreter) at 2e-2, and against its own float32 run; S = 160
    is not a multiple of the 64-key tile."""
    arrays = _qkv(1, s, 3, 1, 128, seed=s + int(causal))
    want = _np(jax_ref(*_jax(arrays, jnp.bfloat16), causal=causal))
    tq, tk, tv = _torch(arrays, torch.bfloat16)
    got = flash_attn_plain(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), want, **BF16)
    f32 = flash_attn_plain(tq.float(), tk.float(), tv.float(),
                           causal=causal)
    np.testing.assert_allclose(_np(got), _np(f32), **BF16)


# (B, S, Hq, Hkv, hd, causal): groups 1, 2 and 4, head widths 16-128,
# lengths below, at and past the 64-row tile
BWD_SHAPES = [(2, 63, 4, 4, 16, True), (1, 64, 4, 2, 32, False),
              (2, 65, 8, 2, 64, True), (1, 130, 4, 1, 16, True),
              (1, 130, 4, 1, 16, False), (1, 100, 2, 2, 128, True),
              (2, 128, 8, 2, 32, True), (1, 1, 2, 1, 16, True)]


def _jax_grads(fn, arrays, do, dtype):
    """(dq, dk, dv) of sum(fn(q, k, v) * dO) by jax.grad (jitted: the
    eager grad of the chunked scan takes seconds a shape)."""
    q, k, v = _jax(arrays, dtype)
    g = jnp.asarray(do).astype(dtype)
    return jax.jit(jax.grad(lambda q, k, v: jnp.sum(
        fn(q, k, v).astype(jnp.float32) * g.astype(jnp.float32)),
        argnums=(0, 1, 2)))(q, k, v)


def _port_grads(arrays, do, dtype, causal, attention=flash_attention):
    q, k, v = (t.requires_grad_() for t in _torch(arrays, dtype))
    o = attention(q, k, v, causal=causal)
    return torch.autograd.grad(o, (q, k, v), torch.from_numpy(do).to(dtype))


@pytest.mark.parametrize("b,s,hq,hkv,hd,causal", BWD_SHAPES)
def test_backward_matches_jax_grad_in_float32(b, s, hq, hkv, hd, causal):
    """The plain backward, called directly on the plain forward's o and
    lse and through the autograd Function, against jax.grad of
    gqa_attention (chunks of 48, which do not divide the tile) and of
    naive_attention."""
    arrays = _qkv(b, s, hq, hkv, hd, seed=3 * s + hd)
    do = np.random.RandomState(s).randn(b, s, hq, hd).astype(np.float32)
    want_gqa = _jax_grads(lambda q, k, v: jax_gqa(q, k, v, causal=causal,
                                                  chunk=48),
                          arrays, do, jnp.float32)
    want_naive = _jax_grads(lambda q, k, v: jax_naive(q, k, v,
                                                      causal=causal),
                            arrays, do, jnp.float32)
    tq, tk, tv = _torch(arrays)
    o, lse = flash_attn_plain(tq, tk, tv, causal=causal, return_lse=True)
    direct = flash_attn_bwd_plain(tq, tk, tv, o, torch.from_numpy(do), lse,
                                  causal=causal)
    through = _port_grads(arrays, do, torch.float32, causal)
    for got in (direct, through):
        for name, g, w1, w2 in zip("qkv", got, want_gqa, want_naive):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(_np(g), _np(w1), **F32, err_msg=name)
            np.testing.assert_allclose(_np(g), _np(w2), **F32, err_msg=name)


@pytest.mark.parametrize("b,s,hq,hkv,hd,causal", BWD_SHAPES)
def test_backward_matches_jax_grad_in_bf16(b, s, hq, hkv, hd, causal):
    """bf16 inputs: the autograd Function's gradients (bf16, from the
    plain forward's bf16 o) against jax.grad of gqa_attention in bf16,
    at 2e-2."""
    arrays = _qkv(b, s, hq, hkv, hd, seed=5 * s + hd)
    do = np.random.RandomState(s + 1).randn(b, s, hq, hd).astype(np.float32)
    want = _jax_grads(lambda q, k, v: jax_gqa(q, k, v, causal=causal,
                                              chunk=64),
                      arrays, do, jnp.bfloat16)
    got = _port_grads(arrays, do, torch.bfloat16, causal)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(g), _np(w), **BF16, err_msg=name)


@pytest.mark.parametrize("sq,skv", [(70, 130), (130, 70)])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_with_other_key_lengths(sq, skv, causal):
    """Sq != Skv, both counted from 0 as in the forward: under the causal
    mask the keys past Sq get no gradient from any query."""
    arrays = _qkv(1, sq, 4, 2, 16, seed=sq + skv, skv=skv)
    do = np.random.RandomState(sq).randn(1, sq, 4, 16).astype(np.float32)
    want = _jax_grads(lambda q, k, v: jax_naive(q, k, v, causal=causal),
                      arrays, do, jnp.float32)
    got = _port_grads(arrays, do, torch.float32, causal)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(_np(g), _np(w), **F32, err_msg=name)
    if causal and skv > sq:
        assert not got[1][:, sq:].any() and not got[2][:, sq:].any()


# (B, Sq, Skv, Hq, Hkv, hd, causal): the bf16 backward test's shapes and
# the other key lengths, both ways, causal and full
PARTS_SHAPES = [(b, s, s, hq, hkv, hd, causal)
                for b, s, hq, hkv, hd, causal in BWD_SHAPES] + [
    (1, sq, skv, 4, 2, 16, causal) for sq, skv in ((70, 130), (130, 70))
    for causal in (True, False)]


@pytest.mark.parametrize("b,sq,skv,hq,hkv,hd,causal", PARTS_SHAPES)
def test_backward_bf16_parts_matches_jax_grad(b, sq, skv, hq, hkv, hd,
                                              causal):
    """The plain mirror of the bf16 kernel's operands (P and dS in two
    bf16 parts, the scale on the float32 S and in the epilogues), from
    the plain forward's bf16 o and lse, against jax.grad of gqa_attention
    in bf16: at most 0.1% of the values past 2e-2, the bar the card holds
    the kernel to; and within 2e-2 of the plain backward."""
    arrays = _qkv(b, sq, hq, hkv, hd, seed=7 * sq + skv + hd, skv=skv)
    do = np.random.RandomState(sq + 2).randn(b, sq, hq, hd).astype(
        np.float32)
    want = _jax_grads(lambda q, k, v: jax_gqa(q, k, v, causal=causal,
                                              chunk=64),
                      arrays, do, jnp.bfloat16)
    tq, tk, tv = _torch(arrays, torch.bfloat16)
    tdo = torch.from_numpy(do).bfloat16()
    o, lse = flash_attn_plain(tq, tk, tv, causal=causal, return_lse=True)
    got = flash_attn_bwd_plain(tq, tk, tv, o, tdo, lse, causal=causal,
                               bf16_parts=True)
    plain = flash_attn_bwd_plain(tq, tk, tv, o, tdo, lse, causal=causal)
    for name, g, w, p in zip("qkv", got, want, plain):
        assert g.dtype == torch.bfloat16 and g.shape == p.shape
        g, w = _np(g), _np(w)
        past = np.abs(g - w) > BF16["atol"] + BF16["rtol"] * np.abs(w)
        assert past.mean() <= 1e-3, (name, past.mean())
        np.testing.assert_allclose(g, _np(p), **BF16, err_msg=name)


def test_forward_lse_matches_logsumexp():
    """The lse the forward keeps is ln sum exp of the scaled, masked
    scores, per (b, h, row) in (B, Hq, Sq), and the output is the same
    with or without it."""
    arrays = _qkv(2, 130, 6, 2, 32, seed=11)
    tq, tk, tv = _torch(arrays)
    o, lse = flash_attn_plain(tq, tk, tv, causal=True, return_lse=True)
    assert torch.equal(o, flash_attn_plain(tq, tk, tv, causal=True))
    kr = tk.repeat_interleave(3, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", tq, kr) / np.sqrt(32)
    s = s.masked_fill(torch.ones(130, 130).triu(1).bool(), float("-inf"))
    np.testing.assert_allclose(_np(lse), _np(torch.logsumexp(s, -1)), **F32)


def test_autograd_takes_the_plain_versions_on_the_cpu(monkeypatch):
    """On CPU tensors the Function calls the kernel wrappers, which run
    the plain forward (with lse) and the plain backward and count no
    launch; with no input needing a gradient the forward keeps no lse.
    ``flash_attention_plain`` gives the same bits."""
    calls = []
    monkeypatch.setattr(fa_ops, "flash_attn_kernel",
                        lambda *a, **k: calls.append(k) or
                        flash_attn_kernel(*a, **k))
    arrays = _qkv(1, 70, 4, 2, 16, seed=4)
    do = np.random.RandomState(4).randn(1, 70, 4, 16).astype(np.float32)
    before = (flash_attn_kernel.launches, flash_attn_bwd_kernel.launches)
    got = _port_grads(arrays, do, torch.float32, True)
    assert calls == [dict(causal=True, return_lse=True)]
    with torch.no_grad():
        flash_attention(*_torch(arrays))
    assert calls[-1] == dict(causal=True)
    plain = _port_grads(arrays, do, torch.float32, True,
                        attention=flash_attention_plain)
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    assert (flash_attn_kernel.launches,
            flash_attn_bwd_kernel.launches) == before


def test_backward_rejects_mismatched_shapes():
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 3, 16)
    with pytest.raises(ValueError):
        flash_attn_bwd_plain(q, k, k, q, q, torch.zeros(1, 4, 8))


# (B, Sq, Skv, Hq, Hkv, hd, causal): hd 16 and 32, groups of 1 and 3, Sq
# and Skv of 70, 130 and 200 (BERT4Rec's full 200 x 200 among them),
# causal and full
TF32_SHAPES = [(2, 200, 200, 2, 2, 32, False), (1, 130, 70, 3, 1, 16, True),
               (1, 70, 130, 6, 2, 32, True), (1, 200, 130, 3, 1, 16, False),
               (1, 130, 200, 2, 2, 16, True)]


def _tf32_mirror(arrays, do, causal):
    """The float32 kernels' split-TF32 mirror: o, then (dQ, dK, dV) from
    its own o and lse."""
    tq, tk, tv = _torch(arrays)
    o, lse = flash_attn_plain(tq, tk, tv, causal=causal, return_lse=True,
                              tf32_parts=True)
    return o, flash_attn_bwd_plain(tq, tk, tv, o, torch.from_numpy(do), lse,
                                   causal=causal, tf32_parts=True)


def _tf32_want(arrays, do, causal):
    """JAX gqa_attention's output and its jax.grad, both jitted."""
    o = jax.jit(lambda q, k, v: jax_gqa(q, k, v, causal=causal, chunk=64))(
        *_jax(arrays))
    grads = _jax_grads(lambda q, k, v: jax_gqa(q, k, v, causal=causal,
                                               chunk=64),
                       arrays, do, jnp.float32)
    return o, grads


def _tf32_inputs(b, sq, skv, hq, hkv, hd):
    arrays = _qkv(b, sq, hq, hkv, hd, seed=11 * sq + skv + hd, skv=skv)
    do = np.random.RandomState(sq + skv).randn(b, sq, hq, hd).astype(
        np.float32)
    return arrays, do


@pytest.mark.parametrize("b,sq,skv,hq,hkv,hd,causal", TF32_SHAPES)
def test_tf32_parts_match_jax(b, sq, skv, hq, hkv, hd, causal):
    """The plain mirror of the float32 kernels' operands (every product
    from two TF32 parts, three products; the scale on the float32 S and
    in the backward's epilogues), forward and backward, against JAX
    gqa_attention and its jax.grad at rtol 1e-4 / atol 1e-5, the bar the
    card holds the kernels to."""
    arrays, do = _tf32_inputs(b, sq, skv, hq, hkv, hd)
    o, grads = _tf32_mirror(arrays, do, causal)
    want_o, want = _tf32_want(arrays, do, causal)
    np.testing.assert_allclose(_np(o), _np(want_o), **F32, err_msg="o")
    for name, g, w in zip("qkv", grads, want):
        assert g.dtype == torch.float32 and g.shape == (b, (sq, skv)[
            name != "q"], (hq, hkv)[name != "q"], hd)
        np.testing.assert_allclose(_np(g), _np(w), **F32, err_msg=name)


def test_one_tf32_part_misses_the_float32_bar(monkeypatch):
    """At BERT4Rec's layout, where two parts pass, the mirror with one
    TF32 part per operand (lo dropped) misses rtol 1e-4 / atol 1e-5 on
    the forward and on every gradient: the test above could not pass
    with one part."""
    from repro_torch.kernels.flash_attn import kernel as fa_kernel
    arrays, do = _tf32_inputs(*TF32_SHAPES[0][:6])
    want_o, want = _tf32_want(arrays, do, False)
    monkeypatch.setattr(fa_kernel, "_tf32_parts",
                        lambda x: (fa_kernel._tf32(x), torch.zeros_like(x)))
    o, grads = _tf32_mirror(arrays, do, False)
    for name, g, w in zip(("o", "q", "k", "v"), (o,) + tuple(grads),
                          (want_o,) + tuple(want)):
        g, w = _np(g), _np(w)
        past = np.abs(g - w) > F32["atol"] + F32["rtol"] * np.abs(w)
        assert past.mean() > 0.1, (name, past.mean())


def test_tf32_rounds_to_nearest_away_from_zero():
    """_tf32 keeps 10 stored mantissa bits, rounding to nearest with
    halves away from zero (cvt.rna), signs and infinities intact, and
    hi + lo holds x to 2^-21 of it."""
    from repro_torch.kernels.flash_attn.kernel import _tf32, _tf32_parts
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 3 * 2.0 ** -12, 1.0 + 2.0 ** -12,
                      float("inf"), -0.0])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                         1.0 + 2.0 ** -10, 1.0, float("inf"), -0.0])
    assert torch.equal(_tf32(x), want)
    assert torch.equal(torch.signbit(_tf32(x)), torch.signbit(want))
    r = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(
        np.float32))
    hi, lo = _tf32_parts(r)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    assert ((hi + lo - r).abs() <= r.abs() * 2.0 ** -21).all()
