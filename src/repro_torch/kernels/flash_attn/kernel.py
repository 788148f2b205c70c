"""Wrapper of the CUDA kernel in ``csrc/flash_attn.cu``, which replaces
``repro/kernels/flash_attn/kernel.py::flash_attn_pallas`` (the source
file says what bounds it on the H100 and what the design does about it),
and its plain PyTorch version.

Both take the model layout q ``(B, Sq, Hq, hd)``, k and v ``(B, Skv,
Hkv, hd)`` (query head h reads KV head ``h // (Hq // Hkv)``), compute in
float32 and return ``(B, Sq, Hq, hd)`` in q's dtype.  Positions count
from 0 for queries and keys alike, as in the TPU kernel.  bfloat16
inputs run the tensor-core kernel (``wgmma``), which carries p through
P . V as two bf16 parts, so that it keeps the float32 arithmetic of the
plain version, the TPU kernel and the JAX model; float32 inputs run the
FMA kernel.

Given CUDA tensors :func:`flash_attn_kernel` validates them (float32 or
bfloat16, contiguous, ``hd`` in {16, 32, 64, 128}), allocates its output
with ``torch.empty``, launches on PyTorch's current stream, raises on a
nonzero ``cudaGetLastError`` and adds one to its ``launches`` count.
Given CPU tensors it runs :func:`flash_attn_plain`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..utils import (check_cuda_tensor, check_launch, load_library, pad_to,
                     ptr, stream_handle)

BLOCK_Q = 64     # query rows per block
BLOCK_K = 64     # keys per KV tile
HEAD_DIMS = (16, 32, 64, 128)
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"flash_attn_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                     _I, _I, ctypes.c_float, _P]}


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or k.shape[2] < 1 or q.shape[2] % k.shape[2]:
        raise ValueError(
            f"expected q (B, Sq, Hq, hd) and k, v (B, Skv, Hkv, hd) with "
            f"Hq % Hkv == 0; got q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}")


def flash_attn_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True) -> torch.Tensor:
    """The kernel's function and tiling in plain PyTorch: q tiles of
    BLOCK_Q rows pre-scaled by 1/sqrt(hd); per q tile the KV tiles of
    BLOCK_K keys, zero-padded at the tail and masked there, those wholly
    above the diagonal skipped under ``causal``; the online softmax with
    the kernel's guards (``m_safe``, a zero correction while m is -inf,
    division by max(l, 1e-30))."""
    _check_shapes(q, k, v)
    n_b, n_q, n_hq, d = q.shape
    n_kv, n_hkv = k.shape[1], k.shape[2]
    g = n_hq // n_hkv
    dev = q.device
    # (B, Hkv, G, Sq, hd) against (B, Hkv, 1, Skv, hd): GQA by broadcast
    qf = (q.float() * (1.0 / math.sqrt(d))).reshape(
        n_b, n_q, n_hkv, g, d).permute(0, 2, 3, 1, 4)
    kf = pad_to(k.float().permute(0, 2, 1, 3)[:, :, None], 3, BLOCK_K)
    vf = pad_to(v.float().permute(0, 2, 1, 3)[:, :, None], 3, BLOCK_K)
    out = torch.empty_like(qf)
    n_kb_all = -(-n_kv // BLOCK_K)
    for q0 in range(0, n_q, BLOCK_Q):
        qt = qf[:, :, :, q0:q0 + BLOCK_Q]
        q_pos = q0 + torch.arange(qt.shape[3], device=dev)
        n_kb = n_kb_all
        if causal:       # the diagonal skip
            n_kb = min(n_kb, (q0 + qt.shape[3] - 1) // BLOCK_K + 1)
        m = torch.full(qt.shape[:4], float("-inf"), device=dev)
        l = torch.zeros(qt.shape[:4], device=dev)
        acc = torch.zeros(qt.shape, device=dev)
        for kb in range(n_kb):
            k0 = kb * BLOCK_K
            kv_pos = k0 + torch.arange(BLOCK_K, device=dev)
            s = qt @ kf[:, :, :, k0:k0 + BLOCK_K].transpose(-1, -2)
            keep = (kv_pos < n_kv)[None, :]              # the tail mask
            if causal:
                keep = keep & (q_pos[:, None] >= kv_pos[None, :])
            s = torch.where(keep, s, float("-inf"))
            m_new = torch.maximum(m, s.amax(-1))
            m_safe = torch.where(m_new == float("-inf"), 0.0, m_new)
            p = torch.exp(s - m_safe[..., None])
            corr = torch.where(m == float("-inf"), 0.0,
                               torch.exp(m - m_safe))
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + p @ vf[:, :, :, k0:k0 + BLOCK_K]
            m = m_new
        out[:, :, :, q0:q0 + BLOCK_Q] = acc / torch.clamp(l, min=1e-30)[
            ..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(n_b, n_q, n_hq, d).to(q.dtype)


def flash_attn_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True) -> torch.Tensor:
    """q (B, Sq, Hq, hd), k, v (B, Skv, Hkv, hd), float32 or bfloat16 ->
    (B, Sq, Hq, hd) in q's dtype."""
    if q.device.type != "cuda":
        return flash_attn_plain(q, k, v, causal=causal)
    _check_shapes(q, k, v)
    dev, dt = q.device, q.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attn takes float32 or bfloat16, got {dt}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_cuda_tensor(name, t, dt, dev, 4)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    n_b, n_q, n_hq, d = q.shape
    n_kv, n_hkv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim must be one of {HEAD_DIMS}, got {d}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if n_kv == 0:
        raise ValueError("flash_attn needs at least one key")
    lib = load_library("flash_attn", _SIGNATURES)
    rc = lib.flash_attn_launch(
        ptr(q), ptr(k), ptr(v), ptr(out), n_b, n_q, n_kv, n_hq, n_hkv, d,
        int(dt == torch.bfloat16), int(bool(causal)),
        ctypes.c_float(1.0 / math.sqrt(d)), stream_handle())
    check_launch(lib, rc, "flash_attn_kernel")
    flash_attn_kernel.launches += 1
    return out


flash_attn_kernel.launches = 0
