"""Wrappers of the CUDA kernels in ``csrc/flash_attn.cu``, which replaces
``repro/kernels/flash_attn/kernel.py::flash_attn_pallas``, and
``csrc/flash_attn_bwd.cu``, its backward, which replaces no TPU kernel
(the JAX package differentiates its jnp ``gqa_attention``); each source
says what bounds it on the H100 and what its design does about it.
Beside each, its plain PyTorch version.

Both take the model layout q ``(B, Sq, Hq, hd)``, k and v ``(B, Skv,
Hkv, hd)`` (query head h reads KV head ``h // (Hq // Hkv)``), compute in
float32 and return ``(B, Sq, Hq, hd)`` in q's dtype.  Positions count
from 0 for queries and keys alike, as in the TPU kernel.  Both types run
on the tensor cores (``wgmma``).  bfloat16 inputs carry p through P . V,
and P and dS through the backward's products, as two bf16 parts, so
that they keep the float32 arithmetic of the plain versions, the TPU
kernel and the JAX model.  float32 inputs run every product as split
TF32: each operand as two TF32 parts, hi = tf32(x) and lo = tf32(x -
hi), three products (lo . hi + hi . lo + hi . hi), which keeps float32's
accuracy (``tf32_parts=True`` mirrors it in the plain versions).

With ``return_lse=True`` the forward also returns each row's
log-sum-exp ``lse`` (B, Hq, Sq) float32, ``ln sum_t exp(q . k_t /
sqrt(hd))`` (+inf for a row that sees no key), which the backward
recomputes P from.  The backward takes q, k, v, the forward's o and
lse, and dO, and returns (dQ, dK, dV) in the inputs' dtype; dK and dV
sum over each KV head's query heads.

Given CUDA tensors :func:`flash_attn_kernel` and
:func:`flash_attn_bwd_kernel` validate them (float32 or bfloat16,
contiguous, ``hd`` in {16, 32, 64, 128}), allocate their outputs with
``torch.empty``, launch on PyTorch's current stream, raise on a nonzero
``cudaGetLastError`` and add one to their ``launches`` count (one
backward call launches the source's two kernels, dQ then dK / dV, and
counts once).  Given CPU tensors they run :func:`flash_attn_plain` and
:func:`flash_attn_bwd_plain`.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from ..utils import (check_cuda_tensor, check_launch, load_library, pad_to,
                     ptr, stream_handle)

BLOCK_Q = 64     # query rows per block
BLOCK_K = 64     # keys per KV tile
HEAD_DIMS = (16, 32, 64, 128)
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"flash_attn_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _I, _I, _I, ctypes.c_float, _P]}
_BWD_SIGNATURES = {"flash_attn_bwd_launch": [
    _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
    ctypes.c_float, _P]}


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or k.shape[2] < 1 or q.shape[2] % k.shape[2]:
        raise ValueError(
            f"expected q (B, Sq, Hq, hd) and k, v (B, Skv, Hkv, hd) with "
            f"Hq % Hkv == 0; got q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}")


def _lse(m: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """The row log-sum-exp from the online softmax's max and sum (+inf
    where the row saw no key), as the kernels write it."""
    return torch.where(l > 0, m + torch.log(l), float("inf"))


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 stored mantissa bits) as the kernels' cvt.rna
    rounds it: to nearest, halves away from zero, on the bit pattern."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def _tf32_parts(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x as the float32 kernels feed it to a product: hi = tf32(x) and lo
    = tf32(x - hi)."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _tf32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the float32 kernels compute it: both operands in two TF32
    parts, the three products lo . hi, hi . lo and hi . hi in that order
    (lo . lo is left out)."""
    a_hi, a_lo = _tf32_parts(a)
    b_hi, b_lo = _tf32_parts(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def flash_attn_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, return_lse: bool = False,
                     tf32_parts: bool = False):
    """The kernel's function and tiling in plain PyTorch: q tiles of
    BLOCK_Q rows pre-scaled by 1/sqrt(hd); per q tile the KV tiles of
    BLOCK_K keys, zero-padded at the tail and masked there, those wholly
    above the diagonal skipped under ``causal``; the online softmax with
    the kernel's guards (``m_safe``, a zero correction while m is -inf,
    division by max(l, 1e-30)).  With ``return_lse``, ``(o, lse)``.

    ``tf32_parts=True`` mirrors the float32 kernel's operands (tests and
    ``chip_smoke.py`` only): q is not pre-scaled, S = q . k^T and P . V
    run as :func:`_tf32_mm`, and the scale goes on the float32 S; the
    tiles stay BLOCK_K's (the kernel's are 32 keys, 16 at hd 128, which
    moves only the rounding)."""
    _check_shapes(q, k, v)
    n_b, n_q, n_hq, d = q.shape
    n_kv, n_hkv = k.shape[1], k.shape[2]
    g = n_hq // n_hkv
    dev = q.device
    scale = 1.0 / math.sqrt(d)
    mm = _tf32_mm if tf32_parts else torch.matmul
    # (B, Hkv, G, Sq, hd) against (B, Hkv, 1, Skv, hd): GQA by broadcast
    qf = (q.float() * (1.0 if tf32_parts else scale)).reshape(
        n_b, n_q, n_hkv, g, d).permute(0, 2, 3, 1, 4)
    kf = pad_to(k.float().permute(0, 2, 1, 3)[:, :, None], 3, BLOCK_K)
    vf = pad_to(v.float().permute(0, 2, 1, 3)[:, :, None], 3, BLOCK_K)
    out = torch.empty_like(qf)
    lse = torch.empty(qf.shape[:4], device=dev)
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
            s = mm(qt, kf[:, :, :, k0:k0 + BLOCK_K].transpose(-1, -2))
            if tf32_parts:
                s = s * scale
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
            acc = acc * corr[..., None] + mm(p, vf[:, :, :, k0:k0 + BLOCK_K])
            m = m_new
        out[:, :, :, q0:q0 + BLOCK_Q] = acc / torch.clamp(l, min=1e-30)[
            ..., None]
        lse[:, :, :, q0:q0 + BLOCK_Q] = _lse(m, l)
    out = out.permute(0, 3, 1, 2, 4).reshape(n_b, n_q, n_hq, d).to(q.dtype)
    if return_lse:
        return out, lse.reshape(n_b, n_hq, n_q)
    return out


def _check_cuda(dt: torch.dtype, dev: torch.device, what: str,
                **tensors: torch.Tensor) -> None:
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} takes float32 or bfloat16, got {dt}")
    for name, t in tensors.items():
        check_cuda_tensor(name, t, dt, dev, 4)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    d = tensors["q"].shape[3]
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim must be one of {HEAD_DIMS}, got {d}")


def flash_attn_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, return_lse: bool = False):
    """q (B, Sq, Hq, hd), k, v (B, Skv, Hkv, hd), float32 or bfloat16 ->
    (B, Sq, Hq, hd) in q's dtype; with ``return_lse``, ``(o, lse (B, Hq,
    Sq) float32)``.  Without it the launch passes a null ``lse`` and runs
    the instances that write none."""
    if q.device.type != "cuda":
        return flash_attn_plain(q, k, v, causal=causal,
                                return_lse=return_lse)
    _check_shapes(q, k, v)
    dev, dt = q.device, q.dtype
    _check_cuda(dt, dev, "flash_attn", q=q, k=k, v=v)
    n_b, n_q, n_hq, d = q.shape
    n_kv, n_hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((n_b, n_hq, n_q), dtype=torch.float32, device=dev)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    if n_kv == 0:
        raise ValueError("flash_attn needs at least one key")
    lib = load_library("flash_attn", _SIGNATURES)
    rc = lib.flash_attn_launch(
        ptr(q), ptr(k), ptr(v), ptr(out),
        ptr(lse) if return_lse else None, n_b, n_q, n_kv, n_hq, n_hkv, d,
        int(dt == torch.bfloat16), int(bool(causal)),
        ctypes.c_float(1.0 / math.sqrt(d)), stream_handle())
    check_launch(lib, rc, "flash_attn_kernel")
    flash_attn_kernel.launches += 1
    return (out, lse) if return_lse else out


flash_attn_kernel.launches = 0


def _bf16_parts(x: torch.Tensor) -> torch.Tensor:
    """x as the bf16 kernel feeds it to a product: hi = bf16(x) and lo =
    bf16(x - hi), summed (exactly) in float32."""
    hi = x.bfloat16().float()
    return hi + (x - hi).bfloat16().float()


def flash_attn_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         o: torch.Tensor, do: torch.Tensor,
                         lse: torch.Tensor, *, causal: bool = True,
                         bf16_parts: bool = False, tf32_parts: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """The backward kernel's function and tiling in plain PyTorch: D =
    rowsum(dO * O) in float32; q pre-scaled by 1/sqrt(hd); P recomputed
    per (BLOCK_Q, BLOCK_K) tile as exp(S - lse), 0 at the masked tail
    keys and above the diagonal, the tail queries' lse +inf; dS = P *
    (dO V^T - D).  dQ sums dS K over the KV tiles at or below the
    diagonal, times 1/sqrt(hd); dK (dS^T of the pre-scaled q) and dV (P^T
    dO) sum over the query tiles at or below the diagonal and the KV
    head's query heads.  Returns (dQ, dK, dV) in q's dtype.

    ``bf16_parts=True`` mirrors the bf16 kernel's operands (tests and
    ``chip_smoke.py`` only): q is not pre-scaled, P = exp(S / sqrt(hd) -
    lse) from the float32 S, P and dS enter their products as two bf16
    parts (:func:`_bf16_parts`; the dK / dV kernel also forms its dS
    from P's parts), and dQ and dK are scaled at the end.
    ``tf32_parts=True`` mirrors the float32 kernels' operands the same
    way, with all five products as :func:`_tf32_mm`."""
    if bf16_parts and tf32_parts:
        raise ValueError("bf16_parts and tf32_parts mirror different "
                         "kernels; take one")
    _check_shapes(q, k, v)
    n_b, n_q, n_hq, d = q.shape
    n_kv, n_hkv = k.shape[1], k.shape[2]
    g = n_hq // n_hkv
    dev = q.device
    scale = 1.0 / math.sqrt(d)
    split = bf16_parts or tf32_parts     # the scale on S and at the end
    mm = _tf32_mm if tf32_parts else torch.matmul

    def grouped(x):      # (B, S, Hq, hd) -> (B, Hkv, G, S, hd) float32
        return pad_to(x.float().reshape(n_b, n_q, n_hkv, g, d)
                      .permute(0, 2, 3, 1, 4), 3, BLOCK_Q)

    qf, dof = grouped(q) * (1.0 if split else scale), grouped(do)
    dsum = (dof * grouped(o)).sum(-1)                     # (B, Hkv, G, Sq)
    lsef = pad_to(lse.float().reshape(n_b, n_hkv, g, n_q), 3, BLOCK_Q,
                  value=float("inf"))
    kf = pad_to(k.float().permute(0, 2, 1, 3)[:, :, None], 3, BLOCK_K)
    vf = pad_to(v.float().permute(0, 2, 1, 3)[:, :, None], 3, BLOCK_K)
    n_qt, n_kt = -(-n_q // BLOCK_Q), -(-n_kv // BLOCK_K)

    def tile(qt: int, kt: int):
        """P and dP - D of query tile qt against KV tile kt."""
        qs, ks = slice(qt * BLOCK_Q, (qt + 1) * BLOCK_Q), \
            slice(kt * BLOCK_K, (kt + 1) * BLOCK_K)
        q_pos = qt * BLOCK_Q + torch.arange(BLOCK_Q, device=dev)
        kv_pos = kt * BLOCK_K + torch.arange(BLOCK_K, device=dev)
        keep = (kv_pos < n_kv)[None, :]
        if causal:
            keep = keep & (q_pos[:, None] >= kv_pos[None, :])
        s = mm(qf[:, :, :, qs], kf[:, :, :, ks].transpose(-1, -2))
        if split:
            s = s * scale
        p = torch.where(keep, torch.exp(s - lsef[:, :, :, qs, None]), 0.0)
        dp = mm(dof[:, :, :, qs], vf[:, :, :, ks].transpose(-1, -2))
        return p, dp - dsum[:, :, :, qs, None]

    parts = _bf16_parts if bf16_parts else (lambda x: x)

    def last_kt(qt: int) -> int:     # the diagonal skip
        if not causal:
            return n_kt
        return min(n_kt, (min((qt + 1) * BLOCK_Q, n_q) - 1) // BLOCK_K + 1)

    dq = torch.zeros_like(qf)
    dk = torch.zeros(kf.shape[:2] + (1,) + kf.shape[3:], device=dev)
    dv = torch.zeros_like(dk)
    for qt in range(n_qt):
        qs = slice(qt * BLOCK_Q, (qt + 1) * BLOCK_Q)
        for kt in range(last_kt(qt)):
            p, dpd = tile(qt, kt)
            dq[:, :, :, qs] += mm(parts(p * dpd),
                                  kf[:, :, :, kt * BLOCK_K:(kt + 1) * BLOCK_K])
    for kt in range(n_kt):
        ks = slice(kt * BLOCK_K, (kt + 1) * BLOCK_K)
        for qt in range(kt * BLOCK_K // BLOCK_Q if causal else 0, n_qt):
            p, dpd = tile(qt, kt)
            p = parts(p)
            ds = parts(p * dpd)
            qs = slice(qt * BLOCK_Q, (qt + 1) * BLOCK_Q)
            dv[:, :, :, ks] += mm(p.transpose(-1, -2), dof[:, :, :, qs]).sum(
                2, keepdim=True)
            dk[:, :, :, ks] += mm(ds.transpose(-1, -2), qf[:, :, :, qs]).sum(
                2, keepdim=True)
    dq = (dq[:, :, :, :n_q] * scale).permute(0, 3, 1, 2, 4).reshape(
        n_b, n_q, n_hq, d)
    if split:
        dk = dk * scale

    def per_kv(x):       # (B, Hkv, 1, Skv, hd) -> (B, Skv, Hkv, hd)
        return x[:, :, 0, :n_kv].permute(0, 2, 1, 3)

    return dq.to(q.dtype), per_kv(dk).to(q.dtype), per_kv(dv).to(q.dtype)


def flash_attn_bwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          o: torch.Tensor, do: torch.Tensor,
                          lse: torch.Tensor, *, causal: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """(dQ, dK, dV) of ``o = flash_attn(q, k, v)`` given dO, from the
    forward's o and lse (B, Hq, Sq) float32; each in q's dtype."""
    if q.device.type != "cuda":
        return flash_attn_bwd_plain(q, k, v, o, do, lse, causal=causal)
    _check_shapes(q, k, v)
    dev, dt = q.device, q.dtype
    _check_cuda(dt, dev, "flash_attn_bwd", q=q, k=k, v=v, o=o, do=do)
    n_b, n_q, n_hq, d = q.shape
    n_kv, n_hkv = k.shape[1], k.shape[2]
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and dO {tuple(do.shape)} must "
                         f"have q's shape {tuple(q.shape)}")
    check_cuda_tensor("lse", lse, torch.float32, dev, 3)
    if tuple(lse.shape) != (n_b, n_hq, n_q):
        raise ValueError(f"lse {tuple(lse.shape)} must be (B, Hq, Sq) = "
                         f"{(n_b, n_hq, n_q)}")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if dk.numel() == 0:
        return dq, dk, dv
    dsum = torch.empty((n_b, n_hq, n_q), dtype=torch.float32, device=dev)
    lib = load_library("flash_attn_bwd", _BWD_SIGNATURES)
    rc = lib.flash_attn_bwd_launch(
        ptr(q), ptr(k), ptr(v), ptr(o), ptr(do), ptr(lse), ptr(dsum),
        ptr(dq), ptr(dk), ptr(dv), n_b, n_q, n_kv, n_hq, n_hkv, d,
        int(dt == torch.bfloat16), int(bool(causal)),
        ctypes.c_float(1.0 / math.sqrt(d)), stream_handle())
    check_launch(lib, rc, "flash_attn_bwd_kernel")
    flash_attn_bwd_kernel.launches += 1
    return dq, dk, dv


flash_attn_bwd_kernel.launches = 0
