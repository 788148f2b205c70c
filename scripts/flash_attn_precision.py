#!/usr/bin/env python3
"""How far the card's bf16 LM lies from the port's reference, through the
``flash_attn`` kernel and through two yardsticks.

    python3 scripts/flash_attn_precision.py [--seeds 0 2]

The yardsticks are the plain attention on the card (the card's GEMMs and
elementwise kernels, the plain attention's float32 arithmetic) and a
mirror of the plain attention that rounds p to bf16 before P . V, as
the tensor cores' P . V would with one bf16 operand.  For each it prints
the largest |diff| and the share of values past the port's bf16 bar
against the JAX model (2e-2, atol and rtol):

- the attention alone at the LM build's shape (32 docs x 512 positions,
  24 query heads over 8 KV heads of 128, causal), against the plain
  attention on the card;
- the bf16 smoke LMs of ``tests/test_torch_gpu.py``
  (``test_bf16_lm_forward_on_cuda_matches_cpu``: minitron-4b and
  stablelm-1.6b, two layers, head_dim 16 and 128, 3 x 300 tokens)
  against the CPU's plain forward;
- minitron-4b at its full width cut to two layers (the depth of
  ``chip_smoke.py``'s held bf16 check) over 32 x 512 tokens, against the
  plain attention on the card.

Weights and tokens are drawn from each seed.  It prints the card's name
and power limit first, and needs a CUDA device.
"""
import argparse
import dataclasses
import math
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_lm_config, smoke  # noqa: E402
from repro_torch.kernels.flash_attn import (flash_attn_kernel,  # noqa: E402
                                            flash_attn_plain)
from repro_torch.kernels.utils import pad_to  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

BLOCK = 64


def rounding_attention(q, k, v, *, causal=True):
    """``flash_attn_plain`` (causal, 64-row and 64-key tiles) with p
    rounded to bf16 before P . V; l sums the float32 p."""
    n_b, n_q, n_hq, d = q.shape
    n_kv, n_hkv = k.shape[1], k.shape[2]
    g = n_hq // n_hkv
    dev = q.device
    qf = (q.float() * (1.0 / math.sqrt(d))).reshape(
        n_b, n_q, n_hkv, g, d).permute(0, 2, 3, 1, 4)
    kf = pad_to(k.float().permute(0, 2, 1, 3)[:, :, None], 3, BLOCK)
    vf = pad_to(v.float().permute(0, 2, 1, 3)[:, :, None], 3, BLOCK)
    out = torch.empty_like(qf)
    for q0 in range(0, n_q, BLOCK):
        qt = qf[:, :, :, q0:q0 + BLOCK]
        q_pos = q0 + torch.arange(qt.shape[3], device=dev)
        n_kb = min(-(-n_kv // BLOCK), (q0 + qt.shape[3] - 1) // BLOCK + 1)
        m = torch.full(qt.shape[:4], float("-inf"), device=dev)
        l = torch.zeros(qt.shape[:4], device=dev)
        acc = torch.zeros(qt.shape, device=dev)
        for kb in range(n_kb):
            k0 = kb * BLOCK
            kv_pos = k0 + torch.arange(BLOCK, device=dev)
            s = qt @ kf[:, :, :, k0:k0 + BLOCK].transpose(-1, -2)
            keep = (kv_pos < n_kv)[None, :] & (q_pos[:, None]
                                               >= kv_pos[None, :])
            s = torch.where(keep, s, float("-inf"))
            m_new = torch.maximum(m, s.amax(-1))
            m_safe = torch.where(m_new == float("-inf"), 0.0, m_new)
            p = torch.exp(s - m_safe[..., None])
            corr = torch.where(m == float("-inf"), 0.0,
                               torch.exp(m - m_safe))
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + (
                p.bfloat16().float() @ vf[:, :, :, k0:k0 + BLOCK])
            m = m_new
        out[:, :, :, q0:q0 + BLOCK] = acc / torch.clamp(l, min=1e-30)[
            ..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(n_b, n_q, n_hq, d).to(q.dtype)


def versus(got, want) -> str:
    got, want = got.float().cpu(), want.float().cpu()
    err = (got - want).abs()
    past = (err > 2e-2 + 2e-2 * want.abs()).float().mean().item()
    return f"max |diff| {err.max().item():.4g}, {past:.4%} past 2e-2"


def on(params, dev):
    return {k: ({n: t.to(dev) for n, t in v.items()}
                if isinstance(v, dict) else v.to(dev))
            for k, v in params.items()}


def attention_at_build_shape(seed: int) -> None:
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(32, 512, h, 128, generator=g, device="cuda")
               .bfloat16() for h in (24, 8, 8))
    plain = flash_attn_plain(q, k, v)
    print(f"seed {seed}: attention (32, 512, 24/8, 128) causal vs plain on "
          f"the card: kernel {versus(flash_attn_kernel(q, k, v), plain)}; "
          f"p rounded {versus(rounding_attention(q, k, v), plain)}")


def smoke_lms(seed: int) -> None:
    for name in ("minitron-4b", "stablelm-1.6b"):
        for hd in (16, 128):
            c = dataclasses.replace(smoke(name), dtype="bfloat16",
                                    head_dim=hd)
            params = T.init_params(c, torch.Generator().manual_seed(seed),
                                   device="cpu")
            toks = torch.from_numpy(np.random.RandomState(seed).randint(
                0, c.vocab_size, (3, 300)).astype(np.int32))
            want, _ = T.forward(params, toks, c)
            pc, tc = on(params, "cuda"), toks.cuda()
            runs = {"kernel": T.forward(pc, tc, c)[0],
                    "plain": T.forward(pc, tc, c,
                                       attention=flash_attn_plain)[0],
                    "p rounded": T.forward(pc, tc, c,
                                           attention=rounding_attention)[0]}
            print(f"seed {seed}: {c.name} bf16 hd {hd} vs the CPU's plain "
                  f"forward: " + "; ".join(f"{k} {versus(v, want)}"
                                           for k, v in runs.items()))


def full_width(seed: int) -> None:
    lm = dataclasses.replace(get_lm_config("minitron-4b"), n_layers=2)
    params = T.init_params(lm, torch.Generator(device="cuda")
                           .manual_seed(seed), device="cuda")
    toks = torch.from_numpy(np.random.RandomState(seed).randint(
        0, lm.vocab_size, (32, 512)).astype(np.int32)).cuda()
    with torch.inference_mode():
        plain, _ = T.forward(params, toks, lm, attention=flash_attn_plain)
        kern, _ = T.forward(params, toks, lm)
        rd, _ = T.forward(params, toks, lm, attention=rounding_attention)
    print(f"seed {seed}: {lm.name} at full width, 2 layers, (32, 512) vs "
          f"the plain attention on the card: kernel {versus(kern, plain)}; "
          f"p rounded {versus(rd, plain)}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 2])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for seed in args.seeds:
        attention_at_build_shape(seed)
        smoke_lms(seed)
        full_width(seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
