#!/usr/bin/env python3
"""Digest the port's flash_attn backward kernel's float32 output for one
source tree, to show that two trees' float32 backward kernels give the
same bits.

    python3 scripts/flash_attn_bwd_digest.py SRC_DIR

``SRC_DIR`` is the ``src`` directory of the tree: ``src`` for the
checkout, or that of another commit unpacked beside it (``git archive
<commit> src | tar -x -C build/parent``, then ``build/parent/src``).
For each of ``SHAPES`` it draws q, k, v and dO with numpy from a fixed
seed and computes the forward's o and lse with numpy in float64 (so the
inputs depend on no kernel and on no random generator of the card),
runs the tree's ``flash_attn_bwd_kernel`` on float32 inputs on the card,
and prints one JSON line ``{"shape causal": sha256 of dQ, dK and dV's
bytes (first 16 hex digits)}``.  The card-only test
``test_flash_attn_backward_keeps_its_float32_bits`` holds the checkout's
kernel to the digests this script printed for the tree that moved the
float32 kernels to split TF32 on ``wgmma``.  It prints the card's name
and power limit first and needs a CUDA device.
"""
import hashlib
import json
import subprocess
import sys

# (B, Sq, Skv, Hq, Hkv, hd, causal): tail lengths, Sq != Skv both ways,
# groups of 1, 3 and 4, every head width
SHAPES = ((2, 100, 100, 6, 2, 64, True), (1, 130, 70, 4, 1, 16, False),
          (2, 129, 129, 8, 2, 32, True), (1, 200, 200, 4, 4, 128, True),
          (1, 70, 130, 3, 1, 64, True))


def inputs(b, sq, skv, hq, hkv, hd, causal):
    """q, k, v, dO (float32) and the forward's o (float32) and lse (B, Hq,
    Sq) float32, computed in float64."""
    import numpy as np
    rng = np.random.RandomState(b * sq + skv + hd)
    q = rng.standard_normal((b, sq, hq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, skv, hkv, hd)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((b, sq, hq, hd)).astype(np.float32)
    kr, vr = (np.repeat(x.astype(np.float64), hq // hkv, axis=2)
              for x in (k, v))
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kr) / np.sqrt(hd)
    if causal:
        s = np.where(np.arange(skv)[None, :] > np.arange(sq)[:, None],
                     -np.inf, s)
    m = s.max(-1, keepdims=True)
    lse = m + np.log(np.exp(s - m).sum(-1, keepdims=True))
    o = np.einsum("bhqk,bkhd->bqhd", np.exp(s - lse), vr)
    return (q, k, v, o.astype(np.float32), do,
            np.ascontiguousarray(lse[..., 0], dtype=np.float32))


def digests(kernel):
    """``{label: digest}`` of ``kernel(q, k, v, o, dO, lse, causal=)`` over
    SHAPES, on float32 tensors on the card."""
    import torch

    out = {}
    for shape in SHAPES:
        causal = shape[-1]
        args = [torch.from_numpy(x).cuda() for x in inputs(*shape)]
        grads = kernel(*args, causal=causal)
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for g in grads:
            h.update(g.cpu().numpy().tobytes())
        out[f"{shape[:-1]} causal={causal}"] = h.hexdigest()[:16]
    return out


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, sys.argv[1])
    import torch
    if not torch.cuda.is_available():
        print("flash_attn_bwd_digest: needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    from repro_torch.kernels.flash_attn import flash_attn_bwd_kernel
    print(json.dumps({"src": sys.argv[1],
                      **digests(flash_attn_bwd_kernel)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
