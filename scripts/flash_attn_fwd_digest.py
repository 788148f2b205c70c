#!/usr/bin/env python3
"""Digest the port's flash_attn forward kernel's output for one source
tree, to show that two trees' forward kernels give the same bits.

    python3 scripts/flash_attn_fwd_digest.py SRC_DIR

``SRC_DIR`` is the ``src`` directory of the tree: ``src`` for the
checkout, or that of another commit unpacked beside it (``git archive
<commit> src | tar -x -C build/parent``, then ``build/parent/src``).
For each of ``SHAPES`` it draws q, k and v with numpy from a fixed seed
(so the inputs do not depend on the card's random generator), runs the
tree's ``flash_attn_kernel`` without an lse on the card, and prints one
JSON line ``{"shape dtype causal": sha256 of the output's bytes (first
16 hex digits)}``.  The card-only test
``test_flash_attn_forward_keeps_its_bits`` holds the checkout's kernel to
the digests this script printed: the bf16 ones for the tree before the
kernel could write an lse, the float32 one for the tree that moved the
float32 kernel to split TF32 on ``wgmma``.  It prints the card's name and power limit first and needs
a CUDA device.
"""
import hashlib
import json
import subprocess
import sys

# (B, S, Hq, Hkv, hd, dtype, causal): the LM build's shape (minitron-4b,
# bf16, wgmma), granite-moe's head width, and the float32 (split TF32)
# kernel at a tail length with a group of 3
SHAPES = ((32, 512, 24, 8, 128, "bfloat16", True),
          (4, 512, 24, 8, 64, "bfloat16", True),
          (2, 200, 6, 2, 64, "bfloat16", False),
          (2, 200, 6, 2, 128, "float32", True))


def digests(kernel):
    """``{label: digest}`` of ``kernel(q, k, v, causal=)`` over SHAPES."""
    import numpy as np
    import torch

    out = {}
    for b, s, hq, hkv, hd, dtype, causal in SHAPES:
        rng = np.random.RandomState(b * s + hd)
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (b, s, h, hd)).astype(np.float32)).to("cuda", getattr(torch,
                                                                   dtype))
            for h in (hq, hkv, hkv))
        o = kernel(q, k, v, causal=causal)
        torch.cuda.synchronize()
        raw = (o.view(torch.int16) if o.dtype == torch.bfloat16 else o)
        out[f"{(b, s, hq, hkv, hd)} {dtype} causal={causal}"] = \
            hashlib.sha256(raw.cpu().numpy().tobytes()).hexdigest()[:16]
    return out


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, sys.argv[1])
    import torch
    if not torch.cuda.is_available():
        print("flash_attn_fwd_digest: needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    from repro_torch.kernels.flash_attn import flash_attn_kernel
    print(json.dumps({"src": sys.argv[1], **digests(flash_attn_kernel)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
